"""The port's dry run (``repro_torch.launch.dryrun`` over the meta-device
cost trace ``launch.op_cost``) against the JAX package's
(``repro.launch.dryrun`` and ``hlo_cost``), in-process on the suite's 8
fake CPU devices with ``Auto`` mesh axes (jax 0.9's default ``Explicit``
axes are why the reference's own ``test_reduced_dryrun_all_families``
fails here).  The JAX programs are compiled once, in a module fixture:

* ``count_params`` and ``model_flops`` equal JAX's exactly, for every
  assigned arch, full and reduced, on each of its shapes;
* ``batch_specs``, ``decode_state_specs_tree`` and
  ``optimizer_state_specs`` equal JAX's, for every ``dryrun_cells()``
  cell on both production meshes (JAX's functions get a stub mesh with
  ``axis_names`` and ``devices``, all they read); ``input_specs`` and
  ``decode_state_specs`` have JAX's shapes and dtypes;
* per-device argument and output bytes equal XLA's
  ``memory_analysis()`` on a (2, 4) and a 1 x 1 mesh for the reduced
  yi-6b, qwen3-moe-235b-a22b and zamba2-2.7b train steps at B 8 x 32,
  up to two terms the port does not have: JAX's optimizer step, a
  4-byte device scalar (the port's is a host int), and XLA's output
  tuple, 8 B a leaf;
* on 1 x 1 the trace's FLOPs of the reference script's five families
  (block remat on both sides) sit within ``FLOPS_BAND`` of
  ``hlo_cost.total_cost``'s, and a trace that drops the backward or
  block remat's recompute falls outside it;
* the qwen3-moe cell's collective bytes on (2, 4) are > 0 (the
  reference's own assertion);
* a context-parallel all-gather records exactly the K/V bytes each
  shard receives, and the blocked CP path's flash forward and backward
  are charged to their shard (the device's share is the last shard's).
"""
import dataclasses
import os
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as J_SHAPES
from repro.configs import dryrun_cells as j_dryrun_cells
from repro.configs import get_arch as j_get_arch
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.dist import sharding as JS
from repro.launch import hlo_cost
from repro.models import lm_zoo as JZ
from repro_torch.configs import SHAPES, dryrun_cells, get_arch
from repro_torch.configs.base import ASSIGNED_ARCHS, ShapeSpec
from repro_torch.dist import sharding as TS
from repro_torch.launch import dryrun as TD
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.op_cost import CostMode
from repro_torch.models import lm_zoo as TZ
from repro_torch.models import transformer_lm as TT

# port / JAX global FLOPs on 1 x 1, from readings (PERF.md section 2):
# 0.978 (zamba2: the port's flash charges only the causal pairs, JAX's
# blocked attention every tile) to 1.0075 (falcon-mamba); the planted
# faults read 0.78-0.86 (no remat recompute) and 0.25-0.27 (no backward)
FLOPS_BAND = (0.95, 1.05)
BYTES_ARCHS = ("yi-6b", "qwen3-moe-235b-a22b", "zamba2-2.7b")
FLOPS_ARCHS = ("yi-6b", "qwen3-moe-235b-a22b", "falcon-mamba-7b",
               "zamba2-2.7b", "hubert-xlarge")
B, S = 8, 32
MESHES = ((2, 4), (1, 1))


@pytest.fixture(scope="module")
def JD():
    """The JAX dry-run module.  Importing it sets ``XLA_FLAGS`` to 512
    placeholder devices for its own process; this process's count is
    fixed already, and the variable is put back so that no subprocess
    started later inherits it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def reduced(arch, remat="block"):
    """Both packages' reduced config, block remat unless asked."""
    return (dataclasses.replace(j_get_arch(arch).reduced(), remat=remat),
            dataclasses.replace(get_arch(arch).reduced(), remat=remat))


def jax_train_rules(cfg):
    rules = JS.default_rules()
    if cfg.family in ("ssm", "hybrid"):
        rules = rules.override(seq_act=None, tp="model", fsdp=("data",))
    return rules


def jax_compile_train(JD, cfg, mesh):
    """The reference script's train step (with ``run_cell``'s output
    shardings) -> (argument bytes, output bytes, output leaves, hlo
    FLOPs), one device's."""
    rules = jax_train_rules(cfg)
    with JS.sharding_ctx(mesh, rules):
        pspecs = JS.param_partition_specs(JZ.param_specs(cfg), rules)
        opt = JZ.make_optimizer(cfg)
        state = JZ.train_state_specs(cfg, opt)
        shape = JShapeSpec("t", S, B, "train")
        batch = JZ.input_specs(cfg, shape)["batch"]
        bspecs = JD.batch_specs(cfg, shape, mesh, False)
        ospecs = JD.optimizer_state_specs(cfg, state["opt"], pspecs)
        metrics = jax.eval_shape(JZ.make_loss_fn(cfg), state["params"],
                                 batch)[1]
        st_sh = {"params": pspecs, "opt": ospecs}
        compiled = jax.jit(
            JZ.make_train_step(cfg, opt),
            in_shardings=JS.named_shardings(mesh, (st_sh, bspecs)),
            out_shardings=JS.named_shardings(
                mesh, (st_sh, jax.tree.map(lambda _: JP(), metrics)))
        ).lower(state, batch).compile()
    ma = compiled.memory_analysis()
    return {"arg": int(ma.argument_size_in_bytes),
            "out": int(ma.output_size_in_bytes),
            "out_leaves": compiled.out_tree.num_leaves,
            "flops": hlo_cost.total_cost(compiled.as_text())["flops"]}


@pytest.fixture(scope="module")
def jax_runs(JD):
    out = {}
    for shape in MESHES:
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        for arch in (FLOPS_ARCHS if shape == (1, 1) else BYTES_ARCHS):
            out[arch, shape] = jax_compile_train(JD, reduced(arch)[0], mesh)
    return out


def port_cell(cfg, mesh_shape):
    return TD.run_cell(cfg.name, "t", False, {}, False, cfg=cfg,
                       shape=ShapeSpec("t", S, B, "train"),
                       mesh_shape=mesh_shape)


@pytest.fixture(scope="module")
def port_runs():
    return {(arch, shape): port_cell(reduced(arch)[1], shape)
            for shape in MESHES
            for arch in (FLOPS_ARCHS if shape == (1, 1) else BYTES_ARCHS)}


# ---------------------------------------------------------------------------
# config arithmetic and spec trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_counts_and_model_flops_equal_jax(JD, arch):
    for j_cfg, t_cfg in ((j_get_arch(arch), get_arch(arch)),
                         (j_get_arch(arch).reduced(),
                          get_arch(arch).reduced())):
        assert TD.count_params(t_cfg) == JD.count_params(j_cfg)
        for shape in j_cfg.shapes():
            assert TD.model_flops(t_cfg, SHAPES[shape.name]) == \
                JD.model_flops(j_cfg, J_SHAPES[shape.name])


def test_cells_equal_jax():
    assert [(c.name, s.name) for c, s in dryrun_cells()] == \
        [(c.name, s.name) for c, s in j_dryrun_cells()]


def canon(tree):
    """A spec tree of either package as plain Python: a spec as
    ("P", entries...), a one-name tuple as the name."""
    if isinstance(tree, (TS.P, JP)):
        return ("P",) + tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                              else e for e in tree)
    if isinstance(tree, dict):
        return {k: canon(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [canon(v) for v in tree]
    return tree


def shapes_dtypes(tree):
    """A tree of arrays or tensors as (shape, dtype name) leaves."""
    if isinstance(tree, dict):
        return {k: shapes_dtypes(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), str(tree.dtype).replace("torch.", "")
    return tuple(tree.shape), np.dtype(tree.dtype).name


def stub_mesh(mesh: Mesh):
    """What JAX's spec functions read of a mesh."""
    return types.SimpleNamespace(axis_names=mesh.axis_names,
                                 devices=np.empty(mesh.axis_sizes))


@pytest.fixture(scope="module")
def param_specs():
    """Each arch's full-size parameter specs, (JAX's, the port's)."""
    return {a: (JZ.param_specs(j_get_arch(a)), TZ.param_specs(get_arch(a)))
            for a in ASSIGNED_ARCHS}


@pytest.mark.parametrize("arch,shape", [(c.name, s.name)
                                        for c, s in dryrun_cells()])
def test_spec_trees_and_inputs_equal_jax(JD, param_specs, arch, shape):
    j_cfg, t_cfg = j_get_arch(arch), get_arch(arch)
    j_shape, t_shape = J_SHAPES[shape], SHAPES[shape]
    Bc, Sc = t_shape.global_batch, t_shape.seq_len
    j_state = JZ.decode_state_specs(j_cfg, Bc, Sc)
    t_state = TZ.decode_state_specs(t_cfg, Bc, Sc)
    assert shapes_dtypes(t_state) == shapes_dtypes(j_state)
    assert shapes_dtypes(TZ.input_specs(t_cfg, t_shape)) == \
        shapes_dtypes(JZ.input_specs(j_cfg, j_shape))
    for multi_pod in (False, True):
        t_mesh = make_production_mesh(multi_pod=multi_pod)
        j_mesh = stub_mesh(t_mesh)
        assert canon(TD.batch_specs(t_cfg, t_shape, t_mesh, multi_pod)) == \
            canon(JD.batch_specs(j_cfg, j_shape, j_mesh, multi_pod))
        assert canon(TD.decode_state_specs_tree(
            t_cfg, t_state, t_mesh, multi_pod)) == canon(
                JD.decode_state_specs_tree(j_cfg, j_state, j_mesh,
                                           multi_pod))
        if t_shape.kind != "train":
            continue
        j_rules = JS.default_rules(multi_pod=multi_pod)
        t_rules = TS.default_rules(multi_pod=multi_pod)
        if t_cfg.family in ("ssm", "hybrid"):
            j_rules = j_rules.override(seq_act=None, tp="model",
                                       fsdp=("data",))
            t_rules = t_rules.override(seq_act=None, tp="model",
                                       fsdp=("data",))
        j_params, t_params = param_specs[arch]
        with JS.sharding_ctx(j_mesh, j_rules):
            j_p = JS.param_partition_specs(j_params, j_rules)
        with TS.sharding_ctx(t_mesh, t_rules):
            t_p = TS.param_partition_specs(t_params, t_rules)
        assert canon(t_p) == canon(j_p)
        j_opt = jax.eval_shape(JZ.make_optimizer(j_cfg).init, j_params)
        t_opt = TZ.make_optimizer(t_cfg).init(t_params)
        assert canon(TD.optimizer_state_specs(t_cfg, t_opt, t_p)) == \
            canon(JD.optimizer_state_specs(j_cfg, j_opt, j_p))


# ---------------------------------------------------------------------------
# per-device bytes and FLOPs against XLA's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", BYTES_ARCHS)
def test_per_device_argument_and_output_bytes_equal_xla(jax_runs, port_runs,
                                                        arch, mesh):
    want, got = jax_runs[arch, mesh], port_runs[arch, mesh]["memory"]
    step_scalar = 4                    # JAX's int32 optimizer step
    assert got["argument_bytes"] + step_scalar == want["arg"]
    assert got["output_bytes"] + step_scalar + 8 * want["out_leaves"] == \
        want["out"]


@pytest.mark.parametrize("arch", FLOPS_ARCHS)
def test_flops_in_band_of_hlo_cost_and_faults_out(jax_runs, port_runs,
                                                  monkeypatch, arch):
    want = jax_runs[arch, (1, 1)]["flops"]
    ratio = port_runs[arch, (1, 1)]["trace"]["flops"] / want
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio
    # fault 1: block remat's recompute dropped
    no_remat = port_cell(reduced(arch, remat="none")[1], (1, 1))
    ratio = no_remat["trace"]["flops"] / want
    assert not FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio
    # fault 2: the backward dropped (the loss's forward alone)

    def forward_only(cfg, optimizer=None):
        loss_fn = TZ.make_loss_fn(cfg)
        return lambda state, batch: (state, loss_fn(state["params"],
                                                    batch)[1])
    monkeypatch.setattr(TZ, "make_train_step", forward_only)
    ratio = port_cell(reduced(arch)[1], (1, 1))["trace"]["flops"] / want
    assert not FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio


def test_moe_cell_moves_collective_bytes(port_runs):
    res = port_runs["qwen3-moe-235b-a22b", (2, 4)]
    assert res["trace"]["collective_bytes"] > 0
    kinds = {c["op"] for c in res["top_collectives"]}
    assert {"all_to_all", "all_gather", "reduce_scatter"} <= kinds


# ---------------------------------------------------------------------------
# the executor's collectives and the shards' kernels
# ---------------------------------------------------------------------------


def cp_inputs(Sq, grad=False):
    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta",
                           requires_grad=grad)
    return meta(2, Sq, 8, 64), meta(2, Sq, 2, 64), meta(2, Sq, 2, 64)


def test_cp_all_gather_records_the_kv_bytes_each_shard_receives():
    mesh = Mesh(("data", "model"), (1, 4), torch.device("meta"))
    q, k, v = cp_inputs(256)
    with TS.sharding_ctx(mesh, TS.default_rules()), \
            CostMode(devices=mesh.size) as trace:
        TT._cp_attention_shard_map(q, k, v, causal=True)
    kv = 2 * 256 * 2 * 64 * 2          # one of K, V gathered: (2, 256, 2, 64)
    assert dict(trace.collectives) == {
        (0, s): {("all_gather", ("model",)): 2.0 * kv} for s in range(4)}
    assert trace.total_cost()["collective_bytes"] == 2 * kv


def test_cp_flash_forward_and_backward_charged_to_their_shard():
    """Blocked CP on meta: each shard's flash call at its q_offset, and
    its backward (run by autograd outside the body) charged to the same
    shard; the device's FLOPs are the last shard's, which sees the most
    keys."""
    mesh = Mesh(("data", "model"), (1, 4), torch.device("meta"))
    q, k, v = cp_inputs(256, grad=True)
    with TS.sharding_ctx(mesh, TS.default_rules()), \
            CostMode(devices=mesh.size) as trace:
        out = TT._cp_attention_shard_map(q, k, v, causal=True, blocked=True)
        torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert dict(trace.kernel_calls) == {"flash_attention": 4,
                                        "flash_attention_bwd": 4}
    per_shard = {key: c[0] for key, c in trace.cost.items()
                 if key is not None}
    for s in range(4):                 # rows 64 s .. 64 s + 63 of 256 keys
        pairs = sum(64 * s + i + 1 for i in range(64))
        assert per_shard[0, s] == (4 + 10) * 64 * 2 * 8 * pairs
    assert trace.total_cost()["flops"] == per_shard[0, 3] + \
        trace.cost[None][0] / 4
