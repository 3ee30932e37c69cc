"""The process mesh (``launch.mesh.make_process_mesh``, ``dist.spmd``,
``launch.mesh_fleet``) on the CPU: one module fixture spawns one fleet of
4 gloo processes (``OMP_NUM_THREADS=1``, and the parent's logical runs on
one thread too: a CPU reduction splits by threads) that runs every job
below, each on a process mesh of the shape it needs; the parent holds
each rank's outputs against the logical executor in-process and against
the JAX package on the suite's fake CPU devices (``tests/conftest.py``)
with ``Auto`` axes:

* every case of ``tests/test_torch_mesh.py``'s ``_COLLECTIVES``,
  ``axis_index`` and autograd through the collectives on a (2, 2)
  process mesh: equal to the logical executor and to ``lax`` (small
  integers: every sum is exact);
* a body whose shards ask for different collectives raises on every
  rank;
* reduced qwen3-moe-235b-a22b in float32 under a (1, 4) process mesh on
  three paths, CP direct, CP blocked (the score budget lowered in both
  packages) and EP (``moe_apply`` alone, with drops and a shared
  expert): the prefill's hidden state and logits, one train step's loss
  and gradients (each rank's expert blocks against their rows), bit for
  bit equal to the logical mesh on every rank, and within the JAX bands
  of ``tests/test_torch_lm_mesh.py`` and
  ``tests/test_torch_lm_mesh_training.py``; the updated parameters of
  the held expert blocks within 1e-6 of the logical update's rows (the
  global norm adds the blocks' partial sums);
* each rank holds 1/4 of the rows of each expert leaf;
* the forward collectives each rank recorded equal, by count and by
  ``wire_bytes`` per kind and axis group, what ``op_cost.
  record_collective`` charges shard r for the same step traced on
  ``meta`` under a (1, 4) logical mesh.
"""
import functools
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import AxisType
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as j_get_arch
from repro.configs.base import MoEConfig
from repro.dist import sharding as JS
from repro.models import lm_zoo as JZ
from repro.models import moe as JMoE
from repro.models import transformer_lm as JT
from repro_torch.dist import sharding as TS
from repro_torch.launch import mesh_fleet as MF
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm_zoo as TZ
from repro_torch.models.convert import params_from_jax

ARCH = "qwen3-moe-235b-a22b"
B, S = 2, 16
HIDDEN_TOL = 1e-4       # tests/test_torch_lm_mesh.py
TOL = 1e-5
LOSS_TOL = 1e-5         # tests/test_torch_lm_mesh_training.py
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-6

# tests/test_torch_mesh.py's _COLLECTIVES, the untiled all-to-all's
# blocks cut so that their dim 0 is the (2, 2) mesh's model size
COLLECTIVES = [
    ("all_gather", "model", dict(axis=1, tiled=True)),
    ("all_gather", "data", dict(axis=0, tiled=True)),
    ("all_gather", ("data", "model"), dict(axis=1, tiled=True)),
    ("all_gather", "model", dict(axis=0, tiled=False)),
    ("all_gather", ("model", "data"), dict(axis=2, tiled=False)),
    ("all_to_all", "model", dict(split_axis=0, concat_axis=1, tiled=True)),
    ("all_to_all", "model", dict(split_axis=2, concat_axis=0, tiled=True)),
    ("all_to_all", "data", dict(split_axis=1, concat_axis=2, tiled=True)),
    ("all_to_all", ("data", "model"),
     dict(split_axis=0, concat_axis=1, tiled=True)),
    ("all_to_all", "model", dict(split_axis=0, concat_axis=1, tiled=False)),
    ("all_to_all", "model", dict(split_axis=0, concat_axis=0, tiled=False)),
    ("pmean", "model", {}),
    ("pmean", ("data", "model"), {}),
    ("pmean", "data", {}),
]
AXIS_NAMES = ["model", "data", ("data", "model"), ("model", "data")]
PATHS = ["cp_direct", "cp_blocked", "ep"]
# each CP path's train step: Adafactor's whole-leaf RMS and AdamW's global
# norm, each summed over the held expert blocks
OPTIMIZER = {"cp_direct": "adafactor", "cp_blocked": "adamw"}
EP_CASES = {"ep_nodrop": (8.0, 0), "ep_drop": (1.0, 0), "ep_shared": (0.5, 24)}


def _case(i, kind, names, kw):
    shape = (4, 16, 8) if kind == "all_to_all" and not kw["tiled"] \
        else (16, 16, 8)
    return {"name": f"c{i}", "kind": kind, "names": names, "kw": kw,
            "shape": shape}


def _collective_job(tmp):
    cases = [_case(i, *c) for i, c in enumerate(COLLECTIVES)]
    cases += [{"name": f"ax{i}", "kind": "axis_index", "names": n}
              for i, n in enumerate(AXIS_NAMES)]
    cases += [{"name": "autograd", "kind": "autograd"},
              {"name": "mismatch", "kind": "mismatch"}]
    return {"job": "collectives", "name": "collectives", "mesh": [2, 2],
            "cases": cases, "dir": str(tmp)}


@functools.lru_cache(maxsize=None)
def _jax_model():
    jcfg = j_get_arch(ARCH).reduced()
    jp = jax.tree.map(np.asarray, JZ.init_params(jcfg, jax.random.PRNGKey(3)))
    return jcfg, jp


def _batch():
    rng = np.random.default_rng(21)
    cfg = j_get_arch(ARCH).reduced()
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "valid": rng.random((B, S)) < 0.8}


@functools.lru_cache(maxsize=None)
def _moe_tree(shared):
    cfg = MoEConfig(num_experts=8, top_k=2, expert_d_ff=32,
                    capacity_factor=1.0, shared_expert_d_ff=shared)
    return jax.tree.map(np.asarray, JMoE.moe_init(jax.random.PRNGKey(0), cfg,
                                                  16, "swiglu"))


def _moe_x():
    return np.random.default_rng(1).normal(size=(4, 16, 16)).astype(
        np.float32)


def _jobs(tmp):
    _, jp = _jax_model()
    torch.save(params_from_jax(jp, device="cpu"), tmp / "params.pt")
    np.savez(tmp / "batch.npz", **_batch())
    np.save(tmp / "x.npy", _moe_x())
    jobs = [_collective_job(tmp)]
    for path in ("cp_direct", "cp_blocked"):
        base = {"job": "lm", "mesh": [1, 4], "arch": ARCH, "reduced": True,
                "compute": "float32", "dir": str(tmp),
                "cp_score_limit": 1.0 if path == "cp_blocked" else None,
                "params": {"file": str(tmp / "params.pt")},
                "batch": {"file": str(tmp / "batch.npz")}}
        jobs += [dict(base, name=f"{path}_prefill", mode="prefill"),
                 dict(base, name=f"{path}_train", mode="train", steps=1,
                      optimizer={"name": OPTIMIZER[path], "peak_lr": 1e-2,
                                 "warmup": 1})]
    for name, (cf, shared) in EP_CASES.items():
        file = tmp / f"{name}.pt"
        torch.save(params_from_jax(_moe_tree(shared), device="cpu"), file)
        jobs.append({"job": "lm", "mode": "moe", "name": name,
                     "mesh": [1, 4], "arch": ARCH, "reduced": True,
                     "cfg": {"moe": dict(num_experts=8, top_k=2,
                                         expert_d_ff=32, capacity_factor=cf,
                                         shared_expert_d_ff=shared)},
                     "dir": str(tmp), "params": {"file": str(file)},
                     "x": str(tmp / "x.npy")})
    return jobs


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """{job name: (logical result, logical arrays, [each rank's (result,
    npz)])}: one 4-process fleet runs every job; meanwhile the parent runs
    each on the logical mesh, on one thread as the ranks do."""
    tmp = tmp_path_factory.mktemp("process_mesh")
    jobs = _jobs(tmp)
    with ThreadPoolExecutor(1) as pool:     # the fleet, while the logical
        fleet_run = pool.submit(             # runs go on here
            MF.launch, jobs, 4, device="cpu", timeout_s=240,
            group_timeout_s=60, extra_env={"OMP_NUM_THREADS": "1"})
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            logical = [MF.run_job(job, "cpu", logical=True) for job in jobs]
        finally:
            torch.set_num_threads(threads)
        results = fleet_run.result()
    out = {}
    for job, (ref, arrays) in zip(jobs, logical):
        ranks = []
        for r in results:
            res = next(j for j in r["jobs"] if j["name"] == job["name"])
            ranks.append((res, np.load(res["file"])
                          if "file" in res else None))
        out[job["name"]] = (ref, arrays, ranks)
    return out


# ---------------------------------------------------------------------------
# collectives on a (2, 2) process mesh
# ---------------------------------------------------------------------------


def _jshard_map(body, in_specs, out_specs, *args):
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fn = JS.shard_map(body, mesh=mesh, in_specs=in_specs,
                      out_specs=out_specs, check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(fn)(*args))


def _every_rank_equals(fleet, name, key, want):
    _, logical, ranks = fleet["collectives"]
    np.testing.assert_array_equal(logical[key], want)
    for _, got in ranks:
        assert got[key].shape == want.shape
        np.testing.assert_array_equal(got[key], want)


@pytest.mark.parametrize("i", range(len(COLLECTIVES)))
def test_collectives_match_lax(fleet, i):
    kind, names, kw = COLLECTIVES[i]
    case = _case(i, kind, names, kw)
    x = MF.collective_input(case["shape"])

    def jbody(a):
        if kind == "pmean":
            r = lax.pmean(a, names)
        elif kind == "all_gather":
            r = lax.all_gather(a, names, **kw)
        else:
            r = lax.all_to_all(a, names, kw["split_axis"], kw["concat_axis"],
                               tiled=kw["tiled"])
        return r[None, None]
    want = _jshard_map(jbody, (JP("data", "model", None),),
                       JP("data", "model"), x)
    _every_rank_equals(fleet, "collectives", case["name"], want)


@pytest.mark.parametrize("i", range(len(AXIS_NAMES)))
def test_axis_index_matches_lax(fleet, i):
    names = AXIS_NAMES[i]

    def jbody(a):
        return jnp.full((1, 1), lax.axis_index(names), jnp.int32)
    want = _jshard_map(jbody, (JP("data", "model"),), JP("data", "model"),
                       np.zeros((2, 2), np.float32))
    _every_rank_equals(fleet, "collectives", f"ax{i}", want)


def test_autograd_through_the_collectives(fleet):
    """The all-gather's transpose (its members' gradients added in shard
    order) and pmean's through the process groups: value and gradient
    equal to the logical executor and to ``jax.grad`` of the same
    ``shard_map``."""
    inp = MF.autograd_inputs()

    def jbody(a, wl):
        full = lax.all_gather(a, "model", axis=1, tiled=True)
        s = (full * full.sum(1, keepdims=True)).sum() * wl.sum()
        return lax.pmean(s, ("data", "model"))
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fn = JS.shard_map(jbody, mesh=mesh,
                      in_specs=(JP("data", "model"), JP("data", "model")),
                      out_specs=JP(), check_vma=False)
    val, grad = jax.jit(jax.value_and_grad(fn))(inp["x"], inp["w"])
    _every_rank_equals(fleet, "collectives", "autograd",
                       np.asarray(val, np.float32))
    _every_rank_equals(fleet, "collectives", "autograd/grad",
                       np.asarray(grad, np.float32))


def test_mismatched_collectives_raise_on_every_rank(fleet):
    ref, _, ranks = fleet["collectives"]
    msg = "shards asked for different collectives"
    assert msg in ref["mismatch"]["error"]      # the logical executor's
    for res, _ in ranks:
        assert msg in res["mismatch"]["error"]


# ---------------------------------------------------------------------------
# reduced Qwen3-MoE under a (1, 4) process mesh
# ---------------------------------------------------------------------------


def _names(path):
    if path == "ep":
        return list(EP_CASES)
    return [f"{path}_prefill", f"{path}_train"]


@pytest.mark.parametrize("path", PATHS)
def test_every_rank_equals_the_logical_mesh(fleet, path):
    for name in _names(path):
        _, want, ranks = fleet[name]
        assert want
        for rank, (res, got) in enumerate(ranks):
            bad = MF.differing(res, got, want, rank, (1, 4))
            assert not bad, (name, rank, bad)
            if "whole_grad_digest" in res:      # rank 0's leaves: on all
                assert res["whole_grad_digest"] == \
                    ranks[0][0]["whole_grad_digest"]


@pytest.mark.parametrize("path", ["cp_direct", "cp_blocked"])
def test_held_blocks_update_as_the_logical_rows(fleet, path):
    """Each rank's updated parameters after one step at a learning rate
    of 1e-2 (cp_direct: Adafactor, whose update of a leaf is clipped to
    its whole-leaf RMS, here above 1 on every expert leaf; cp_blocked:
    AdamW, whose global norm takes every leaf's sum of squares): a whole
    leaf equal to the logical update (rank 0's, and every rank's by
    digest), a held expert block within 1e-6 of its rows of it (both add
    the four blocks' partial sums, the logical update each leaf whole; a
    wrong block count or leaf would move it by about 1e-4 or more); the
    losses equal."""
    ref, want, ranks = fleet[f"{path}_train"]
    for rank, (res, got) in enumerate(ranks):
        assert res["losses"] == ref["losses"]
        assert res["whole_param_digest"] == ranks[0][0]["whole_param_digest"]
        held = 0
        for k in (k for k in want if k.startswith("param/")):
            leaf = k.split("/", 1)[1]
            if leaf in res["held"]:
                held += 1
                w = MF.rows_of(want[k], got[k].shape, rank)
                np.testing.assert_allclose(got[k], w, rtol=0,
                                           atol=UPDATE_TOL)
            elif rank == 0:
                np.testing.assert_array_equal(got[k], want[k])
        assert held == 3


def test_each_rank_holds_a_quarter_of_each_expert_leaf(fleet):
    _, jp = _jax_model()
    whole = {f"layers/moe/{n}": jp["layers"]["moe"][n].shape
             for n in ("w_gate", "w_up", "w_down")}
    for name in ("cp_direct_train", "cp_blocked_prefill"):
        for res, _ in fleet[name][2]:
            assert set(res["held"]) == set(whole)
            for n, shape in whole.items():
                L, E = shape[:2]
                assert res["held"][n] == [L, E // 4, *shape[2:]]
    for res, _ in fleet["ep_shared"][2]:
        assert {n: s[0] for n, s in res["held"].items()} == {
            "w_gate": 2, "w_up": 2, "w_down": 2}


def _jax_ctx():
    mesh = jax.make_mesh((1, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return JS.sharding_ctx(mesh, JS.default_rules())


@pytest.fixture
def float32_both(monkeypatch):
    """Both packages' loss and forward in float32 (the port's through
    ``mesh_fleet.float32_compute``, as its fleets run them)."""
    monkeypatch.setattr(JZ, "_cast_compute",
                        lambda params, dtype=None: params)
    monkeypatch.setattr(JZ, "embed_input",
                        functools.partial(JT.embed_input, dtype=jnp.float32))
    with MF.float32_compute():
        yield


def _close_to_leaf(got, want, tol, what):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


@pytest.mark.parametrize("path", PATHS)
def test_within_the_jax_bands(fleet, path, float32_both, monkeypatch):
    """Rank 0's outputs against the JAX package's under its (1, 4) mesh:
    the hidden state within 1e-4, the loss within 1e-5 of max(1, |loss|)
    and each gradient leaf within 1e-4 of its max (a held leaf: the
    rank's rows), the EP layer's output and aux within 1e-5 and its
    gradients within 1e-4."""
    if path == "ep":
        x = _moe_x()
        for name, (cf, shared) in EP_CASES.items():
            cfg = MoEConfig(num_experts=8, top_k=2, expert_d_ff=32,
                            capacity_factor=cf, shared_expert_d_ff=shared)
            jp = _moe_tree(shared)
            def f(p, xx, cfg=cfg):
                y, aux = JMoE.moe_apply(p, xx, cfg, "swiglu")
                return jnp.sum(y ** 2), (y, aux)
            with _jax_ctx():
                (_, (y, aux)), g = jax.jit(jax.value_and_grad(
                    f, argnums=(0, 1), has_aux=True))(jp, x)
            for rank, (res, got) in enumerate(fleet[name][2]):
                np.testing.assert_allclose(got["y"], y, rtol=TOL, atol=TOL)
                for k in ("moe_lb_loss", "moe_drop_frac"):
                    np.testing.assert_allclose(got[k], aux[k], rtol=TOL,
                                               atol=TOL)
                _close_to_leaf(got["grad/x"], g[1], GRAD_TOL, "x")
                for n, leaf in MF._paths(params_from_jax(g[0],
                                                         device="cpu")):
                    want = leaf.numpy()
                    if n in res["held"]:
                        want = MF.rows_of(want, got[f"grad/{n}"].shape, rank)
                    _close_to_leaf(got[f"grad/{n}"], want, GRAD_TOL, n)
        return
    if path == "cp_blocked":
        monkeypatch.setattr(JT, "_CP_SCORE_BYTES_LIMIT", 1.0)
    jcfg, jp = _jax_model()
    batch = _batch()
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    x = jp["embed"][batch["tokens"]]
    with _jax_ctx():
        h = jax.jit(lambda p, xx, pp: JT.forward_hidden(jcfg, p, xx, pp)[0])(
            jp, x, pos)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            JZ.make_loss_fn(jcfg), has_aux=True))(
            jax.tree.map(jnp.asarray, jp),
            {k: jnp.asarray(v) for k, v in batch.items()})
    res, got = fleet[f"{path}_prefill"][2][0]
    np.testing.assert_allclose(got["hidden"], h, rtol=HIDDEN_TOL,
                               atol=HIDDEN_TOL)
    res, got = fleet[f"{path}_train"][2][0]
    assert abs(res["losses"][0] - float(loss)) <= LOSS_TOL * max(
        1.0, abs(float(loss)))
    for n, leaf in MF._paths(params_from_jax(jax.tree.map(np.asarray, grads),
                                             device="cpu")):
        want = leaf.numpy()
        if n in res["held"]:
            want = MF.rows_of(want, got[f"grad/{n}"].shape, 0)
        _close_to_leaf(got[f"grad/{n}"], want, GRAD_TOL, n)


# ---------------------------------------------------------------------------
# the collective record against the dry run's charges
# ---------------------------------------------------------------------------


def _dry_run_charges(job, monkeypatch):
    """Each shard's ``record_collective`` calls for the job's step traced
    on ``meta`` under a (1, 4) logical mesh: {shard: Counter((kind,
    axes, bytes))}."""
    calls = {}
    real = op_cost.record_collective

    def spy(kind, b, group, shard):
        calls.setdefault(shard[1], Counter())[(kind, tuple(group),
                                                float(b))] += 1
        real(kind, b, group, shard)
    monkeypatch.setattr(op_cost, "record_collective", spy)
    cfg = MF.arch_config(job)
    meta = torch.device("meta")
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device=meta),
             "valid": torch.empty((B, S), dtype=torch.bool, device=meta)}
    with MF._patched(job), TS.sharding_ctx(Mesh(("data", "model"), (1, 4),
                                                meta), TS.default_rules()):
        params = TZ.param_specs(cfg)
        if job["mode"] == "train":
            opt = TZ.make_optimizer(cfg)
            step = TZ.make_train_step(cfg, opt)
            args = ({"params": params, "opt": opt.init(params)}, batch)
        else:
            step, args = TZ.make_prefill_step(cfg), (params, batch)
        with op_cost.CostMode(devices=4):
            step(*args)
    return calls


@pytest.mark.parametrize("name", ["cp_direct_prefill", "cp_blocked_prefill",
                                  "cp_direct_train", "cp_blocked_train"])
def test_forward_collectives_equal_the_dry_run(fleet, name, monkeypatch):
    """Rank r's forward collectives (its body's, as recorded) equal, in
    count and in ``wire_bytes`` per kind and axis group, shard r's
    ``record_collective`` charges; the backward's are recorded apart
    (the dry run does not model them) and a train step has some."""
    job = next(j for j in _jobs_meta() if j["name"] == name)
    charges = _dry_run_charges(job, monkeypatch)
    assert sorted(charges) == [0, 1, 2, 3]
    for rank, (res, _) in enumerate(fleet[name][2]):
        rows = res["records"][0] if "records" in res else res["record"]
        body = Counter((r["kind"], tuple(r["axes"]), r["bytes"])
                       for r in rows if r["what"] == "body")
        assert body == charges[rank], (rank, body, charges[rank])
        assert all(r["dir"] == "fwd" for r in rows
                   if r["what"] in ("body", "assemble"))
        backward = [r for r in rows if r["dir"] == "bwd"]
        assert bool(backward) == name.endswith("_train")


def _jobs_meta():
    """The lm jobs' descriptions, without the files (the trace needs only
    the config and the patches)."""
    out = []
    for path in ("cp_direct", "cp_blocked"):
        base = {"job": "lm", "mesh": [1, 4], "arch": ARCH, "reduced": True,
                "compute": "float32",
                "cp_score_limit": 1.0 if path == "cp_blocked" else None}
        out += [dict(base, name=f"{path}_prefill", mode="prefill"),
                dict(base, name=f"{path}_train", mode="train")]
    return out
