"""Fleets of one process a mesh shard: the launcher of the process mesh
(``launch.mesh.make_process_mesh``, ``dist.spmd``).

    parent (this module's CLI, a test, or chip_smoke.py)
      ├─ builds the CUDA kernels once (runtime.build) for the card
      ├─ spawns data x model workers: python -m repro_torch.launch.mesh_fleet
      │  (launch.multihost.launch: its ports, environment and fail-fast
      │  wait), the jobs in REPRO_MH_RUN_CFG
      │
      │   rank 0          rank 1          rank 2          rank 3
      │   shard (0, 0)    shard (0, 1)    shard (0, 2)    shard (0, 3)
      │   └──────── gloo group + one subgroup per set of axes ────────┘
      └─ collects one MH_RESULT json line per worker

Each worker joins the gloo group (its timeout ends the fleet when a
rank dies), then runs its jobs in order, each under
``sharding_ctx(make_process_mesh(*job["mesh"]), default_rules())``:

* ``collectives``: cases of ``all_gather``, ``all_to_all``, ``pmean``,
  ``axis_index``, autograd through them, and a body whose shards ask for
  different collectives;
* ``lm``: an LM step of an arch (``mode`` ``prefill``: ``make_prefill_step``
  after a short warm-up, its hidden state and aux kept; ``grads``: the
  forward's hidden state, then one train step's loss and gradients
  (``make_loss_fn`` under ``torch.autograd.grad``, no optimizer state);
  ``train``: ``make_train_step`` for n steps, the first step's
  gradients and updated parameters kept; ``moe``: ``moe_apply`` alone),
  on a tree from a file (cut to the process's expert blocks,
  ``dist.spmd.hold_blocks``) or drawn from a seed (in turns, rank by
  rank, each expert leaf cut to the block as soon as it is drawn: four
  ranks of a full-width model never hold a whole one each).

A job's arrays go to ``.npz`` files under its ``dir``: of the gradients
and parameters, every rank's held blocks and rank 0's whole leaves, with
every rank's digests of its whole leaves.  The result line carries their
paths, the flash and 5b launch counts, the device's peak memory, each
phase's wall seconds and the process's collective record
(``dist.spmd.record``).  :func:`run_job` runs the same job in this
process on a logical mesh: the reference a fleet is held to.
:func:`float32_compute` and :func:`routing` are the parity checks'
patches, here and in the tests and ``chip_smoke.py``.

    PYTHONPATH=src python -m repro_torch.launch.mesh_fleet --device cpu

runs reduced Qwen3-MoE's prefill and one train step in float32 as a
(1, 4) fleet on the CPU and exits 1 unless every rank's hidden state,
loss and gradients equal the logical mesh's bit for bit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import functools
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.launch import multihost
from repro_torch.obs import get_logger

WORKER_CMD = (sys.executable, "-m", "repro_torch.launch.mesh_fleet")
GROUP_TIMEOUT_S = 300.0        # a rank that dies ends its peers after this

log = get_logger("launch.mesh_fleet")


def launch(jobs: List[Dict[str, Any]], processes: int, *,
           device: str = "cuda", timeout_s: float = 900.0,
           group_timeout_s: float = GROUP_TIMEOUT_S,
           extra_env: Optional[Dict[str, str]] = None) -> List[Dict]:
    """Spawn ``processes`` workers that run ``jobs`` and return each
    rank's result (:func:`worker_main`), in rank order.  A rank that
    fails takes the fleet down and its traceback is in the raised
    error."""
    outs = multihost.launch(
        processes, 1, run_cfg={"jobs": jobs,
                               "group_timeout_s": group_timeout_s},
        device=device, extra_env=extra_env, timeout_s=timeout_s,
        worker_cmd=WORKER_CMD)
    return multihost.parse_results(outs)


# ---------------------------------------------------------------------------
# Jobs: the same code on a process mesh (a worker) or a logical one
# ---------------------------------------------------------------------------


def _mesh(job, device, logical: bool):
    from repro_torch.launch.mesh import make_local_mesh, make_process_mesh
    data, model = job["mesh"]
    if logical:
        return make_local_mesh(data, model, device=device)
    return make_process_mesh(data, model, device=device)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def float32_compute():
    """The loss and the forward in float32, as the parity tests run them:
    the bf16 compute cast and the embedding's bf16 output set aside."""
    import torch

    from repro_torch.models import lm_zoo as Z
    from repro_torch.models import transformer_lm as T
    saved = Z._cast_compute, Z.embed_input
    Z._cast_compute = lambda params, dtype=None: params
    Z.embed_input = functools.partial(T.embed_input, dtype=torch.float32)
    try:
        yield
    finally:
        Z._cast_compute, Z.embed_input = saved


@contextlib.contextmanager
def routing(replay=None):
    """Record, for each ``moe._top_k`` call inside the block, the router's
    probabilities and the experts it picks (on the host).  With
    ``replay`` (an earlier record, call by call) the model gets that
    record's experts instead, with this run's own probabilities at them."""
    from repro_torch.models import moe

    real, picked = moe._top_k, []

    def record(probs, k):
        vals, idx = real(probs, k)
        picked.append((probs.detach().cpu(), idx.cpu()))
        if replay is None:
            return vals, idx
        idx = replay[len(picked) - 1][1].to(probs.device)
        return probs.gather(-1, idx), idx
    moe._top_k = record
    try:
        yield picked
    finally:
        moe._top_k = real


@contextlib.contextmanager
def _patched(job):
    """The job's departures from the production step: the loss and the
    forward in float32 (``compute: "float32"``) and the context-parallel
    score budget (``cp_score_limit``)."""
    from repro_torch.models import transformer_lm as T
    saved = T._CP_SCORE_BYTES_LIMIT
    if job.get("cp_score_limit") is not None:
        T._CP_SCORE_BYTES_LIMIT = float(job["cp_score_limit"])
    try:
        with (float32_compute() if job.get("compute") == "float32"
              else contextlib.nullcontext()):
            yield
    finally:
        T._CP_SCORE_BYTES_LIMIT = saved


def _save_experts(arrays, head: str, picked) -> None:
    for i, (_, idx) in enumerate(picked):
        arrays[f"{head}/{i}"] = idx.numpy()


def arch_config(job):
    """The job's ``ArchConfig``: ``arch`` (``reduced`` if asked) with the
    fields of ``cfg`` replaced (``moe`` a dict of MoEConfig fields)."""
    from repro_torch.configs import get_arch
    cfg = get_arch(job["arch"])
    if job.get("reduced"):
        cfg = cfg.reduced()
    over = dict(job.get("cfg", {}))
    if "moe" in over:
        over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
    return dataclasses.replace(cfg, **over)


def _tree(job, cfg, device, mesh, logical: bool):
    """The parameter tree on ``device``: a file's whole tree (cut to the
    process's blocks), or drawn from ``params.seed`` with each expert
    leaf cut as soon as it is drawn, rank by rank."""
    import torch
    import torch.distributed as tdist

    from repro_torch.dist import spmd
    from repro_torch.models import lm_zoo as Z
    spec = job["params"]
    if "file" in spec:
        whole = torch.load(spec["file"], map_location=device)
        if job["mode"] == "moe":        # one layer's tree: its rules' path
            return spmd.hold_blocks({"moe": whole})["moe"]
        return spmd.hold_blocks(whole)
    dtype = getattr(torch, spec.get("dtype", "float32"))
    gen = lambda: torch.Generator(device=device).manual_seed(spec["seed"])
    if logical:
        return Z.init_params(cfg, gen(), dtype, device=device)
    tree = None
    for r in range(mesh.size):        # one whole expert leaf at a time
        if r == mesh.rank:
            tree = Z.init_params(cfg, gen(), dtype, device=device,
                                 keep=spmd.expert_keeper())
            _sync(device)
            if device.type == "cuda":  # the whole leaves' blocks, for
                torch.cuda.empty_cache()   # the next rank's draw
                free, _ = torch.cuda.mem_get_info(device)
                log.info(f"rank {mesh.rank}: tree drawn, "
                         f"{torch.cuda.memory_allocated(device) / 1e9:.2f} "
                         f"GB held, the card {free / 1e9:.2f} GB free")
        tdist.barrier()
    return tree


def _batch(job, cfg, device):
    import torch
    spec = job["batch"]
    if "file" in spec:
        data = np.load(spec["file"])
        return {k: torch.from_numpy(data[k]).to(device) for k in data.files}
    rng = np.random.default_rng(spec["seed"])
    toks = rng.integers(0, cfg.vocab, (spec["B"], spec["S"]))
    return {"tokens": torch.from_numpy(toks.astype(np.int32)).to(device)}


def _paths(tree):
    """(name, leaf) in ``train.optimizer.tree_leaves`` order, the name
    the leaf's path joined by '/'."""
    from repro_torch.dist.spmd import _paths_sorted
    return [("/".join(p), t) for p, t in _paths_sorted(tree)]


def _digest(t) -> List[int]:
    """Two integer sums of a tensor's bit patterns (on its device, in
    chunks): equal tensors give equal digests."""
    import torch
    v = t.detach().contiguous().reshape(-1)
    v = v.view(torch.int32 if v.element_size() == 4 else torch.int16)
    s1 = s2 = 0
    step = 1 << 24
    for i in range(0, v.numel(), step):
        c = v[i:i + step].to(torch.int64)
        w = torch.arange(i + 1, i + 1 + c.numel(), device=c.device)
        s1 += int(c.sum())
        s2 += int((c * w).sum())
    return [s1, s2]


def _counts() -> Dict[str, int]:
    from repro_torch.kernels import runtime
    return {k: v for k, v in runtime.launch_counts().items()
            if k.startswith("flash_attention")}


def _peak(device) -> int:
    import torch
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def _save_leaves(kind, res, arrays, tree, leaves, logical) -> None:
    """``leaves`` (in ``tree``'s leaf order) into ``arrays`` as
    ``<kind>/<path>``: every leaf on the logical mesh; on a process mesh
    the held blocks on every rank and the whole leaves on rank 0 only
    (four ranks of a full-width model would each write the same GBs),
    with every rank's digests of its whole leaves in
    ``res["whole_<kind>_digest"]`` to show they are the same on all."""
    import torch.distributed as tdist
    whole = []
    for (n, _), t in zip(_paths(tree), leaves):
        held = n in res["held"]
        if logical or held or tdist.get_rank() == 0:
            arrays[f"{kind}/{n}"] = t.detach().float().cpu().numpy()
        if not held:
            whole.append(_digest(t))
    if not logical:
        res[f"whole_{kind}_digest"] = whole


def run_lm(job, device, *, logical: bool = False) -> tuple:
    """One ``lm`` job on a process mesh (``logical`` False: this process
    is one rank of a fleet) or a logical mesh: (result dict, arrays)."""
    import torch

    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import default_rules, sharding_ctx
    from repro_torch.kernels import runtime
    from repro_torch.models import lm_zoo as Z
    from repro_torch.models import moe as MoE
    from repro_torch.models import transformer_lm as T
    from repro_torch.train.optimizer import (Optimizer, tree_leaves,
                                             tree_unflatten)

    cfg = arch_config(job)
    mesh = _mesh(job, device, logical)
    res: Dict[str, Any] = {"mode": job["mode"], "device": str(device)}
    arrays: Dict[str, np.ndarray] = {}
    f32 = lambda t: t.detach().float().cpu().numpy()
    with _patched(job), sharding_ctx(mesh, default_rules()):
        t0 = time.perf_counter()
        tree = _tree(job, cfg, device, mesh, logical)
        _sync(device)
        res["init_s"] = time.perf_counter() - t0
        prefix = ("moe",) if job["mode"] == "moe" else ()
        res["held"] = {} if logical else {
            n: list(t.shape) for n, t in _paths(tree)
            if spmd._expert_split(prefix + tuple(n.split("/")), t.ndim,
                                  mesh, default_rules())}
        batch = None if job["mode"] == "moe" else _batch(job, cfg, device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        if job["mode"] == "moe":
            x = torch.from_numpy(np.load(job["x"])).to(device)
            leaves = [p.requires_grad_() for p in tree_leaves(tree)]
            x.requires_grad_()
            y, aux = MoE.moe_apply(tree, x, cfg.moe, cfg.act)
            grads = torch.autograd.grad((y ** 2).sum(), leaves + [x])
            arrays["y"] = f32(y)
            for k, v in aux.items():
                arrays[k] = f32(v)
            for (n, _), g in zip(_paths(tree), grads):
                arrays[f"grad/{n}"] = f32(g)
            arrays["grad/x"] = f32(grads[-1])
        elif job["mode"] == "prefill":
            prefill = Z.make_prefill_step(cfg)
            warm = max(4, batch["tokens"].shape[1] // 64 * 4)
            with torch.no_grad():               # a short warm-up prefill
                prefill(tree, {k: v[:, :warm] for k, v in batch.items()})
            _sync(device)
            seen = []
            real = Z.forward_hidden

            def hidden(*a, **kw):               # the prefill's own pass
                seen.append(real(*a, **kw))
                return seen[-1]
            Z.forward_hidden = hidden
            spmd.reset_record()
            runtime.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                with torch.no_grad(), routing() as picked:
                    logits, _ = prefill(tree, batch)
                _sync(device)
            finally:
                Z.forward_hidden = real
            res["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            res["launches"] = _counts()
            res["record"] = spmd.record()
            h, aux, _ = seen.pop()
            res["aux"] = {k: float(v) for k, v in aux.items()}
            if job.get("save_hidden", True):
                arrays["hidden"] = f32(h)
            arrays["logits"] = f32(logits)
            del h, seen
            _save_experts(arrays, "experts", picked)
        elif job["mode"] == "grads":            # the forward's hidden first
            B, S = batch["tokens"].shape
            with torch.no_grad(), routing() as picked:
                x = Z.embed_input(cfg, Z._cast_compute(tree), batch)
                pos = torch.arange(S, device=device)[None].expand(B, S)
                arrays["hidden"] = f32(T.forward_hidden(
                    cfg, Z._cast_compute(tree), x, pos)[0])
            _save_experts(arrays, "hidden_experts", picked)
            del x
            leaves = [p.detach().requires_grad_() for p in tree_leaves(tree)]
            spmd.reset_record()
            runtime.reset_launch_counts()
            t0 = time.perf_counter()
            with routing() as picked:
                loss, m = Z.make_loss_fn(cfg)(tree_unflatten(tree, leaves),
                                              batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            _sync(device)
            res.update(step_ms=(time.perf_counter() - t0) * 1e3,
                       launches=_counts(), record=spmd.record(),
                       metrics={k: float(v.detach()) for k, v in m.items()})
            del leaves
            _save_leaves("grad", res, arrays, tree, grads, logical)
            _save_experts(arrays, "experts", picked)
        else:                                           # train
            opt_cfg = job.get("optimizer", {})
            base = Z.make_optimizer(
                dataclasses.replace(cfg, optimizer=opt_cfg.get(
                    "name", cfg.optimizer)),
                **{k: v for k, v in opt_cfg.items() if k != "name"})
            captured: list = []        # the first step's gradients

            def update(grads, state, params):
                captured.append(grads if not captured else None)
                return base.update(grads, state, params)
            opt = Optimizer(init=base.init, update=update)
            step = Z.make_train_step(cfg, opt)
            box = {"state": {"params": tree, "opt": opt.init(tree)}}
            del tree
            losses, walls, launches, records = [], [], [], []
            for i in range(job.get("steps", 1)):
                spmd.reset_record()
                runtime.reset_launch_counts()
                t0 = time.perf_counter()
                with routing() as picked:
                    box["state"], m = step(box["state"], batch)
                _sync(device)
                walls.append((time.perf_counter() - t0) * 1e3)
                launches.append(_counts())
                records.append(spmd.record())
                losses.append(float(m["loss"]))
                if i == 0:              # the step's gradients and update
                    new = box["state"]["params"]
                    res["metrics"] = {k: float(v) for k, v in m.items()}
                    _save_leaves("grad", res, arrays, new,
                                 tree_leaves(captured[0]), logical)
                    _save_leaves("param", res, arrays, new,
                                 tree_leaves(new), logical)
                    _save_experts(arrays, "experts", picked)
                    captured[0] = None
            res.update(losses=losses, step_ms=walls, launches=launches,
                       records=records)
        res["peak_bytes"] = _peak(device)
    return res, arrays


def _collective_case(case, mesh):
    """One case of the ``collectives`` job on ``mesh``: (result dict,
    arrays)."""
    import torch

    from repro_torch.dist import sharding as S
    P = S.P
    name = case["name"]
    if case["kind"] == "axis_index":
        names = case["names"]

        def body(a):
            return torch.full((1, 1), S.axis_index(names),
                              dtype=torch.int32)
        x = torch.zeros(tuple(mesh.axis_sizes))
        out = S.shard_map(body, mesh=mesh, in_specs=(P("data", "model"),),
                          out_specs=P("data", "model"))(x)
        return {}, {name: out.numpy()}
    if case["kind"] == "autograd":
        x, w = (torch.from_numpy(autograd_inputs()[k]) for k in "xw")
        x.requires_grad_()

        def body(a, wl):
            full = yield S.all_gather(a, "model", axis=1, tiled=True)
            s = (full * full.sum(1, keepdim=True)).sum() * wl.sum()
            m = yield S.pmean(s, ("data", "model"))
            return m
        out = S.shard_map(body, mesh=mesh,
                          in_specs=(P("data", "model"), P("data", "model")),
                          out_specs=P())(x, w)
        gx, = torch.autograd.grad(out, x)
        return {}, {name: out.detach().numpy(), name + "/grad": gx.numpy()}
    if case["kind"] == "mismatch":
        def mixed(a):
            if S.axis_index("model") == 1:
                r = yield S.pmean(a, "model")
            else:
                r = yield S.all_gather(a, "model")
            return r
        try:
            S.shard_map(mixed, mesh=mesh, in_specs=(P("data", "model"),),
                        out_specs=P("data", "model"))(torch.zeros(4, 4))
        except RuntimeError as e:
            return {"error": str(e)}, {}
        return {"error": None}, {}
    kind, names, kw = case["kind"], case["names"], case["kw"]
    x = torch.from_numpy(collective_input(case["shape"]))

    def body(a):
        if kind == "pmean":
            r = yield S.pmean(a, names)
        elif kind == "all_gather":
            r = yield S.all_gather(a, names, **kw)
        else:
            r = yield S.all_to_all(a, names, kw["split_axis"],
                                   kw["concat_axis"], tiled=kw["tiled"])
        return r[None, None]
    out = S.shard_map(body, mesh=mesh, in_specs=(P("data", "model", None),),
                      out_specs=P("data", "model"))(x)
    return {}, {name: out.numpy()}


def collective_input(shape) -> np.ndarray:
    """The ``collectives`` job's input: small integers, so every sum is
    exact."""
    return (np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
            % 97)


def autograd_inputs() -> Dict[str, np.ndarray]:
    """x and w of the autograd case: small integers (every sum exact)."""
    return {"x": (np.arange(32, dtype=np.float32).reshape(4, 8) % 7) - 3,
            "w": (np.arange(32, dtype=np.float32).reshape(4, 8) * 3 % 5)
            - 2}


def run_collectives(job, device, *, logical: bool = False) -> tuple:
    from repro_torch.dist.sharding import default_rules, sharding_ctx
    mesh = _mesh(job, device, logical)
    res: Dict[str, Any] = {}
    arrays: Dict[str, np.ndarray] = {}
    with sharding_ctx(mesh, default_rules()):
        for case in job["cases"]:
            r, a = _collective_case(case, mesh)
            res[case["name"]] = r
            arrays.update(a)
    return res, arrays


def run_job(job, device, *, logical: bool = False) -> tuple:
    """(result dict, arrays) of one job, on a process mesh (this process
    a rank of a fleet) or, ``logical``, on a logical mesh in this
    process."""
    import torch
    device = torch.device(device)
    if job["job"] == "collectives":
        return run_collectives(job, device, logical=logical)
    return run_lm(job, device, logical=logical)


def rows_of(whole: np.ndarray, block_shape, index: int) -> np.ndarray:
    """Block ``index`` of ``whole`` cut as ``hold_blocks`` cuts a leaf
    into blocks of ``block_shape`` (along the one dim they differ in)."""
    dims = [d for d, (a, b) in enumerate(zip(whole.shape, block_shape))
            if a != b]
    if not dims:
        return whole
    d, size = dims[0], block_shape[dims[0]]
    return np.take(whole, range(index * size, (index + 1) * size), axis=d)


def differing(res: Dict, got, want: Dict[str, np.ndarray], rank: int,
              mesh_shape) -> List[str]:
    """The arrays of rank ``rank``'s job (``got``, its ``.npz``) that
    differ, bit for bit, from the logical mesh's (``want``): a held
    leaf's gradient against its block of the logical one (the rank's
    ``model`` coordinate), the experts of its i-th routing against the
    logical mesh's routing i * size + rank (the logical executor routes
    every shard of a layer in turn).  The updated parameters are left
    out: a held block's update adds the blocks' partial sums of a whole
    leaf, which the logical update adds in another order."""
    size, block = int(np.prod(mesh_shape)), rank % mesh_shape[1]
    bad = []
    routed = ("experts/", "hidden_experts/")
    for k in got.files:
        if k.startswith(routed):
            head, i = k.rsplit("/", 1)
            w = want.get(f"{head}/{int(i) * size + rank}")
            if w is None or not np.array_equal(got[k], w):
                bad.append(k)
    for k, w in want.items():
        if k.startswith(routed + ("param/",)):
            continue
        if k not in got.files:
            if k.startswith("grad/") and rank != 0 and \
                    k[len("grad/"):] not in res.get("held", {}):
                continue           # a whole leaf: saved by rank 0 only
            bad.append(k)
            continue
        g = got[k]
        leaf = k.split("/", 1)[-1]
        if leaf in res.get("held", {}):
            w = rows_of(w, g.shape, block)
        if g.shape != w.shape or not np.array_equal(g, w):
            bad.append(k)
    return bad


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------


def worker_main(run_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Join the fleet, run its jobs, print the MH_RESULT line."""
    import torch
    import torch.distributed as tdist

    spec = multihost.MultihostSpec.from_env()
    tdist.init_process_group(
        "gloo", init_method=f"tcp://{spec.coordinator}",
        rank=spec.process_id, world_size=spec.n_processes,
        timeout=datetime.timedelta(seconds=run_cfg["group_timeout_s"]))
    device = torch.device("cpu") if spec.device == "cpu" else \
        spec.torch_device()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    out = {"process_id": spec.process_id, "device": str(device),
           "jobs": []}
    for job in run_cfg["jobs"]:
        t0 = time.perf_counter()
        res, arrays = run_job(job, device)
        if device.type == "cuda":      # the card is shared: give back
            torch.cuda.empty_cache()   # what this job's cache holds
        if arrays:
            path = Path(job["dir"]) / f"{job['name']}_r{spec.process_id}.npz"
            np.savez(path, **arrays)
            res["file"] = str(path)
        res["name"] = job["name"]
        res["wall_s"] = time.perf_counter() - t0
        out["jobs"].append(res)
        log.info(f"rank {spec.process_id} ({device}): {job['name']} in "
                 f"{res['wall_s']:.1f} s" + (
                     f", peak {res['peak_bytes'] / 1e9:.2f} GB"
                     if res.get("peak_bytes") else ""))
    print(multihost.RESULT_TAG + json.dumps(out), flush=True)
    tdist.barrier()
    tdist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# CLI: a small fleet against the logical mesh
# ---------------------------------------------------------------------------

# the CLI's fleet: the mesh, arch and batch of the process mesh's tests
CLI_MESH, CLI_ARCH, CLI_BATCH = (1, 4), "qwen3-moe-235b-a22b", (2, 16)


def main(argv: Optional[Sequence[str]] = None) -> int:
    if os.environ.get(multihost._ENV["role"]) == "worker":
        worker_main(json.loads(os.environ[multihost._ENV["run_cfg"]]))
        return 0
    ap = argparse.ArgumentParser(
        description="run a reduced LM's prefill and train step as a fleet "
                    "of one process a mesh shard and hold every rank to "
                    "the logical mesh, bit for bit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--blocked", action="store_true",
                    help="lower the score budget: CP attention blocked")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.models import lm_zoo as Z
    n = CLI_MESH[0] * CLI_MESH[1]
    threads = "1"
    with tempfile.TemporaryDirectory() as tmp:
        base = {"job": "lm", "mesh": list(CLI_MESH), "arch": CLI_ARCH,
                "reduced": True, "compute": "float32", "dir": tmp,
                "cp_score_limit": 1.0 if args.blocked else None,
                "params": {"file": os.path.join(tmp, "params.pt")},
                "batch": {"seed": 0, "B": CLI_BATCH[0], "S": CLI_BATCH[1]}}
        cfg = arch_config(base)
        torch.save(Z.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu"), base["params"]["file"])
        jobs = [dict(base, name="prefill", mode="prefill"),
                dict(base, name="train", mode="train", steps=1)]
        results = launch(jobs, n, device=args.device, timeout_s=600.0,
                         extra_env={"OMP_NUM_THREADS": threads})
        torch.set_num_threads(int(threads))
        dev = "cpu" if args.device == "cpu" else "cuda"
        bad = 0
        for job in jobs:
            ref, want = run_job(job, dev, logical=True)
            for r in results:
                res = next(j for j in r["jobs"] if j["name"] == job["name"])
                diff = differing(res, np.load(res["file"]), want,
                                 r["process_id"], CLI_MESH)
                bad += len(diff)
                line = (f"rank {r['process_id']} {job['name']}: "
                        f"{len(want)} arrays, {len(diff)} differ from the "
                        f"logical mesh")
                if job["mode"] == "train":
                    line += (f"; loss {res['losses'][0]:.6f} (logical "
                             f"{ref['losses'][0]:.6f}), held "
                             f"{res['held']}")
                else:
                    line += f"; moe_drop_frac {res['aux']['moe_drop_frac']}"
                log.info(line + (f": {diff[:4]}" if diff else ""))
    if bad:
        log.error(f"{bad} arrays differ from the logical mesh")
        return 1
    log.info(f"OK: {n} ranks equal the logical mesh bit for bit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
