"""Dry run of every (arch x shape x mesh) cell: one device's memory and
roofline terms from a cost trace of the port's own step on the ``meta``
device (counterpart of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
    python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k --multi-pod
    python -m repro_torch.launch.dryrun --all --jobs 4          # subprocess batch
    ... [--rule seq_act=model] [--save-trace]                   # perf-pass knobs

No card is needed, as the JAX dry run needs no TPU: the step runs on
``meta`` tensors (shapes and dtypes, nothing allocated) under the
production mesh (``launch.mesh``; the port's logical mesh runs its
shards one after another) with JAX's rules and rule overrides, inside
``launch.op_cost.CostMode``, which charges every aten op and every
hand-written kernel call.  Each cell writes
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json`` with the
JAX dry run's keys where they mean the same thing (``"hlo"`` is
``"trace"``; XLA's own cost analysis has no counterpart).

Per-device accounting (also in each cell's JSON, ``"accounting"``):

* argument and output bytes are exact: each leaf's bytes over the
  product of the mesh axes in its sanitized spec (``named_shardings``),
  as XLA's ``memory_analysis`` counts them; the optimizer's step is a
  host int in the port (JAX's is a 4-byte device scalar);
* ops inside a ``shard_map`` body are charged per shard and the
  device's share is the largest shard's (context-parallel shards do
  unequal causal work, and the slowest sets the step); ops outside any
  body are charged global ÷ mesh size, an *ideal* split (the port has
  no partitioner to say what GSPMD would replicate);
* temp bytes are the trace's peak live bytes (the storages the step
  creates, outputs included, rounded to the allocator's 512 B) ÷ mesh
  size: the state and the batch exist before the step and are not in
  them, so ``hbm_frac`` is (argument + temp) bytes over the card's;
* collective bytes are what the ``shard_map`` executor recorded (the
  largest shard's) plus what the parameter specs imply for FSDP: each
  FSDP-sharded leaf all-gathered at each forward use (its result bytes
  a device, in its compute dtype; twice in a train step under block
  remat) and its gradient reduce-scattered once (operand bytes);
  tensor-parallel activation all-reduces are not modeled (the port has
  no tensor-parallel execution) and are listed under ``"unmodeled"``;
* ``collective_s`` takes NVLink's rate for a collective over the
  innermost mesh axis when it spans at most 8 cards (one host) and
  InfiniBand's for every other.

JAX's per-chip numbers include GSPMD's replication, so the two dry runs'
numbers differ by design.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

ACCOUNTING = {
    "arguments": "exact: each leaf's bytes / the product of the mesh axes "
                 "in its sanitized spec; the optimizer step is a host int",
    "outputs": "exact, as the arguments; alias_bytes are outputs that are "
               "argument storages written in place",
    "inside_shard_map": "per shard; the device's share is the largest "
                        "shard's (a kernel's backward with its forward's "
                        "shard)",
    "outside_shard_map": "ideal: global / mesh size",
    "temp": "the trace's peak live bytes (storages the step creates, "
            "outputs included, 512 B rounding) / mesh size; hbm_frac = "
            "(argument + temp) / hbm_bytes",
    "collectives": "the shard_map executor's (largest shard) + FSDP: each "
                   "fsdp-sharded leaf all-gathered at each forward use "
                   "(twice under block remat), its gradient "
                   "reduce-scattered once",
    "collective_s": "nvlink_bw over the innermost axis of size <= 8, "
                    "ib_bw otherwise",
}
UNMODELED = [
    "tensor-parallel activation all-reduces (the port has no "
    "tensor-parallel execution)",
    "the backward of a shard_map body's collectives (an all-gather's "
    "reduce-scatter, the all-to-all's return): the logical mesh computes "
    "them as adds and views, charged as HBM bytes outside the body",
    "kernel time beyond the kernels' formulas (PERF.md's bound "
    "conventions); fusion and overlap of any kind",
]


def _cell_json(arch: str, shape: str, mesh_kind: str, tag: str) -> Path:
    suffix = f"__{tag}" if tag else ""
    return ARTIFACTS / f"{arch}__{shape}__{mesh_kind}{suffix}.json"


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS + parameter accounting
# ---------------------------------------------------------------------------


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, path + (str(k),))
    else:
        yield path, tree


def count_params(cfg) -> Tuple[int, int]:
    """(total, active) parameter counts from the param spec tree."""
    from repro_torch.models.lm_zoo import param_specs

    total = active = 0
    for path, leaf in _leaves_with_paths(param_specs(cfg)):
        n = leaf.numel()
        total += n
        if cfg.moe is not None and re.search(
                r"w_(gate|up|down)$", "/".join(path)) \
                and leaf.dim() == 4:  # stacked experts (L, E, in, out)
            active += n * cfg.moe.top_k // cfg.moe.num_experts
        else:
            active += n
    return total, active


def model_flops(cfg, shape) -> float:
    """Assignment formula: 6*N*D train (N=active for MoE), 2*N*D inference."""
    _, active = count_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active * tokens


# ---------------------------------------------------------------------------
# Sharding assembly for step inputs/outputs
# ---------------------------------------------------------------------------


def _dp_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def _axis_size(mesh, names) -> int:
    sizes = mesh.shape
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    n = 1
    for a in names:
        n *= sizes.get(a, 1)
    return n


def batch_specs(cfg, shape, mesh, multi_pod: bool):
    """Partition specs for the input batch dict."""
    from repro_torch.dist.sharding import P
    dp = _dp_axes(multi_pod)
    B = shape.global_batch
    dp = dp if B % _axis_size(mesh, dp) == 0 else None
    tok = P(dp, None)
    if cfg.input_kind == "tokens":
        return {"tokens": tok}
    out = {"frames": P(dp, None, None)}
    if shape.kind == "train":
        out["labels"] = tok
        out["mask"] = tok
    return out


def decode_state_specs_tree(cfg, state_specs, mesh, multi_pod: bool):
    """The decode state's spec tree (the JAX module's layout rules)."""
    from repro_torch.dist.sharding import P, _tree_map
    dp = _dp_axes(multi_pod)
    tp = "model"
    tp_n = _axis_size(mesh, tp)

    def one(path, leaf):
        name = path[-1] if path else ""
        shp = leaf.shape
        nd = len(shp)

        def dpx(dim):
            return dp if shp[dim] % _axis_size(mesh, dp) == 0 else None

        def tpx(dim):
            return tp if shp[dim] % tp_n == 0 else None

        if name == "pos":
            return P()
        if name in ("k", "v"):           # (..., B, S, H, D)
            # Prefer head sharding; when GQA kv-heads don't divide TP,
            # shard the context dim instead (flash-decoding split-KV).
            if shp[nd - 2] % tp_n == 0:
                return P(*([None] * (nd - 4) + [dpx(nd - 4), None,
                                                tp, None]))
            return P(*([None] * (nd - 4) + [dpx(nd - 4), tpx(nd - 3),
                                            None, None]))
        if name == "conv":               # (..., B, K-1, C)
            return P(*([None] * (nd - 3) + [dpx(nd - 3), None,
                                            tpx(nd - 1)]))
        if name == "h":
            if cfg.ssm is not None and cfg.ssm.version == 2:
                #  (..., B, H, N, P)
                return P(*([None] * (nd - 4) + [dpx(nd - 4), tpx(nd - 3),
                                                None, None]))
            #  (..., B, Din, N)
            return P(*([None] * (nd - 3) + [dpx(nd - 3), tpx(nd - 2),
                                            None]))
        return P()

    return _tree_map(one, state_specs)


def optimizer_state_specs(cfg, opt_shapes, pspecs):
    """Mirror parameter specs onto optimizer state (AdamW / Adafactor)."""
    from repro_torch.dist.sharding import P
    from repro_torch.train.optimizer import AdamWState

    def pad(spec, ndim):
        return tuple(spec) + (None,) * (ndim - len(tuple(spec)))

    if cfg.optimizer == "adamw":
        return AdamWState(step=P(), mu=pspecs, nu=pspecs)

    # adafactor: factored leaves are (row, col) tuples
    def walk(spec, shape_leaf):
        if isinstance(spec, dict):
            return {k: walk(spec[k], shape_leaf[k]) for k in spec}
        if isinstance(shape_leaf, tuple):  # (row, col) pair
            row, _ = shape_leaf
            t = pad(spec, row.dim() + 1)
            return (P(*t[:-1]), P(*(t[:-2] + (t[-1],))))
        return spec

    return AdamWState(step=P(), mu=walk(pspecs, opt_shapes.mu), nu=None)


def _spec_pairs(tree, specs):
    """(tensor, its spec) for every tensor of ``tree`` laid out by
    ``specs``, a prefix tree of ``P`` (a None spec holds nothing)."""
    from repro_torch.dist.sharding import P
    from repro_torch.launch.op_cost import tensors
    if specs is None or tree is None:
        return
    if isinstance(specs, P):
        for t in tensors(tree):
            yield t, specs
    elif isinstance(specs, dict):
        for k, s in specs.items():
            yield from _spec_pairs(tree[k], s)
    else:
        for t, s in zip(tree, specs):
            yield from _spec_pairs(t, s)


def per_device_bytes(mesh, pairs) -> int:
    """One device's bytes of (tensor, spec) ``pairs``: each tensor's
    bytes over the product of the mesh axes in its spec."""
    from repro_torch.dist.sharding import _names
    return sum(t.numel() * t.element_size()
               // math.prod(mesh.shape[a] for e in spec for a in _names(e))
               for t, spec in pairs)


def fsdp_collectives(cfg, params, pspecs, mesh, kind: str) -> Dict:
    """(kind, mesh axes) -> one device's on-wire bytes that the parameter
    specs imply for FSDP: each leaf sharded on an fsdp axis all-gathered
    at each forward use (result bytes, compute dtype; twice a train step
    under block remat) and, in a train step, its gradient
    reduce-scattered once (operand bytes)."""
    from repro_torch.dist.sharding import (_FSDP_AXES, _logical_param_axes,
                                           _names)
    from repro_torch.models.lm_zoo import _FP32_KEEP

    uses = 2 if kind == "train" and cfg.remat != "none" else 1
    out: Dict[tuple, float] = {}
    specs = dict(_leaves_with_paths(pspecs))
    for path, leaf in _leaves_with_paths(params):
        spec = specs[path]
        logical = _logical_param_axes(path, leaf.dim())
        group, other = (), 1
        for lg, entry in zip(logical, spec):
            if lg in _FSDP_AXES:
                group += _names(entry)
            else:
                other *= math.prod(mesh.shape[a] for a in _names(entry))
        if math.prod(mesh.shape[a] for a in group) == 1:
            continue          # no fsdp axis, or one of one shard
        size = 4 if path[-1] in _FP32_KEEP else 2
        full = leaf.numel() * size / other
        for op, n in (("all_gather", uses),
                      ("reduce_scatter", 1 if kind == "train" else 0)):
            if n:
                out[(op, group)] = out.get((op, group), 0.0) + n * full
    return out


def _link(mesh, group) -> str:
    inner = mesh.axis_names[-1]
    return ("nvlink" if tuple(group) == (inner,)
            and mesh.shape[inner] <= 8 else "ib")


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rule_overrides: Dict[str, Any], save_trace: bool,
             tag: str = "", *, cfg=None, shape=None,
             mesh_shape: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
    """Trace one cell.  ``cfg``, ``shape`` and ``mesh_shape`` (a (data,
    model) mesh in place of the production one) take the place of the
    named arch, shape and mesh: a cut of a config, or the one-card mesh
    the card's measured steps run on."""
    import dataclasses

    import torch

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.dist.sharding import (P, default_rules, named_shardings,
                                           param_partition_specs,
                                           sharding_ctx)
    from repro_torch.launch import op_cost
    from repro_torch.launch.mesh import HW, Mesh, make_production_mesh
    from repro_torch.models import lm_zoo

    cfg = cfg or get_arch(arch)
    shape = shape or SHAPES[shape_name]
    meta = torch.device("meta")
    if mesh_shape is not None:
        mesh = Mesh(("data", "model"), tuple(mesh_shape), meta)
        mesh_kind = "x".join(map(str, mesh_shape))
    else:
        mesh = dataclasses.replace(make_production_mesh(multi_pod=multi_pod),
                                   device=meta)
        mesh_kind = "multi" if multi_pod else "single"
    n_chips = mesh.size

    rules = default_rules(multi_pod=multi_pod)
    if cfg.family in ("ssm", "hybrid") and shape.kind == "train":
        # mamba blocks are channel/head-separable: TP over d_inner/heads is
        # fully local; sequence-CP would shard the scan's time axis.
        rules = rules.override(seq_act=None, tp="model", fsdp=("data",))
    if shape.kind != "train":
        # Inference topology: pure TP within each data-replica group
        # (weights replicated across 'data', sharded over 'model').
        rules = rules.override(fsdp=None, embed_fsdp=None, tp="model",
                               seq_act=None, vocab="model")
    if rule_overrides:
        fixed = {}
        for k, v in rule_overrides.items():
            if v in ("None", ""):
                fixed[k] = None
            elif "," in v:
                fixed[k] = tuple(v.split(","))
            else:
                fixed[k] = v
        rules = rules.override(**fixed)

    res: Dict[str, Any] = {
        "arch": cfg.name if arch is None else arch, "shape": shape.name,
        "mesh": mesh_kind, "chips": n_chips, "kind": shape.kind, "tag": tag,
        "rules": {k: v for k, v in rules.table.items()},
    }

    t0 = time.time()
    with sharding_ctx(mesh, rules):
        params = lm_zoo.param_specs(cfg)
        pspecs = param_partition_specs(params, rules)
        bspecs = batch_specs(cfg, shape, mesh, multi_pod)
        specs_in = lm_zoo.input_specs(cfg, shape)
        dp = _dp_axes(multi_pod)
        dpv = dp if shape.global_batch % _axis_size(mesh, dp) == 0 else None
        vocab_ax = (rules.table.get("vocab")
                    if cfg.vocab % _axis_size(
                        mesh, rules.table.get("vocab")) == 0 else None)
        if shape.kind == "train":
            optimizer = lm_zoo.make_optimizer(cfg)
            state = {"params": params, "opt": optimizer.init(params)}
            ospecs = optimizer_state_specs(cfg, state["opt"], pspecs)
            in_specs = ({"params": pspecs, "opt": ospecs}, bspecs)
            step = lm_zoo.make_train_step(cfg, optimizer)
            args = (state, specs_in["batch"])
        elif shape.kind == "prefill":
            args = (lm_zoo.param_specs(cfg, dtype=torch.bfloat16),
                    specs_in["batch"])
            in_specs = (pspecs, bspecs)
            step = lm_zoo.make_prefill_step(cfg)
        else:  # decode
            if cfg.is_encoder:
                raise ValueError("decode shape on encoder arch")
            dstate_specs = decode_state_specs_tree(
                cfg, specs_in["dstate"], mesh, multi_pod)
            in_specs = (pspecs, dstate_specs, P(dpv, None))
            args = (lm_zoo.param_specs(cfg, dtype=torch.bfloat16),
                    specs_in["dstate"], specs_in["tokens"])
            step = lm_zoo.make_serve_step(cfg)
        del params
        arg_ids = {t.untyped_storage()._cdata
                   for t in op_cost.tensors(args)}

        with op_cost.CostMode(devices=n_chips) as trace:
            out = step(*args)
        res["trace_s"] = round(time.time() - t0, 2)

        if shape.kind == "train":
            out_specs = (in_specs[0], {k: P() for k in out[1]})
        elif cfg.is_encoder:
            out_specs = (P(dpv, None, vocab_ax), P())
        elif shape.kind == "prefill":
            out_specs = (P(dpv, vocab_ax), decode_state_specs_tree(
                cfg, out[1], mesh, multi_pod))
        else:
            out_specs = (P(dpv, vocab_ax), dstate_specs)
        in_sh = named_shardings(mesh, in_specs)
        out_sh = named_shardings(mesh, out_specs)
        outs = list(_spec_pairs(out, out_sh))

    # ---- memory (per device) ----
    arg_b = per_device_bytes(mesh, _spec_pairs(args, in_sh))
    out_b = per_device_bytes(mesh, outs)
    alias_b = per_device_bytes(mesh, [
        (t, spec) for t, spec in outs
        if t.untyped_storage()._cdata in arg_ids])
    cost = trace.total_cost()
    temp_b = cost["peak_live_bytes"] / n_chips
    res["memory"] = {
        "argument_bytes": arg_b,
        "output_bytes": out_b,
        "temp_bytes": temp_b,
        "alias_bytes": alias_b,
        "hbm_frac": (arg_b + temp_b) / HW["hbm_bytes"],
    }

    # ---- the trace's cost (per device) ----
    groups = dict(trace.collective_groups())
    for key, b in fsdp_collectives(cfg, args[0]["params"] if shape.kind
                                   == "train" else args[0], pspecs, mesh,
                                   shape.kind).items():
        groups[key] = groups.get(key, 0.0) + b
    by_link = {"nvlink": 0.0, "ib": 0.0}
    for (_, group), b in groups.items():
        by_link[_link(mesh, group)] += b
    cost["collective_bytes"] = float(sum(by_link.values()))
    res["trace"] = {**cost, "kernel_calls": dict(trace.kernel_calls),
                    "collective_bytes_by_link": by_link}
    res["top_collectives"] = sorted(
        ({"op": kind, "axes": list(group), "bytes": b,
          "link": _link(mesh, group)}
         for (kind, group), b in groups.items()),
        key=lambda d: -d["bytes"])[:12]
    if save_trace:
        _cell_json(res["arch"], shape.name, mesh_kind, tag).with_suffix(
            ".top_ops.json").write_text(json.dumps(trace.top_ops(),
                                                   indent=2))

    # ---- roofline terms ----
    compute_s = cost["flops"] / HW["peak_flops_bf16"]
    memory_s = cost["bytes"] / HW["hbm_bw"]
    collective_s = (by_link["nvlink"] / HW["nvlink_bw"]
                    + by_link["ib"] / HW["ib_bw"])
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    total_p, active_p = count_params(cfg)
    res.update({
        "roofline": terms,
        "dominant": dominant,
        "model_flops_global": mf,
        "trace_flops_global": cost["flops"] * n_chips,
        "model_to_trace_flops": mf / max(cost["flops"] * n_chips, 1.0),
        "params_total": total_p,
        "params_active": active_p,
        "step_time_bound_s": max(terms.values()),
        "roofline_frac": (mf / n_chips / HW["peak_flops_bf16"])
        / max(max(terms.values()), 1e-30),
        "accounting": ACCOUNTING,
        "unmodeled": UNMODELED,
        "ok": True,
    })
    return res


# ---------------------------------------------------------------------------
# CLI / batch runner
# ---------------------------------------------------------------------------


def _run_batch(jobs: int, multi_pod_only: Optional[bool], save_trace: bool,
               archs: Optional[list] = None) -> None:
    from repro_torch.configs import dryrun_cells
    cells = []
    for cfg, shape in dryrun_cells():
        if archs and cfg.name not in archs:
            continue
        for mp in ([False, True] if multi_pod_only is None
                   else [multi_pod_only]):
            out = _cell_json(cfg.name, shape.name,
                             "multi" if mp else "single", "")
            if out.exists():
                try:
                    if json.loads(out.read_text()).get("ok"):
                        continue
                except (OSError, ValueError):
                    pass
            cells.append((cfg.name, shape.name, mp))
    print(f"[dryrun] {len(cells)} cells to run, jobs={jobs}")
    procs: list = []
    failed = 0
    for arch, shape, mp in cells:
        while len(procs) >= jobs:
            for p in procs[:]:
                if p.poll() is not None:
                    failed += p.returncode != 0
                    procs.remove(p)
            time.sleep(0.2)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape]
        if mp:
            cmd.append("--multi-pod")
        if save_trace:
            cmd.append("--save-trace")
        print("[dryrun] start", arch, shape, "multi" if mp else "single",
              flush=True)
        procs.append(subprocess.Popen(cmd))
    for p in procs:
        failed += p.wait() != 0
    print(f"[dryrun] batch done, {failed} failed")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", nargs="*", default=None)
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--rule", action="append", default=[],
                    help="logical=meshaxis override, e.g. seq_act=model")
    ap.add_argument("--save-trace", action="store_true",
                    help="also write the cell's top ops by bytes and FLOPs")
    ap.add_argument("--tag", default="", help="artifact suffix (perf runs)")
    args = ap.parse_args()

    ARTIFACTS.mkdir(parents=True, exist_ok=True)

    if args.all:
        _run_batch(args.jobs,
                   multi_pod_only=(False if args.single_pod_only else None),
                   save_trace=args.save_trace, archs=args.archs)
        return

    overrides = dict(r.split("=", 1) for r in args.rule)
    mesh_kind = "multi" if args.multi_pod else "single"
    out = _cell_json(args.arch, args.shape, mesh_kind, args.tag)
    try:
        res = run_cell(args.arch, args.shape, args.multi_pod, overrides,
                       args.save_trace, args.tag)
    except Exception as e:  # record failures as artifacts too
        import traceback
        res = {"arch": args.arch, "shape": args.shape, "mesh": mesh_kind,
               "tag": args.tag, "ok": False, "error": str(e),
               "traceback": traceback.format_exc()}
    out.write_text(json.dumps(res, indent=2, default=str))
    if res.get("ok"):
        print(summary(res))
    else:
        print(f"[dryrun] FAILED {args.arch} {args.shape} {mesh_kind}: "
              f"{res['error']}")
        sys.exit(1)


def summary(res: Dict[str, Any]) -> str:
    """The one line a cell prints."""
    t, m = res["roofline"], res["memory"]
    return (f"[dryrun] {res['arch']} {res['shape']} {res['mesh']}: "
            f"compute={t['compute_s']:.4f}s memory={t['memory_s']:.4f}s "
            f"collective={t['collective_s']:.4f}s "
            f"dominant={res['dominant']} "
            f"roofline_frac={res['roofline_frac']:.3f} "
            f"device={(m['argument_bytes'] + m['temp_bytes']) / 1e9:.2f}GB "
            f"(trace {res['trace_s']}s)")


if __name__ == "__main__":
    main()
