"""Readings that the limits of ``limits/<cell>.json`` are set from: the
control and the planted faults, at the cell's own size.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--seconds 12]

Training cells: for each seed, the plain reference's first steps against
the same reference computed with float8 (e4m3) operands (the control),
and against the reference with half of each batch left out (the mean
over the other half): the cell's numbers (``loss_gap``, ``grad_gap``,
``change_gap``) for each.  A step that returns its state unchanged
reads ``change_gap`` = 1 and needs no run.  With ``--masters``, in
their place, the program's own path in the precision below its float32
masters: the run's train step on bf16 parameters (the control of the
masters' precision), its numbers against the reference.  Chat cells: a short window
of the program at the cell's load (at least one whole cycle), then on
the run's own sample the program's ``logit_gap`` and the control's (the
gap of the token the float8 reference puts first at each position).
One JSON line a seed.  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--masters", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench.bench import chat, spec, train
    from perfbench.reference.model import Numerics

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    tr = cell.traffic
    for seed in args.seeds:
        t0 = time.time()
        if tr["kind"] == "train" and args.masters:
            low = copy.deepcopy(cell)
            low.config["port"]["master_dtype"] = "bfloat16"
            r = train.run(low, seed, args.seconds, False, "cuda", t0)
            line = {"seed": seed, "program_bf16_masters": dict(
                {k: v for k, (v, _) in r["checks"].items()},
                **r["notes"]["not_compared"]),
                "worst_leaves": r["notes"]["worst_leaves"]}
        elif tr["kind"] == "train":
            B, S, n = tr["batch"], tr["seq_len"], tr["check_steps"]
            ref = train.reference(cell.config, seed, B, S, n, "cuda")
            ctl = train.reference(cell.config, seed, B, S, n, "cuda",
                                  Numerics(fp8=True))
            half = train.reference(cell.config, seed, B, S, n, "cuda",
                                   rows=B // 2)
            line = {"seed": seed, "control": train.numbers(ctl, ref),
                    "half_batch": train.numbers(half, ref),
                    "state_unchanged": {"change_gap": 1.0}}
        else:
            r = chat.run(cell, seed, args.seconds, False, "cuda", t0,
                         control=True)
            line = {"seed": seed,
                    "program": {k: v for k, (v, _) in r["checks"].items()},
                    "control": {"logit_gap": r["notes"]["control_gap"]},
                    "e2e": r["e2e"], "notes": r["notes"]}
        line["seconds"] = time.time() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
