"""What the traffic modules share: synchronising, freeing the program's state,
the limits of the comparisons, and the gap measures they use."""
from __future__ import annotations

import gc
import json
import statistics
from typing import Dict, List

import torch

from perfbench.bench.spec import HERE


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def limits(cell: str) -> Dict[str, float]:
    """The cell's limits, ``limits/<cell>.json``: each compared number's
    name and the largest value a correct run may read."""
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())[
        "limits"]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the
    median leaf; over the leaves ``keep`` names (all by default)."""
    names = sorted(keep if keep is not None else ref)
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def token_gap(prog: torch.Tensor, ref: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Each token's gap between a layer's output on the program's side
    and the reference's, both (B, S, d) from the same input x: |prog -
    ref| over the larger of the reference's change of that token, |ref -
    x|, and the median token's.  Rows the program did not produce count
    as zeros.  Flat (B * S,), float32, a batch row at a time."""
    prog = prog.to(ref.device)
    if prog.shape[0] < ref.shape[0]:
        prog = torch.cat([prog, prog.new_zeros(
            (ref.shape[0] - prog.shape[0],) + tuple(prog.shape[1:]))])
    diff, move = [], []
    for p, r, x0 in zip(prog, ref, x):
        r = r.float()
        diff.append((p.float() - r).norm(dim=-1))
        move.append((r - x0.float()).norm(dim=-1))
    diff, move = torch.cat(diff), torch.cat(move)
    return diff / torch.clamp(move, min=max(float(move.median()), 1e-30))


def compared(numbers: Dict[str, float], lim: Dict[str, float]):
    """(the numbers the cell's limits name, each with its limit; the
    others, read but not compared)."""
    checks = {k: (numbers[k], v) for k, v in lim.items()}
    return checks, {k: v for k, v in numbers.items() if k not in lim}


def check_lines(checks: Dict[str, List[float]]) -> List[str]:
    return [f"check {k}: {v:.6g} (limit {lim:.6g})"
            for k, (v, lim) in checks.items()]
