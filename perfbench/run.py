"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Finds the cell in ``BENCHMARK.json``, its configuration, traffic mix and
per-layer metrics by name under ``perfbench/``, drives ``repro_torch`` on
the card, checks what the timed path produced against the plain
reference, and prints one JSON line last: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number and its limit.
Exits non-zero with no result line when no card (or too few) is found,
when the program is missing, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench.bench import spec

    bench = spec.load_benchmark()
    w = {c["name"]: c for c in bench["workloads"]}.get(args.workload)
    if w is None:
        return fail(f"no workload {args.workload!r} in BENCHMARK.json")
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs only on the card")
    torch.cuda.init()
    if torch.cuda.device_count() < w["chips"]:
        return fail(f"{w['chips']} cards wanted, "
                    f"{torch.cuda.device_count()} found")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the program (repro_torch) is not in this checkout: {e}")
    cuda_s = time.time() - T_START
    result = execute(spec.cell(args.workload, bench), args, "cuda")
    result.setdefault("notes", {}).setdefault("setup_marks", {})[
        "torch_and_cuda"] = cuda_s
    found = forbidden_modules()
    if found:
        return fail(f"modules of JAX or the JAX package loaded: {found}")
    lines = emit(result, args)
    for line in lines["stderr"]:
        print(line, file=sys.stderr, flush=True)
    print(lines["stdout"], flush=True)
    return 0


def execute(cell, args, device) -> dict:
    """Drive the cell's traffic (``bench.<kind>.run``) and read its
    per-layer metrics from the trace."""
    import importlib

    from perfbench.bench import spec

    kind = cell.traffic["kind"]
    traffic = importlib.import_module(f"perfbench.bench.{kind}")
    result = traffic.run(cell, args.seed, args.seconds, bool(args.trace),
                        device, T_START)
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(result["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(result["e2e"], setup_s=result["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    return result


def is_correct(result: dict) -> bool:
    """Every request or step finished, and every compared number within
    its limit."""
    return (result["failed"] == 0 and result["attempted"] > 0
            and all(v <= lim for v, lim in result["checks"].values()))


def emit(result: dict, args) -> dict:
    import torch

    from perfbench.bench.common import check_lines

    checks = result["checks"]
    correct = is_correct(result)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1, "memory_peak_bytes": result["memory_peak_bytes"],
              "power_limit_w": power_limit_w()}
    if args.trace:
        device["busy_s"] = result["busy_s"]
        device["window_s"] = result["window_s"]
    line = {"correct": correct, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": device, "notes": result.get("notes", {})}
    if args.trace:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return {"stdout": json.dumps(line), "stderr": check_lines(checks)}


if __name__ == "__main__":
    sys.exit(main())
