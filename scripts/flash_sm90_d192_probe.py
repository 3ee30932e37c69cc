"""The Hopper flash_attention forward at head dim 192 with key tiles of
other sizes, held against the plain version and timed in turns on the
card.

``csrc/flash_attention_sm90.cu`` takes its key tile at D 192 from one
constant, ``kBK192`` (112 in the shipped design, FlashAttention-3's
tile: two K/V stages beside the 128-row q tile); its ring takes as many
stages as fit (up to 3, so 3 at 64 keys).  This script builds a copy of
the source for each ``--bk`` with that constant replaced, into
``src/repro_torch/_build/variants/`` (git-ignored), prints what
``ptxas`` reports for the D 192 kernel of each (registers, spills,
serialized wgmma), checks each against the plain version at ragged,
causal, non-causal and offset shapes, and times each at Nemotron-4's
heads (96/8 of 192, causal) at the prefill shape (2, 4,096) and at (1,
520), in turns (a, b, ..., ..., b, a), beside the general instance and
one ``scaled_dot_product_attention``.  Device ms are the profiler's with
a cold L2 (``chip_smoke.device_ms``).  Prints one JSON line and writes
it to ``chiprun_out/flash_sm90_d192_probe.json``.

    python3 scripts/flash_sm90_d192_probe.py [--bk 112 64 96]
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                      # noqa: E402
import torch                                                 # noqa: E402
from repro_torch.kernels import runtime                      # noqa: E402
from repro_torch.kernels.flash_attention.ops import (        # noqa: E402
    flash_attention, instance)
from repro_torch.kernels.flash_attention.ref import (        # noqa: E402
    flash_attention_ref)

NAME = "flash_attention_sm90"
CONST = re.compile(r"constexpr int kBK192 = \d+;")
# (B, Sq, Skv, Hq, Hkv, causal, q_offset or None)
CHECKS = ((1, 70, 70, 12, 1, True, None), (1, 130, 130, 12, 1, False, None),
          (2, 520, 520, 96, 8, True, None), (1, 5, 70, 2, 1, True, None),
          (2, 100, 333, 4, 2, True, None), (1, 300, 1000, 4, 2, True, 0),
          (1, 300, 1000, 4, 2, True, 517), (1, 300, 1000, 4, 2, True, 2000),
          (1, 777, 777, 8, 2, False, None))
TIMED = ((2, 4096), (1, 520))


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def variant(bk: int) -> Path:
    """A directory with the sources, kBK192 set to ``bk``."""
    src = runtime.CSRC / f"{NAME}.cu"
    out = runtime.BUILD_DIR / "variants" / f"bk{bk}"
    out.mkdir(parents=True, exist_ok=True)
    for h in runtime.CSRC.glob("*.cuh"):
        shutil.copy(h, out / h.name)
    text, n = CONST.subn(f"constexpr int kBK192 = {bk};", src.read_text())
    if n != 1:
        raise RuntimeError(f"{src}: kBK192 not found once")
    (out / f"{NAME}.cu").write_text(text)
    return out


def ptxas_192(log: str) -> list:
    """The ptxas lines about the D 192 kernel instance."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            keep = "ILi192E" in line
        if keep or "ILi192E" in line:
            lines.append(line.strip())
    return lines


def inputs(B, Sq, Skv, Hq, Hkv, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(sh, generator=g, device="cuda").to(torch.bfloat16)
            for sh in ((B, Sq, Hq, 192), (B, Skv, Hkv, 192),
                       (B, Skv, Hkv, 192))]


def rows_close(got, want) -> float:
    """max |err| of a row over its max |want|; raises past the bf16 bars."""
    err = (got.float() - want.float()).abs().amax(-1)
    rel = float((err / want.float().abs().amax(-1).clamp_min(1e-30)).max())
    if rel > cs.ROW_REL_BF16 or float(err.max()) > cs.ATOL_BF16:
        raise AssertionError(f"row rel {rel}, max |err| {float(err.max())}")
    return rel


def check(designs) -> dict:
    """Each design against the plain version at CHECKS."""
    worst = {}
    for bk, ctx in designs:
        w = 0.0
        with ctx():
            for i, (B, Sq, Skv, Hq, Hkv, causal, off) in enumerate(CHECKS):
                q, k, v = inputs(B, Sq, Skv, Hq, Hkv, 100 + i)
                got = flash_attention(q, k, v, causal=causal, q_offset=off)
                want = flash_attention_ref(q, k, v, causal=causal,
                                           q_offset=off)
                torch.cuda.synchronize()
                w = max(w, rows_close(got, want))
        worst[bk] = w
        print(f"[probe] BK {bk}: every check within the bf16 bars (worst "
              f"row {w:.3g})", flush=True)
    return worst


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bk", type=int, nargs="+", default=[112, 64])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = smi()
    print(f"[probe] {card}", flush=True)
    assert instance(torch.bfloat16, 192) == "sm90"
    shipped = int(CONST.search((runtime.CSRC / f"{NAME}.cu").read_text())
                  .group(0).split("=")[1].strip(" ;"))
    dirs = {bk: (runtime.CSRC if bk == shipped else variant(bk))
            for bk in args.bk}
    report = {}
    for bk, d in dirs.items():
        logs = runtime.build([NAME], d)
        report[bk] = ptxas_192(logs[NAME])
        print(f"[probe] BK {bk} ptxas (D 192):\n  " + "\n  ".join(
            report[bk] or ["(cached: no report)"]), flush=True)
    q, k, v = inputs(1, 64, 64, 12, 1, 0)
    flash_attention(q, k, v, causal=True)         # load the shipped library

    def ctx_of(bk):
        return (lambda: runtime.sources_from(NAME, dirs[bk]))
    designs = [(bk, ctx_of(bk)) for bk in args.bk]
    worst = check(designs)

    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    F = torch.nn.functional
    out = {"device": card, "ptxas": report,
           "worst_row": worst, "shapes": {}}
    order = designs + designs[::-1]
    for B, S in TIMED:
        q, k, v = inputs(B, S, S, 96, 8, S)
        kern = lambda: flash_attention(q, k, v, causal=True)
        general = lambda: flash_attention(q, k, v, causal=True,
                                          _instance="general")
        ref = general()
        turns = []
        for bk, ctx in order:
            with ctx():
                rows_close(kern(), ref)
                ms, call = cs.timings(torch, kern, flush)
            turns.append({"bk": bk, "ms": ms, "call_ms": call})
        g_ms, g_call = cs.timings(torch, general, flush)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms, lib_call = cs.timings(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), flush)
        pairs = B * 96 * (S * S + S) / 2
        nbytes = 2 * (2 * q.numel() + 2 * k.numel())
        bound = cs.bound_ms(nbytes, 4.0 * 192 * pairs, cs.BF16_OPS_PER_S,
                            exps=pairs)
        shape = f"B={B} S={S} Hq=96 Hkv=8 D=192 bf16 causal"
        out["shapes"][shape] = dict(turns=turns, general_ms=g_ms,
                                    general_call_ms=g_call, sdpa_ms=lib_ms,
                                    sdpa_call_ms=lib_call, bound_ms=bound[0],
                                    bound_by=bound[1])
        print(f"[probe] {shape}: device ms / ms per call in turns "
              + "  ".join(f"BK{t['bk']} {t['ms']:.4f}/{t['call_ms']:.4f}"
                          for t in turns)
              + f"; general {g_ms:.4f}/{g_call:.4f}; SDPA {lib_ms:.4f}/"
            f"{lib_call:.4f}; bound {bound[0]:.4f} ({bound[1]})", flush=True)
        del q, k, v, qt, kt, vt, ref
        torch.cuda.empty_cache()
    line = json.dumps(out)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "flash_sm90_d192_probe.json").write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
