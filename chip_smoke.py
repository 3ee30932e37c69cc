#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--events N] [--nodes N] [--ab DIR]...
                          [--ab-wide DIR]...

Phases, each fatal on failure (non-zero exit, no result line):

1. print the card's name and power limit (``nvidia-smi``) and build the
   CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
   in parallel);
2. ingest a synthetic stream at the size of the public Reddit
   temporal-interaction dataset (JODIE: 10,984 nodes, 672,447 events,
   172-dim edge features) through the serving wing's publish path, and
   warm the engine with a few queries;
3. kernel phase: each of the four forward kernel bodies (temporal_sample
   recent and uniform, cache_gather, temporal_attn) runs at the serving
   path's shapes on the live mirror and caches, against its plain
   PyTorch version on the same inputs (ids, masks and gathered rows
   exact, floats within 1e-5), and is timed beside the plain version
   and, for temporal_attn, a masked ``scaled_dot_product_attention``:
   device time per call from ``torch.profiler`` (L2 flushed before each
   call) and time per call between CUDA events, which also holds the
   host's launch work while the stream waits.  Both samplers also
   run at the serving hop 0 (the link batch's 128 seeds), and the
   samplers, cache_gather and the attention forward at the train steps'
   shapes: TGAT's 1,800 hop-0 and 18,000 hop-1 targets of a 600-event
   batch (uniform), that batch's 18,000 hop-0 edge ids padded to 32,768
   as ``FeatureCache.fetch`` pads, and TGN's 12,000 roots of a
   4,000-event batch (recent), each attention row with the sampler's own
   masks; those rows take their launch counts from the rounds of phase
   6, which launch each kernel at several shapes, not only at the row's.
   Rows at shapes past the kernels' old limits follow (uniform sampling
   with K 50, the attention forward with K 50 and with Dh 150, its
   backward with both); no path launches these shapes, so each such row
   counts the launches of its own call.  Then the launch floor: the time
   of a kernel that does nothing (``torch.cuda._sleep(0)``) under the
   same timing.  With ``--ab DIR`` (repeatable), each row
   whose source file is also in ``DIR`` (another design with the same C
   interface, such as ``git archive <commit> src/repro_torch/csrc``
   unpacked into a git-ignored directory) is checked against that
   design and timed in turns with it, other, tree, tree, other; the
   rows carry the times as ``ab`` (by directory) in the ``kernels``
   line; the rows past the old limits are not, since an older design
   refuses their shapes, but ``--ab-wide DIR`` times them in turns
   against a design that takes them;
4. serving phase: TGAT at the paper's full width (d_node 128, d_edge
   172, d_time 100, d_hidden 100, 2 heads, fanouts 10/10) with
   ``recent`` sampling answers 512 link and 128 embed queries through
   the worker thread while an ingest thread publishes the rest of the
   stream; every response must match ``offline_forward`` on its pinned
   version (1e-4), the kernels' launch counts over this run must all be
   positive, and the same engine rebuilt on the CPU must agree (hop-0
   neighbourhoods exact, scores and embeddings within 1e-4);
5. ``uniform`` sampling: every sampled hop-0 neighbour must be an
   in-window candidate and each target must get min(K, n) of them;
6. training phase: the temporal_attn backward kernel against the plain
   autograd (1e-5) at the TGAT hop shapes of a sampled batch, timed
   beside the plain backward (and, with ``--ab``, in turns with the
   other design) and the autograd backward of a masked
   ``scaled_dot_product_attention``; then ``ContinuousTrainer`` for TGN
   (recent, batch 4000) and TGAT (uniform, batch 600) at full width
   ingests the first 600,000 events, runs an unprofiled warm round of
   one batch (one epoch), then one round of 12,000 events with 2 epochs
   (one such round, not more, to keep the whole script well inside its
   time limit): losses finite, every kernel of the path
   launched (the backward once per train step and layer), the per-stage
   split, the share of each train prefetch that overlaps the step before it
   (CUDA events), and the device's busy share over that round
   (``torch.profiler``).  A card trainer and a CPU trainer agree over
   a one-batch round (2 train steps) after a 50,000-event prefix (TGN
   and TGAT with recent sampling: per-step loss, eval loss and AP
   within 1e-4, cache hit rates equal), and 64 link queries through
   ``QueryEngine.attach`` on the card's TGAT trainer match
   ``offline_forward`` (1e-4);
7. distributed training phase: ``DistributedContinuousTrainer`` with
   P 4 machines x G 2 ranks in one process (the in-process transport,
   every worker on the card) and the exact ``bucketed`` collective, for
   TGN (recent, batch 4,000) and TGAT (uniform, batch 600) at phase 6's
   full width, ingests the first 600,000 events and runs one round of
   12,000 events with 2 epochs: losses finite and AP in [0, 1], the
   attention forward launched exactly W·L times a train and an eval
   step and its backward W·L times a train step (W = 8 workers), the
   samplers and cache_gather launched, the collective's steps and bytes
   as accounted, the schedule's load CV below 0.1, and the stage split,
   the routing's host waits, the traffic, the per-partition hit rates,
   the refresh bytes beside a full re-upload, the mirrors' bytes and
   TGN's device busy share printed (TGAT's round is not profiled: the
   profiler took longer over its 8 workers' events than the round
   itself).  Then one more global step of each
   trainer holds every kernel against its plain version on the inputs
   it gives them: each routed, pow2-padded owner bucket of the sampler
   (uniform with its request-keyed noise, also against the sampler's
   ``_hop_plain``), each ``cache_gather``, each worker's attention
   forward and backward (ids, masks and rows exact, floats within 1e-5
   of max(1, max |plain|)).  Then, after a 50,000-event prefix and a
   one-batch round: the distributed trainer on the card against itself
   on the CPU (TGN and TGAT with recent sampling: step losses, eval
   loss and AP within 1e-4; load matrix, request and response bytes
   and per-partition hit rates equal) and against the single-host
   trainer on the card (loss within 1e-4, AP within 1e-3, the
   reference's bands); sharded state against replicated for TGN (losses
   within 1e-4, each machine's shard about 1/P of the replicated
   bytes); the quantized (int8) and top-k collectives within 0.05 of
   the exact one, int8 with under a third of its bytes a step and top-k
   with fewer; and two uniform
   sampler systems fed the same requests in opposite worker orders draw
   identical samples, each hop-0 pick an in-window candidate, min(K, n)
   of them.  If the phase ran past 240 s, the warm prefix
   (``DIST_WARM_EVENTS``) is what is cut, never the width, P·G or the
   batch;
8. multihost phase: ``repro_torch.launch.multihost.launch`` runs P 4
   worker processes x G 2 ranks on the card (one machine a process:
   its partition, rank samplers and state shard behind an RPC server;
   barriers on the process group's store, the shard count, loss and
   gradients summed over gloo), for TGN (recent, batch 4,000, sharded
   state, fenced) and TGAT (uniform, batch 600, replicated state) at
   phase 6's full width: a 50,000-event warm prefix, then one round of
   12,000 events with 2 epochs, each worker tracing its spans into a
   fleet trace under ``chiprun_out/mh_trace``; then the same schedule
   through the in-process trainer on the card.  Every worker exits 0
   with its result line; the workers' step and eval losses agree within
   1e-6; the fleet is within 1e-4 (losses) and 1e-3 (AP) of the
   in-process trainer, the gap printed; every worker sent RPCs in the
   round and launched the attention forward exactly G·L times a train
   and an eval step, its backward G·L times a train step, its sampler
   and cache_gather; sharded TGN crossed the wire, served its peers,
   hit its prefetch, served nothing stale and holds about 1/P of the
   replicated bytes; the merged trace has P lanes with ``rpc.call``,
   ``rpc.serve`` and ``barrier`` spans.  Printed per worker: the round
   wall and its split, the RPC and state waits, the seconds in barriers
   and collectives (from the trace) and the peak device memory, beside
   the in-process round.  Past 240 s the warm prefix is cut first, then
   the round's events, never the width, P·G or the batch;
9. LM serving phase, for Yi-6B (dense GQA) and Falcon-Mamba-7B (Mamba-1),
   one at a time: initialise at full width and depth on the card from a
   seeded CUDA generator, cast once to the bf16 compute tree, prefill
   2 prompts of 4,096 tokens through ``make_prefill_step`` (exactly one
   ``flash_attention`` or ``selective_scan`` launch per layer, finite
   logits), and decode 32 steps through ``make_serve_step`` (Yi: 8
   sequences against a 4,096-deep cache from ``init_decode_state``;
   Falcon: the 2 prompts, continuing from the prefill state); then the
   kernel against its plain version at the model's shape (attention
   (2, 4096, 32/4 heads, 128) in bf16, the Hopper instance, within 4e-2
   and 1.6e-2 of each row's scale, timed per call in turns with one
   ``scaled_dot_product_attention``; at Nemotron-4's heads of 192 (1,
   520) the Hopper instance in bf16 (112-key tiles), timed beside SDPA
   and in turns with the general instance, which must agree with it,
   and the general one in float32; the general instance at head dims 320
   (bf16) and 512 (float32) and at Yi's heads in
   float32 (split TF32 on the tensor cores), timed beside SDPA with the
   float32 rows' split-TF32 bound; scan (2, 4096, 8192,
   16) in float32 within 1e-5, and at d_state 32 and 64 (these wide
   rows, as the head dims 192, 320 and 512 and Yi's float32 row, count
   their own call's launches: no prefill runs them); with ``--ab``
   the Hopper attention, the float32 flash rows and the scan at d_state
   16 in turns with the other design); then, at full width cut to 2
   layers (B 2,
   S 256), the card against the CPU (``forward_hidden`` in float32
   within 1e-4, bf16 prefill and decode logits within 0.1) and the
   prefill against token-by-token decode on the card (0.15, the
   reference's bar; for Falcon also prefill(S) + one decode step against
   prefill(S + 1)); then the same serving for Qwen3-MoE-235B-A22B and
   Llama-4-Scout-17B-16E (moe: full width, cut to 8 layers),
   Zamba2-2.7B (hybrid: whole, 54 layers) and Nemotron-4-340B (dense:
   full width, cut to 4 layers, a 46.5 GB bf16 tree), one at a time,
   each initialised straight in bf16: the prefill launches
   ``flash_attention`` exactly once a layer (8, 8, 4) or a superlayer
   (9), the moe prefill's ``moe_drop_frac`` is printed, 32 decode steps
   at B 8 against a fresh 4,096-deep cache; flash_attention against its
   plain version at each one's prefill shape in bf16 (Hopper at GQA
   groups 16 and 5, at zamba2's heads of 80 with a 16-column tail box
   and at Nemotron-4's 96/8 heads of 192 with 112-key tiles, the last
   two also timed in turns with the general instance, which must agree
   with it), timed beside SDPA; and the
   depth cut (the moe archs at 1 layer, B 1, S 128, which puts 15-17 GB
   of float32 on the host; Nemotron-4 at 1 layer, B 1, S 128, with its
   vocabulary cut to 4,096, 14.4 GB of float32 on the host; zamba2 at
   one superlayer, B 2, S 256): each
   token's experts the same on the card and the CPU in float32,
   ``forward_hidden`` within 1e-4, bf16 logits within 5e-2 (zamba2's
   within 0.1, a bar that must fail a planted fault; in bf16 the CPU
   replays the card's experts, and a token routed differently must be a
   near-tie and is named beside the reading), the prefill
   against token-by-token decode within 0.15 (the moe archs at 4 tokens,
   where the prefill cannot drop a slot), and zamba2's prefill(S) + one
   decode step against prefill(S + 1).  Qwen3-MoE's tree is also served
   under a (data 1, model 4) local mesh with ``default_rules()`` (the
   mesh part): a 2 x 8,192 prefill whose attention takes the
   context-parallel blocked branch (``flash_attention`` at q_offset 0,
   2,048, 4,096 and 6,144: exactly 32 launches) and whose moe layers
   take the expert-parallel path, timed beside the same prefill off the
   mesh, with its ``moe_drop_frac`` and peak memory; 4 decode steps from
   its state; a 2 x 4,096 prefill on the direct branch (0 launches);
   layer 0's context-parallel attention against ``blocked_attention``
   over the whole sequence on the card (the per-row bf16 bar); then, the
   tree dropped, flash_attention at the context-parallel shape at each
   offset against its plain version (the per-row bar, which the last
   shard's offset given to shard 0 must fail), timed beside SDPA with the
   same boolean mask, and the general instance in float32 at offsets
   within 1e-5; and on the moe depth cut, under the mesh, the card
   against the CPU within 1e-4 (the same experts) and, at a capacity
   factor of E / k where nothing drops, the mesh against no mesh within
   1e-4;
10. LM training phase: every family at full width takes 3 steps of
   ``make_train_step`` (block remat) on one seeded batch, each arch cut
   as ``LM_TRAIN_OF`` says: Yi-6B and Falcon-Mamba-7B to 8 layers at B 2
   x S 4,096 with AdamW, Zamba2-2.7B whole (AdamW), and Qwen3-MoE-235B-A22B,
   Llama-4-Scout-17B-16E and Nemotron-4-340B (its vocabulary cut to
   4,096, ``LM_CUT_VOCAB``) at one layer with Adafactor (AdamW's moments
   do not fit beside their 3.7, 4.3 and 3.6 B parameters): the loss falls at
   every step, each step launches the forward kernel twice an attention
   application or Mamba-1 layer and its backward kernel
   (``flash_attention_bwd``, the Hopper instance, or
   ``selective_scan_bwd``) once, exactly, and the step time, peak
   memory, device busy share and top device ops are printed; on each moe
   arch's trained tree two backward passes give the same bits.  Then
   Qwen3-MoE's layer under the (1, 4) mesh at B 2 x 8,192 (context
   parallel, blocked: flash at the 4 shards' q_offsets, 8 launches a
   step and its backward 4; expert parallel): 3 steps, the loss falling,
   timed beside one step off the mesh, both peaks printed.  Then both
   backward kernels against the plain version's autograd (flash at
   Yi's train shape in bf16, the Hopper instance, each query row of dq
   and each key of dk and dv within 0.02 of its max |grad| beyond each
   element's rounding budget, a bar that must fail the last KV tile's dk
   and dv zeroed, and timed in turns with the general instance, which
   must agree with it within the same bar; the same at Zamba2's
   attention (2, 4,096, 32/32 heads of 80, causal: the Hopper instance
   with its tail box); at Nemotron-4's train shape (2, 4,096, 96/8 heads
   of 192, causal: the Hopper instance's 64-key dk/dv tiles split
   between its warpgroups, its train steps' launches) and at (1, 520)
   (ragged against every tile, its own call's launches), both the same
   bar, planted fault and turns with the general instance; at the mesh step's
   context-parallel shape at
   each shard's q_offset (the same bar, which shard 0's gradient at the
   last shard's offset must fail; dk and dv exactly 0 on the keys no
   query of a shard sees; timed beside SDPA's backward with the same
   boolean mask), and the general instance in float32 at those
   offsets; at a ragged float32 shape and at Yi's heads in float32
   within 1e-5 of max(1, max |grad|) (with ``--ab`` in turns with the
   other design); the scan at Falcon's with L cut to
   1,024 for the oracle, within 1e-5, and with ``--ab`` in turns with
   the other design at the full L), timed beside the plain backward
   and, for flash, the backward of one
   ``scaled_dot_product_attention``; one train step's
   gradients of each arch's depth cut (``LM_TRAIN_CUT_OF``: Yi's one
   layer at B 2, Falcon's at B 1) on the card
   against the CPU (float32: loss within 1e-4, each gradient leaf within
   1e-4 of its max, a moe arch's experts equal; bf16: each leaf within
   5e-2 of its max, the CPU replaying a moe arch's experts, a bar that
   must fail the card's step with the last 64 positions' gradients of
   both backward kernels zeroed), and on Qwen3-MoE's cut under the mesh
   with the score budget lowered (blocked at S 128): the card against
   the CPU and, at a capacity factor of E / k, the mesh against no mesh
   on the card, both within 1e-4.  Then the process mesh part
   (``process_mesh_part``): Qwen3-MoE as four ranks of a (1, 4) process
   mesh on the one card (``repro_torch.launch.mesh_fleet``: one OS
   process a shard, joined over gloo, the collectives staged through
   host memory, each rank holding 1/4 of the expert blocks): the
   8-layer full-width prefill at 2 x 8,192 (CP blocked, EP), each rank
   launching flash exactly once a layer at its own q_offset, the four
   ranks' logits equal bit for bit and within 5e-2 of phase 9's logical
   mesh, each rank's time, peak, drop fraction and collective record
   (count, wire bytes, host-staged bytes and seconds by kind) printed
   beside the logical mesh's; the float32 depth cut (one full-width
   layer, B 1 x 128, the score budget lowered: CP blocked) against the
   logical mesh on the card: the prefill's hidden state within 1e-4,
   one train step's loss within 1e-4 and each gradient leaf within 1e-4
   of its max, each token's experts equal, flash twice and 5b once a
   rank (block remat); and 3 Adafactor train steps at the reduced
   config with block remat (the full-width cut's optimizer step does not
   fit four times on one card; each rank's RMS of an expert leaf sums
   the four ranks' blocks), the loss falling and the same on every rank,
   flash twice and 5b once a layer a step; ``LMTrainer``'s save, restore and
   continue on the card equal to an uninterrupted run, exactly, for
   Yi-6B's and Qwen3-MoE's reduced configs; and ``python -m
   repro_torch.launch.train lm`` in a subprocess;
11. dry-run phase: ``repro_torch.launch.dryrun.run_cell`` traces, on the
   ``meta`` device under a (1, 1) mesh (the context-parallel rule off,
   as the measured steps run off any mesh), the two Yi-6B steps the LM
   phases measured: the 8-layer train step at B 2 x 4,096 (phase 10)
   and the 32-layer prefill at 2 x 4,096 (phase 9).  Beside each
   prediction it prints the card's reading and holds it: argument bytes
   equal to the state's and batch's and within 512 B a leaf of the
   memory they hold; argument + temp bytes within 10 % of the step's
   peak above that; the trace's kernel calls per name equal to one
   step's launches; the roofline bound no longer than the measured step
   (the ratio printed).  Then one production cell, Yi-6B x decode_32k x
   the 16 x 16 mesh, traced on meta (train_4k takes about three minutes
   of host time there), its roofline line and wall time printed.

The second-to-last line is the JSON ``kernels`` record, the last line
``{"ok": true, "device": {...}}``.  Without a card, or without the
repository beside it, the script exits non-zero before printing either.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ATOL_KERNEL = 1e-5      # one op, float32 (the reference's per-op bar)
ATOL_SERVED = 1e-4      # served score vs offline / CPU (engine.py bar)
# bf16 attention: max |err| of an output row over that row's max |out|,
# 2 bf16 ulps of the row's scale (one ulp is at most 2^-7 of a value),
# beside the reference's absolute bar (tests/test_flash_attention.py)
ROW_REL_BF16 = 1.6e-2
ATOL_BF16 = 4e-2
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, at 700 W
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM dense TF32 tensor cores
# special-function units: 16 exp2 results per clock per SM (throughput
# table for compute capability 9.0), 132 SMs at the 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9
# shapes only the widened kernels take: the fanout of
# TemporalSampler(g, (50,), "uniform") and the head dim of a TGAT with
# d_hidden 300 and 2 heads
WIDE_FANOUT = 50
WIDE_HEAD_DIM = 150


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def call_ms(torch, fn, *, reps: int = 30, warm: int = 5,
            flush=None) -> float:
    """Median time per call of ``fn`` between CUDA events recorded just
    before and after it.  ``flush`` (a large tensor) is overwritten
    before each rep so the inputs come from device memory, not a warm
    L2.  A call whose device work is shorter than its host work (the
    wrapper's checks and the launch) is timed at its host cost."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def device_events(torch, prof) -> list:
    """The device's own events (kernels, copies, memsets) of a
    ``torch.profiler`` run, averaged by name: host ops are skipped, as
    their device time repeats that of the kernels they launched."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages() if e.device_type == cuda]


def device_ms(torch, fn, flush, *, reps: int = 30) -> float:
    """Device time per call of ``fn`` with a cold L2, from the profiler
    over ``reps`` (flush, fn) pairs: for each kernel of ``fn``, the mean
    duration of its recorded launches times its launches per call (its
    recorded count over ``reps``, rounded, at least one).  The profiler
    does not record every launch of its window (in runs on an H100 it
    kept as few as 1 of 30), but those it records are timed right, so a
    mean over them is not biased by the loss, where a sum over ``reps``
    would be.  The flush's own kernel (a fill of its uint8 bytes) is
    left out, and a line is logged when fewer than ``reps`` of it were
    recorded."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    flush_kernel = "FillFunctor<unsigned char>"     # flush.zero_()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    seen = {e.key: (e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type == cuda}
    flushes = sum(n for key, (n, _) in seen.items() if flush_kernel in key)
    if flushes < reps:
        log(f"[profiler] events lost: {flushes} of {reps} flushes recorded")
    return sum(us / n * max(1, round(n / reps)) for key, (n, us)
               in seen.items() if flush_kernel not in key) / 1e3


def burst_ms(torch, fn, flush, *, reps: int = 20) -> float:
    """Device time per call of ``fn`` with a cold L2 by CUDA events, the
    profiler's counterpart: events around ``reps`` back-to-back (flush,
    fn) pairs, less the same around ``reps`` flushes.  The host enqueues
    ahead of the device when a call's device work outlasts its host
    work, so no host gap is counted then."""
    def span(work):
        work()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            work()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    return (span(lambda: (flush.zero_(), fn())) - span(flush.zero_)) / reps


def top_ops(events, n: int = 6) -> list:
    """The ``n`` of ``events`` (:func:`device_events`) with the most
    device time: [(name, ms)]."""
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:n]
    return [(e.key[:48], round(e.self_device_time_total / 1e3, 3))
            for e in top]


def profiled_busy(torch, work) -> tuple:
    """(device busy share, wall s, top device ops, work's result) of
    ``work`` under ``torch.profiler``: the summed duration of the device's
    events over the wall time (one stream, so they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = work()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(torch, prof)       # averaged once: slow on a
    busy_us = sum(e.self_device_time_total for e in events)  # long run
    return busy_us / (wall * 1e6), wall, top_ops(events), out


def timings(torch, fn, flush) -> tuple:
    """(device ms, ms per call) of ``fn``; see :func:`device_ms` and
    :func:`call_ms`."""
    return device_ms(torch, fn, flush), call_ms(torch, fn, flush=flush)


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = FP32_OPS_PER_S, exps: float = 0.0) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their peak rate, where ``exps``
    exponentials on the special-function units are operations too."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = max(ops / ops_per_s, exps / SFU_PER_S)
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def flash_bound(nbytes: float, flops: float, pairs: float,
                bf16: bool) -> tuple:
    """(ms, "bytes" or "operations", note) of a flash_attention row: bf16
    on the bf16 tensor cores; float32 as the kernels run it, split TF32,
    three TF32 products a float32 one on the TF32 tensor cores, with the
    float32 FMA rate's bound (the first float32 design's floor) in the
    note.  Each (q, key) pair's exp is an operation on the special-
    function units either way."""
    if bf16:
        return bound_ms(nbytes, flops, BF16_OPS_PER_S, exps=pairs) + ("",)
    b, by = bound_ms(nbytes, 3.0 * flops, TF32_OPS_PER_S, exps=pairs)
    fma = bound_ms(nbytes, flops, FP32_OPS_PER_S, exps=pairs)[0]
    return b, by, (f"split TF32: 3 x {flops:.3g} FLOP at "
                   f"{TF32_OPS_PER_S / 1e12:.0f} TFLOP/s; at the float32 "
                   f"FMA rate {fma:.4f}")


def in_turns(torch, lib, ab, kernel, flush, what, close=None) -> list:
    """``kernel`` against another design of its library ``lib``, built
    from the source in directory ``ab`` (same C interface): the two must
    agree (ints and masks exactly, floats within the kernel bar, or by
    ``close(other, tree, what)``), then both are timed in turns, other,
    tree, tree, other."""
    from repro_torch.kernels import runtime

    with runtime.sources_from(lib, ab):
        other = kernel()
    tree = kernel()
    torch.cuda.synchronize()
    for i, (o, t) in enumerate(zip(*(x if isinstance(x, (tuple, list))
                                     else (x,) for x in (other, tree)))):
        if t.is_floating_point():
            (close or (lambda a, b, w: max_err(torch, a, b, w)))(
                o, t, f"{what} [{i}]: {ab} vs the tree")
        else:
            assert_equal(torch, o, t, f"{what} [{i}]: {ab} vs the tree")
    turns = []
    for design in ("other", "tree", "tree", "other"):
        with (runtime.sources_from(lib, ab) if design == "other"
              else contextlib.nullcontext()):
            ms, call = timings(torch, kernel, flush)
        turns.append(dict(design=design, ms=ms, call_ms=call))
    log(f"[ab] {what}: outputs agree; device ms / ms per call in turns: "
        + "  ".join(f"{t['design']} {t['ms']:.4f}/{t['call_ms']:.4f}"
                    for t in turns))
    return turns


def assert_equal(torch, got, want, what):
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{what}: {bad} entries differ from the "
                             f"plain version")


def max_err(torch, got, want, what, tol: float = ATOL_KERNEL) -> float:
    err = (float((got.float() - want.float()).abs().max()) if got.numel()
           else 0.0)
    if not err <= tol:
        raise AssertionError(f"{what}: max |err| {err} > {tol}")
    return err


def row_rel_err(torch, got, want, what, tol: float = ROW_REL_BF16
                ) -> float:
    """Largest over the rows (last axis) of max |got - want| over the
    row's max |want|, checked against ``tol``."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp_min(1e-30)
    rel = float((err / scale).max())
    if not rel <= tol:
        raise AssertionError(f"{what}: max |err| / max |ref| of a row "
                             f"{rel} > {tol}")
    return rel


# ---------------------------------------------------------------------------
# ingest (the JAX package's ContinuousTrainer._ingest_body order)
# ---------------------------------------------------------------------------


class Feed:
    def __init__(self, stream, state, engines, params):
        from repro_torch.core.dgraph import DynamicGraph
        self.stream = stream
        self.state = state
        self.engines = engines
        self.params = params
        self.g = DynamicGraph(threshold=64, undirected=True)
        self.snap = None
        self.ingested = 0
        self.lock = threading.Lock()

    def ingest(self, lo: int, hi: int) -> None:
        from repro_torch.core.snapshot import (build_snapshot,
                                               refresh_snapshot)
        with self.lock:
            batch = self.stream.slice(lo, hi)
            eids = self.g.add_edges(batch.src, batch.dst, batch.ts)
            nodes = np.unique(np.concatenate([batch.src, batch.dst]))
            self.state.put_node_feats(nodes, batch.node_features(nodes))
            uniq = np.unique(eids)
            self.state.register_edges(uniq, np.zeros_like(uniq))
            self.state.put_edge_feats(uniq, batch.edge_features(uniq))
            self.snap = (build_snapshot(self.g) if self.snap is None
                         else refresh_snapshot(self.g, self.snap))
            for eng in self.engines:
                eng.on_publish(self, self.snap, batch, nodes, uniq)
            self.ingested = hi


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def kernel_phase(torch, eng, feed, t_q, rng, dev, ab=(), ab_wide=()):
    """Phase 3; each row is also timed in turns against the design of
    its source in each directory of ``ab`` (see :func:`in_turns`), and a
    row at a shape past the old limits against those of ``ab_wide``."""
    from repro_torch.configs.tgn_gdelt import tgn
    from repro_torch.core.rand import gumbel_noise
    from repro_torch.kernels.cache_gather.ops import cache_gather
    from repro_torch.kernels.cache_gather.ref import cache_gather_ref
    from repro_torch.kernels.temporal_attn.ops import temporal_attn
    from repro_torch.kernels.temporal_attn.ref import temporal_attn_ref
    from repro_torch.kernels.temporal_sample.ops import temporal_sample
    from repro_torch.kernels.temporal_sample.ref import (
        temporal_sample_ref, temporal_sample_uniform_ref)

    cfg = eng.cfg
    K = cfg.fanouts[0]
    h = eng.publisher.current()
    d = h.dev
    scan = min(h.scan_pages, d["page_table"].shape[1])
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    pages = (d["page_table"], d["page_tmin"], d["page_tmax"],
             d["pages_nbr"], d["pages_eid"], d["pages_ts"],
             d["pages_valid"])
    plain_pages = (d["page_table"][:, :scan].contiguous(),) + pages[1:]
    C = d["pages_ts"].shape[1]

    # hop-0 targets of a 64-pair link batch, hop-1 targets from its result
    pairs = rng.integers(0, len(feed.stream), 64)
    seeds = np.concatenate([feed.stream.src[pairs], feed.stream.dst[pairs]])
    tgt0 = torch.from_numpy(seeds.astype(np.int32)).to(dev)
    t0 = torch.full((128,), t_q, dtype=torch.float32, device=dev)
    ninf = lambda t: torch.full_like(t, float("-inf"))
    m0 = torch.ones(128, dtype=torch.bool, device=dev)
    hop0 = temporal_sample_ref(*plain_pages, tgt0, t0, ninf(t0), m0, k=K)
    tgt = hop0[0].reshape(-1).contiguous()
    tq = hop0[2].reshape(-1).contiguous()
    tm = hop0[3].reshape(-1).contiguous()
    ts0 = ninf(tq)
    N = tgt.shape[0]
    rows = []

    def sample_bytes(policy, tgt, tq, ts0, tm, k=K):
        """Bytes the walk needs on this data (see PERF.md), and its
        compares.  Both policies need nbr/eid of their picks only, and
        uniform the noise of each in-window lane; for uniform a third
        value is the looser count that also reads nbr/eid of every
        in-window lane, as a one-warp-per-target walk does."""
        N = tgt.shape[0]
        pt = d["page_table"][tgt.clamp(0, d["page_table"].shape[0] - 1)
                             .long()][:, :scan]
        alive = tm & (tgt >= 0) & (tgt < d["page_table"].shape[0])
        valid_pid = (pt >= 0) & alive[:, None]
        pc = pt.clamp(0, d["pages_ts"].shape[0] - 1).long()
        hit = valid_pid & (d["page_tmin"][pc] < tq[:, None]) \
            & (d["page_tmax"][pc] >= ts0[:, None])
        lane_ts = d["pages_ts"][pc]
        inwin = (d["pages_valid"][pc] & hit[:, :, None]
                 & (lane_ts >= ts0[:, None, None])
                 & (lane_ts < tq[:, None, None])).sum(-1)     # (N, S)
        if policy == "recent":
            before = inwin.cumsum(1) - inwin
            reached = before < k
        else:
            reached = torch.ones_like(inwin, dtype=torch.bool)
        reads = float((reached & alive[:, None]).sum())
        visited = float((reached & valid_pid).sum())
        scanned = float((reached & hit).sum())
        lanes_in = float((inwin * reached).sum())
        common = 13 * N + 4 * reads + 8 * visited + 5 * C * scanned \
            + 13 * N * k
        ops = 3.0 * C * scanned
        picks = float(inwin.sum(1).clamp(max=k).sum())
        if policy == "recent":
            return common + 8 * picks, ops
        return (common + 4 * lanes_in + 8 * picks, ops,
                common + 12 * lanes_in)

    def row(name, source, replaces, err, shape, kernel, plain, nbytes,
            ops, library=None, path="serve", widened=False):
        """Time and record one kernel row; ``widened``: a shape only the
        widened kernels take and no path of this run launches, timed in
        turns only against ``ab_wide`` (an older design refuses it), its
        launches those of its own call."""
        ms, call = timings(torch, kernel, flush)
        plain_ms, plain_call = timings(torch, plain, flush)
        b, by = bound_ms(nbytes, ops)
        lib_ms, lib_call = (None, None) if library is None else timings(
            torch, library, flush)
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{source}",
            replaces=f"src/repro/kernels/{replaces}", max_abs_err=err,
            shape=shape, ms=ms, call_ms=call, plain_ms=plain_ms,
            plain_call_ms=plain_call, bound_ms=b, bound_by=by,
            library_ms=lib_ms, library_call_ms=lib_call,
            path="widened" if widened else path))
        if widened:
            rows[-1]["launches"] = own_launches(torch, name, kernel)
        ab_rows(torch, rows[-1], Path(source).stem,
                ab_wide if widened else ab, kernel, flush,
                f"{name} ({shape})")

    def check_sample(what, got, want):
        torch.cuda.synchronize()
        for name, g_, w_ in zip(("nbr", "eid", "mask"),
                                (got[0], got[1], got[3]),
                                (want[0], want[1], want[3])):
            assert_equal(torch, g_, w_, f"{what} {name}")
        return max_err(torch, got[2], want[2], f"{what} ts")

    # -- temporal_sample, recent ------------------------------------------
    def recent_row(tag, args, path):
        """Check, time and record one recent launch; returns the plain
        version's output."""
        got = temporal_sample(*pages, *args, k=K, policy="recent", scan=scan)
        want = temporal_sample_ref(*plain_pages, *args, k=K)
        err = check_sample(f"temporal_sample_recent ({tag})", got, want)
        row("temporal_sample_recent", "temporal_sample.cu",
            "temporal_sample/temporal_sample.py:42", err,
            f"N={args[0].shape[0]} S={scan} C={C} K={K} ({tag})",
            lambda: temporal_sample(*pages, *args, k=K, policy="recent",
                                    scan=scan),
            lambda: temporal_sample_ref(*plain_pages, *args, k=K),
            *sample_bytes("recent", *args), path=path)
        return want

    recent_row("serving hop 0", (tgt0, t0, ninf(t0), m0), "serve")
    args = (tgt, tq, ts0, tm)
    recent_row("serving hop 1", args, "serve")

    # -- temporal_sample, uniform (shared noise) --------------------------
    def uniform_row(tag, args, noise, path, k=K):
        """Check, time and record one uniform launch; returns the plain
        version's output."""
        got = temporal_sample(*pages, *args, k=k, policy="uniform",
                              noise=noise, scan=scan)
        want = temporal_sample_uniform_ref(*plain_pages, *args, noise, k=k)
        err = check_sample(f"temporal_sample_uniform ({tag})", got, want)
        nbytes, ops, loose = sample_bytes("uniform", *args, k=k)
        log(f"[kernel] temporal_sample_uniform ({tag}): bound from "
            f"{nbytes / 1e6:.3f} MB ({loose / 1e6:.3f} MB with nbr/eid of "
            f"every in-window lane: {bound_ms(loose, ops)[0]:.5f} ms)")
        row("temporal_sample_uniform", "temporal_sample.cu",
            "temporal_sample/temporal_sample.py:103", err,
            f"N={args[0].shape[0]} S={scan} C={C} K={k} ({tag})",
            lambda: temporal_sample(*pages, *args, k=k, policy="uniform",
                                    noise=noise, scan=scan),
            lambda: temporal_sample_uniform_ref(*plain_pages, *args, noise,
                                                k=k),
            nbytes, ops, path=path, widened=k > 32)
        return want

    uniform_row("serving hop 0", (tgt0, t0, ninf(t0), m0),
                gumbel_noise(torch.Generator(device=dev).manual_seed(8),
                             (tgt0.shape[0], scan, C), dev), "serve_uniform")
    gen = torch.Generator(device=dev).manual_seed(7)
    uniform_row("serving hop 1", args, gumbel_noise(gen, (N, scan, C), dev),
                "serve_uniform")
    # the TGAT train step: a 600-event batch (src, dst and random
    # negatives at the events' times, 1,800 targets) sampled uniformly at
    # hop 0, whose 18,000 neighbours are the hop-1 targets at their edge
    # times
    B = cfg.batch_size                      # 600, as the trainer's TGAT
    lo = feed.ingested - B
    seeds_t = np.concatenate([feed.stream.src[lo:lo + B],
                              feed.stream.dst[lo:lo + B],
                              rng.integers(0, feed.stream.n_nodes, B)])
    tgt_t = torch.from_numpy(seeds_t.astype(np.int32)).to(dev)
    t_t = torch.from_numpy(np.tile(feed.stream.ts[lo:lo + B], 3)
                           .astype(np.float32)).to(dev)
    m_t = torch.ones_like(tgt_t, dtype=torch.bool)
    hop0_t = uniform_row("TGAT train hop 0", (tgt_t, t_t, ninf(t_t), m_t),
                         gumbel_noise(gen, (3 * B, scan, C), dev),
                         "train_tgat")
    args_t = (hop0_t[0].reshape(-1).contiguous(),
              hop0_t[2].reshape(-1).contiguous(),
              torch.full((3 * B * K,), float("-inf"), device=dev),
              hop0_t[3].reshape(-1).contiguous())
    hop1_t = uniform_row("TGAT train hop 1", args_t,
                         gumbel_noise(gen, (3 * B * K, scan, C), dev),
                         "train_tgat")
    # the TGN train step: a 4,000-event batch's [src|dst|neg] roots at the
    # events' times (12,000 targets), sampled recent at its one hop
    Bn = tgn().batch_size
    lo = feed.ingested - Bn
    seeds_n = np.concatenate([feed.stream.src[lo:lo + Bn],
                              feed.stream.dst[lo:lo + Bn],
                              rng.integers(0, feed.stream.n_nodes, Bn)])
    tgt_n = torch.from_numpy(seeds_n.astype(np.int32)).to(dev)
    t_n = torch.from_numpy(np.tile(feed.stream.ts[lo:lo + Bn], 3)
                           .astype(np.float32)).to(dev)
    hop_n = recent_row("TGN train hop", (tgt_n, t_n, ninf(t_n),
                                         torch.ones_like(tgt_n,
                                                         dtype=torch.bool)),
                       "train_tgn")
    # K > 32 (the shared-memory reservoir) at the serving hop 1's targets
    uniform_row("serving hop 1, K > 32", args,
                gumbel_noise(gen, (N, scan, C), dev), "serve_uniform",
                k=WIDE_FANOUT)

    # -- cache_gather: edge fetches on the warmed edge cache ---------------
    st = eng.edge_cache.state
    D = st.feats.shape[1]

    def gather_row(tag, eids, path):
        """``eids`` padded with NULL ids to a power of two, as
        ``FeatureCache.fetch`` pads a request."""
        bucket = 1 << math.ceil(math.log2(eids.numel()))
        ids = torch.full((bucket,), -1, dtype=torch.int32, device=dev)
        ids[:eids.numel()] = eids
        got = cache_gather(st.slot_of, st.ids, st.feats, ids)
        want = cache_gather_ref(st.slot_of, st.ids, st.feats, ids)
        torch.cuda.synchronize()
        assert_equal(torch, got[1], want[1], f"cache_gather hit ({tag})")
        assert_equal(torch, got[0], want[0], f"cache_gather rows ({tag})")
        hits = int(got[1].sum())
        row("cache_gather", "cache_gather.cu",
            "cache_gather/cache_gather.py:22", 0.0,
            f"N={bucket} D={D} C={st.ids.shape[0]} hits={hits}",
            lambda: cache_gather(st.slot_of, st.ids, st.feats, ids),
            lambda: cache_gather_ref(st.slot_of, st.ids, st.feats, ids),
            12 * bucket + 4 * D * hits + 4 * D * bucket + bucket, 0.0,
            path=path)

    # serving: the hop-1 edge fetch of the 64-pair link batch
    hop1 = temporal_sample_ref(*plain_pages, tgt, tq, ts0, tm, k=K)
    gather_row("serving hop 1", hop1[1].reshape(-1), "serve")
    # TGAT train step: the edges of the 1,800 hop-0 targets (18,000 ids)
    gather_row("TGAT train hop 0", hop0_t[1].reshape(-1), "train_tgat")

    # -- temporal_attn forward, at full width -------------------------------
    F = torch.nn.functional
    H, dh = cfg.n_heads, cfg.d_hidden // cfg.n_heads

    def attn_row(tag, mask, path, dh=dh, seed=11):
        """The forward on random q, k, v with the sampler's ``mask``
        (N, K), timed beside one masked ``scaled_dot_product_attention``
        (a yardstick, never called by the port)."""
        n, k = mask.shape
        gq = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn((n, H, dh), generator=gq, device=dev)
        kk = torch.randn((n, k, H, dh), generator=gq, device=dev)
        v = torch.randn((n, k, H, dh), generator=gq, device=dev)
        with torch.no_grad():
            got = temporal_attn(q, kk, v, mask)
            want = temporal_attn_ref(q, kk, v, mask)
        torch.cuda.synchronize()
        err = max_err(torch, got, want, f"temporal_attn ({tag})")
        empty = ~mask.any(1)
        if not bool((got[empty] == 0).all()):
            raise AssertionError(f"temporal_attn ({tag}): a target with no "
                                 f"neighbour has a nonzero row")
        q_l = q.reshape(n * H, 1, dh)
        k_l = kk.permute(0, 2, 1, 3).reshape(n * H, k, dh).contiguous()
        v_l = v.permute(0, 2, 1, 3).reshape(n * H, k, dh).contiguous()
        m_l = mask[:, None, :].expand(n, H, k).reshape(n * H, 1,
                                                       k).contiguous()
        row("temporal_attn", "temporal_attn.cu",
            "temporal_attn/temporal_attn.py:21", err,
            f"N={n} H={H} Dh={dh} K={k} ({tag}; {int(empty.sum())} "
            f"targets without neighbours)",
            lambda: temporal_attn(q, kk, v, mask),
            lambda: temporal_attn_ref(q, kk, v, mask),
            4 * (n * H * dh * 2 + 2 * n * k * H * dh) + n * k,
            4.0 * n * H * k * dh + 3.0 * n * H * k,
            library=lambda: F.scaled_dot_product_attention(
                q_l, k_l, v_l, attn_mask=m_l),
            path=path, widened=k > 32 or dh > 128)

    attn_row("serving hop 1", hop1[3].contiguous(), "serve")
    attn_row("TGAT train hop 0", hop0_t[3].contiguous(), "train_tgat")
    attn_row("TGAT train hop 1", hop1_t[3].contiguous(), "train_tgat")
    attn_row("TGN train hop", hop_n[3].contiguous(), "train_tgn")
    # K and Dh past 32 and 128: the shared-memory instance
    gm = torch.Generator(device=dev).manual_seed(12)
    wide_mask = torch.rand((N, WIDE_FANOUT), generator=gm, device=dev) < 0.5
    wide_mask[::5] = False
    attn_row("K > 32", wide_mask, "serve")
    attn_row("Dh > 128", hop1[3].contiguous(), "serve", dh=WIDE_HEAD_DIM)
    backward_wide_row(torch, dev, flush, rows, ab_wide)

    # -- the launch floor: a kernel that does nothing, same timing -------
    floor = timings(torch, lambda: torch.cuda._sleep(0), flush)
    log(f"[kernel] launch floor: a kernel that does nothing "
        f"(torch.cuda._sleep(0), one thread) takes device ms "
        f"{floor[0]:.4f}, ms per call {floor[1]:.4f}, under the rows' "
        f"timing")

    for r in rows:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms ({r['library_call_ms']:.4f} "
                    f"per call)")
        log(f"[kernel] {r['name']:<24} {r['shape']:<33} ok "
            f"max|err|={r['max_abs_err']:.3g} (tol {ATOL_KERNEL}) "
            f"device ms: kernel {r['ms']:.4f}  plain {r['plain_ms']:.4f}  "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']})  library {lib}; "
            f"ms per call: kernel {r['call_ms']:.4f}  plain "
            f"{r['plain_call_ms']:.4f}")
    return rows


def backward_wide_row(torch, dev, flush, rows, ab_wide=()):
    """The temporal_attn backward's shared-memory instance (K > 32, Dh >
    128) against the plain autograd at the TGAT hop 0's 1,800 targets,
    with random masks, some targets without neighbours; timed beside the
    autograd backward of one masked ``scaled_dot_product_attention``, as
    the hop rows are."""
    from repro_torch.kernels.temporal_attn.ops import temporal_attn
    from repro_torch.kernels.temporal_attn.ref import temporal_attn_ref

    N, H, K, dh = 1800, 2, WIDE_FANOUT, WIDE_HEAD_DIM
    g = torch.Generator(device=dev).manual_seed(13)
    ins = [torch.randn(shape, generator=g, device=dev).requires_grad_()
           for shape in ((N, H, dh), (N, K, H, dh), (N, K, H, dh))]
    mask = torch.rand((N, K), generator=g, device=dev) < 0.5
    mask[::5] = False
    dout = torch.randn((N, H, dh), generator=g, device=dev)
    out_k = temporal_attn(*ins, mask)
    out_p = temporal_attn_ref(*ins, mask)
    got = torch.autograd.grad(out_k, ins, dout, retain_graph=True)
    want = torch.autograd.grad(out_p, ins, dout, retain_graph=True)
    torch.cuda.synchronize()
    err = max(max_err(torch, a, b, f"temporal_attn_bwd (wide) {nm}")
              for nm, a, b in zip(("dq", "dk", "dv"), got, want))
    q, kk, v = (t.detach() for t in ins)
    lib_in = [q.reshape(N * H, 1, dh)] + [
        t.permute(0, 2, 1, 3).reshape(N * H, K, dh) for t in (kk, v)]
    lib_in = [t.contiguous().requires_grad_() for t in lib_in]
    m_l = mask[:, None, :].expand(N, H, K).reshape(N * H, 1, K)
    out_l = torch.nn.functional.scaled_dot_product_attention(
        *lib_in, attn_mask=m_l)
    d_l = dout.reshape(N * H, 1, dh)
    kernel = lambda: torch.autograd.grad(out_k, ins, dout, retain_graph=True)
    plain = lambda: torch.autograd.grad(out_p, ins, dout, retain_graph=True)
    library = lambda: torch.autograd.grad(out_l, lib_in, d_l,
                                          retain_graph=True)
    ms, call = timings(torch, kernel, flush)
    plain_ms, plain_call = timings(torch, plain, flush)
    lib_ms, lib_call = timings(torch, library, flush)
    nbytes = 4 * N * H * dh * ((2 * K + 2) + (2 * K + 1)) + N * K
    b, by = bound_ms(nbytes, 8.0 * N * H * K * dh + 6.0 * N * H * K)
    rows.append(dict(
        name="temporal_attn_bwd", route="cuda",
        source="src/repro_torch/csrc/temporal_attn.cu",
        replaces="src/repro/kernels/temporal_attn/temporal_attn.py:21",
        max_abs_err=err, shape=f"N={N} H={H} Dh={dh} K={K} (K > 32, "
        f"Dh > 128)", ms=ms, call_ms=call, plain_ms=plain_ms,
        plain_call_ms=plain_call, bound_ms=b, bound_by=by, library_ms=lib_ms,
        library_call_ms=lib_call, path="widened",
        launches=own_launches(torch, "temporal_attn_bwd", kernel)))
    ab_rows(torch, rows[-1], "temporal_attn", ab_wide, kernel, flush,
            f"temporal_attn_bwd ({rows[-1]['shape']})")


# ---------------------------------------------------------------------------
# serving phases
# ---------------------------------------------------------------------------


def serve(eng, feed, queries, depth_cap):
    """Submit ``queries`` (("link", u, v, t) | ("embed", u, t)) keeping
    the queue shallow; returns [(query, QueryResult)] and the wall time."""
    t_start = time.perf_counter()
    pending = []
    for q in queries:
        while eng.queue.depth >= depth_cap:
            time.sleep(0.0002)
        if q[0] == "link":
            f = eng.submit_link([q[1]], [q[2]], [q[3]])
        else:
            f = eng.submit_embed([q[1]], [q[2]])
        pending.append((q, f))
    out = [(q, f.result(300)) for q, f in pending]
    return out, time.perf_counter() - t_start


def check_offline(eng, results):
    """Every served answer equals offline_forward on its pinned version;
    the offline replays are grouped per version."""
    by_v = {}
    for q, r in results:
        by_v.setdefault((r.version, q[0]), []).append((q, r))
    worst = 0.0
    for (version, kind), items in by_v.items():
        if kind == "link":
            off = eng.offline_forward(
                version, [q[1] for q, _ in items], [q[2] for q, _ in items],
                [q[3] for q, _ in items])
            got = np.concatenate([r.scores for _, r in items])
        else:
            off = eng.offline_forward(version, [q[1] for q, _ in items],
                                      ts=[q[2] for q, _ in items])
            got = np.concatenate([r.emb for _, r in items])
        if not np.isfinite(got).all():
            raise AssertionError("non-finite served output")
        err = float(np.abs(got - off).max())
        worst = max(worst, err)
        if not err <= ATOL_SERVED:
            raise AssertionError(f"served vs offline on version {version}"
                                 f": {err} > {ATOL_SERVED}")
    return worst, len(by_v)


def device_busy(torch, eng, feed, queries):
    """Serve ``queries`` under ``torch.profiler`` and the engine's span
    tracer.  The device's busy share is the summed duration of the
    device's events over the wall time of the window (one stream, so
    they do not overlap); the spans give the host's split of a batch (host
    clock; ``serve.fetch`` waits for the sampling kernels through its
    first device-to-host read, ``serve.forward`` for the forward)."""
    from repro_torch.obs import trace
    trace.reset()
    trace.enable()
    try:
        share, wall, top, _ = profiled_busy(
            torch, lambda: serve(eng, feed, queries, 128))
    finally:
        trace.disable()
    spans = {}
    for e in trace.events():
        if e["kind"].startswith("serve."):
            spans.setdefault(e["kind"], []).append(e["dur_us"] / 1e3)
    split = {k: round(float(np.sum(v)) / len(spans["serve.batch"]), 3)
             for k, v in sorted(spans.items())}
    return share, wall, split, top


def probe_ms(cache, ids, reps: int = 5) -> float:
    """Host time of ``FeatureCache.probe`` (what ``invalidate`` runs):
    it reads the whole ``slot_of`` map to the host."""
    cache.probe(ids)
    t = time.perf_counter()
    for _ in range(reps):
        cache.probe(ids)
    return (time.perf_counter() - t) / reps * 1e3


def make_queries(rng, stream, hi, n_link, n_embed, t_q):
    ev = rng.integers(0, hi, n_link)
    links = [("link", int(stream.src[e]), int(stream.dst[e]), t_q)
             for e in ev]
    nodes = rng.integers(0, stream.n_nodes, n_embed)
    embeds = [("embed", int(u), t_q) for u in nodes]
    out, step = [], max(1, n_link // max(n_embed, 1))
    for i, q in enumerate(links):
        out.append(q)
        if (i + 1) % step == 0 and embeds:
            out.append(embeds.pop())
    return out + embeds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--events", type=int, default=672_447)
    ap.add_argument("--nodes", type=int, default=10_984)
    ap.add_argument("--ab", type=Path, action="append", default=[],
                    metavar="DIR",
                    help="also time each kernel-phase row in turns against "
                         "the design of its source in DIR (repeatable)")
    ap.add_argument("--ab-wide", type=Path, action="append", default=[],
                    metavar="DIR",
                    help="also time the rows at shapes past the kernels' "
                         "old limits against DIR, whose design takes them "
                         "(repeatable)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port is missing ({src}/repro_torch)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import runtime

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    # -- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    build_logs = runtime.build()
    for name, text in build_logs.items():
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln
                or "properties for" in ln or "wgmma" in ln]
        log(f"[build] {name}: " + (" | ".join(regs) or text.strip()))
    log(f"[build] {len(build_logs)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")

    from repro_torch.data.events import synth_ctdg
    stream = synth_ctdg(n_nodes=args.nodes, n_events=args.events,
                        d_node=128, d_edge=172, seed=args.seed)
    rows = run(torch, dev, args, stream)
    train_rows, train_counts = train_phase(torch, dev, args, stream)
    for r in rows:
        if r["path"].startswith("train_"):   # a train step's shapes
            trainer = r["path"][len("train_"):]
            r["launches"] = int(train_counts[trainer].get(r["name"], 0))
            if r["launches"] <= 0:
                raise AssertionError(f"{r['name']}: no launch in the "
                                     f"{trainer} rounds")
    rows += train_rows
    dist_phase(torch, dev, args, stream)
    del stream
    multihost_phase(torch, dev, args)
    measured = {}
    rows += lm_phase(torch, dev, args, measured)
    rows += lm_train_phase(torch, dev, args, measured)
    dryrun_phase(torch, args, measured)
    print(smi, flush=True)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "call_ms", "library_call_ms", "shape")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys}
        | {k: r[k] for k in ("instance", "ab", "launches_of", "fma_bound_ms")
           if k in r}
        | ({"launches_of": "own call"} if r.get("path") == "widened"
           else {})
        for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(torch, dev, args, stream):
    """Phases 2-5 on ``dev``; returns the kernel rows, with their launch
    counts from the serving runs for the serving shapes."""
    from repro_torch.configs.tgn_gdelt import tgat
    from repro_torch.core.feature_store import ReplicatedStateService
    from repro_torch.kernels import runtime
    from repro_torch.models.gnn import init_params
    from repro_torch.serve import HandlePublisher, QueryEngine

    # -- phase 2: ingest the Reddit-scale stream --------------------------
    rng = np.random.default_rng(args.seed)
    cfg = tgat(sampling="recent")
    t0 = time.perf_counter()
    state = ReplicatedStateService(1, d_node=cfg.d_node, d_edge=cfg.d_edge)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device=dev)
    pub = HandlePublisher(scan_pages=16, history=64, device=dev)
    cache_kw = dict(cache_nodes=math.ceil(0.03 * args.nodes),
                    cache_edges=math.ceil(0.03 * args.events),
                    id_space_nodes=args.nodes + 1,
                    id_space_edges=args.events + 1)
    eng = QueryEngine(pub, cfg=cfg, state=state, max_batch=64,
                      record_neighbors=True, seed=args.seed, device=dev,
                      **cache_kw)
    feed = Feed(stream, state, [eng], params)
    E = len(stream)
    tail = E - min(E // 9, 72_447)        # published while serving
    chunk = 50_000
    for lo in range(0, tail, chunk):
        feed.ingest(lo, min(lo + chunk, tail))
    snap = feed.snap
    log(f"[ingest] {tail} events in {time.perf_counter() - t0:.1f} s: "
        f"{snap.num_pages} pages x page_cap {snap.page_cap}, page table "
        f"{snap.page_table.shape}, version {snap.version}")
    t_q = float(stream.ts.max()) + 1.0
    eng.start()
    try:
        warm = make_queries(rng, stream, tail, 128, 16, t_q)
        serve(eng, feed, warm, 128)
        torch.cuda.synchronize()

        # -- phase 3: kernels against their plain versions ----------------
        rows = kernel_phase(torch, eng, feed, t_q, rng, dev, args.ab,
                            args.ab_wide)

        # -- phase 4: serve (recent) while ingest publishes the tail ------
        queries = make_queries(rng, stream, tail, 512, 128, t_q)
        runtime.reset_launch_counts()
        b0 = eng.metrics.counter("serve.batches").value
        ingest_err = []

        def _tail():
            try:
                for lo in range(tail, E, 10_000):
                    feed.ingest(lo, min(lo + 10_000, E))
            except BaseException as e:   # reported by the main thread
                ingest_err.append(e)

        th = threading.Thread(target=_tail, name="ingest")
        th.start()
        results, wall = serve(eng, feed, queries, 128)
        th.join(600)
        if th.is_alive() or ingest_err:
            raise RuntimeError(f"ingest thread failed: {ingest_err}")
        torch.cuda.synchronize()
        counts = runtime.launch_counts()
        batches = int(eng.metrics.counter("serve.batches").value - b0)
        versions = {r.version for _, r in results}
        lat = np.array([r.latency_s for _, r in results]) * 1e3
        log(f"[serve] recent: {len(results)} queries in {wall:.3f} s "
            f"({len(results) / wall:.1f} QPS), {batches} batches, "
            f"{len(versions)} versions; latency p50 "
            f"{np.percentile(lat, 50):.2f} ms p99 "
            f"{np.percentile(lat, 99):.2f} ms; launches {counts}")
        for name in ("temporal_sample_recent", "cache_gather",
                     "temporal_attn"):
            if counts.get(name, 0) <= 0:
                raise AssertionError(f"{name} never launched while serving")
        worst, n_groups = check_offline(eng, results)
        log(f"[serve] all {len(results)} responses match offline_forward "
            f"on their pinned version ({n_groups} groups): max |diff| "
            f"{worst:.3g} (tol {ATOL_SERVED})")
        for c in (eng.node_cache, eng.edge_cache):
            log(f"[serve] {c.name}: hit rate {c.hit_rate:.4f} "
                f"({c.hits}/{c.accesses}), capacity {c.capacity}")

        idle = np.array([eng.query_link([q[1]], [q[2]], [q[3]]).latency_s
                         for q in make_queries(rng, stream, E, 32, 0, t_q)])
        log(f"[serve] one query at a time: 32 link queries, latency p50 "
            f"{np.percentile(idle * 1e3, 50):.2f} ms p99 "
            f"{np.percentile(idle * 1e3, 99):.2f} ms")
        from repro_torch.core.feature_cache import FeatureCache
        probe_ids = np.unique(stream.src[:1000]).astype(np.int64)
        wide = FeatureCache(cache_kw["cache_edges"], cfg.d_edge,
                            id_space=1 << 20, device=dev)
        log(f"[serve] probe/invalidate reads slot_of to the host: "
            f"{4 * eng.edge_cache.state.slot_of.numel()} B in "
            f"{probe_ms(eng.edge_cache, probe_ids):.3f} ms (edge cache), "
            f"{4 << 20} B in {probe_ms(wide, probe_ids):.3f} ms (id space "
            f"1<<20, the engine's default)")

        busy, p_wall, split, top = device_busy(
            torch, eng, feed, make_queries(rng, stream, E, 256, 64, t_q))
        log(f"[profile] 320 queries in {p_wall:.3f} s: device busy "
            f"{busy:.4f} of the wall time; host span ms per batch {split}; "
            f"top device ops (ms): {top}")

        # -- phase 4b: the same engine on the CPU --------------------------
        cpu_params = {k: _to_cpu(v) for k, v in params.items()}
        pub_cpu = HandlePublisher(scan_pages=16, history=2, device="cpu")
        eng_cpu = QueryEngine(pub_cpu, cfg=cfg, state=state, max_batch=64,
                              record_neighbors=True, device="cpu",
                              **cache_kw)
        eng_cpu.on_publish(_Owner(cpu_params), feed.snap, None, None, None)
        if pub_cpu.current().version != pub.current().version:
            raise AssertionError("CPU engine published another version")
        par_q = make_queries(rng, stream, E, 64, 32, t_q)
        with eng_cpu:
            got_cpu, _ = serve(eng_cpu, feed, par_q, 128)
        got_gpu, _ = serve(eng, feed, par_q, 128)
        worst_c = 0.0
        for (q, a), (_, b) in zip(got_gpu, got_cpu):
            for key in a.nbrs:
                if not np.array_equal(a.nbrs[key], b.nbrs[key]):
                    raise AssertionError(f"CPU vs card hop-0 {key} differ "
                                         f"for {q}")
            x, y = (a.scores, b.scores) if q[0] == "link" else (a.emb,
                                                                 b.emb)
            worst_c = max(worst_c, float(np.abs(x - y).max()))
        if not worst_c <= ATOL_SERVED:
            raise AssertionError(f"card vs CPU engine: {worst_c}")
        log(f"[serve] card engine == CPU engine on {len(par_q)} queries: "
            f"hop-0 neighbourhoods exact, max |diff| {worst_c:.3g}")
    finally:
        eng.stop()

    # -- phase 5: uniform sampling ----------------------------------------
    cfg_u = tgat()                         # the paper's TGAT: uniform
    eng_u = QueryEngine(pub, cfg=cfg_u, state=state, max_batch=64,
                        record_neighbors=True, seed=args.seed + 1,
                        device=dev, **cache_kw)
    uq = make_queries(rng, stream, E, 128, 64, t_q)
    with eng_u:
        serve(eng_u, feed, uq[:16], 128)           # warm the caches
        runtime.reset_launch_counts()
        u_res, u_wall = serve(eng_u, feed, uq, 128)
        torch.cuda.synchronize()
        u_counts = runtime.launch_counts()
    if u_counts.get("temporal_sample_uniform", 0) <= 0:
        raise AssertionError("temporal_sample_uniform never launched")
    K = cfg_u.fanouts[0]
    checked = 0
    for q, r in u_res:
        sides = [(q[1], r.nbrs["ids"][0], r.nbrs["mask"][0],
                  r.nbrs["ts"][0])]
        if q[0] == "link":
            sides.append((q[2], r.nbrs["dst_ids"][0], r.nbrs["dst_mask"][0],
                          None))
            if not np.isfinite(r.scores).all():
                raise AssertionError("non-finite uniform score")
        for node, ids, m, ts in sides:
            cn, _, ct = feed.g.neighbors_in_window(node, -np.inf, q[-1])
            allowed = set(cn.tolist())
            if not set(ids[m].tolist()) <= allowed:
                raise AssertionError(f"uniform sampled a non-candidate "
                                     f"for node {node}")
            if ts is not None and not set(ts[m].tolist()) <= set(
                    ct.astype(np.float32).tolist()):
                raise AssertionError(f"uniform ts not a candidate ({node})")
            if int(m.sum()) != min(K, len(cn)):
                raise AssertionError(f"uniform count {int(m.sum())} != "
                                     f"min({K}, {len(cn)}) for {node}")
            checked += 1
    ulat = np.array([r.latency_s for _, r in u_res]) * 1e3
    log(f"[serve] uniform: {len(u_res)} queries in {u_wall:.3f} s "
        f"({len(u_res) / u_wall:.1f} QPS), p50 {np.percentile(ulat, 50):.2f}"
        f" ms p99 {np.percentile(ulat, 99):.2f} ms; {checked} hop-0 "
        f"neighbourhoods are oracle candidates with min(K, n) entries; "
        f"launches {u_counts}")

    per_batch = {k: v / max(batches, 1) for k, v in counts.items()}
    for r in rows:
        if r["path"].startswith("train_") or r["path"] == "widened":
            continue                       # counted by its trainer / call
        run = u_counts if r["path"] == "serve_uniform" else counts
        r["launches"] = int(run.get(r["name"], 0))
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']}: no launch on its path")
    log(f"[serve] launches per served batch (recent run): {per_batch}")
    return rows

# ---------------------------------------------------------------------------
# training phase
# ---------------------------------------------------------------------------

WARM_EVENTS = 600_000     # ingested before the first round
ROUND_EVENTS = 12_000     # events per continuous round
# one profiled round after a warm round of one batch (one epoch), so
# that the profile sees no first call of any kernel: a second full round
# took 66 s on the card, 57.8 of it TGAT's fetch-bound round, which the
# LM training phase's Nemotron-4 train step, its cut and its flash
# backward rows need (PERF.md section 6)
ROUNDS, EPOCHS = 1, 2
PARITY_EVENTS = 50_000    # prefix of the card-vs-CPU check
# one batch each, 2 train steps: float noise grows with steps (see
# card_vs_cpu)
PARITY_ROUND = {"tgn": 4_000, "tgat": 600}


def backward_row(torch, tr, dev, ab=()):
    """The temporal_attn backward kernel against the plain autograd at
    the two hop shapes of one sampled TGAT batch (hop 0: N = 3 x batch,
    hop 1: N x K), with the masks the sampler gave; random q, k, v and
    dout.  Timed beside the plain backward and the autograd backward of
    one masked ``scaled_dot_product_attention`` (a yardstick, never
    called by the port).  Returns the row at the hop-1 shape."""
    from repro_torch.kernels.temporal_attn.ops import temporal_attn
    from repro_torch.kernels.temporal_attn.ref import temporal_attn_ref

    cfg, stream = tr.cfg, tr.stream
    H, dh, K = cfg.n_heads, cfg.d_hidden // cfg.n_heads, cfg.fanouts[0]
    n = cfg.batch_size
    lo = WARM_EVENTS - n
    neg = np.random.default_rng(5).integers(0, stream.n_nodes, n)
    seeds = np.concatenate([stream.src[lo:lo + n], stream.dst[lo:lo + n],
                            neg])
    seed_ts = np.tile(stream.ts[lo:lo + n], 3).astype(np.float32)
    masks = [layer.mask.contiguous() for layer in
             tr.sampler.sample(seeds, seed_ts)]
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    F = torch.nn.functional
    row = None
    for hop, mask in enumerate(masks):
        N = mask.shape[0]
        g = torch.Generator(device=dev).manual_seed(N)
        ins = [torch.randn(shape, generator=g, device=dev).requires_grad_()
               for shape in ((N, H, dh), (N, K, H, dh), (N, K, H, dh))]
        dout = torch.randn((N, H, dh), generator=g, device=dev)
        out_k = temporal_attn(*ins, mask)
        out_p = temporal_attn_ref(*ins, mask)
        got = torch.autograd.grad(out_k, ins, dout, retain_graph=True)
        want = torch.autograd.grad(out_p, ins, dout, retain_graph=True)
        torch.cuda.synchronize()
        err = max(max_err(torch, a, b, f"temporal_attn_bwd hop {hop} {nm}")
                  for nm, a, b in zip(("dq", "dk", "dv"), got, want))
        q, kk, v = (t.detach() for t in ins)
        lib_in = [q.reshape(N * H, 1, dh)] + [
            t.permute(0, 2, 1, 3).reshape(N * H, K, dh) for t in (kk, v)]
        lib_in = [t.contiguous().requires_grad_() for t in lib_in]
        m_l = mask[:, None, :].expand(N, H, K).reshape(N * H, 1, K)
        out_l = F.scaled_dot_product_attention(*lib_in, attn_mask=m_l)
        d_l = dout.reshape(N * H, 1, dh)
        kernel = lambda: torch.autograd.grad(out_k, ins, dout,
                                             retain_graph=True)
        plain = lambda: torch.autograd.grad(out_p, ins, dout,
                                            retain_graph=True)
        library = lambda: torch.autograd.grad(out_l, lib_in, d_l,
                                              retain_graph=True)
        ms, call = timings(torch, kernel, flush)
        plain_ms, plain_call = timings(torch, plain, flush)
        lib_ms, lib_call = timings(torch, library, flush)
        nbytes = 4 * N * H * dh * ((2 * K + 2) + (2 * K + 1)) + N * K
        b, by = bound_ms(nbytes, 8.0 * N * H * K * dh + 6.0 * N * H * K)
        shape = f"N={N} H={H} Dh={dh} K={K}"
        log(f"[kernel] temporal_attn_bwd        {shape:<32} ok "
            f"max|err|={err:.3g} (tol {ATOL_KERNEL}) device ms: kernel "
            f"{ms:.4f}  plain {plain_ms:.4f}  bound {b:.4f} ({by}, "
            f"{nbytes / 1e6:.1f} MB)  library {lib_ms:.4f} ms; ms per "
            f"call: kernel {call:.4f}  plain {plain_call:.4f}  library "
            f"{lib_call:.4f}")
        row = dict(name="temporal_attn_bwd", route="cuda",
                   source="src/repro_torch/csrc/temporal_attn.cu",
                   replaces="src/repro/kernels/temporal_attn/"
                            "temporal_attn.py:21",
                   max_abs_err=err, shape=shape, ms=ms, call_ms=call,
                   plain_ms=plain_ms, plain_call_ms=plain_call,
                   bound_ms=b, bound_by=by, library_ms=lib_ms,
                   library_call_ms=lib_call)
        ab_rows(torch, row, "temporal_attn", ab, kernel, flush,
                f"temporal_attn_bwd ({shape})")
    return row


def ab_rows(torch, row, lib, ab, kernel, flush, what, close=None):
    """``row`` timed in turns against the design of ``lib``'s source in
    each directory of ``ab`` that has it (see :func:`in_turns`)."""
    for other in ab:
        if (other / f"{lib}.cu").is_file():
            row.setdefault("ab", {})[str(other)] = in_turns(
                torch, lib, other, kernel, flush, what, close)


def own_launches(torch, name, fn) -> int:
    """Launches of kernel ``name`` in one call of ``fn``, counted from 0:
    the launch count of a row at a shape that no path of this run takes
    (its instance never runs there, so the path's count is not its)."""
    from repro_torch.kernels import runtime

    runtime.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    n = runtime.launch_counts().get(name, 0)
    if n <= 0:
        raise AssertionError(f"{name}: its own call launched nothing")
    return n


class OverlapProbe:
    """How much of each train prefetch runs while the step before it is
    still on the device.  At each prefetch start a CUDA event is
    recorded; it completes when the work queued before it (the previous
    step) retires.  Its device time, against an event recorded on an
    idle device at a known host time, gives the step's end on the host
    clock, and the overlap of that prefetch is the part of its host span
    before that end."""

    def __init__(self, torch, tr):
        self.torch, self.tr = torch, tr
        self.spans = []
        torch.cuda.synchronize()
        self.zero = torch.cuda.Event(enable_timing=True)
        self.h0 = time.perf_counter()
        self.zero.record()
        stage = tr._stage_train

        def probed(item):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            p0 = time.perf_counter()
            out = stage(item)
            self.spans.append((p0, time.perf_counter(), ev))
            return out

        tr._stage_train = probed

    def close(self) -> tuple:
        """(overlapped s, prefetch s) summed over the round's prefetches."""
        del self.tr._stage_train
        self.torch.cuda.synchronize()
        over = total = 0.0
        for p0, p1, ev in self.spans:
            end = self.h0 + self.zero.elapsed_time(ev) / 1e3
            over += min(max(end - p0, 0.0), p1 - p0)
            total += p1 - p0
        return over, total


def train_runs(torch, dev, args, stream):
    """TGN and TGAT at full width on the card: ingest, a warm round of
    one batch, then ROUNDS continuous rounds.  Returns the backward kernel's row (launches
    summed over both trainers' rounds) and each trainer's launch counts
    over its rounds, by name."""
    from repro_torch.configs.tgn_gdelt import tgat, tgn
    from repro_torch.core.continuous import ContinuousTrainer
    from repro_torch.kernels import runtime

    row = None
    bwd_launches = 0
    train_counts = {}
    for cfg in (tgn(), tgat()):
        name, L = cfg.name, cfg.n_layers
        t0 = time.perf_counter()
        tr = ContinuousTrainer(cfg, stream, seed=args.seed, device=dev)
        tr.ingest(stream.slice(0, WARM_EVENTS))
        torch.cuda.synchronize()
        log(f"[train] {name} ({cfg.sampling}, batch {cfg.batch_size}, "
            f"fanouts {cfg.fanouts}): ingested {WARM_EVENTS} events in "
            f"{time.perf_counter() - t0:.1f} s; node cache "
            f"{tr.node_cache.capacity}, edge cache {tr.edge_cache.capacity}")
        if name == "tgat":
            row = backward_row(torch, tr, dev, args.ab)
        t0 = time.perf_counter()
        m = tr.train_round(stream.slice(WARM_EVENTS,
                                        WARM_EVENTS + cfg.batch_size),
                           epochs=1)
        torch.cuda.synchronize()
        if not np.isfinite(m.step_losses + [m.eval_loss]).all():
            raise AssertionError(f"{name} warm round: non-finite loss ({m})")
        log(f"[train] {name} warm round of {cfg.batch_size} events "
            f"({len(m.step_losses)} train step) in "
            f"{time.perf_counter() - t0:.1f} s")
        start = WARM_EVENTS + cfg.batch_size
        runtime.reset_launch_counts()
        steps = evals = 0
        for r in range(ROUNDS):
            lo = start + r * ROUND_EVENTS
            probe = OverlapProbe(torch, tr)
            t0 = time.perf_counter()
            if r == ROUNDS - 1:
                share, _, top, m = profiled_busy(
                    torch, lambda: tr.train_round(
                        stream.slice(lo, lo + ROUND_EVENTS), epochs=EPOCHS))
            else:
                m = tr.train_round(stream.slice(lo, lo + ROUND_EVENTS),
                                   epochs=EPOCHS)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            over, pre = probe.close()
            losses = m.step_losses + [m.eval_loss]
            if not (np.isfinite(losses).all() and 0.0 <= m.ap <= 1.0):
                raise AssertionError(f"{name} round {r}: non-finite loss "
                                     f"or bad AP ({m})")
            steps += len(m.step_losses)
            evals += math.ceil(ROUND_EVENTS / cfg.batch_size)
            busy = ""
            if r == ROUNDS - 1:
                busy = (f"; device busy {share:.4f} of the round's wall "
                        f"time; top device ops (ms): {top}")
            log(f"[train] {name} round {r}: loss {m.loss:.6f} eval loss "
                f"{m.eval_loss:.6f} AP {m.ap:.6f}; round {wall:.3f} s: "
                f"sample_s {m.sample_s:.3f} fetch_s {m.fetch_s:.3f} step_s "
                f"{m.step_s:.3f} train_s {m.train_s:.3f} ingest_s "
                f"{m.ingest_s:.3f}; hit rate node {m.node_hit_rate:.4f} "
                f"edge {m.edge_hit_rate:.4f}; {len(m.step_losses)} train "
                f"steps; prefetch {pre:.3f} s, of which {over:.3f} s "
                f"({over / max(pre, 1e-12):.4f}) overlaps the step before"
                + busy)
        torch.cuda.synchronize()
        counts = runtime.launch_counts()
        sample = f"temporal_sample_{cfg.sampling}"
        want = {"temporal_attn": (steps + evals) * L,
                "temporal_attn_bwd": steps * L}
        for k, v in want.items():
            if counts.get(k, 0) != v:
                raise AssertionError(f"{name}: {k} launched "
                                     f"{counts.get(k, 0)} times, expected {v}")
        for k in (sample, "cache_gather"):
            if counts.get(k, 0) <= 0:
                raise AssertionError(f"{name}: {k} never launched")
        bwd_launches += counts["temporal_attn_bwd"]
        train_counts[name] = counts
        per = {k: round(v / (steps + evals), 3) for k, v in counts.items()}
        log(f"[train] {name}: launches over {ROUNDS} rounds ({steps} train "
            f"+ {evals} eval steps) {counts}; per step {per}")
        del tr
    row["launches"] = bwd_launches
    return row, train_counts


def card_vs_cpu(torch, dev, args, stream):
    """One round on a PARITY_EVENTS prefix, on the card and on the CPU,
    from the same seed (TGN, TGAT with recent sampling): per-step loss,
    eval loss and AP within 1e-4, cache hit rates equal.  The rounds are
    one batch long: the two devices sum in different orders, and on
    this stream's time span the time encoding and Adam's normalised
    steps grow that float noise step by step (TGAT, recent: 6e-8 after
    2 steps, 4e-5 after 4, 1.6e-3 after 8 on an H100; ROADMAP queue 3).
    Returns the card's TGAT trainer."""
    from repro_torch.configs.tgn_gdelt import tgat, tgn
    from repro_torch.core.continuous import ContinuousTrainer

    card_tgat = None
    for cfg in (tgn(), tgat(sampling="recent")):
        n = PARITY_ROUND[cfg.name]
        out = []
        for d in (dev, "cpu"):
            t0 = time.perf_counter()
            tr = ContinuousTrainer(cfg, stream, seed=args.seed, device=d)
            tr.ingest(stream.slice(0, PARITY_EVENTS))
            m = tr.train_round(stream.slice(PARITY_EVENTS,
                                            PARITY_EVENTS + n),
                               epochs=EPOCHS)
            out.append((tr, m, time.perf_counter() - t0))
        (tr, a, t_card), (_, b, t_cpu) = out
        steps = [abs(x - y) for x, y in zip(a.step_losses, b.step_losses)]
        worst = max(steps + [abs(a.eval_loss - b.eval_loss),
                             abs(a.ap - b.ap)])
        if len(a.step_losses) != len(b.step_losses) or not \
                worst <= ATOL_SERVED:
            raise AssertionError(f"{cfg.name} card vs CPU: {a} vs {b}")
        if (a.node_hit_rate, a.edge_hit_rate) != (b.node_hit_rate,
                                                  b.edge_hit_rate):
            raise AssertionError(f"{cfg.name}: card and CPU caches differ")
        log(f"[train] card == CPU, {cfg.name} ({cfg.sampling}), one round "
            f"of {n} events after {PARITY_EVENTS}: {len(a.step_losses)} "
            f"step losses, eval loss and AP within {worst:.3g} (tol "
            f"{ATOL_SERVED}); per-step |diff| "
            f"{[float(f'{d:.3g}') for d in steps]}; eval loss |diff| "
            f"{abs(a.eval_loss - b.eval_loss):.3g}, AP |diff| "
            f"{abs(a.ap - b.ap):.3g}; card {t_card:.1f} s, CPU "
            f"{t_cpu:.1f} s")
        if cfg.name == "tgat":
            card_tgat = tr
    return card_tgat


def attached_serving(tr, hi):
    """64 link queries (among the first ``hi`` events, which ``tr`` has
    ingested) through ``QueryEngine.attach(tr)`` against
    ``offline_forward`` on their pinned version."""
    from repro_torch.serve import QueryEngine

    rng = np.random.default_rng(17)
    t_q = float(tr.stream.ts[hi - 1]) + 1.0
    queries = make_queries(rng, tr.stream, hi, 64, 0, t_q)
    with QueryEngine.attach(tr, max_batch=64, start=False) as eng:
        results, _ = serve(eng, None, queries, 128)
        worst, groups = check_offline(eng, results)
    log(f"[train] QueryEngine.attach(tgat trainer): 64 link queries match "
        f"offline_forward on version {results[0][1].version} ({groups} "
        f"group): max |diff| {worst:.3g} (tol {ATOL_SERVED})")


def train_phase(torch, dev, args, stream):
    """Phase 6; returns the backward kernel's row and each trainer's
    launch counts."""
    t0 = time.perf_counter()
    row, train_counts = train_runs(torch, dev, args, stream)
    attached_serving(card_vs_cpu(torch, dev, args, stream),
                     PARITY_EVENTS + PARITY_ROUND["tgat"])
    log(f"[train] training phase done in {time.perf_counter() - t0:.1f} s")
    return [row], train_counts


# ---------------------------------------------------------------------------
# distributed training phase
# ---------------------------------------------------------------------------

DIST = (4, 2)                 # P machines x G ranks: the reference's topology
DIST_WARM_EVENTS = WARM_EVENTS    # cut here (and say so) if the phase
#                                   ran past 240 s; never the width
DIST_ATOL_AP = 1e-3           # distributed vs single host: the reference's
#                               bands (tests/test_dist_continuous.py:73-74)
LOSSY_BAND = 0.05             # quantized / top-k vs bucketed
# the round profiled for the device's busy share: TGN's.  TGAT's 8
# workers launch so many kernels and copies that the profiler's
# averaging of them took about 120 s beside the round's 46.8 (PERF.md
# run R2), more than half the phase; phase 6 profiles single-host TGAT
DIST_PROFILED = ("tgn",)


def dist_trainer(cfg, stream, dev, args, collective="bucketed", **kw):
    from repro_torch.configs.tgn_gdelt import DistConfig
    from repro_torch.dist.continuous import DistributedContinuousTrainer
    return DistributedContinuousTrainer(
        cfg, stream, DistConfig(*DIST, collective), seed=args.seed,
        device=dev, **kw)


def dist_runs(torch, dev, args, stream):
    """TGN (recent, batch 4,000) and TGAT (uniform, batch 600) at full
    width through ``DistributedContinuousTrainer`` (P 4 x G 2,
    bucketed): DIST_WARM_EVENTS ingested, then one round of ROUND_EVENTS
    with EPOCHS epochs (profiled for the trainers in DIST_PROFILED).
    Checks the round's launch counts (the
    attention forward and backward W·L times a train step, the forward
    W·L times an eval step), the collective's accounting and the load
    CV, and prints the stage split and the traffic."""
    from repro_torch.configs.tgn_gdelt import tgat, tgn
    from repro_torch.kernels import runtime

    W = DIST[0] * DIST[1]
    for cfg in (tgn(), tgat()):
        name, L = cfg.name, cfg.n_layers
        t0 = time.perf_counter()
        tr = dist_trainer(cfg, stream, dev, args)
        tr.ingest(stream.slice(0, DIST_WARM_EVENTS))
        torch.cuda.synchronize()
        log(f"[dist] {name} ({cfg.sampling}, batch {cfg.batch_size}, P "
            f"{DIST[0]} x G {DIST[1]}): ingested {DIST_WARM_EVENTS} events "
            f"in {time.perf_counter() - t0:.1f} s; {W} sampler mirrors hold "
            f"{tr.samplers.mirror_bytes() / 1e6:.1f} MB on the card; full "
            f"re-upload {tr.full_upload_bytes() / 1e6:.1f} MB")
        lo = DIST_WARM_EVENTS
        runtime.reset_launch_counts()
        round_ = lambda: tr.train_round(stream.slice(lo, lo + ROUND_EVENTS),
                                        epochs=EPOCHS)
        if name in DIST_PROFILED:
            share, wall, top, m = profiled_busy(torch, round_)
            busy = (f"device busy {share:.4f} of the round's wall time; top "
                    f"device ops (ms): {top}")
        else:
            t1 = time.perf_counter()
            m = round_()
            torch.cuda.synchronize()
            wall, busy = time.perf_counter() - t1, "not profiled"
        counts = runtime.launch_counts()
        steps = len(m.step_losses)
        evals = math.ceil(ROUND_EVENTS / cfg.batch_size)
        losses = m.step_losses + [m.eval_loss]
        if not (np.isfinite(losses).all() and 0.0 <= m.ap <= 1.0):
            raise AssertionError(f"dist {name}: non-finite loss or bad AP "
                                 f"({m})")
        want = {"temporal_attn": (steps + evals) * W * L,
                "temporal_attn_bwd": steps * W * L}
        for k, v in want.items():
            if counts.get(k, 0) != v:
                raise AssertionError(f"dist {name}: {k} launched "
                                     f"{counts.get(k, 0)} times, expected {v}")
        for k in (f"temporal_sample_{cfg.sampling}", "cache_gather"):
            if counts.get(k, 0) <= 0:
                raise AssertionError(f"dist {name}: {k} never launched")
        if m.collective_steps != steps or m.reduce_bytes != \
                steps * tr.reduce_bytes_per_step:
            raise AssertionError(f"dist {name}: collective accounting "
                                 f"{m.collective_steps} steps, "
                                 f"{m.reduce_bytes} bytes")
        if not m.load_cv < 0.1:
            raise AssertionError(f"dist {name}: load CV {m.load_cv} "
                                 f"(>= 0.1): {tr.samplers._load.tolist()}")
        log(f"[dist] {name} round: loss {m.loss:.6f} eval loss "
            f"{m.eval_loss:.6f} AP {m.ap:.6f}; round {wall:.3f} s: sample_s "
            f"{m.sample_s:.3f} (host waits on the owners' hop results "
            f"{m.route_sync_s:.3f} s over {m.route_syncs} reads, "
            f"{m.route_sync_s / max(m.sample_s, 1e-12):.4f} of it) fetch_s "
            f"{m.fetch_s:.3f} step_s {m.step_s:.3f} train_s {m.train_s:.3f} "
            f"ingest_s {m.ingest_s:.3f}; {steps} train + {evals} eval steps; "
            f"load CV {m.load_cv:.4f} (load {tr.samplers._load.tolist()}); "
            f"dispatch {m.dispatch_bytes} B, request {m.request_bytes} B, "
            f"response {m.response_bytes} B, reduce {m.reduce_bytes} B "
            f"({tr.reduce_bytes_per_step} a step); hit rate node "
            f"{m.node_hit_rate:.4f} edge {m.edge_hit_rate:.4f}, per "
            f"partition node {list(m.node_hit_per_part)} edge "
            f"{list(m.edge_hit_per_part)}; refresh {m.refresh_bytes} B "
            f"against a full re-upload of {tr.full_upload_bytes()} B; "
            f"{busy}")
        per = {k: round(v / (steps + evals), 3) for k, v in counts.items()}
        log(f"[dist] {name}: launches over the round {counts}; per global "
            f"step {per}")
        t1 = time.perf_counter()
        dist_holds(torch, tr, stream, lo + ROUND_EVENTS)
        log(f"[dist] {name}: ingest, round and holds in "
            f"{time.perf_counter() - t0:.1f} s (the holds "
            f"{time.perf_counter() - t1:.1f})")
        del tr
        torch.cuda.empty_cache()


@contextlib.contextmanager
def hooked(module, name, hook):
    """``module.name`` replaced by a wrapper that calls the original,
    then ``hook(args, kwargs, result)``; restored on exit."""
    orig = getattr(module, name)

    def wrapper(*a, **kw):
        out = orig(*a, **kw)
        hook(a, kw, out)
        return out

    setattr(module, name, wrapper)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


def scaled_err(torch, got, want, what) -> float:
    """max |got - want| against ATOL_KERNEL x max(1, max |want|)."""
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    return max_err(torch, got, want, what, ATOL_KERNEL * scale) / scale


def dist_holds(torch, tr, stream, lo):
    """Every kernel of the distributed path against its plain version on
    the inputs that one more global step of ``tr`` (the events from
    ``lo``) gives it: each routed, pow2-padded owner bucket of the
    sampler (the uniform one with the request-keyed noise the kernel got,
    against both the kernel's plain version and the sampler's own
    ``_hop_plain``), each ``cache_gather`` of every worker's fetch, and
    each worker's attention forward and, with a random upstream gradient,
    backward.  Ids, masks and gathered rows exact; floats within
    ATOL_KERNEL of max(1, max |plain|).  Runs after the round's launch
    counts were read: these launches count nowhere."""
    from repro_torch.core import feature_cache, sampling
    from repro_torch.kernels.cache_gather.ref import cache_gather_ref
    from repro_torch.kernels.temporal_attn.ref import temporal_attn_ref
    from repro_torch.kernels.temporal_sample.ref import (
        temporal_sample_ref, temporal_sample_uniform_ref)
    from repro_torch.models import gnn

    cfg, dist = tr.cfg, tr.dist
    name, B = cfg.name, cfg.batch_size
    keys = ("page_table", "page_tmin", "page_tmax", "pages_nbr",
            "pages_eid", "pages_ts", "pages_valid")
    seen = {"sample": 0, "padded": 0, "gather": 0, "gather_ids": 0}
    sizes = {"sample": set(), "attn": set()}
    attn_calls = []

    def by_eid(r):
        o = torch.sort(r[1], dim=1, stable=True).indices
        return r[0].gather(1, o), r[1].gather(1, o), r[2].gather(1, o), r[3]

    def hold_sample(a, kw, out):
        pages, hop = a[:7], a[7:11]
        k, scan, policy = kw["k"], kw["scan"], kw["policy"]
        plain_pages = (pages[0][:, :scan].contiguous(),) + tuple(pages[1:])
        if policy == "uniform":
            want = temporal_sample_uniform_ref(*plain_pages, *hop,
                                               kw["noise"], k=k)
        else:
            want = temporal_sample_ref(*plain_pages, *hop, k=k)
        also = sampling._hop_plain(dict(zip(keys, pages)), *hop,
                                   kw["noise"], k=k, policy=policy,
                                   scan_pages=scan)
        torch.cuda.synchronize()
        what = f"dist {name} temporal_sample_{policy} N={hop[0].shape[0]}"
        if policy == "uniform":
            # _hop_plain lists a row's picks in newest-first lane order,
            # the kernel in noise order: held row by row, sorted by eid
            checks = ((out, want, "plain"),
                      (by_eid(out), by_eid(also),
                       "_hop_plain, rows sorted by eid"))
        else:
            checks = ((out, want, "plain"), (out, also, "_hop_plain"))
        for got, ref, tag in checks:
            for i, f in ((0, "nbr"), (1, "eid"), (3, "mask")):
                assert_equal(torch, got[i], ref[i], f"{what} {f} ({tag})")
            max_err(torch, got[2], ref[2], f"{what} ts ({tag})")
        seen["sample"] += 1
        seen["padded"] += int(not bool(hop[3].all()))
        sizes["sample"].add(int(hop[0].shape[0]))

    def hold_gather(a, kw, out):
        want = cache_gather_ref(*a)
        torch.cuda.synchronize()
        what = f"dist {name} cache_gather N={a[3].shape[0]}"
        assert_equal(torch, out[1], want[1], f"{what} hit")
        assert_equal(torch, out[0], want[0], f"{what} rows")
        seen["gather"] += 1
        seen["gather_ids"] += int(a[3].shape[0])

    def record_attn(a, kw, out):
        q, k, v, mask = a
        with torch.no_grad():
            want = temporal_attn_ref(q, k, v, mask)
        scaled_err(torch, out.detach(), want,
                   f"dist {name} temporal_attn N={q.shape[0]}")
        attn_calls.append([t.detach().clone() for t in a])

    src, dst, ts = (np.asarray(x[lo:lo + B])
                    for x in (stream.src, stream.dst, stream.ts))
    with hooked(sampling, "temporal_sample", hold_sample), \
            hooked(feature_cache, "cache_gather", hold_gather):
        staged = tr._stage_shards(src, dst, ts, micros=dist.grad_accum)
        shards = tr._sharded_batch(staged)
    with hooked(gnn, "temporal_attn", record_attn) as temporal_attn:
        tr._dist_step(tr.params, tr.opt_state, shards, tr.err)
    want_calls = dist.n_workers * dist.grad_accum * cfg.n_layers
    if len(attn_calls) != want_calls or not (seen["sample"]
                                             and seen["padded"]
                                             and seen["gather"]):
        raise AssertionError(f"dist {name} holds: {len(attn_calls)} "
                             f"attention calls (expected {want_calls}), "
                             f"{seen}")
    bwd = 0.0
    for q, k, v, mask in attn_calls:
        ins = [t.requires_grad_() for t in (q, k, v)]
        g = torch.Generator(device=q.device).manual_seed(q.shape[0])
        dout = torch.randn(q.shape, generator=g, device=q.device)
        got = torch.autograd.grad(temporal_attn(*ins, mask), ins, dout)
        want = torch.autograd.grad(temporal_attn_ref(*ins, mask), ins, dout)
        torch.cuda.synchronize()
        for nm, x, y in zip(("dq", "dk", "dv"), got, want):
            bwd = max(bwd, scaled_err(
                torch, x, y, f"dist {name} temporal_attn_bwd "
                             f"N={q.shape[0]} {nm}"))
        sizes["attn"].add(tuple(mask.shape))
    log(f"[dist] {name} kernels against their plain versions on one more "
        f"global step's inputs: {seen['sample']} routed sampler buckets "
        f"(N {sorted(sizes['sample'])}; {seen['padded']} with a padded "
        f"tail) equal to the plain version and to _hop_plain; "
        f"{seen['gather']} cache_gather calls ({seen['gather_ids']} ids) "
        f"equal; {len(attn_calls)} attention forwards and backwards at "
        f"(N, K) {sorted(sizes['attn'])}, backward max |err| / max(1, "
        f"max |grad|) {bwd:.3g} (tol {ATOL_KERNEL})")


def dist_round(cfg, stream, dev, args, trainer=None, **kw):
    """(trainer, metrics, load matrix, s): one PARITY_ROUND-event round
    after PARITY_EVENTS, by the distributed trainer or ``trainer``."""
    t0 = time.perf_counter()
    tr = trainer(cfg, stream, seed=args.seed, device=dev) if trainer \
        else dist_trainer(cfg, stream, dev, args, **kw)
    tr.ingest(stream.slice(0, PARITY_EVENTS))
    n = PARITY_ROUND[cfg.name]
    m = tr.train_round(stream.slice(PARITY_EVENTS, PARITY_EVENTS + n),
                       epochs=EPOCHS)
    load = tr.samplers.load_stats().per_worker_targets if not trainer \
        else None
    return tr, m, load, time.perf_counter() - t0


def dist_checks(torch, dev, args, stream):
    """The distributed trainer on the card against itself on the CPU
    and against the single-host trainer on the card (TGN and TGAT with
    recent sampling, one-batch rounds); sharded against replicated
    state; the lossy collectives against the exact one; and the uniform
    sampler's request-keyed draws and their containment."""
    from repro_torch.configs.tgn_gdelt import tgat, tgn
    from repro_torch.core.continuous import ContinuousTrainer

    card = {}
    for cfg in (tgn(), tgat(sampling="recent")):
        tr, a, load_a, t_card = dist_round(cfg, stream, dev, args)
        _, b, load_b, t_cpu = dist_round(cfg, stream, "cpu", args)
        _, c, _, _ = dist_round(cfg, stream, dev, args,
                                trainer=ContinuousTrainer)
        card[cfg.name] = (tr, a)
        diffs = [abs(x - y) for x, y in zip(a.step_losses, b.step_losses)]
        worst = max(diffs + [abs(a.eval_loss - b.eval_loss),
                             abs(a.ap - b.ap)])
        if len(a.step_losses) != len(b.step_losses) or not \
                worst <= ATOL_SERVED:
            raise AssertionError(f"dist {cfg.name} card vs CPU: {a} vs {b}")
        for key in ("request_bytes", "response_bytes", "node_hit_per_part",
                    "edge_hit_per_part", "node_hit_rate", "edge_hit_rate"):
            if getattr(a, key) != getattr(b, key):
                raise AssertionError(f"dist {cfg.name}: {key} differs "
                                     f"between the card and the CPU")
        if not np.array_equal(load_a, load_b):
            raise AssertionError(f"dist {cfg.name}: load matrices differ")
        single = max([abs(x - y) for x, y in zip(a.step_losses,
                                                  c.step_losses)]
                     + [abs(a.loss - c.loss)])
        if len(a.step_losses) != len(c.step_losses) or not (
                single <= ATOL_SERVED and abs(a.ap - c.ap) <= DIST_ATOL_AP):
            raise AssertionError(f"dist {cfg.name} vs single host: {a} vs "
                                 f"{c}")
        log(f"[dist] card == CPU, {cfg.name} ({cfg.sampling}), one round "
            f"of {PARITY_ROUND[cfg.name]} events after {PARITY_EVENTS}: "
            f"{len(diffs)} step losses, eval loss and AP within "
            f"{worst:.3g} (tol {ATOL_SERVED}); load, request and response "
            f"bytes and per-partition hit rates equal; card {t_card:.1f} s, "
            f"CPU {t_cpu:.1f} s.  Against the single-host trainer on the "
            f"card: loss within {single:.3g} (tol {ATOL_SERVED}), AP "
            f"|diff| {abs(a.ap - c.ap):.3g} (tol {DIST_ATOL_AP})")

    # sharded state against replicated (TGN), on the card
    t0 = time.perf_counter()
    rep_tr, rep = card["tgn"]
    shd_tr, shd, _, _ = dist_round(tgn(), stream, dev, args,
                                   state="sharded")
    diff = max(abs(x - y) for x, y in zip(rep.step_losses + [rep.eval_loss],
                                          shd.step_losses + [shd.eval_loss]))
    total = rep_tr.state.resident_bytes()
    per = [shd_tr.state.shard_bytes(p) / total for p in range(DIST[0])]
    if not (diff <= ATOL_SERVED and shd_tr.state.resident_bytes() == total
            and all(0.15 <= r <= 0.35 for r in per)):
        raise AssertionError(f"dist sharded vs replicated: |diff| {diff}, "
                             f"shares {per}")
    log(f"[dist] sharded == replicated state, tgn: losses within "
        f"{diff:.3g} (tol {ATOL_SERVED}); each machine's shard holds "
        f"{[round(r, 4) for r in per]} of the replicated {total} B; "
        f"{shd.state_calls} modeled state calls, {shd.state_bytes} B")

    # the lossy collectives against the exact one (TGAT, recent)
    exact_tr, exact = card["tgat"]
    for mode in ("quantized", "topk"):
        tr, m, _, _ = dist_round(tgat(sampling="recent"), stream, dev, args,
                                 collective=mode)
        d = max(abs(x - y) for x, y in zip(exact.step_losses,
                                           m.step_losses))
        ratio = 3 if mode == "quantized" else 1
        smaller = (tr.reduce_bytes_per_step * ratio
                   < exact_tr.reduce_bytes_per_step)
        if not (np.isfinite(m.step_losses).all() and d <= LOSSY_BAND
                and smaller):
            raise AssertionError(f"dist {mode}: loss |diff| {d}, "
                                 f"{tr.reduce_bytes_per_step} B a step")
        log(f"[dist] {mode} collective: step losses within {d:.3g} of "
            f"bucketed (band {LOSSY_BAND}); {tr.reduce_bytes_per_step} B a "
            f"step a worker against {exact_tr.reduce_bytes_per_step}")
    t1 = time.perf_counter()
    uniform_keyed(torch, dev, args, stream)
    log(f"[dist] sharded and lossy rounds {t1 - t0:.1f} s, uniform "
        f"{time.perf_counter() - t1:.1f} s")


def uniform_keyed(torch, dev, args, stream):
    """Two DistributedSamplerSystems on the card over the PARITY_EVENTS
    prefix (TGAT's uniform fanouts), fed the same requests in two worker
    orders: identical samples; every hop-0 pick an in-window candidate
    of the whole graph, min(K, n) of them."""
    from repro_torch.configs.tgn_gdelt import tgat
    from repro_torch.core.dgraph import DynamicGraph
    from repro_torch.core.partition import Dispatcher, GraphPartition
    from repro_torch.core.scheduler import DistributedSamplerSystem
    from repro_torch.kernels import runtime

    cfg = tgat()
    P, G = DIST
    ev = (stream.src[:PARITY_EVENTS], stream.dst[:PARITY_EVENTS],
          stream.ts[:PARITY_EVENTS])
    whole = DynamicGraph(threshold=64, undirected=True)
    whole.add_edges(*ev)
    rng = np.random.default_rng(args.seed + 3)
    n = 3 * 75                    # one worker's shard of a 600-event batch
    reqs = {(m, r): (rng.integers(0, stream.n_nodes, n),
                     rng.uniform(ev[2][-1] / 2, ev[2][-1] + 1, n)
                     .astype(np.float32))
            for m in range(P) for r in range(G)}
    order = sorted(reqs)
    runs = []
    runtime.reset_launch_counts()
    for workers in (order, order[::-1]):
        parts = [GraphPartition(p, P, threshold=64) for p in range(P)]
        Dispatcher(parts, undirected=True).add_edges(*ev)
        system = DistributedSamplerSystem(parts, G, cfg.fanouts,
                                          policy="uniform", seed=args.seed,
                                          device=dev)
        runs.append({w: system.sample(*w, *reqs[w]) for w in workers})
        del system
    launched = runtime.launch_counts().get("temporal_sample_uniform", 0)
    if launched <= 0:
        raise AssertionError("uniform: the distributed sampler never "
                             "launched its kernel")
    K = cfg.fanouts[0]
    checked = 0
    for w in order:
        for la, lb in zip(runs[0][w], runs[1][w]):
            for f in ("nbr_ids", "nbr_eids", "nbr_ts", "mask"):
                if not np.array_equal(getattr(la, f), getattr(lb, f)):
                    raise AssertionError(f"uniform {w}: {f} depends on the "
                                         f"order of requests")
        hop0 = runs[0][w][0]
        for i, node in enumerate(reqs[w][0]):
            cn, ce, _ = whole.neighbors_in_window(int(node), -np.inf,
                                                  float(reqs[w][1][i]))
            got = hop0.nbr_eids[i][hop0.mask[i]]
            if not set(got.tolist()) <= set(ce.tolist()):
                raise AssertionError(f"uniform sampled a non-candidate for "
                                     f"node {node}")
            if len(got) != min(K, len(cn)):
                raise AssertionError(f"uniform count {len(got)} != min({K},"
                                     f" {len(cn)}) for node {node}")
            checked += 1
    log(f"[dist] uniform: two systems fed {len(order)} workers' requests in "
        f"opposite orders drew identical samples; {checked} hop-0 "
        f"neighbourhoods are candidates of the whole graph with min(K, n) "
        f"entries; {launched} uniform launches")


def dist_phase(torch, dev, args, stream):
    """Phase 7: the distributed continuous trainer."""
    t0 = time.perf_counter()
    dist_runs(torch, dev, args, stream)
    t1 = time.perf_counter()
    dist_checks(torch, dev, args, stream)
    log(f"[dist] distributed training phase done in "
        f"{time.perf_counter() - t0:.1f} s (the runs {t1 - t0:.1f}, the "
        f"checks {time.perf_counter() - t1:.1f})")


# ---------------------------------------------------------------------------
# multihost phase
# ---------------------------------------------------------------------------

MH_WARM_EVENTS = 50_000       # cut here first (and say so) if the phase
MH_ROUND_EVENTS = ROUND_EVENTS  # ran past 240 s, then the round; never
#                                 the width, P·G or the batch
MH_ATOL_LOSS = 1e-4           # fleet vs in-process: the reference's bands
MH_ATOL_AP = 1e-3             # (tests/test_multihost.py:88-117)
MH_AGREE = 1e-6               # worker vs worker
MH_TRACE_CAPACITY = 262_144   # span ring per thread of each worker
MH_RUNS = (("tgn", "sharded"), ("tgat", "replicated"))


def span_seconds(trace, names) -> dict:
    """pid -> seconds in the merged fleet ``trace``'s spans of ``names``."""
    out: dict = {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X" and ev["name"] in names:
            out[ev["pid"]] = out.get(ev["pid"], 0.0) + ev["dur"] / 1e6
    return out


def mh_run_cfg(args, name, state):
    """One round at phase 6's full width on the phase-2 stream, P 4 x
    G 2 (``DIST``), bucketed, as the workers and the in-process trainer
    read it."""
    return {"model": name, "model_kw": {},
            "stream": dict(n_nodes=args.nodes, n_events=args.events,
                           d_node=128, d_edge=172, seed=args.seed),
            "dist": {"collective": "bucketed"},
            "trainer": {"seed": args.seed, "state": state},
            "warm": MH_WARM_EVENTS, "round_size": MH_ROUND_EVENTS,
            "rounds": 1, "epochs": EPOCHS}


def mh_fleet(torch, dev, args, name, state, out_dir):
    """(results, merged trace, s): the P-process fleet on the card, each
    worker tracing its spans; the merged trace is written to
    ``out_dir``."""
    from repro_torch.launch import multihost
    from repro_torch.obs.trace import load_trace

    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    outs = multihost.launch(
        *DIST, run_cfg=mh_run_cfg(args, name, state), device=dev.type,
        extra_env={"REPRO_TRACE": str(MH_TRACE_CAPACITY),
                   "REPRO_MH_TRACE_DIR": str(out_dir)},
        timeout_s=600.0)
    results = multihost.parse_results(outs)
    merged = multihost.collect_fleet_trace(
        results, str(out_dir / f"mh_trace_{name}.json"))
    if merged is None:
        raise AssertionError(f"multihost {name}: no worker trace")
    return results, load_trace(merged), time.perf_counter() - t0


def mh_inprocess(torch, dev, args, name, state):
    """(trainer, round metrics, round wall s) of the same schedule
    through the in-process trainer on the card (peak memory counted
    from here)."""
    from repro_torch.dist.continuous import DistributedContinuousTrainer
    from repro_torch.launch import multihost

    run_cfg = mh_run_cfg(args, name, state)
    cfg, stream, dist, kw = multihost.build_run(run_cfg, *DIST)
    torch.cuda.reset_peak_memory_stats(dev)
    tr = DistributedContinuousTrainer(cfg, stream, dist, device=dev, **kw)
    walls: list = []
    [m] = multihost.run_rounds(run_cfg, tr, stream, walls)
    torch.cuda.synchronize()
    return tr, m, walls[0]


def mh_checks(name, state, cfg, results, trace, ref_tr, ref):
    """Every check of the multihost phase on one fleet run; returns the
    largest fleet-vs-in-process gaps (loss, AP)."""
    P, G = DIST
    L = cfg.n_layers
    if len(results) != P:
        raise AssertionError(f"multihost {name}: {len(results)} results")
    rounds = [r["rounds"][0] for r in results]
    steps = len(ref.step_losses)
    evals = math.ceil(MH_ROUND_EVENTS / cfg.batch_size)
    for r, rd in zip(results, rounds):
        w = r["process_id"]
        if len(rd["step_losses"]) != steps:
            raise AssertionError(f"multihost {name} worker {w}: "
                                 f"{len(rd['step_losses'])} steps, "
                                 f"in-process {steps}")
        agree = max(abs(a - b) for a, b in zip(
            rd["step_losses"] + [rd["eval_loss"]],
            rounds[0]["step_losses"] + [rounds[0]["eval_loss"]]))
        if not agree <= MH_AGREE:
            raise AssertionError(f"multihost {name}: worker {w} differs "
                                 f"from worker 0 by {agree}")
        if not (rd["rpc_calls"] > 0 and rd["rpc_wire_bytes"] > 0):
            raise AssertionError(f"multihost {name} worker {w}: no RPC "
                                 f"traffic in the round")
        n = r["launches"]
        want = {"temporal_attn": (steps + evals) * G * L,
                "temporal_attn_bwd": steps * G * L}
        for k, v in want.items():
            if n.get(k, 0) != v:
                raise AssertionError(f"multihost {name} worker {w}: {k} "
                                     f"launched {n.get(k, 0)} times, "
                                     f"expected {v}")
        for k in (f"temporal_sample_{cfg.sampling}", "cache_gather"):
            if n.get(k, 0) <= 0:
                raise AssertionError(f"multihost {name} worker {w}: {k} "
                                     f"never launched")
        if state == "sharded":
            ss = r["state"]
            share = ss["resident_bytes"] / ref_tr.state.resident_bytes()
            if not (ss["wire_calls"] > 0 and ss["served_calls"] > 0
                    and rd["state_pf_hits"] > 0
                    and rd["state_stale_served"] == 0
                    and 0.15 <= share <= 0.35):
                raise AssertionError(f"multihost {name} worker {w}: state "
                                     f"{ss}, round pf hits "
                                     f"{rd['state_pf_hits']}, stale "
                                     f"{rd['state_stale_served']}, share "
                                     f"{share}")
    got = rounds[0]
    loss_gap = max(abs(a - b) for a, b in zip(
        got["step_losses"] + [got["eval_loss"]],
        ref.step_losses + [ref.eval_loss]))
    ap_gap = abs(got["ap"] - ref.ap)
    if not (loss_gap <= MH_ATOL_LOSS and ap_gap <= MH_ATOL_AP):
        raise AssertionError(f"multihost {name}: fleet vs in-process loss "
                             f"{loss_gap}, AP {ap_gap}")
    for kind in ("rpc.call", "rpc.serve", "barrier"):
        lanes = span_seconds(trace, {kind})
        if sorted(lanes) != list(range(P)):
            raise AssertionError(f"multihost {name}: {kind} spans in lanes "
                                 f"{sorted(lanes)}, expected {P}")
    return loss_gap, ap_gap


def multihost_phase(torch, dev, args):
    """Phase 8: ``repro_torch.launch.multihost`` on the card, P 4 worker
    processes x G 2, against the in-process trainer on the same events."""
    t0 = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "mh_trace"
    P, G = DIST
    for name, state in MH_RUNS:
        results, trace, t_fleet = mh_fleet(torch, dev, args, name, state,
                                           out_dir)
        t1 = time.perf_counter()
        ref_tr, ref, ref_wall = mh_inprocess(torch, dev, args, name, state)
        t_ref = time.perf_counter() - t1
        cfg = ref_tr.cfg
        loss_gap, ap_gap = mh_checks(name, state, cfg, results, trace,
                                     ref_tr, ref)
        bar = span_seconds(trace, {"barrier"})
        coll = span_seconds(trace, {"all_gather"})
        got = results[0]["rounds"][0]
        workers = trace["metadata"]["workers"]
        log(f"[multihost] {name} ({cfg.sampling}, batch {cfg.batch_size}, "
            f"state {state}), {P} processes x G {G} after {MH_WARM_EVENTS} "
            f"events, one round of {MH_ROUND_EVENTS} ({EPOCHS} epochs): "
            f"workers agree within {MH_AGREE}; fleet vs in-process: step "
            f"and eval losses within {loss_gap:.3g} (tol {MH_ATOL_LOSS}), "
            f"AP {ap_gap:.3g} (tol {MH_ATOL_AP}); loss {got['loss']:.6f} "
            f"eval loss {got['eval_loss']:.6f} AP {got['ap']:.6f}; fleet "
            f"launch {t_fleet:.1f} s, in-process {t_ref:.1f} s")
        for r in results:
            w, rd = r["process_id"], r["rounds"][0]
            st = r["state"]
            log(f"[multihost] {name} worker {w}: round "
                f"{r['round_walls'][0]:.3f} s: sample_s {rd['sample_s']:.3f} "
                f"fetch_s {rd['fetch_s']:.3f} step_s {rd['step_s']:.3f} "
                f"ingest_s {rd['ingest_s']:.3f} train_s {rd['train_s']:.3f}; "
                f"rpc {rd['rpc_calls']} calls, {rd['rpc_wire_bytes']} B, "
                f"wait {rd['rpc_wait_s']:.3f} s; state wait "
                f"{rd['state_wait_s']:.3f} s ({rd['state_round_trips']} "
                f"trips, pf hits {rd['state_pf_hits']}, stale "
                f"{rd['state_stale_served']}, resident "
                f"{st['resident_bytes']} B, served {st['served_calls']}); "
                f"barriers {bar.get(w, 0.0):.3f} s, collectives "
                f"{coll.get(w, 0.0):.3f} s (trace); peak device memory "
                f"{r['peak_device_bytes'] / 1e9:.3f} GB; launches "
                f"{r['launches']}; dropped spans "
                f"{workers[str(w)].get('dropped_events')}")
        log(f"[multihost] {name} in-process (P {P} x G {G}, one process): "
            f"round {ref_wall:.3f} s: sample_s {ref.sample_s:.3f} fetch_s "
            f"{ref.fetch_s:.3f} step_s {ref.step_s:.3f} ingest_s "
            f"{ref.ingest_s:.3f} train_s {ref.train_s:.3f}; resident "
            f"{ref_tr.state.resident_bytes()} B; peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
        del ref_tr
        torch.cuda.empty_cache()
    log(f"[multihost] multihost phase done in "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# LM serving phase
# ---------------------------------------------------------------------------

LM_ARCHS = ("yi-6b", "falcon-mamba-7b")
# served after Yi and Falcon (the LM training phase trains them too):
# the moe archs cut in depth (qwen3-moe's bf16 tree takes 5 GB a layer),
# zamba2 whole, nemotron-4 at full width cut to 4 layers (3.45 B
# parameters a layer and 2 x 4.72 B of untied embedding and head: a
# 46.5 GB bf16 tree)
LM_SERVE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e",
                  "zamba2-2.7b", "nemotron-4-340b")
LM_SERVE_DEPTH = {"qwen3-moe-235b-a22b": 8, "llama4-scout-17b-a16e": 8,
                  "nemotron-4-340b": 4}
LM_PREFILL = (2, 4096)        # prompts x tokens (prefill_32k: 32 x 32,768)
LM_DECODE = {"yi-6b": 8, "falcon-mamba-7b": 2, "qwen3-moe-235b-a22b": 8,
             "llama4-scout-17b-a16e": 8, "zamba2-2.7b": 8,
             "nemotron-4-340b": 8}                          # sequences
LM_DECODE_STEPS = 32          # (decode_32k: 128 x 32,768)
LM_CUT = (2, 2, 256)          # layers, B, S of the card-vs-CPU checks
# the moe archs' cut holds a 15-17 GB float32 layer on the host; zamba2's
# is one superlayer; nemotron-4's one layer with its vocabulary cut
# (LM_CUT_VOCAB)
LM_CUT_OF = {"qwen3-moe-235b-a22b": (1, 1, 128),
             "llama4-scout-17b-a16e": (1, 1, 128), "zamba2-2.7b": (6, 2, 256),
             "nemotron-4-340b": (1, 1, 128)}
# the cut's vocabulary, where it is cut: nemotron-4's untied embedding and
# head of 256,000 x 18,432 would add 37.7 GB of float32 to its 13.8 GB
# layer on the host; at 4,096 the cut holds 14.4 GB there (width, heads
# and d_ff stay full)
LM_CUT_VOCAB = {"nemotron-4-340b": 4096}
# the moe archs' prefill against token-by-token decode: a length at which
# the prefill cannot drop a slot (a token's k experts are distinct, so an
# expert gets at most S slots a row, and capacity is at least 4; asserted).
# A random-init layer routes a short prompt's tokens alike, so 8 tokens
# can already overflow a capacity of 4
MOE_DECODE_S = 4
# the LM training phase's card-vs-CPU train step: Yi's and Falcon's cut
# to one layer (the serving checks' two), so that the host's passes over
# a second layer do not push the script past 1,000 s beside the process
# mesh part.  Yi's at B 2, the one train cut with a second batch row
# (the loss's batch chunks under remat, positions, the kernels' batch
# strides on the model path); Falcon's and Zamba2's at B 1 (their host
# bf16 passes took 14.6-16.8 s each at B 2), beside Nemotron-4's cut
# (PERF.md section 6)
LM_TRAIN_CUT_OF = dict(LM_CUT_OF, **{"yi-6b": (1, 2, 256),
                                     "falcon-mamba-7b": (1, 1, 256),
                                     "zamba2-2.7b": (6, 1, 256)})
# a token routed differently by two bf16 runs must be a near-tie: each
# expert one run picked within 2^-5 of the other's k-th router log-prob
# (the log-probs differ as the logits do: 4 bf16 ulps of a logit in
# [1, 2), where the top-k boundary of N(0, 1) logits sits)
NEAR_TIE = 2 ** -5
# bf16 logits, card vs CPU: 1.6 bf16 ulps at the logits' magnitude of 4-5
# (one ulp is 0.031 in [4, 8))
ATOL_LOGITS = 5e-2
# zamba2's cut (5 Mamba-2 blocks and the shared block) rounds more: on an
# H100 (``python tests/test_torch_cuda.py logits``, 4 seeds) its sound
# prefill and decode logits read 0.039-0.0625 card vs CPU, and 0.209-0.477
# with the newest key hidden from the card's decode attention; the CPU
# tests' port-vs-JAX bar of 0.1 sits between
ATOL_LOGITS_OF = {"zamba2-2.7b": 0.1}
ATOL_DECODE = 0.15            # prefill vs decode (tests/test_lm_smoke.py)
# the mesh part: Qwen3-MoE's 8-layer tree served under a (data 1, model 4)
# local mesh with default_rules(): context-parallel attention and
# expert-parallel moe over 4 logical shards on the one card
MESH_ARCH = "qwen3-moe-235b-a22b"
MESH = (1, 4)
# each shard's float32 score block 2 x 64 x 2,048 x 8,192 x 4 B = 8.6e9 B,
# past the 5e9 budget: the blocked branch, flash at 4 offsets a layer
MESH_PREFILL = (2, 8192)
MESH_DIRECT = (2, 4096)       # 2.1e9 B: the direct branch, no flash launch
MESH_DECODE_STEPS = 4
# head dims whose arch row is also timed in turns with the general
# flash_attention instance: 80, which the Hopper instance takes through
# its 16-column tail box, and 192, through its 112-key tiles
FLASH_TURNS_HEAD_DIMS = (80, 192)
# the largest float32 score block (B Hq Sq Skv x 4 B; qwen3-moe's prefill
# row) whose plain forward runs whole beside the kernel's output; past it
# (nemotron-4's 12.9 GB) the plain version runs one batch row at a time
PLAIN_FWD_WHOLE_SCORES = 2 ** 33


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def tree_leaf_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_leaf_count(v) for v in tree.values())
    return 1


def lm_serve(torch, dev, args, cfg, measured=None):
    """Init, prefill and decode at full size; returns the kernel's launch
    count over the prefill and the decode, and the compute tree.  For an
    arch of ``DRYRUN_OF``, its prefill's readings go into ``measured``
    (the dry-run phase's): the tree's and the tokens' bytes, the memory
    they hold and the prefill's peak above what was allocated before the
    init, the launches and the time."""
    from repro_torch.kernels import runtime
    from repro_torch.models import lm_zoo as Z
    from repro_torch.models import transformer_lm as T

    kernel = "selective_scan" if cfg.family == "ssm" else "flash_attention"
    launches = T.attention_layers(cfg) or cfg.n_layers
    via = ""
    if kernel == "flash_attention":   # every served arch's heads: Hopper's
        from repro_torch.kernels.flash_attention.ops import instance
        inst = instance(torch.bfloat16, cfg.head_dim_)
        if inst != "sm90":
            raise AssertionError(f"{cfg.name}: its prefill attention takes "
                                 f"the {inst} instance")
        via = f" ({inst} instance)"
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if cfg.name in LM_SERVE_ARCHS:
        # straight to bf16; the router and Mamba-2's A_log, D, dt_bias f32
        cp = Z.init_params(cfg, gen, torch.bfloat16, device=dev)
    else:
        params = Z.init_params(cfg, gen, device=dev)
        cp = Z._cast_compute(params)      # cast once; drop the masters
        del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
        f"{cfg.vocab}: init + bf16 cast {time.perf_counter() - t0:.1f} s, "
        f"compute tree {tree_bytes(cp) / 1e9:.2f} GB")

    B, S = LM_PREFILL
    rng = np.random.default_rng(args.seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32)).to(dev)
    args_allocated = torch.cuda.memory_allocated() - base
    prefill, serve = Z.make_prefill_step(cfg), Z.make_serve_step(cfg)
    prefill(cp, {"tokens": toks})                      # warm-up
    drops = ""
    if cfg.moe is not None:      # the prefill's aux, from its forward_hidden
        x = T.embed_input(cfg, cp, {"tokens": toks})
        aux = T.forward_hidden(cfg, cp, x, torch.arange(S, device=dev)[
            None].expand(B, S))[1]
        drops = (f", moe_drop_frac {float(aux['moe_drop_frac']):.6f} "
                 f"(moe_lb_loss {float(aux['moe_lb_loss']):.6f})")
        del x, aux
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    logits, st = prefill(cp, {"tokens": toks})
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    counts = runtime.launch_counts()
    if counts != {kernel: launches}:
        raise AssertionError(f"{cfg.name} prefill launched {counts}, "
                             f"expected {{{kernel!r}: {launches}}}")
    if tuple(logits.shape) != (B, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: bad prefill logits")
    pre_peak = torch.cuda.max_memory_allocated()
    if measured is not None and (cfg.name, "prefill") in DRYRUN_OF:
        measured[cfg.name, "prefill"] = {
            "args": tree_bytes(cp) + toks.numel() * toks.element_size(),
            "allocated": args_allocated, "peak": pre_peak - base,
            "leaves": tree_leaf_count(cp) + 1, "launches": counts,
            "ms": pre_s * 1e3, "depth": cfg.n_layers, "B": B, "S": S}

    Bd = LM_DECODE[cfg.name]
    if cfg.family == "ssm":          # the prefill state continues
        dstate, tok = st, logits.argmax(-1, keepdim=True).to(torch.int32)
    else:                            # a dense prefill's K/V are S long
        del st
        dstate = T.init_decode_state(cfg, Bd, S, device=dev)
        tok = toks[:1, :Bd].reshape(Bd, 1).contiguous()
    torch.cuda.reset_peak_memory_stats()
    step_ms, outs = [], []
    for _ in range(LM_DECODE_STEPS):
        t0 = time.perf_counter()
        out, dstate = serve(cp, dstate, tok)
        tok = out.argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    dec_peak = torch.cuda.max_memory_allocated()
    counts = runtime.launch_counts()
    if counts != {kernel: launches}:
        raise AssertionError(f"{cfg.name}: launches over prefill + decode "
                             f"{counts}")
    if not bool(torch.isfinite(torch.stack(outs)).all()):
        raise AssertionError(f"{cfg.name}: non-finite decode logits")
    if int(dstate["pos"][0]) != (S if cfg.family == "ssm" else 0) \
            + LM_DECODE_STEPS:
        raise AssertionError(f"{cfg.name}: decode position wrong")
    med = float(np.median(step_ms))
    busy = profiled_busy(torch, lambda: prefill(cp, {"tokens": toks}))
    state = [dstate, tok]

    def steps():
        for _ in range(8):
            o, state[0] = serve(cp, state[0], state[1])
            state[1] = o.argmax(-1, keepdim=True).to(torch.int32)
    d_busy = profiled_busy(torch, steps)
    log(f"[lm] {cfg.name} prefill {B} x {S}: {pre_s * 1e3:.1f} ms "
        f"({B * S / pre_s:.0f} tokens/s), peak {pre_peak / 1e9:.2f} GB; "
        f"{kernel} launches {counts[kernel]}{via} (one per "
        f"{'superlayer' if cfg.family == 'hybrid' else 'layer'}){drops}; "
        f"profiled prefill: device busy {busy[0]:.4f} of "
        f"{busy[1] * 1e3:.1f} ms, top device ops (ms) {busy[2]}")
    log(f"[lm] {cfg.name} decode {Bd} x {LM_DECODE_STEPS} steps "
        f"({'from the prefill state' if cfg.family == 'ssm' else f'cache {S} deep'}): "
        f"{med:.2f} ms per step median (first {step_ms[0]:.2f}, max "
        f"{max(step_ms):.2f}), {Bd / med * 1e3:.0f} tokens/s, peak "
        f"{dec_peak / 1e9:.2f} GB; 8 profiled steps: device busy "
        f"{d_busy[0]:.4f} of {d_busy[1] * 1e3:.1f} ms, top device ops (ms) "
        f"{d_busy[2]}")
    return counts[kernel], cp


def flash_row(torch, dev, cfg, flush, ab=()):
    """flash_attention against its plain version at Yi's prefill shape in
    bf16 (the Hopper instance), timed beside one
    scaled_dot_product_attention (a yardstick, never called by the port):
    device time from the profiler, and time per call between CUDA events
    in turns (kernel, library, library, kernel)."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         instance)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    B, S = LM_PREFILL
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    inst = instance(torch.bfloat16, D)
    if inst != "sm90":
        raise AssertionError(f"{cfg.name}: flash_attention takes the "
                             f"{inst} instance at head dim {D}")
    g = torch.Generator(device=dev).manual_seed(13)

    def inputs(b, s, hq, hkv, d, dtype):
        return [torch.randn(sh, generator=g, device=dev).to(dtype)
                for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))]

    q, k, v = inputs(B, S, Hq, Hkv, D, torch.bfloat16)
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    rel = row_rel_err(torch, got, want, "flash_attention")
    err = max_err(torch, got, want, "flash_attention", ATOL_BF16)
    del want
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_rel = row_rel_err(torch, library().transpose(1, 2), got,
                          "scaled_dot_product_attention vs flash_attention")
    kern = lambda: flash_attention(q, k, v, causal=True)
    ms, lib_ms = device_ms(torch, kern, flush), device_ms(torch, library,
                                                          flush)
    turns = [call_ms(torch, fn, flush=flush)
             for fn in (kern, library, library, kern)]
    call, lib_call = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    burst, lib_burst = burst_ms(torch, kern, flush), burst_ms(torch, library,
                                                              flush)
    plain_ms = device_ms(torch, lambda: flash_attention_ref(
        q, k, v, causal=True), flush, reps=3)
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    pairs = B * Hq * (S * S + S) / 2          # (q, key) pairs in the window
    ops = 4.0 * D * pairs
    b, by = bound_ms(nbytes, ops, BF16_OPS_PER_S, exps=pairs)
    del q, k, v, got
    shape = f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal"
    log(f"[kernel] flash_attention ({inst})   {shape:<32} ok max|err|/max|ref| "
        f"of a row {rel:.3g} (tol {ROW_REL_BF16}; SDPA vs kernel "
        f"{lib_rel:.3g}), max|err| {err:.3g} (tol {ATOL_BF16}) device ms: "
        f"kernel {ms:.4f}"
        f"  plain {plain_ms:.4f}  bound {b:.4f} ({by}: {ops:.3g} FLOP at "
        f"bf16 peak {ops / BF16_OPS_PER_S * 1e3:.4f}, {pairs:.3g} exp on "
        f"the special-function units {pairs / SFU_PER_S * 1e3:.4f}, "
        f"{nbytes / 1e6:.1f} MB {nbytes / HBM_BYTES_PER_S * 1e3:.4f})  "
        f"library {lib_ms:.4f} ms; ms per call, in turns (kernel, library, "
        f"library, kernel): {' '.join(f'{t:.4f}' for t in turns)}; device "
        f"ms by CUDA events over a burst: kernel {burst:.4f}  library "
        f"{lib_burst:.4f}")
    row = dict(name="flash_attention", route="cuda", instance=inst,
               source="src/repro_torch/csrc/flash_attention_sm90.cu",
               replaces="src/repro/kernels/flash_attention/"
                        "flash_attention.py:82",
               max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain_ms,
               bound_ms=b, bound_by=by, library_ms=lib_ms,
               library_call_ms=lib_call, shape=shape)
    if ab:
        q, k, v = inputs(B, S, Hq, Hkv, D, torch.bfloat16)
        ab_rows(torch, row, "flash_attention_sm90", ab,
                lambda: flash_attention(q, k, v, causal=True), flush,
                f"flash_attention ({shape})")
    return row


def wide_head_row(torch, dev, flush):
    """flash_attention at Nemotron-4-340B's heads (1, 520, 96/8 heads of
    192, causal): in bf16 the Hopper instance (three 64-column boxes,
    112-key tiles) against the plain version, timed beside one
    scaled_dot_product_attention with its bound and in turns with the
    general instance (WMMA, the wide template; through the ops module's
    private ``_instance``), which must hold the same bars and agree with
    it; in float32 the general instance (split TF32) against the plain
    version.  No path of this run takes the shape (Nemotron-4's prefill
    row is :func:`arch_flash_row`'s): the row's launches are its own
    call's."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         instance)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    cfg = get_arch("nemotron-4-340b")
    B, S, Hq, Hkv, D = 1, 520, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g = torch.Generator(device=dev).manual_seed(13)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = [torch.randn(sh, generator=g, device=dev).to(dtype)
                   for sh in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
        got = flash_attention(q, k, v, causal=True)
        want = flash_attention_ref(q, k, v, causal=True)
        what = f"flash_attention D={D} {dtype} ({instance(dtype, D)})"
        if dtype == torch.bfloat16:
            err = max_err(torch, got, want, what, ATOL_BF16)
            errs[dtype] = row_rel_err(torch, got, want, what)
        else:
            errs[dtype] = max_err(torch, got, want, what)
    inst = instance(torch.bfloat16, D)
    if inst != "sm90":
        raise AssertionError(f"flash_attention takes the {inst} instance "
                             f"at bf16 head dim {D}")
    shape = f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal"
    kern = lambda: flash_attention(q, k, v, causal=True)
    general = lambda: flash_attention(q, k, v, causal=True,
                                      _instance="general")
    held, turns = general_held(torch, general, kern, got, want, flush,
                               f"flash_attention ({shape})")
    del got, want
    plain = lambda: flash_attention_ref(q, k, v, causal=True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    ms, call = timings(torch, kern, flush)
    lib_ms, lib_call = timings(torch, library, flush)
    plain_ms = device_ms(torch, plain, flush, reps=3)
    pairs = B * Hq * (S * S + S) / 2
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    b, by, _ = flash_bound(nbytes, 4.0 * D * pairs, pairs, True)
    log(f"[kernel] flash_attention ({inst}) {shape} (Nemotron-4's heads) ok "
        f"max|err|/max|ref| of a row {errs[torch.bfloat16]:.3g} (tol "
        f"{ROW_REL_BF16}), max|err| {err:.3g} (tol {ATOL_BF16}){held}; "
        f"float32 (general) max|err| {errs[torch.float32]:.3g} (tol "
        f"{ATOL_KERNEL}) device ms: "
        f"kernel {ms:.4f}  plain {plain_ms:.4f}  bound {b:.4f} ({by})  "
        f"library {lib_ms:.4f}; ms per call: kernel {call:.4f}  library "
        f"{lib_call:.4f}")
    row = dict(name="flash_attention", route="cuda", instance=inst,
               source="src/repro_torch/csrc/flash_attention_sm90.cu",
               replaces="src/repro/kernels/flash_attention/"
                        "flash_attention.py:82",
               max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain_ms,
               bound_ms=b, bound_by=by, library_ms=lib_ms,
               library_call_ms=lib_call, shape=shape, path="widened",
               launches=own_launches(torch, "flash_attention", kern))
    row["ab"] = {"general instance (csrc/flash_attention.cu)": turns}
    del q, k, v, qt, kt, vt
    return row


def arch_flash_row(torch, dev, cfg, flush, launches, ab=()):
    """flash_attention against its plain version at the prefill shape of
    a served-only arch in bf16, on the Hopper instance (qwen3-moe's 64/4
    heads of 128 and llama4-scout's 40/8, at GQA groups 16 and 5;
    zamba2's 32/32 heads of 80, a 64-column box and a 16-column tail
    box; nemotron-4's 96/8 heads of 192, three boxes and 112-key tiles),
    timed beside one scaled_dot_product_attention.  At a head dim
    in FLASH_TURNS_HEAD_DIMS it is also timed in turns with the general
    instance (the route such heads took before the tail box or the
    112-key tiles, through the ops module's private ``_instance``:
    general, Hopper, Hopper, general), which must hold the same bars
    against the plain version and agree with the Hopper one within
    them.  Past PLAIN_FWD_WHOLE_SCORES the plain version runs one batch
    row at a time.  ``launches`` is the arch's prefill count; with
    ``--ab``, the Hopper instance is also timed in turns with each
    directory's design of it."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         instance)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    B, S = LM_PREFILL
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    inst = instance(torch.bfloat16, D)
    if inst != "sm90":
        raise AssertionError(f"{cfg.name}: flash_attention takes the "
                             f"{inst} instance at head dim {D}")
    g = torch.Generator(device=dev).manual_seed(23)
    q, k, v = [torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)
               for sh in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    kern = lambda: flash_attention(q, k, v, causal=True)
    rows_of = B * Hq * S * S * 4 > PLAIN_FWD_WHOLE_SCORES
    if rows_of:
        plain = lambda: torch.cat([flash_attention_ref(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=True)
            for b in range(B)])
    else:
        plain = lambda: flash_attention_ref(q, k, v, causal=True)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    what = f"flash_attention {cfg.name}"
    rel = row_rel_err(torch, got, want, what)
    err = max_err(torch, got, want, what, ATOL_BF16)
    shape = f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal"
    g_turns, held = None, ""
    if D in FLASH_TURNS_HEAD_DIMS:
        general = lambda: flash_attention(q, k, v, causal=True,
                                          _instance="general")
        held, g_turns = general_held(torch, general, kern, got, want, flush,
                                     f"flash_attention {cfg.name} ({shape})")
    del got, want
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    ms, lib_ms = device_ms(torch, kern, flush), device_ms(torch, library,
                                                          flush)
    turns = [call_ms(torch, fn, flush=flush)
             for fn in (kern, library, library, kern)]
    call, lib_call = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    plain_ms = device_ms(torch, plain, flush, reps=2)
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    pairs = B * Hq * (S * S + S) / 2          # (q, key) pairs in the window
    ops = 4.0 * D * pairs
    b, by = bound_ms(nbytes, ops, BF16_OPS_PER_S, exps=pairs)
    log(f"[kernel] flash_attention ({inst}) {cfg.name} {shape} ok "
        f"max|err|/max|ref| of a row {rel:.3g} (tol {ROW_REL_BF16}), "
        f"max|err| {err:.3g} (tol {ATOL_BF16}){held} device ms: kernel "
        f"{ms:.4f}  "
        f"plain {plain_ms:.4f}{' (a batch row at a time)' if rows_of else ''}"
        f"  bound {b:.4f} ({by})  library {lib_ms:.4f}; "
        f"ms per call, in turns (kernel, library, library, kernel): "
        f"{' '.join(f'{t:.4f}' for t in turns)}; launches {launches} a "
        f"prefill")
    row = dict(name="flash_attention", route="cuda", instance=inst,
               source="src/repro_torch/csrc/flash_attention_sm90.cu",
               replaces="src/repro/kernels/flash_attention/"
                        "flash_attention.py:82",
               launches=launches, max_abs_err=err, ms=ms, call_ms=call,
               plain_ms=plain_ms, bound_ms=b, bound_by=by,
               library_ms=lib_ms, library_call_ms=lib_call, shape=shape)
    if g_turns is not None:
        row["ab"] = {"general instance (csrc/flash_attention.cu)": g_turns}
    ab_rows(torch, row, "flash_attention_sm90", ab, kern, flush,
            f"flash_attention {cfg.name} ({shape})")
    del q, k, v, qt, kt, vt
    return row


def general_held(torch, general, tree, got, want, flush, what) -> tuple:
    """The general instance (``general``) at a head dim the Hopper one
    (``tree``, whose output is ``got``) takes: within the bf16 bars of the
    plain version's ``want`` and of the Hopper output, then the two timed
    in turns (:func:`general_turns`).  Returns (the log note, the
    turns)."""
    other = general()
    torch.cuda.synchronize()
    g_what = f"{what}, the general instance"
    g_rel = row_rel_err(torch, other, want, g_what)
    max_err(torch, other, want, g_what, ATOL_BF16)
    agree = row_rel_err(torch, other, got, f"{g_what} vs the Hopper one")
    del other
    return (f"; the general instance {g_rel:.3g} against the plain "
            f"version, {agree:.3g} against the Hopper one (same bar)",
            general_turns(torch, general, tree, flush, what))


def general_turns(torch, general, tree, flush, what, reps=30) -> list:
    """The general instance (``general``, other) and the Hopper one
    (``tree``) on the same inputs, timed in turns: general, Hopper,
    Hopper, general, each over ``reps`` calls, its device time by CUDA
    events (:func:`burst_ms`) and its time per call (:func:`call_ms`).
    The caller has held the two against each other."""
    turns = []
    for design, fn in (("other", general), ("tree", tree), ("tree", tree),
                       ("other", general)):
        turns.append(dict(design=design,
                          ms=burst_ms(torch, fn, flush, reps=reps),
                          call_ms=call_ms(torch, fn, flush=flush, reps=reps,
                                          warm=1)))
    log(f"[ab] {what}: the general instance (other) and the Hopper one "
        f"(tree) agree; device ms (CUDA events) / ms per call over {reps} "
        f"calls, in turns: " + "  ".join(
            f"{t['design']} {t['ms']:.4f}/{t['call_ms']:.4f}"
            for t in turns))
    return turns


# float32 forward rows past the Hopper instance (B, S, Hq, Hkv, D, dtype,
# causal): D 320 in bf16 and D 512 in float32 (head dims past the old
# limit of 256), and Yi-6B's heads in float32 (the general instance's
# float32 route at a model's head dim, the rows kernel)
WIDE_FLASH_SHAPES = ((1, 2048, 8, 2, 320, "bfloat16", True),
                     (1, 1024, 8, 2, 512, "float32", False),
                     (2, 2048, 32, 4, 128, "float32", True))


def wide_flash_rows(torch, dev, flush, ab=()):
    """The general instance at WIDE_FLASH_SHAPES, against its plain
    version, timed beside one scaled_dot_product_attention; the float32
    rows also in turns with each ``ab`` directory's design (split TF32 on
    the tensor cores against the scalar FMAs of earlier commits).  No
    path of this run takes these shapes: each row's launches are its own
    call's."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         instance)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(19)
    rows = []
    for B, S, Hq, Hkv, D, dname, causal in WIDE_FLASH_SHAPES:
        dtype = getattr(torch, dname)
        q, k, v = [torch.randn(sh, generator=g, device=dev).to(dtype)
                   for sh in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
        kern = lambda: flash_attention(q, k, v, causal=causal)
        plain = lambda: flash_attention_ref(q, k, v, causal=causal)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        what = f"flash_attention D={D} {dtype}"
        if dtype == torch.bfloat16:
            err = max_err(torch, got, want, what, ATOL_BF16)
            row_rel_err(torch, got, want, what)
        else:
            err = max_err(torch, got, want, what)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        ms, call = timings(torch, kern, flush)
        lib_ms, lib_call = timings(torch, library, flush)
        plain_ms = device_ms(torch, plain, flush, reps=3)
        pairs = B * Hq * ((S * S + S) / 2 if causal else S * S)
        nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
        b, by, note = flash_bound(nbytes, 4.0 * D * pairs, pairs,
                                  dtype == torch.bfloat16)
        shape = (f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} {dname} "
                 f"{'causal' if causal else 'full'}")
        log(f"[kernel] flash_attention ({instance(dtype, D)}) {shape} ok "
            f"max|err| {err:.3g} device ms: kernel {ms:.4f}  plain "
            f"{plain_ms:.4f}  bound {b:.4f} ({by}{'; ' + note if note else ''})"
            f"  library {lib_ms:.4f}; ms per call: kernel {call:.4f}  "
            f"library {lib_call:.4f}")
        row = dict(
            name="flash_attention", route="cuda",
            instance=instance(dtype, D),
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/"
                     "flash_attention.py:82",
            max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain_ms,
            bound_ms=b, bound_by=by, library_ms=lib_ms,
            library_call_ms=lib_call, shape=shape, path="widened",
            launches=own_launches(torch, "flash_attention", kern))
        if dtype == torch.float32:
            row["fma_bound_ms"] = bound_ms(nbytes, 4.0 * D * pairs,
                                           FP32_OPS_PER_S, exps=pairs)[0]
            ab_rows(torch, row, "flash_attention", ab, kern, flush,
                    f"flash_attention ({shape})")
        rows.append(row)
        del q, k, v, got, want, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def scan_row(torch, dev, cfg, flush, ab=(), N=None, L=None):
    """selective_scan against its plain version at Falcon-Mamba-7B's
    prefill shape in float32 (or with d_state ``N`` and length ``L``,
    shapes no path of this run takes: the row's launches are then those
    of its own call); no PyTorch call computes the scan."""
    widened = N is not None
    from repro_torch.kernels.selective_scan.ops import selective_scan
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    B, L = LM_PREFILL[0], L or LM_PREFILL[1]
    Din, N = cfg.ssm.expand * cfg.d_model, N or cfg.ssm.d_state
    g = torch.Generator(device=dev).manual_seed(17)
    r = lambda *s: torch.rand(s, generator=g, device=dev)
    n = lambda *s: torch.randn(s, generator=g, device=dev)
    args = (0.001 + 0.099 * r(B, L, Din), n(B, L, Din),
            -(0.5 + 3.5 * r(Din, N)), n(B, L, N), n(B, L, N), n(B, Din, N))
    y, h = selective_scan(*args)
    y_w, h_w = selective_scan_ref(*args)
    torch.cuda.synchronize()
    err = max(max_err(torch, y, y_w, "selective_scan y"),
              max_err(torch, h, h_w, "selective_scan h_last"))
    del y_w, h_w
    kern = lambda: selective_scan(*args)
    ms, call = timings(torch, kern, flush)
    burst = burst_ms(torch, kern, flush)
    plain_ms = device_ms(torch, lambda: selective_scan_ref(*args), flush,
                         reps=2)
    elems = B * L * Din * N
    nbytes = 4 * (3 * B * L * Din + 2 * B * L * N + Din * N
                  + 2 * B * Din * N)
    ops = 6.0 * elems               # 6 flops and one exp per state element
    b, by = bound_ms(nbytes, ops, exps=elems)
    shape = f"B={B} L={L} Din={Din} N={N} f32"
    log(f"[kernel] selective_scan           {shape:<32} ok max|err|="
        f"{err:.3g} (tol {ATOL_KERNEL}) device ms: kernel {ms:.4f}  plain "
        f"{plain_ms:.4f}  bound {b:.4f} ({by}: {elems:.3g} exp on the "
        f"special-function units {elems / SFU_PER_S * 1e3:.4f}, {ops:.3g} "
        f"FLOP at f32 peak {ops / FP32_OPS_PER_S * 1e3:.4f}, "
        f"{nbytes / 1e6:.1f} MB {nbytes / HBM_BYTES_PER_S * 1e3:.4f})  "
        f"library none; ms per call: kernel {call:.4f}; device ms by CUDA "
        f"events over a burst {burst:.4f}")
    row = dict(name="selective_scan", route="cuda",
               source="src/repro_torch/csrc/selective_scan.cu",
               replaces="src/repro/kernels/selective_scan/"
                        "selective_scan.py:57",
               max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain_ms,
               bound_ms=b, bound_by=by, library_ms=None,
               library_call_ms=None, shape=shape)
    if widened:
        row["launches"] = own_launches(torch, "selective_scan", kern)
        row["path"] = "widened"
    if N <= 16:                  # an older design takes only N <= 16
        ab_rows(torch, row, "selective_scan", ab, kern, flush,
                f"selective_scan ({shape})")
    return row


def routing_note(torch, ref, run, what, tol=None) -> str:
    """Tokens whose set of experts differs between two records (``ref``'s
    picks against ``run``'s own), and the largest amount by which an
    expert ``ref`` picked falls below ``run``'s k-th router log-prob.
    ``tol`` None: any difference raises; else a gap past ``tol`` (a
    routing that is no near-tie) raises."""
    moved = tot = 0
    gap = 0.0
    for (_, i_ref), (p_run, i_run) in zip(ref, run):
        bad = (i_ref.sort(-1).values != i_run.sort(-1).values).any(-1)
        moved, tot = moved + int(bad.sum()), tot + bad.numel()
        if bool(bad.any()):
            lp = p_run.log()
            kth = lp.gather(-1, i_run).amin(-1, keepdim=True)
            gap = max(gap, float((kth - lp.gather(-1, i_ref))
                                 .clamp_min(0).amax(-1)[bad].max()))
    if not moved:
        return ""
    note = (f"{what}: {moved} of {tot} tokens routed differently, each "
            f"choice within {gap:.3g} of the k-th router log-prob")
    if tol is None or gap > tol:
        raise AssertionError(f"{note} (tol {tol})")
    return f"; {note} (a near-tie, tol {tol}; compared with the same routing)"
def newest_key_hidden(torch, cfg, cp, B, S, dev, steps) -> float:
    """The largest |card - CPU| over the decode ``steps`` ((token, CPU
    logits) pairs, from a fresh state) with a fault planted on the card:
    decode attention hides each row's newest key (the one just written)."""
    from repro_torch.models import lm_zoo as Z
    from repro_torch.models import transformer_lm as T

    real, serve = T.decode_attention, Z.make_serve_step(cfg)
    T.decode_attention = lambda q, k, v, valid_len: real(
        q, k, v, (valid_len - 1).clamp_min(1))
    try:
        d, worst = T.init_decode_state(cfg, B, S, device=dev), 0.0
        for tok, o_c in steps:
            o, d = serve(cp, d, tok.to(dev))
            worst = max(worst, float((o.cpu() - o_c).abs().max()))
    finally:
        T.decode_attention = real
    return worst


def one_longer(torch, state):
    """A prefill state with room for one more token: its K/V stacks (L,
    B, S, Hkv, Dh) padded to S + 1 (a prefill's are exactly S long)."""
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 1))
    return dict(state, k=pad(state["k"]), v=pad(state["v"]))


def lm_cut_checks(torch, dev, args, cfg):
    """Full width, depth cut (and, for an arch of LM_CUT_VOCAB, the
    vocabulary): the card against the CPU, and the prefill against
    token-by-token decode on the card.  For a moe arch each
    token's experts must be the same on the card and the CPU in float32;
    in bf16, where the router's logits are rounded and near-ties are
    common, a token routed differently must be a near-tie (its experts
    within NEAR_TIE of the k-th router log-prob) and the logits are held
    with the first run's routing replayed.  For the hybrid its prefill
    state, continued by one decode step, must give prefill(S + 1)'s last
    logits."""
    import dataclasses
    import resource

    from repro_torch.launch.mesh_fleet import routing
    from repro_torch.models import lm_zoo as Z
    from repro_torch.models import transformer_lm as T

    depth, B, S = LM_CUT_OF.get(cfg.name, LM_CUT)
    cut = dataclasses.replace(cfg, n_layers=depth,
                              vocab=LM_CUT_VOCAB.get(cfg.name, cfg.vocab))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    params = Z.init_params(cut, gen, device=dev)
    cpu = _to_cpu(params)
    rng = np.random.default_rng(args.seed + 1)
    x = torch.from_numpy(rng.normal(size=(B, S, cut.d_model)).astype(
        np.float32))
    pos = torch.arange(S)[None].expand(B, S)
    t0 = time.perf_counter()
    with routing() as r_g:
        h_g = T.forward_hidden(cut, params, x.to(dev), pos.to(dev))[0]
    with routing() as r_c:
        h_c = T.forward_hidden(cut, cpu, x, pos)[0]
    routing_note(torch, r_g, r_c, f"{cfg.name} float32 forward_hidden")
    err_f = max_err(torch, h_g.cpu(), h_c, f"{cfg.name} forward_hidden f32",
                    ATOL_SERVED)
    routed = (f", the same experts for all {B * S} tokens"
              if cut.moe is not None else "")
    if cfg.name == MESH_ARCH:
        routed += mesh_cut_holds(torch, dev, cut, params, cpu, x, pos)
    cp_g, cp_c = Z._cast_compute(params), Z._cast_compute(cpu)
    del params, cpu, h_g
    toks = torch.from_numpy(rng.integers(0, cut.vocab, (B, S + 1)).astype(
        np.int32))
    prefill, serve = Z.make_prefill_step(cut), Z.make_serve_step(cut)
    with routing() as r_g:
        l_g, st_g = prefill(cp_g, {"tokens": toks[:, :S].to(dev)})
    with routing(r_g) as r_c:
        l_c, st_c = prefill(cp_c, {"tokens": toks[:, :S]})
    notes = [routing_note(torch, r_g, r_c, "bf16 prefill", NEAR_TIE)]
    atol = ATOL_LOGITS_OF.get(cfg.name, ATOL_LOGITS)
    err_p = max_err(torch, l_g.cpu(), l_c, f"{cfg.name} bf16 prefill "
                    f"logits", atol)
    if cfg.family == "ssm":          # continue both prefill states
        d_g, d_c = st_g, st_c
    else:
        d_g = T.init_decode_state(cut, B, S, device=dev)
        d_c = T.init_decode_state(cut, B, S, device="cpu")
    err_d, tok, steps = 0.0, toks[:, S:], []
    for i in range(4):
        with routing() as r_g:
            o_g, d_g = serve(cp_g, d_g, tok.to(dev))
        with routing(r_g) as r_c:
            o_c, d_c = serve(cp_c, d_c, tok)
        notes.append(routing_note(torch, r_g, r_c, f"bf16 decode step {i}",
                                  NEAR_TIE))
        err_d = max(err_d, max_err(torch, o_g.cpu(), o_c, f"{cfg.name} "
                                   f"bf16 decode logits", atol))
        steps.append((tok, o_c))
        tok = o_c.argmax(-1, keepdim=True).to(torch.int32)
    if cfg.name in ATOL_LOGITS_OF:   # its own bar must fail a planted fault
        worst = newest_key_hidden(torch, cut, cp_g, B, S, dev, steps)
        if not worst > atol:
            raise AssertionError(f"{cfg.name}: the bf16 decode bar {atol} "
                                 f"passes the newest key hidden ({worst})")
        notes.append(f"; with the newest key hidden from the card's decode "
                     f"attention {worst:.3g} (must exceed {atol})")
    cpu_s = time.perf_counter() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    del cp_c, d_c, st_c

    # prefill against token-by-token decode, on the card; a moe prefill
    # that dropped slots would differ by design, so its length is one at
    # which it drops none (checked), and each decode step replays the
    # prefill's routing of its token
    St, l_t, r_p, drops = S, l_g, None, ""
    if cut.moe is not None:
        St = MOE_DECODE_S
        with routing() as r_p:
            l_t, _ = prefill(cp_g, {"tokens": toks[:, :St].to(dev)})
        xt = T.embed_input(cut, cp_g, {"tokens": toks[:, :St].to(dev)})
        aux = T.forward_hidden(cut, cp_g, xt, torch.arange(
            St, device=dev)[None].expand(B, St))[1]
        if float(aux["moe_drop_frac"]) != 0.0:
            raise AssertionError(f"{cfg.name}: the {St}-token prefill "
                                 f"dropped {float(aux['moe_drop_frac'])}")
        drops = f" (the {St}-token prefill drops no slot)"
    d = T.init_decode_state(cut, B, St, device=dev)
    for i in range(St):
        rp = r_p and [(p[:, i:i + 1], ix[:, i:i + 1]) for p, ix in r_p]
        with routing(rp) as r_d:
            o, d = serve(cp_g, d, toks[:, i:i + 1].to(dev))
        if rp:
            notes.append(routing_note(torch, rp, r_d, f"decode step {i} vs "
                                      f"the prefill", NEAR_TIE))
    err_t = max_err(torch, o.cpu(), l_t.cpu(), f"{cfg.name} prefill vs "
                    f"token-by-token decode", ATOL_DECODE)
    extra = ""
    if cfg.family in ("ssm", "hybrid"):
        st = st_g if cfg.family == "ssm" else one_longer(torch, st_g)
        o, _ = serve(cp_g, st, toks[:, S:].to(dev))
        l_n, _ = prefill(cp_g, {"tokens": toks.to(dev)})
        err_n = max_err(torch, o.cpu(), l_n.cpu(), f"{cfg.name} prefill(S) "
                        f"+ decode vs prefill(S+1)", ATOL_DECODE)
        extra = f"; prefill(S) + 1 decode step vs prefill(S+1) {err_n:.3g}"
    vocab = (f", vocabulary {cut.vocab}" if cut.vocab != cfg.vocab
             else "")
    log(f"[lm] {cfg.name} cut to {depth} layers{vocab}, B {B} S {S}: card "
        f"vs CPU "
        f"forward_hidden f32 {err_f:.3g} (tol {ATOL_SERVED}){routed}, bf16 "
        f"prefill logits {err_p:.3g}, 4 decode steps {err_d:.3g} (tol "
        f"{atol}) in {cpu_s:.1f} s, host peak RSS {rss:.1f} GB; "
        f"prefill vs {St} decode steps {err_t:.3g}{drops}{extra} (tol "
        f"{ATOL_DECODE}){''.join(notes)}")


def mesh_ctx(dev):
    """The mesh part's context: a (1, 4) local mesh on ``dev`` with the
    default rules."""
    from repro_torch.dist.sharding import default_rules, sharding_ctx
    from repro_torch.launch.mesh import make_local_mesh

    return sharding_ctx(make_local_mesh(*MESH, device=dev), default_rules())


def mesh_timed(torch, fn) -> tuple:
    """(fn's result, ms on the host clock, synchronised, the kernels'
    launch counts during it)."""
    from repro_torch.kernels import runtime

    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, runtime.launch_counts()


def mesh_serve(torch, dev, args, cfg, cp, measured=None):
    """Qwen3-MoE's full-width tree ``cp`` served under the (1, 4) mesh:
    the 2 x 8,192 prefill (CP blocked: ``flash_attention`` at 4 offsets a
    layer, exactly; EP with 32 experts a shard), timed beside the same
    prefill off the mesh; 4 decode steps from its state (dense moe, no
    flash); the 2 x 4,096 prefill (CP direct: no flash launch); and layer
    0's q, k and v at 2 x 8,192 through ``_cp_attention_shard_map``
    (blocked, 4 launches) against ``blocked_attention`` over the whole
    sequence (1 launch), both on the card, at the per-row bf16 bar.
    Returns the flash launches of the mesh prefill; its time, drop
    fraction, peak and logits go into ``measured["mesh_prefill"]`` (the
    process mesh part holds its ranks beside them)."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm_zoo as Z
    from repro_torch.models import transformer_lm as T

    t0 = time.perf_counter()
    B, S = MESH_PREFILL
    sp, want = MESH[1], {"flash_attention": MESH[1] * cfg.n_layers}
    rng = np.random.default_rng(args.seed + 2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32)).to(dev)
    prefill, serve = Z.make_prefill_step(cfg), Z.make_serve_step(cfg)
    prefill(cp, {"tokens": toks})                      # warm-up
    _, flat_ms, counts = mesh_timed(torch, lambda: prefill(
        cp, {"tokens": toks}))
    if counts != {"flash_attention": cfg.n_layers}:
        raise AssertionError(f"mesh: the prefill off the mesh launched "
                             f"{counts}")
    x = T.embed_input(cfg, cp, {"tokens": toks})
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    flat_drop = float(T.forward_hidden(cfg, cp, x, pos)[1]["moe_drop_frac"])
    with mesh_ctx(dev):
        prefill(cp, {"tokens": toks})                  # warm-up
        torch.cuda.reset_peak_memory_stats()
        (logits, st), pre_ms, counts = mesh_timed(torch, lambda: prefill(
            cp, {"tokens": toks}))
        peak = torch.cuda.max_memory_allocated()
        if counts != want:
            raise AssertionError(f"mesh: the {B} x {S} prefill launched "
                                 f"{counts}, expected {want}")
        if tuple(logits.shape) != (B, cfg.vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError("mesh: bad prefill logits")
        aux = T.forward_hidden(cfg, cp, x, pos)[1]
        drop = float(aux["moe_drop_frac"])
        if measured is not None:
            measured["mesh_prefill"] = {
                "ms": pre_ms, "flat_ms": flat_ms, "drop": drop,
                "peak": peak, "layers": cfg.n_layers,
                "logits": logits.float().cpu()}

        # decode from the prefill's state, its K/V stacks S long
        pad = lambda t: torch.nn.functional.pad(
            t, (0, 0, 0, 0, 0, MESH_DECODE_STEPS))
        dstate = dict(st, k=pad(st["k"]), v=pad(st["v"]))
        del st
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        step_ms, outs = [], []
        for _ in range(MESH_DECODE_STEPS):
            (out, dstate), ms, counts = mesh_timed(
                torch, lambda: serve(cp, dstate, tok))
            if counts:
                raise AssertionError(f"mesh: a decode step launched {counts}")
            tok = out.argmax(-1, keepdim=True).to(torch.int32)
            step_ms.append(ms)
            outs.append(out)
        if (int(dstate["pos"][0]) != S + MESH_DECODE_STEPS
                or not bool(torch.isfinite(torch.stack(outs)).all())):
            raise AssertionError("mesh: bad decode")
        del dstate, outs

        Sd = MESH_DIRECT[1]
        toks_d = toks[:, :Sd].contiguous()
        prefill(cp, {"tokens": toks_d})                # warm-up
        (l_d, _), direct_ms, counts = mesh_timed(torch, lambda: prefill(
            cp, {"tokens": toks_d}))
        if counts or not bool(torch.isfinite(l_d).all()):
            raise AssertionError(f"mesh: the {B} x {Sd} prefill (direct) "
                                 f"launched {counts} or is not finite")

        # layer 0's attention: CP (blocked) against the whole sequence
        lp = T.layer(cp["layers"], 0)
        q, k, v = T._qkv(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                         cfg, pos)
        del x
        o_cp, cp_ms, counts = mesh_timed(
            torch, lambda: T._cp_attention_shard_map(q, k, v, causal=True,
                                                     blocked=True))
        if counts != {"flash_attention": sp}:
            raise AssertionError(f"mesh: CP attention launched {counts}")
    o_all, all_ms, counts = mesh_timed(
        torch, lambda: L.blocked_attention(q, k, v, causal=True))
    if counts != {"flash_attention": 1}:
        raise AssertionError(f"mesh: whole-sequence attention launched "
                             f"{counts}")
    what = "mesh: layer 0's CP attention vs the whole sequence"
    rel = row_rel_err(torch, o_cp, o_all, what)
    err = max_err(torch, o_cp, o_all, what, ATOL_BF16)
    log(f"[mesh] {cfg.name} ({cfg.n_layers} layers) under a {MESH} mesh: "
        f"prefill {B} x {S} {pre_ms:.1f} ms ({B * S / pre_ms * 1e3:.0f} "
        f"tokens/s; off the mesh {flat_ms:.1f} ms), flash_attention "
        f"launches {want['flash_attention']} (CP blocked, {sp} a layer), "
        f"moe_drop_frac {drop:.6f} (off the mesh {flat_drop:.6f}; "
        f"moe_lb_loss {float(aux['moe_lb_loss']):.6f}), peak "
        f"{peak / 1e9:.2f} GB; "
        f"{MESH_DECODE_STEPS} decode steps (B {B}, dense moe) "
        f"{float(np.median(step_ms)):.2f} ms a step median (each "
        f"{' '.join(f'{m:.2f}' for m in step_ms)}); prefill {B} x {Sd} "
        f"(CP direct) {direct_ms:.1f} ms, 0 flash launches; layer 0's "
        f"attention at {B} x {S}: CP {cp_ms:.2f} ms ({sp} launches) vs the "
        f"whole sequence {all_ms:.2f} ms (1), max|err|/max|ref| of a row "
        f"{rel:.3g} (tol {ROW_REL_BF16}), max|err| {err:.3g} (tol "
        f"{ATOL_BF16}); {time.perf_counter() - t0:.1f} s")
    return want["flash_attention"]


def mesh_flash_row(torch, dev, cfg, flush, launches):
    """flash_attention at the context-parallel shape of the mesh prefill
    (q 2 x 2,048 of the 8,192 positions, qwen3-moe's 64/4 heads of 128,
    bf16, causal) at each shard's q_offset 0, 2,048, 4,096 and 6,144,
    against its plain version at the per-row bar, timed beside one
    scaled_dot_product_attention with the same explicit boolean mask
    (``enable_gqa``); the row's times and bound are the four launches'
    sums (one layer's attention).  The last shard's offset given to
    shard 0, a planted fault, must fail the bar.  Then the general
    instance in float32 at q_offsets inside and past the default, within
    1e-5.  ``launches`` is the mesh prefill's count."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         instance)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    B, S = MESH_PREFILL
    sp = MESH[1]
    Sq, Hq, Hkv, D = S // sp, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    inst = instance(torch.bfloat16, D)
    if inst != "sm90":
        raise AssertionError(f"mesh: flash_attention takes the {inst} "
                             f"instance at head dim {D}")
    g = torch.Generator(device=dev).manual_seed(29)
    q, k, v = [torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)
               for sh in ((B, Sq, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kpos = torch.arange(S, device=dev)
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    tot = dict(ms=0.0, call=0.0, plain=0.0, lib=0.0, lib_call=0.0,
               bound=0.0)
    rels, errs, lib_rels, per, bys = [], [], [], [], set()
    for off in range(0, S, Sq):
        kern = lambda off=off: flash_attention(q, k, v, causal=True,
                                               q_offset=off)
        plain = lambda off=off: flash_attention_ref(q, k, v, causal=True,
                                                    q_offset=off)
        mask = kpos[None, :] <= (torch.arange(Sq, device=dev) + off)[:, None]
        library = lambda mask=mask: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        what = f"flash_attention q_offset {off}"
        rels.append(row_rel_err(torch, got, want, what))
        errs.append(max_err(torch, got, want, what, ATOL_BF16))
        lib_rels.append(row_rel_err(torch, library().transpose(1, 2), got,
                                    f"SDPA vs {what}"))
        del got, want
        ms, lib_ms = device_ms(torch, kern, flush), device_ms(torch, library,
                                                              flush)
        turns = [call_ms(torch, fn, flush=flush)
                 for fn in (kern, library, library, kern)]
        pairs = B * Hq * float(np.minimum(S, off + np.arange(Sq) + 1).sum())
        b, by = bound_ms(nbytes, 4.0 * D * pairs, BF16_OPS_PER_S, exps=pairs)
        bys.add(by)
        for key, val in (("ms", ms), ("lib", lib_ms),
                         ("call", (turns[0] + turns[3]) / 2),
                         ("lib_call", (turns[1] + turns[2]) / 2),
                         ("plain", device_ms(torch, plain, flush, reps=2)),
                         ("bound", b)):
            tot[key] += val
        per.append(f"{off}: {ms:.4f}/{lib_ms:.4f}/{b:.4f}")
    # the planted fault: shard 0's rows at the last shard's offset
    bad = row_rel_err(torch, flash_attention(q, k, v, causal=True,
                                             q_offset=S - Sq),
                      flash_attention_ref(q, k, v, causal=True, q_offset=0),
                      "the last shard's offset on shard 0", math.inf)
    if not bad > ROW_REL_BF16:
        raise AssertionError(f"mesh: the per-row bar {ROW_REL_BF16} passes "
                             f"shard 0 at the last shard's offset ({bad})")
    del q, k, v, qt, kt, vt

    # the general instance in float32, at offsets before, at and past the
    # default (row i then sees keys up to i + q_offset)
    f_shape, f_errs = "B=2 Sq=256 Skv=1024 Hq=8 Hkv=2 D=64", []
    q, k, v = [torch.randn(sh, generator=g, device=dev) for sh in (
        (2, 256, 8, 64), (2, 1024, 2, 64), (2, 1024, 2, 64))]
    for off in (0, 300, 768, 900):
        f_errs.append(max_err(
            torch, flash_attention(q, k, v, causal=True, q_offset=off),
            flash_attention_ref(q, k, v, causal=True, q_offset=off),
            f"flash_attention f32 q_offset {off}"))
    del q, k, v
    shape = (f"B={B} Sq={Sq} Skv={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal "
             f"q_offset {'/'.join(str(o) for o in range(0, S, Sq))} (a "
             f"layer's {sp} context-parallel shards, one launch each)")
    log(f"[kernel] flash_attention ({inst}) {cfg.name} {shape} ok "
        f"max|err|/max|ref| of a row {max(rels):.3g} (tol {ROW_REL_BF16}; "
        f"SDPA with the mask vs kernel {max(lib_rels):.3g}), max|err| "
        f"{max(errs):.3g} (tol {ATOL_BF16}); the last shard's offset on "
        f"shard 0 {bad:.3g} (must exceed {ROW_REL_BF16}); device ms of the "
        f"{sp}: kernel {tot['ms']:.4f}  plain {tot['plain']:.4f}  bound "
        f"{tot['bound']:.4f} ({'/'.join(sorted(bys))})  library "
        f"{tot['lib']:.4f}; per offset kernel/library/bound {'  '.join(per)};"
        f" ms per call summed, in turns: kernel {tot['call']:.4f}  library "
        f"{tot['lib_call']:.4f}; launches {launches} a mesh prefill; the "
        f"general instance f32 at {f_shape} q_offset 0/300/768/900 max|err| "
        f"{max(f_errs):.3g} (tol {ATOL_KERNEL})")
    return dict(name="flash_attention", route="cuda", instance=inst,
                source="src/repro_torch/csrc/flash_attention_sm90.cu",
                replaces="src/repro/kernels/flash_attention/"
                         "flash_attention.py:82",
                launches=launches, max_abs_err=max(errs), ms=tot["ms"],
                call_ms=tot["call"], plain_ms=tot["plain"],
                bound_ms=tot["bound"], bound_by="/".join(sorted(bys)),
                library_ms=tot["lib"], library_call_ms=tot["lib_call"],
                shape=shape)


def mesh_cut_holds(torch, dev, cut, params, cpu, x, pos) -> str:
    """The mesh on the full-width float32 1-layer cut (``params`` on the
    card, ``cpu`` its copy; ``x``, ``pos`` on the host), at the cut's S,
    where CP takes the direct branch: (a) the card against the CPU, both
    under the mesh (each token's experts equal, the hidden within 1e-4);
    (b) at a capacity factor of E / k, where no shard and no row can
    drop a slot, the mesh against no mesh on the card within 1e-4.
    Returns the note for the cut's log line."""
    import dataclasses

    from repro_torch.launch.mesh_fleet import routing
    from repro_torch.models import moe
    from repro_torch.models import transformer_lm as T

    paths = []
    with hooked(T, "_cp_attention_shard_map",
                lambda a, kw, out: paths.append(("cp", kw["blocked"]))), \
            hooked(moe, "_moe_apply_ep",
                   lambda a, kw, out: paths.append(("ep",))):
        with mesh_ctx(dev), routing() as r_g:
            h_g = T.forward_hidden(cut, params, x.to(dev), pos.to(dev))[0]
        with mesh_ctx(torch.device("cpu")), routing() as r_c:
            h_c = T.forward_hidden(cut, cpu, x, pos)[0]
    if paths != [("cp", False), ("ep",)] * 2:
        raise AssertionError(f"mesh: the cut took {paths}, expected CP "
                             f"direct and EP on both sides")
    routing_note(torch, r_g, r_c, "mesh float32 forward_hidden")
    err_a = max_err(torch, h_g.cpu(), h_c, "mesh forward_hidden f32, card "
                    "vs CPU", ATOL_SERVED)
    del h_g, h_c
    E, k = cut.moe.num_experts, cut.moe.top_k
    wide = dataclasses.replace(cut, moe=dataclasses.replace(
        cut.moe, capacity_factor=E / k))
    xg, pg = x.to(dev), pos.to(dev)
    with mesh_ctx(dev):
        h_m, aux_m, _ = T.forward_hidden(wide, params, xg, pg)
    h_d, aux_d, _ = T.forward_hidden(wide, params, xg, pg)
    drops = (float(aux_m["moe_drop_frac"]), float(aux_d["moe_drop_frac"]))
    if drops != (0.0, 0.0):
        raise AssertionError(f"mesh: cf {E / k} dropped {drops}")
    err_b = max_err(torch, h_m, h_d, f"mesh vs no mesh at cf {E / k}",
                    ATOL_SERVED)
    return (f"; under a {MESH} mesh (CP direct, EP) card vs CPU {err_a:.3g} "
            f"with the same experts, and at cf {E / k:g} (no slot dropped) "
            f"mesh vs no mesh {err_b:.3g} (tol {ATOL_SERVED})")


def lm_phase(torch, dev, args, measured=None):
    """Yi-6B, then Falcon-Mamba-7B: serve at full size, hold the kernel
    against its plain version (and at the shapes past its old limits),
    check the depth cut; then the same for Qwen3-MoE and Llama-4-Scout
    (cut to 8 layers), Zamba2 (whole) and Nemotron-4 (cut to 4 layers),
    with a flash_attention row at each one's prefill shape, and for
    Qwen3-MoE the mesh part
    (:func:`mesh_serve` on its tree, then :func:`mesh_flash_row`; the
    depth cut adds :func:`mesh_cut_holds`).  Returns the rows of
    flash_attention and selective_scan."""
    import dataclasses

    from repro_torch.configs import get_arch

    t0 = time.perf_counter()
    rows = []
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    for arch in LM_ARCHS:
        cfg = get_arch(arch)
        launches = lm_serve(torch, dev, args, cfg, measured)[0]
        torch.cuda.empty_cache()
        row = (scan_row if cfg.family == "ssm" else flash_row)(
            torch, dev, cfg, flush, args.ab)
        # d_state and head dims past the old limits (16 and 256)
        wide = ([scan_row(torch, dev, cfg, flush, N=32),
                 scan_row(torch, dev, cfg, flush, N=64, L=1024)]
                if cfg.family == "ssm"
                else wide_flash_rows(torch, dev, flush, args.ab)
                + [wide_head_row(torch, dev, flush)])
        row["launches"] = launches
        rows += [row] + wide
        torch.cuda.empty_cache()
        lm_cut_checks(torch, dev, args, cfg)
        torch.cuda.empty_cache()
    for arch in LM_SERVE_ARCHS:
        t1 = time.perf_counter()
        cfg = get_arch(arch)
        if arch in LM_SERVE_DEPTH:
            cfg = dataclasses.replace(cfg, n_layers=LM_SERVE_DEPTH[arch])
        launches, cp = lm_serve(torch, dev, args, cfg)
        mesh_launches = (mesh_serve(torch, dev, args, cfg, cp, measured)
                         if arch == MESH_ARCH else None)
        del cp
        torch.cuda.empty_cache()
        if mesh_launches is not None:
            rows.append(mesh_flash_row(torch, dev, cfg, flush,
                                       mesh_launches))
            torch.cuda.empty_cache()
        rows.append(arch_flash_row(torch, dev, cfg, flush, launches,
                                   args.ab))
        torch.cuda.empty_cache()
        lm_cut_checks(torch, dev, args, cfg)
        torch.cuda.empty_cache()
        log(f"[lm] {arch} done in {time.perf_counter() - t1:.1f} s")
    log(f"[lm] LM serving phase done in {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# LM training phase
# ---------------------------------------------------------------------------

LM_TRAIN = (8, 2, 4096)   # layers (cut from 32 and 64), B, S (train_4k's S;
LM_TRAIN_STEPS = 3        # its global batch of 256 cut to 2)
# every arch trained at full width, with its cut (layers, B, S) and its
# optimizer (None: the config's own), reckoned from Yi's measured peak of
# 63.27 GB at 1.9 B parameters (S1): about 33 B a parameter under the
# functional AdamW (float32 masters, moments, gradients, their clipped
# copies and the new tree beside the old)
LM_TRAIN_OF = {
    "yi-6b": LM_TRAIN + (None,),
    "falcon-mamba-7b": LM_TRAIN + (None,),
    # 2.0 B parameters whole (bf16 tree 4.07 GB): about 67 GB at Yi's
    # ratio before SSD's float32 activations; it fits whole, B 2 x S
    # 4,096 (peak 70.00 GB, PERF.md run P2)
    "zamba2-2.7b": (54, 2, 4096, None),
    # one layer each (3.7 and 4.3 B parameters with the embedding and
    # unembedding): about 123 and 140 GB under AdamW; Adafactor's
    # factored moments hold about 14 B a parameter (52 and 60 GB) plus
    # the update's temporaries of one leaf
    "qwen3-moe-235b-a22b": (1, 2, 4096, "adafactor"),
    "llama4-scout-17b-a16e": (1, 2, 4096, "adafactor"),
    # one layer (its config's Adafactor) with the vocabulary cut to 4,096
    # (LM_CUT_VOCAB): at 256,000 the untied embedding and head are 9.44 B
    # parameters, 12.9 B with the layer's 3.45 B, about 180 GB at 14 B a
    # parameter; at 4,096 3.61 B, about 50 GB of state beside one 5.4 GB
    # float32 MLP leaf's update temporaries and the activations.  Width,
    # heads (96/8 of 192) and d_ff stay full: its attention backward is
    # the Hopper instance at D 192
    "nemotron-4-340b": (1, 2, 4096, "adafactor")}
SCAN_ORACLE_L = 1024      # the plain scan's autograd graph, L cut from 4,096
# the flash_attention backward rows (B, S, Hq, Hkv, D, causal, dtype,
# whose launches): Yi-6B's train shape in bf16 (Yi's train steps'
# launches), Zamba2-2.7B's attention in bf16 (the Hopper instance at
# head dim 80; Zamba2's train steps' launches), Qwen3-MoE's and
# Llama-4-Scout's train shapes in bf16 (64/4 and 40/8 heads of 128;
# their train steps' launches), Nemotron-4's train shape in bf16 (96/8
# of 192: the Hopper instance's 64-key dk/dv tiles; its train steps'
# launches) and its heads at S 520 (ragged against every tile; its own
# call's), then two float32 ones (shapes no path of this run takes:
# their own call's): a ragged one at head dim 80 and Yi-6B's train
# heads
FLASH_BWD_SHAPES = ((2, 4096, 32, 4, 128, True, "bfloat16", "yi-6b"),
                    (2, 4096, 32, 32, 80, True, "bfloat16", "zamba2-2.7b"),
                    (2, 4096, 64, 4, 128, True, "bfloat16",
                     "qwen3-moe-235b-a22b"),
                    (2, 4096, 40, 8, 128, True, "bfloat16",
                     "llama4-scout-17b-a16e"),
                    (2, 4096, 96, 8, 192, True, "bfloat16",
                     "nemotron-4-340b"),
                    (1, 520, 96, 8, 192, True, "bfloat16", "own call"),
                    (2, 1000, 8, 2, 80, False, "float32", "own call"),
                    (2, 2048, 32, 4, 128, True, "float32", "own call"))
# the largest float32 score block (B Hq Sq Skv x 4 B, Yi's row) whose
# plain autograd graph is held whole beside the kernel's; past it the
# plain version runs in (batch, KV head) slices (``plain_bwd_sliced``)
PLAIN_WHOLE_SCORES = 2 ** 32
# the mesh train step: Qwen3-MoE's one full-width layer (Adafactor)
# under the (1, 4) mesh at B 2 x 8,192, where each shard's float32 score
# block (8.6e9 B) is past the 5e9 budget: flash at the 4 shards'
# q_offsets, twice under block remat, and 5b at each once
MESH_TRAIN = (1, 2, 8192)
# float32 train step, card vs CPU: the loss within the reference's
# per-round bar, each gradient leaf within 1e-4 of its max |value|
ATOL_LOSS = 1e-4
RTOL_GRAD = 1e-4
# bf16 attention gradients, held per row as the forward's output is:
# over dq's query rows and dk's and dv's keys, the largest error beyond
# each element's rounding budget (``flash_attention_grad_budget``) over
# the row's max |grad|; from readings (``python tests/test_torch_cuda.py``
# on the card; PERF.md section 2)
BF16_GRAD_ROW = 0.02
# bf16 train step, card vs CPU: each gradient leaf's max |diff| over its
# max |grad|, from readings (PERF.md section 2)
BF16_STEP_GRAD_REL = 5e-2
# the positions whose gradients the planted control fault zeroes: a
# kernel tile (64 keys of flash's dk/dv tile, 64 steps of the scan)
FAULT_TAIL = 64


def grad_err(torch, got, want, what, tol) -> float:
    """max |got - want|, checked against ``tol`` x max(1, max |want|);
    returns the absolute error."""
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    scale = max(1.0, float(want.float().abs().max()) if want.numel() else 0)
    if not err <= tol * scale:
        raise AssertionError(f"{what}: max |err| {err} > {tol} x {scale}")
    return err


def train_cut(cfg, depth, opt=None):
    """``cfg`` cut to ``depth`` layers (the hybrid's in whole superlayers)
    with the optimizer ``opt`` (None: its own), and, for an arch of
    LM_CUT_VOCAB, its vocabulary cut."""
    import dataclasses

    return dataclasses.replace(cfg, n_layers=depth,
                               optimizer=opt or cfg.optimizer,
                               vocab=LM_CUT_VOCAB.get(cfg.name, cfg.vocab))


def train_launches(cfg, applications: int = 1) -> dict:
    """The kernel launches of one train step under block remat: the
    forward kernel twice an attention application (or a Mamba-1 layer)
    and its backward once, ``applications`` times a layer (the
    context-parallel shards)."""
    if cfg.family == "ssm":
        return {"selective_scan": 2 * cfg.n_layers,
                "selective_scan_bwd": cfg.n_layers}
    n = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
         else cfg.n_layers) * applications
    return {"flash_attention": 2 * n, "flash_attention_bwd": n}


def seeded_tokens(torch, cfg, B, S, seed, dev):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)}


# bytes a train step may leave allocated beyond the state it returns and
# its batch (workspaces, small caches); a tree kept alive past its step
# by a reference cycle is GBs at every arch's cut
STEP_KEPT_SLACK = 0.5e9


def timed_steps(torch, step, box, batch, want, what, n, profile=True,
                kept=None):
    """``n`` steps of ``step`` from ``box["state"]`` on ``batch``, each
    launching exactly ``want`` (the last one profiled), each new state
    put in ``box`` in place of the old, so that no caller's name keeps a
    state alive (a full-width tree and its moments are tens of GB);
    returns (losses, step ms, the profile's (busy, wall, top ops) or
    None).  With a list ``kept``, the device memory allocated after each
    step is appended to it."""
    from repro_torch.kernels import runtime

    losses, step_ms, busy = [], [], None
    for i in range(n):
        runtime.reset_launch_counts()
        t0 = time.perf_counter()
        if profile and i == n - 1:
            busy = profiled_busy(torch, lambda: step(box.pop("state"),
                                                     batch))
            box["state"], m = busy[3]
            busy = busy[:3]
        else:
            box["state"], m = step(box.pop("state"), batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = runtime.launch_counts()
        if counts != want:
            raise AssertionError(f"{what} train step {i} launched {counts}, "
                                 f"expected {want}")
        losses.append(float(m["loss"]))
        del m
        if kept is not None:
            kept.append(torch.cuda.memory_allocated())
    if not all(math.isfinite(x) for x in losses) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{what}: losses {losses} do not fall")
    return losses, step_ms, busy


def same_grads_twice(torch, cut, params, batch) -> int:
    """The loss's gradients with respect to ``params`` taken twice on the
    same batch must be the same bits, leaf by leaf (the moe dispatch and
    combine and both backward kernels add in a fixed order).  Returns
    the leaves compared."""
    from repro_torch.models import lm_zoo as Z
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten

    def grads():
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, _ = Z.make_loss_fn(cut)(tree_unflatten(params, leaves), batch)
        return torch.autograd.grad(loss, leaves, allow_unused=True,
                                   materialize_grads=True)

    first = grads()
    for i, (a, b) in enumerate(zip(first, grads())):
        if not torch.equal(a, b):
            raise AssertionError(f"{cut.name}: two identical backward "
                                 f"passes differ at leaf {i}")
    return len(first)


def lm_train_steps(torch, dev, args, cfg, measured=None) -> dict:
    """Full width, depth, B and S cut as ``LM_TRAIN_OF`` says, with its
    optimizer (AdamW from ``make_optimizer``, or Adafactor for the moe
    layers): 3 steps of ``make_train_step`` on one seeded batch, block
    remat as the config says.  The loss must be finite and fall at every
    step; each step must launch the forward kernel twice an attention
    application or Mamba-1 layer (the remat recompute) and the backward
    kernel once.  For a moe arch, two backward passes on the trained
    tree must then give the same bits.  Returns the launches per step."""
    from repro_torch.models import lm_zoo as Z
    from repro_torch.train.optimizer import tree_leaves

    depth, B, S, opt_name = LM_TRAIN_OF[cfg.name]
    cut = train_cut(cfg, depth, opt_name)
    want = train_launches(cut)
    if cfg.family != "ssm":
        from repro_torch.kernels.flash_attention.ops import (
            backward_instance, instance)
        inst = (instance(torch.bfloat16, cfg.head_dim_),
                backward_instance(torch.bfloat16, cfg.head_dim_))
        if inst != ("sm90", "sm90"):
            raise AssertionError(f"{cfg.name}: its attention takes the "
                                 f"{inst} instances, forward and backward")
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    opt = Z.make_optimizer(cut)
    box = {"state": Z.init_train_state(
        cut, torch.Generator(device=dev).manual_seed(args.seed), opt,
        device=dev)}
    n_params = sum(p.numel() for p in tree_leaves(box["state"]["params"]))
    batch = seeded_tokens(torch, cut, B, S, args.seed, dev)
    step = Z.make_train_step(cut, opt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    args_allocated = torch.cuda.memory_allocated() - base
    # the state's and the batch's bytes and leaves (no name may keep the
    # initial state alive past its step: ``timed_steps``)
    held = [(t.numel() * t.element_size()) for t in
            tree_leaves(box["state"]) if torch.is_tensor(t)] \
        + [tree_bytes(batch)]
    torch.cuda.reset_peak_memory_stats()
    kept = []
    losses, step_ms, busy = timed_steps(
        torch, step, box, batch, want, cfg.name, LM_TRAIN_STEPS, kept=kept)
    peak = torch.cuda.max_memory_allocated()
    # a step keeps nothing but the state it returns (no reference cycle
    # holding the old tree until the cyclic collector runs)
    state = tree_bytes(batch) + sum(
        t.numel() * t.element_size() for t in tree_leaves(box["state"])
        if torch.is_tensor(t))
    extra = [k - base - state for k in kept]
    if max(extra) > STEP_KEPT_SLACK:
        raise AssertionError(f"{cfg.name}: allocated after the steps beyond "
                             f"the state and batch ({state} B): {extra} B")
    if measured is not None and (cfg.name, "train") in DRYRUN_OF:
        measured[cfg.name, "train"] = {
            "args": sum(held), "allocated": args_allocated,
            "peak": peak - base, "leaves": len(held), "launches": want,
            "ms": step_ms[1], "depth": depth, "B": B, "S": S}
    same = ""
    if cut.moe is not None:
        n = same_grads_twice(torch, cut, box["state"]["params"], batch)
        same = (f"; two backward passes on the trained tree: the same "
                f"bits in all {n} gradient leaves")
    vocab = (f", vocabulary cut to {cut.vocab:,}" if cut.vocab != cfg.vocab
             else "")
    log(f"[lm_train] {cfg.name} cut to {depth} layers{vocab} "
        f"({n_params / 1e9:.3f} B params), B {B} x S {S}, remat {cut.remat!r}, "
        f"{cut.optimizer}: init {init_s:.1f} s; losses "
        f"{[round(x, 4) for x in losses]}; step ms "
        f"{[round(x, 1) for x in step_ms]} (the last profiled); peak "
        f"{peak / 1e9:.2f} GB; allocated after each step beyond the state "
        f"and batch ({state / 1e9:.2f} GB) {[round(x / 1e6, 1) for x in extra]}"
        f" MB (tol {STEP_KEPT_SLACK / 1e6:.0f}); launches per step {want} "
        f"(exact); profiled "
        f"step: device busy {busy[0]:.4f} of {busy[1] * 1e3:.1f} ms, top "
        f"device ops (ms) {busy[2]}{same}")
    del box, batch
    return want


def mesh_train_steps(torch, dev, args, cfg) -> dict:
    """Qwen3-MoE's full-width layer (``MESH_TRAIN``, Adafactor) trained
    under the (1, 4) mesh: each layer's attention takes the
    context-parallel blocked branch (flash at the 4 shards' q_offsets,
    twice under block remat, and the backward kernel at each once:
    exactly 8 and 4 launches a step) and its moe layer the
    expert-parallel path; 3 steps on one seeded batch, the loss finite
    and falling, timed beside one step of the same state off the mesh
    (2 and 1 launches), with both peaks.  Returns the mesh step's
    launches."""
    from repro_torch.models import lm_zoo as Z
    from repro_torch.models import moe
    from repro_torch.models import transformer_lm as T

    t0 = time.perf_counter()
    depth, B, S = MESH_TRAIN
    cut = train_cut(cfg, depth, "adafactor")
    sp = MESH[1]
    score = B * cut.n_heads * (S // sp) * S * 4.0
    if not score > T._CP_SCORE_BYTES_LIMIT:
        raise AssertionError(f"mesh train: a shard's score block {score} B "
                             f"takes the direct branch")
    opt = Z.make_optimizer(cut)
    box = {"state": Z.init_train_state(
        cut, torch.Generator(device=dev).manual_seed(args.seed + 5), opt,
        device=dev)}
    batch = seeded_tokens(torch, cut, B, S, args.seed + 5, dev)
    step = Z.make_train_step(cut, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # one step off the mesh from the same state, its new state dropped
    flat_ms = timed_steps(torch, step, dict(box), batch, train_launches(cut),
                          f"{cfg.name} off the mesh", 1, profile=False)[1]
    flat_peak = torch.cuda.max_memory_allocated()
    want = train_launches(cut, sp)
    paths = []
    torch.cuda.reset_peak_memory_stats()
    with mesh_ctx(dev), \
            hooked(T, "_cp_attention_shard_map",
                   lambda a, kw, out: paths.append(("cp", kw["blocked"]))), \
            hooked(moe, "_moe_apply_ep",
                   lambda a, kw, out: paths.append(("ep",))):
        losses, step_ms, _ = timed_steps(
            torch, step, box, batch, want, f"{cfg.name} under the mesh",
            LM_TRAIN_STEPS, profile=False)
    peak = torch.cuda.max_memory_allocated()
    if not took_cp_ep(paths, depth * LM_TRAIN_STEPS):
        raise AssertionError(f"mesh train: the steps took {set(paths)}, "
                             f"expected CP blocked and EP")
    log(f"[mesh] {cfg.name} cut to {depth} layer, Adafactor, B {B} x S {S} "
        f"under a {MESH} mesh (CP blocked: each shard's score block "
        f"{score:.3g} B; EP): losses {[round(x, 4) for x in losses]}; step "
        f"ms {[round(x, 1) for x in step_ms]} (off the mesh "
        f"{flat_ms[0]:.1f}, peak {flat_peak / 1e9:.2f} GB); peak "
        f"{peak / 1e9:.2f} GB; launches per step {want} (exact); "
        f"{time.perf_counter() - t0:.1f} s")
    del box, batch
    return want


def took_cp_ep(paths, layers) -> bool:
    """Whether ``layers`` layer applications under autograd and block
    remat took the blocked context-parallel branch and the
    expert-parallel moe path (``paths`` as ``hooked`` records them on
    return): each layer's forward and its recompute return from the
    attention; the recompute stops once the block's saved tensors are
    back (``torch.utils.checkpoint``'s early stop), inside the moe
    layer, so only the forward's moe call returns for certain."""
    return (set(paths) == {("cp", True), ("ep",)}
            and paths.count(("cp", True)) == 2 * layers
            and paths.count(("ep",)) >= layers)


def plain_bwd_sliced(torch, q, k, v, dout, causal, off, flush):
    """The plain version's autograd (dq, dk, dv) and rounding budgets
    (``flash_attention_grad_budget``) at ``q_offset`` ``off`` (None: the
    default), in float32, taken in (batch, KV head) slices to bound the
    score blocks' memory, and the summed device ms of the slices'
    backward passes."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_grad_budget, flash_attention_ref)

    B, Hkv = k.shape[0], k.shape[2]
    G = q.shape[2] // Hkv
    q, k, v, dout = (t.detach() for t in (q, k, v, dout))
    outs = [torch.empty_like(t, dtype=torch.float32) for t in
            (q, k, v, q, k, v)]
    ms = 0.0
    for b in range(B):
        for h in range(Hkv):
            hq = slice(h * G, (h + 1) * G)
            ins = [q[b:b + 1, :, hq], k[b:b + 1, :, h:h + 1],
                   v[b:b + 1, :, h:h + 1]]
            ins = [t.contiguous().requires_grad_() for t in ins]
            d = dout[b:b + 1, :, hq].contiguous()
            out = flash_attention_ref(*ins, causal=causal, q_offset=off)
            back = lambda: torch.autograd.grad(out, ins, d,
                                               retain_graph=True)
            got = back()
            ms += device_ms(torch, back, flush, reps=2)
            budget = flash_attention_grad_budget(
                *(t.detach() for t in ins), d, causal=causal, q_offset=off)
            for j, t in enumerate(got + budget):
                idx = (slice(b, b + 1), slice(None),
                       hq if j % 3 == 0 else slice(h, h + 1))
                outs[j][idx] = t.float()
            del out, got, budget
    return outs[:3], outs[3:], ms


def mesh_flash_bwd_row(torch, dev, cfg, flush, launches):
    """The flash_attention backward at the mesh train step's
    context-parallel shape (q 2 x 2,048 of the 8,192 positions,
    qwen3-moe's 64/4 heads of 128, bf16, causal: the Hopper instance) at
    each shard's q_offset 0, 2,048, 4,096 and 6,144, against the plain
    version's autograd at the same offset, taken in (batch, KV head)
    slices to bound its memory: each query row of dq and each key of dk
    and dv within BF16_GRAD_ROW beyond its rounding budget, and dk and dv
    exactly 0 on the keys past the shard's last row (no query sees
    them).  Shard 0's gradient at the last shard's offset, a planted
    fault, must fail the bar.  Timed beside the backward of one
    scaled_dot_product_attention with the same boolean mask; the row's
    times and bound are the four offsets' sums (one layer's backward).
    Then the general instance in float32 at the same offsets of a
    smaller shape, within 1e-5 of max(1, max |grad|)."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         instance)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_ref, grad_rows_beyond_budget)

    _, B, S = MESH_TRAIN
    sp = MESH[1]
    Sq, Hq, Hkv, D = S // sp, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    G = Hq // Hkv
    inst = instance(torch.bfloat16, D)
    if inst != "sm90":
        raise AssertionError(f"mesh: flash_attention takes the {inst} "
                             f"instance at head dim {D}")
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(31)
    q, k, v, dout = [torch.randn(sh, generator=g, device=dev)
                     .to(torch.bfloat16) for sh in (
                         (B, Sq, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                         (B, Sq, Hq, D))]
    kpos = torch.arange(S, device=dev)
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * B * Hq * Sq
    tot = dict(ms=0.0, call=0.0, plain=0.0, lib=0.0, lib_call=0.0,
               bound=0.0)
    rels, errs, per, bys, zeros = [], [], [], set(), 0

    for off in range(0, S, Sq):
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out_k = flash_attention(*ins, causal=True, q_offset=off)
        kernel = lambda: torch.autograd.grad(out_k, ins, dout,
                                             retain_graph=True)
        got = kernel()
        torch.cuda.synchronize()
        want, budgets, plain_ms = plain_bwd_sliced(torch, q, k, v, dout,
                                                   True, off, flush)
        for name, a, w, bud in zip(("dq", "dk", "dv"), got, want, budgets):
            rel = grad_rows_beyond_budget(a, w, bud)
            if not rel <= BF16_GRAD_ROW:
                raise AssertionError(f"mesh: flash_attention_bwd {name} at "
                                     f"q_offset {off}: {rel} of a row's max")
            rels.append(rel)
            errs.append(float((a.float() - w).abs().max()))
        if off + Sq < S:          # keys past the shard's last row
            unseen = [t[:, off + Sq:] for t in got[1:]]
            if any(bool(t.any()) for t in unseen):
                raise AssertionError(f"mesh: flash_attention_bwd at "
                                     f"q_offset {off} wrote nonzero dk/dv "
                                     f"on keys no query sees")
            zeros += unseen[0].shape[1]
        if off == 0:              # the planted fault: the last offset
            wrong = torch.autograd.grad(
                flash_attention(*ins, causal=True, q_offset=S - Sq), ins,
                dout)
            bad = max(grad_rows_beyond_budget(a, w, bud) for a, w, bud in
                      zip(wrong, want, budgets))
            # over what the shard sees alone (dq, and dk and dv of the
            # keys up to its last row) and only the rows whose reference
            # is not 0 (the unseen keys, and dq's first row, whose one
            # key's softmax is 1): elsewhere the 1e-30 floor reads it
            over, top = [], []
            for a, w, bud, n in zip(wrong, want, budgets,
                                    (Sq, off + Sq, off + Sq)):
                w = w[:, :n]
                over.append(((a[:, :n].float() - w).abs() - bud[:, :n])
                            .clamp_min(0).amax(-1).flatten())
                top.append(w.abs().amax(-1).flatten())
            over, top = torch.cat(over), torch.cat(top)
            seen = (over[top > 0] / top[top > 0]).double()
            bad_seen = float(seen.max())
            seen_share = float((seen > BF16_GRAD_ROW).double().mean())
            if not min(bad, bad_seen) > BF16_GRAD_ROW:
                raise AssertionError(f"mesh: the per-row bar passes shard "
                                     f"0's gradient at the last shard's "
                                     f"offset ({bad}; on the rows it sees "
                                     f"{bad_seen})")
            del wrong, over, top, seen
        del got, want, budgets
        mask = kpos[None, :] <= (torch.arange(Sq, device=dev) + off)[:, None]
        lib_in = [t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v)]
        out_l = F.scaled_dot_product_attention(*lib_in, attn_mask=mask,
                                               enable_gqa=True)
        d_l = dout.transpose(1, 2)
        library = lambda: torch.autograd.grad(out_l, lib_in, d_l,
                                              retain_graph=True)
        ms, lib_ms = (device_ms(torch, kernel, flush),
                      device_ms(torch, library, flush))
        turns = [call_ms(torch, fn, flush=flush)
                 for fn in (kernel, library, library, kernel)]
        pairs = B * Hq * float(np.minimum(S, off + np.arange(Sq) + 1).sum())
        b, by = bound_ms(nbytes, 10.0 * D * pairs, BF16_OPS_PER_S,
                         exps=pairs)
        bys.add(by)
        for key, val in (("ms", ms), ("lib", lib_ms),
                         ("call", (turns[0] + turns[3]) / 2),
                         ("lib_call", (turns[1] + turns[2]) / 2),
                         ("plain", plain_ms), ("bound", b)):
            tot[key] += val
        per.append(f"{off}: {ms:.4f}/{lib_ms:.4f}/{b:.4f}")
        del ins, out_k, lib_in, out_l, mask
        torch.cuda.empty_cache()
    del q, k, v, dout

    # the general instance in float32 at the same offsets, a smaller shape
    f_shape, f_errs = "B=2 Sq=256 Skv=1024 Hq=8 Hkv=2 D=64", []
    f_in = [torch.randn(sh, generator=g, device=dev) for sh in (
        (2, 256, 8, 64), (2, 1024, 2, 64), (2, 1024, 2, 64))]
    f_d = torch.randn((2, 256, 8, 64), generator=g, device=dev)
    for off in (0, 256, 512, 768):
        grads = []
        for fn in (flash_attention, flash_attention_ref):
            ins = [t.clone().requires_grad_() for t in f_in]
            grads.append(torch.autograd.grad(
                fn(*ins, causal=True, q_offset=off), ins, f_d))
        f_errs += [grad_err(torch, a, w, f"flash_attention_bwd f32 q_offset "
                            f"{off}", ATOL_KERNEL)
                   for a, w in zip(*grads)]
    shape = (f"B={B} Sq={Sq} Skv={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal "
             f"q_offset {'/'.join(str(o) for o in range(0, S, Sq))} (a "
             f"layer's {sp} context-parallel shards, one launch each)")
    log(f"[kernel] flash_attention_bwd ({inst}) {cfg.name} {shape} ok dq, "
        f"dk, dv beyond the rounding budget {max(rels):.3g} of a row's max "
        f"(tol {BF16_GRAD_ROW}; shard 0 at the last shard's offset "
        f"{bad:.3g}, over its dq and the keys it sees, rows whose "
        f"reference is not 0, {bad_seen:.3g} with {seen_share:.3g} of "
        f"them over the bar; both must exceed it), max|err| "
        f"{max(errs):.3g}; dk and dv "
        f"exactly 0 on the {zeros} keys past the shards' last rows; device "
        f"ms of the {sp}: kernel {tot['ms']:.4f}  plain {tot['plain']:.4f} "
        f"(its {B * Hkv} (batch, KV head) slices summed)  bound "
        f"{tot['bound']:.4f} ({'/'.join(sorted(bys))})  library (SDPA "
        f"backward, the same boolean mask) {tot['lib']:.4f}; per offset "
        f"kernel/library/bound {'  '.join(per)}; ms per call summed, in "
        f"turns: kernel {tot['call']:.4f}  library {tot['lib_call']:.4f}; "
        f"launches {launches['flash_attention_bwd']} a mesh train step; the "
        f"general instance f32 at {f_shape} q_offset 0/256/512/768 max|err| "
        f"{max(f_errs):.3g} (tol {ATOL_KERNEL} of max(1, max|grad|))")
    return dict(name="flash_attention_bwd", route="cuda", instance=inst,
                source="src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
                replaces="src/repro/kernels/flash_attention/"
                         "flash_attention.py:82",
                launches=launches["flash_attention_bwd"],
                max_abs_err=max(errs), ms=tot["ms"], call_ms=tot["call"],
                plain_ms=tot["plain"], bound_ms=tot["bound"],
                bound_by="/".join(sorted(bys)), library_ms=tot["lib"],
                library_call_ms=tot["lib_call"], shape=shape)


def flash_bwd_rows(torch, dev, flush, launches, ab=()):
    """The flash_attention backward against the plain version's autograd
    at Yi-6B's train shape (2, 4,096, 32/4 heads of 128), Zamba2-2.7B's
    attention (2, 4,096, 32/32 heads of 80, the tail box), Qwen3-MoE's
    (64/4 heads of 128) and Llama-4-Scout's (40/8) in bf16, causal (the
    Hopper instances, forward and backward), at Nemotron-4's train shape
    (2, 4,096, 96/8 heads of 192) and at (1, 520) in bf16, causal (the
    Hopper instances; at D 192 its dk/dv pass splits 64-key tiles between
    two warpgroups), and at (2, 1,000, 8/2, 80)
    in float32, not causal (the general ones), timed beside the plain
    autograd backward (in (batch, KV head) slices past
    PLAIN_WHOLE_SCORES) and the autograd backward of one
    ``scaled_dot_product_attention`` (a yardstick, never called by the
    port).  Each bf16 row's Hopper backward is also timed in turns with
    the general instance's (its WMMA route, taken through the ops
    module's private ``_instance``), which must agree with it within the
    same bar.  The bf16 rows count their archs' train steps' launches
    (``launches``, by arch); Nemotron-4's S 520 row and the float32 rows'
    shapes are on no card path, so they count their own call's.  With ``ab``, each float32 row's
    backward is also timed in turns with each directory's design of the
    general backward (``flash_attention_bwd``), on this tree's forward
    outputs."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ops import (backward_instance,
                                                         flash_attention,
                                                         instance)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_grad_budget, flash_attention_ref,
        grad_rows_beyond_budget)

    F = torch.nn.functional
    rows = []
    for B, S, Hq, Hkv, D, causal, dname, launches_of in FLASH_BWD_SHAPES:
        dtype = getattr(torch, dname)
        g = torch.Generator(device=dev).manual_seed(23)
        ins = [torch.randn(sh, generator=g, device=dev).to(dtype)
               .requires_grad_()
               for sh in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
        dout = torch.randn((B, S, Hq, D), generator=g, device=dev).to(dtype)
        out_k = flash_attention(*ins, causal=causal)
        got = torch.autograd.grad(out_k, ins, dout, retain_graph=True)
        out_p = budgets = None
        sliced = B * Hq * S * S * 4 > PLAIN_WHOLE_SCORES
        if sliced:
            want, budgets, plain_ms = plain_bwd_sliced(
                torch, *ins, dout, causal, None, flush)
        else:
            out_p = flash_attention_ref(*ins, causal=causal)
            want = torch.autograd.grad(out_p, ins, dout, retain_graph=True)
        torch.cuda.synchronize()
        names = [f"flash_attention_bwd {nm} D={D}" for nm in ("dq", "dk",
                                                              "dv")]
        inst = backward_instance(dtype, D)
        turns = None
        if dtype == torch.bfloat16:
            tol = BF16_GRAD_ROW
            if budgets is None:
                budgets = flash_attention_grad_budget(
                    *(t.detach() for t in ins), dout, causal=causal)
            rels = [grad_rows_beyond_budget(a, w, b)
                    for a, w, b in zip(got, want, budgets)]
            rel = max(rels)
            if not rel <= tol:
                raise AssertionError(
                    f"flash_attention_bwd D={D}: dq, dk, dv beyond the "
                    f"rounding budget {rels} of a row's max > {tol}")
            err = max(max_err(torch, a, w, nm, math.inf)
                      for nm, a, w in zip(names, got, want))
            # the control: the same bar must fail the kernel's gradients
            # with the last KV tile's dk and dv zeroed
            dropped = [a.clone() for a in got[1:]]
            for a in dropped:
                a[:, -FAULT_TAIL:] = 0
            fault = max(grad_rows_beyond_budget(a, w, b) for a, w, b in
                        zip(dropped, want[1:], budgets[1:]))
            if not fault > tol:
                raise AssertionError(f"flash_attention_bwd: the bar {tol} "
                                     f"passes the last KV tile's dk and dv "
                                     f"zeroed ({fault})")
            held = (f"per row beyond the rounding budget {rel:.3g} (tol "
                    f"{tol}; the last KV tile's dk and dv zeroed: "
                    f"{fault:.3g})")
            if inst == "sm90":
                turns, agree = route_turns(torch, ops, ins, dout, causal,
                                           got, budgets, flush,
                                           f"D={D} Hkv={Hkv}")
                held += (f"; the general instance against the Hopper one "
                         f"{agree:.3g} (tol {tol})")
            del dropped, budgets
        else:
            tol = ATOL_KERNEL
            errs = [grad_err(torch, a, w, nm, tol)
                    for nm, a, w in zip(names, got, want)]
            err = max(errs)
            rel = max(e / max(1.0, float(w.abs().max()))
                      for e, w in zip(errs, want))
            held = f"{rel:.3g} of max(1, max|grad|) (tol {tol})"
        del got, want
        lib_in = [t.detach().transpose(1, 2).requires_grad_() for t in ins]
        out_l = F.scaled_dot_product_attention(*lib_in, is_causal=causal,
                                               enable_gqa=True)
        d_l = dout.transpose(1, 2)
        kernel = lambda: torch.autograd.grad(out_k, ins, dout,
                                             retain_graph=True)
        plain = lambda: torch.autograd.grad(out_p, ins, dout,
                                            retain_graph=True)
        library = lambda: torch.autograd.grad(out_l, lib_in, d_l,
                                              retain_graph=True)
        ms, call = timings(torch, kernel, flush)
        if not sliced:
            plain_ms = device_ms(torch, plain, flush, reps=3)
        lib_ms, lib_call = timings(torch, library, flush)
        pairs = B * Hq * ((S * S + S) / 2 if causal else S * S)
        ops_n = 10.0 * D * pairs      # S, dP, dv, dk, dq: 2D FLOP a pair
        esize = ins[0].element_size()
        nbytes = esize * 4 * (ins[0].numel() + ins[1].numel()) \
            + 4 * B * Hq * S          # q o dO dq, k v dk dv; the lse
        bf16 = dtype == torch.bfloat16
        b, by, note = flash_bound(nbytes, ops_n, pairs, bf16)
        b7 = flash_bound(nbytes, 1.4 * ops_n, pairs, bf16)[0]
        slices = (f" (its {B * Hkv} (batch, KV head) slices summed)"
                  if sliced else "")
        fwd = instance(dtype, D)
        shape = (f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
                 f"{str(dtype).split('.')[-1]} "
                 f"{'causal' if causal else 'full'} ({inst}"
                 f"{f', after the {fwd} forward' if fwd != inst else ''})")
        log(f"[kernel] flash_attention_bwd {shape} ok max|err| {err:.3g}, "
            f"{held} device ms: kernel {ms:.4f}  plain {plain_ms:.4f}"
            f"{slices}  "
            f"bound {b:.4f} ({by}: {ops_n:.3g} FLOP, {pairs:.3g} exp, "
            f"{nbytes / 1e6:.1f} MB; with S and dP recomputed for dq, "
            f"seven products: {b7:.4f}{'; ' + note if note else ''})  "
            f"library (SDPA backward) "
            f"{lib_ms:.4f}; ms per call: kernel {call:.4f}  library "
            f"{lib_call:.4f}")
        src = ("flash_attention_bwd_sm90.cu" if inst == "sm90"
               else "flash_attention_bwd.cu")
        row = dict(name="flash_attention_bwd", route="cuda", instance=inst,
                   source=f"src/repro_torch/csrc/{src}",
                   replaces="src/repro/kernels/flash_attention/"
                            "flash_attention.py:82",
                   max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain_ms,
                   bound_ms=b, bound_by=by, library_ms=lib_ms,
                   library_call_ms=lib_call, shape=shape)
        if turns is not None:
            row["ab"] = {"general instance (csrc/flash_attention_bwd.cu)":
                         turns}
        if not bf16:
            row["fma_bound_ms"] = bound_ms(nbytes, ops_n, FP32_OPS_PER_S,
                                           exps=pairs)[0]
            ab_rows(torch, row, "flash_attention_bwd", ab, kernel, flush,
                    f"flash_attention_bwd ({shape})",
                    close=lambda a, w, what: grad_err(torch, a, w, what,
                                                      ATOL_KERNEL))
        if launches_of in launches:
            row["launches"] = launches[launches_of]["flash_attention_bwd"]
        else:
            row["launches"] = own_launches(torch, "flash_attention_bwd",
                                           kernel)
            if dtype == torch.float32:
                row["path"] = "widened"
            else:
                row["launches_of"] = launches_of
        rows.append(row)
        del ins, dout, out_k, out_p, lib_in, out_l
        torch.cuda.empty_cache()
    return rows


def route_turns(torch, ops, ins, dout, causal, got, budgets, flush, what):
    """The Hopper backward (``got``, its gradients) against the general
    instance's on the same forward outputs: the general one's gradients
    within BF16_GRAD_ROW of the Hopper one's per row beyond the rounding
    budget, then both timed in turns, general, Hopper, Hopper, general
    (one backward launch each, no autograd, 5 calls a turn: the general
    instance takes 15-33 ms a call at the D 64-128 train shapes and about
    197 ms at Nemotron-4's).  Returns (turns, the agreement)."""
    from repro_torch.kernels.flash_attention.ref import (
        grad_rows_beyond_budget)

    q, k, v = (t.detach() for t in ins)
    B, S, Hq, _ = q.shape
    lse = torch.empty((B, Hq, S), device=q.device)
    o32 = torch.empty(q.shape, device=q.device)
    ops._forward(q, k, v, causal, lse, o32)
    run = {inst: (lambda inst=inst: ops.flash_attention_bwd(
        q, k, v, o32, lse, dout, causal=causal, _instance=inst))
        for inst in ("general", None)}
    other = run["general"]()
    torch.cuda.synchronize()
    agree = max(grad_rows_beyond_budget(a, w, b)
                for a, w, b in zip(other, got, budgets))
    if not agree <= BF16_GRAD_ROW:
        raise AssertionError(f"flash_attention_bwd: the general instance "
                             f"against the Hopper one {agree} > "
                             f"{BF16_GRAD_ROW}")
    del other
    return general_turns(torch, run["general"], run[None], flush,
                         f"flash_attention_bwd ({what})", reps=5), agree


def scan_bwd_row(torch, dev, flush, cfg, launches, ab=()):
    """The selective_scan backward at Falcon-Mamba-7B's train shape (2,
    4,096, 8,192, 16), with a gradient into h_last too: held against the
    plain loop's autograd with L cut to 1,024 (its graph keeps every
    step's tensors), timed at the full L; the plain time is at the cut
    L.  No PyTorch call computes the scan.  With ``--ab``, timed in turns
    with the design of each directory's ``selective_scan_bwd.cu``, the
    two within 1e-5 of max(1, max |grad|) of each other at the full L."""
    from repro_torch.kernels.selective_scan.ops import selective_scan
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    B, L = LM_TRAIN[1], LM_TRAIN[2]
    Din, N = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
    g = torch.Generator(device=dev).manual_seed(29)
    r = lambda *s: torch.rand(s, generator=g, device=dev)
    n = lambda *s: torch.randn(s, generator=g, device=dev)
    full = (0.001 + 0.099 * r(B, L, Din), n(B, L, Din),
            -(0.5 + 3.5 * r(Din, N)), n(B, L, N), n(B, L, N), n(B, Din, N))
    d_out = (n(B, L, Din), n(B, Din, N))

    def leaves(length):   # the inputs cut to ``length`` steps, as leaves
        return [(t[:, :length] if i in (0, 1, 3, 4) else t).contiguous()
                .requires_grad_() for i, t in enumerate(full)]

    Lc = SCAN_ORACLE_L
    cut_in, cut_d = leaves(Lc), (d_out[0][:, :Lc].contiguous(), d_out[1])
    out_k = selective_scan(*cut_in)
    out_p = selective_scan_ref(*cut_in)
    got = torch.autograd.grad(out_k, cut_in, cut_d, retain_graph=True)
    want = torch.autograd.grad(out_p, cut_in, cut_d, retain_graph=True)
    torch.cuda.synchronize()
    err = max(grad_err(torch, a, b, f"selective_scan_bwd {nm}", ATOL_KERNEL)
              for nm, a, b in zip(("ddt", "dx", "dA", "dB", "dC", "dh0"),
                                  got, want))
    plain = lambda: torch.autograd.grad(out_p, cut_in, cut_d,
                                        retain_graph=True)
    plain_ms = device_ms(torch, plain, flush, reps=2)
    del got, want, out_p, plain
    ins = leaves(L)
    out_f = selective_scan(*ins)
    kernel = lambda: torch.autograd.grad(out_f, ins, d_out,
                                         retain_graph=True)
    ms, call = timings(torch, kernel, flush)
    elems = B * L * Din * N
    nbytes = 4 * (5 * B * L * Din + 4 * B * L * N + 2 * Din * N
                  + 3 * B * Din * N)
    b, by = bound_ms(nbytes, 10.0 * elems, exps=elems)
    shape = (f"B={B} L={L} Din={Din} N={N} f32 (oracle and plain at "
             f"L={Lc})")
    log(f"[kernel] selective_scan_bwd {shape} ok max|err| {err:.3g} (tol "
        f"{ATOL_KERNEL} of max(1, max|grad|)) device ms: kernel {ms:.4f}  "
        f"plain (L {Lc}) {plain_ms:.4f}  bound {b:.4f} ({by}: "
        f"{nbytes / 1e6:.1f} MB, {elems:.3g} exp)  library none; ms per "
        f"call: kernel {call:.4f}")
    row = dict(name="selective_scan_bwd", route="cuda",
               source="src/repro_torch/csrc/selective_scan_bwd.cu",
               replaces="src/repro/kernels/selective_scan/"
                        "selective_scan.py:57",
               max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain_ms,
               bound_ms=b, bound_by=by, library_ms=None,
               library_call_ms=None, shape=shape,
               launches=launches["selective_scan_bwd"])
    ab_rows(torch, row, "selective_scan_bwd", ab, kernel, flush,
            f"selective_scan_bwd ({shape})",
            lambda o, t, what: grad_err(torch, o, t, what, ATOL_KERNEL))
    return row


@contextlib.contextmanager
def last_tile_dropped(torch):
    """A fault planted in both backward kernels, the control of the bf16
    train step's gradient bar: the gradients of the last FAULT_TAIL
    positions zeroed (flash: those keys' dk and dv; the scan: ddt, dx, dB
    and dC of those steps), as a grid that missed its last tile would
    leave them."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.selective_scan import ops as ss

    flash_bwd, scan_bwd = fa.flash_attention_bwd, ss.selective_scan_bwd

    def flash(*args, **kwargs):
        dq, dk, dv = flash_bwd(*args, **kwargs)
        dk[:, -FAULT_TAIL:] = 0
        dv[:, -FAULT_TAIL:] = 0
        return dq, dk, dv

    def scan(*args):
        grads = scan_bwd(*args)
        for t in (grads[0], grads[1], grads[3], grads[4]):
            t[:, -FAULT_TAIL:] = 0
        return grads

    fa.flash_attention_bwd, ss.selective_scan_bwd = flash, scan
    try:
        yield
    finally:
        fa.flash_attention_bwd, ss.selective_scan_bwd = flash_bwd, scan_bwd


def cut_loss_grads(torch, cut, tree, toks, device):
    """(loss, gradients with respect to every leaf of ``tree``, metrics)
    of one train step's loss on ``toks``, on ``device``."""
    from repro_torch.models import lm_zoo as Z
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten

    leaves = [p.detach().requires_grad_() for p in tree_leaves(tree)]
    loss, m = Z.make_loss_fn(cut)(tree_unflatten(tree, leaves),
                                  {"tokens": toks.to(device)})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return (float(loss.detach()), list(grads),
            {k: float(v.detach()) for k, v in m.items()})


def leaf_rel(got, want) -> float:
    """The largest over the leaves of max |got - want| / max |want|,
    each leaf of ``want`` moved to ``got``'s device (the card's, where
    the arithmetic over a full-width tree is quick)."""
    def rel(a, b):
        b = b.to(a.device)
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    return max(rel(a, b) for a, b in zip(got, want))


def lm_train_cut(torch, dev, args, cfg):
    """Full width, depth cut as ``LM_TRAIN_CUT_OF`` says (Yi 1 layer at
    B 2, S 256, Falcon 1 layer and Zamba2 one superlayer at B 1, S 256;
    the moe archs and Nemotron-4 1 layer at B 1, S 128): every gradient leaf of one train
    step on the card against the CPU.  In float32 the loss within
    ATOL_LOSS and each leaf within RTOL_GRAD of its max |grad|, a moe
    arch's experts the same for every token; in bf16 each leaf within
    BF16_STEP_GRAD_REL of it (a moe arch's CPU side replaying the card's
    experts, a token routed differently a near-tie), a bar that must
    fail the card's gradients with the last tile's gradients of both
    backward kernels zeroed (the bf16 loss is logged: the forward is
    held by the bf16 prefill logits of ``lm_cut_checks``).  On Qwen3-MoE's
    cut, :func:`mesh_train_holds` too."""
    from repro_torch.launch.mesh_fleet import float32_compute, routing
    from repro_torch.models import lm_zoo as Z

    depth, B, S = LM_TRAIN_CUT_OF.get(cfg.name, LM_CUT)
    cut = train_cut(cfg, depth)
    params = Z.init_params(cut, torch.Generator(device=dev).manual_seed(
        args.seed + 2), device=dev)
    cpu = _to_cpu(params)
    toks = seeded_tokens(torch, cut, B, S, args.seed + 2, "cpu")["tokens"]

    t0 = time.perf_counter()
    ts = []                          # card and CPU seconds of each pass
    with float32_compute():
        with routing() as r_g:
            l_g, g_g, _ = cut_loss_grads(torch, cut, params, toks, dev)
        ts.append(time.perf_counter())
        with routing() as r_c:
            l_c, g_c, _ = cut_loss_grads(torch, cut, cpu, toks, "cpu")
        ts.append(time.perf_counter())
    routing_note(torch, r_g, r_c, f"{cfg.name} f32 train step")
    d_f, rel_f = abs(l_g - l_c), leaf_rel(g_g, g_c)
    if not (d_f <= ATOL_LOSS and rel_f <= RTOL_GRAD):
        raise AssertionError(f"{cfg.name} f32 train step, card vs CPU: "
                             f"loss {d_f}, gradients {rel_f} of a leaf's "
                             f"max")
    del g_g, g_c
    ts.append(time.perf_counter())
    with routing() as r_g:
        b_g, h_g, _ = cut_loss_grads(torch, cut, params, toks, dev)
    ts.append(time.perf_counter())
    with routing(r_g) as r_c:
        b_c, h_c, _ = cut_loss_grads(torch, cut, cpu, toks, "cpu")
    ts.append(time.perf_counter())
    note = routing_note(torch, r_g, r_c, "bf16 train step", NEAR_TIE)
    rel_b = leaf_rel(h_g, h_c)
    del h_g
    with last_tile_dropped(torch), routing(r_g):
        rel_x = leaf_rel(cut_loss_grads(torch, cut, params, toks, dev)[1],
                         h_c)
    del h_c
    ts.append(time.perf_counter())
    split = " / ".join(f"{b - a:.1f}" for a, b in zip([t0] + ts, ts))
    if not rel_b <= BF16_STEP_GRAD_REL < rel_x:
        raise AssertionError(
            f"{cfg.name} bf16 train step, card vs CPU: gradients {rel_b} "
            f"of a leaf's max, with the last tile's gradients zeroed "
            f"{rel_x}; the bar {BF16_STEP_GRAD_REL} must lie between")
    routed = (f", the same experts for all {B * S} tokens in float32"
              if cut.moe is not None else "")
    if cfg.name == MESH_ARCH:
        t1 = time.perf_counter()
        routed += mesh_train_holds(torch, dev, cut, params, cpu, toks)
        split += f"; the mesh holds {time.perf_counter() - t1:.1f}"
    vocab = (f", vocabulary cut to {cut.vocab:,}" if cut.vocab != cfg.vocab
             else "")
    log(f"[lm_train] {cfg.name} cut to {depth} layers{vocab}, B {B} S {S}, "
        f"one train step's gradients, card vs CPU, the largest leaf max|diff| "
        f"/ leaf max|grad|: f32 {rel_f:.3g} (tol {RTOL_GRAD}; loss "
        f"{l_g:.6f} vs {l_c:.6f}, |diff| {d_f:.3g}, tol {ATOL_LOSS}); bf16 "
        f"{rel_b:.3g} (tol {BF16_STEP_GRAD_REL}; loss |diff| "
        f"{abs(b_g - b_c):.3g}, logged), with the last {FAULT_TAIL} "
        f"positions' gradients zeroed in both backward kernels {rel_x:.3g} "
        f"(must exceed the tol){routed}{note}; in "
        f"{time.perf_counter() - t0:.1f} s (f32 card / CPU / compare, bf16 "
        f"card / CPU / compare and fault: {split})")


def mesh_train_holds(torch, dev, cut, params, cpu, toks) -> str:
    """The mesh on the moe depth cut's train step, in float32, with the
    score budget lowered so that each shard's attention takes the
    blocked branch at the cut's S (flash and its backward at the 4
    shards' q_offsets, the general instances): (a) the card against the
    CPU, both under the (1, 4) mesh: the loss within ATOL_LOSS, each
    gradient leaf within RTOL_GRAD of its max, each token's experts
    equal, and on the card exactly the launches of ``train_launches(cut,
    4)``; (b) at a capacity factor of E / k (no shard and no row drops a
    slot) with the balance term weighted 0 (the EP balance loss is each
    shard's, averaged, by the JAX package's convention, so it differs
    from the dense path's by design; the CPU tests hold it against JAX),
    the mesh against no mesh on the card within the same bars.  Returns
    the note for the cut's log line."""
    import dataclasses

    from repro_torch.kernels import runtime
    from repro_torch.launch.mesh_fleet import float32_compute, routing
    from repro_torch.models import moe
    from repro_torch.models import transformer_lm as T

    paths, limit = [], T._CP_SCORE_BYTES_LIMIT
    T._CP_SCORE_BYTES_LIMIT = 1.0
    try:
        with float32_compute(), \
                hooked(T, "_cp_attention_shard_map", lambda a, kw, out:
                       paths.append(("cp", kw["blocked"]))), \
                hooked(moe, "_moe_apply_ep",
                       lambda a, kw, out: paths.append(("ep",))):
            runtime.reset_launch_counts()
            with mesh_ctx(dev), routing() as r_g:
                l_g, g_g, _ = cut_loss_grads(torch, cut, params, toks, dev)
            torch.cuda.synchronize()
            counts = runtime.launch_counts()
            with mesh_ctx(torch.device("cpu")), routing() as r_c:
                l_c, g_c, _ = cut_loss_grads(torch, cut, cpu, toks, "cpu")
        want = train_launches(cut, MESH[1])
        if counts != want:
            raise AssertionError(f"mesh train cut launched {counts}, "
                                 f"expected {want}")
        if not took_cp_ep(paths, 2 * cut.n_layers):     # card and CPU
            raise AssertionError(f"mesh train cut took {set(paths)}, "
                                 f"expected CP blocked and EP")
        routing_note(torch, r_g, r_c, "mesh f32 train step")
        d_a, rel_a = abs(l_g - l_c), leaf_rel(g_g, g_c)
        if not (d_a <= ATOL_LOSS and rel_a <= RTOL_GRAD):
            raise AssertionError(f"mesh f32 train step, card vs CPU: loss "
                                 f"{d_a}, gradients {rel_a} of a leaf's max")
        del g_g, g_c
        E, k = cut.moe.num_experts, cut.moe.top_k
        wide = dataclasses.replace(cut, moe=dataclasses.replace(
            cut.moe, capacity_factor=E / k, router_aux_weight=0.0))
        with float32_compute():
            with mesh_ctx(dev):
                l_m, g_m, m_m = cut_loss_grads(torch, wide, params, toks,
                                               dev)
            l_d, g_d, m_d = cut_loss_grads(torch, wide, params, toks, dev)
    finally:
        T._CP_SCORE_BYTES_LIMIT = limit
    drops = (m_m["moe_drop_frac"], m_d["moe_drop_frac"])
    if drops != (0.0, 0.0):
        raise AssertionError(f"mesh: cf {E / k} dropped {drops}")
    d_b, rel_b = abs(l_m - l_d), leaf_rel(g_m, g_d)
    if not (d_b <= ATOL_LOSS and rel_b <= RTOL_GRAD):
        raise AssertionError(f"mesh vs no mesh at cf {E / k}: loss {d_b}, "
                             f"gradients {rel_b} of a leaf's max")
    return (f"; under a {MESH} mesh with the score budget lowered (CP "
            f"blocked at {MESH[1]} offsets, EP; launches {counts}), f32 "
            f"card vs CPU: gradients {rel_a:.3g}, loss |diff| {d_a:.3g} "
            f"with the same experts; at cf {E / k:g} (no slot dropped, the "
            f"balance term weighted 0) mesh vs no mesh on the card: "
            f"gradients {rel_b:.3g}, loss |diff| {d_b:.3g} (tols "
            f"{RTOL_GRAD}, {ATOL_LOSS})")


def lm_resume(torch, dev, args, arch):
    """``LMTrainer`` on the card (``arch``'s reduced config): 2 steps, a
    save, a new trainer that restores and runs to step 4 must equal an
    uninterrupted 4-step run leaf by leaf, exactly."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import lm_batches
    from repro_torch.train.checkpoint import flatten_with_names
    from repro_torch.train.trainer import LMTrainer, TrainerConfig

    cfg = get_arch(arch).reduced()
    stream = lm_batches(cfg, 2, 64, seed=args.seed, device=dev)
    batches = [next(stream) for _ in range(4)]
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(name, steps):
            return LMTrainer(cfg, TrainerConfig(
                ckpt_dir=f"{tmp}/{name}", ckpt_every=100, log_every=1,
                max_steps=steps), seed=args.seed, device=dev)
        whole = trainer("whole", 4)
        whole.init_or_restore()
        whole.train(iter(batches))
        first = trainer("split", 2)
        first.init_or_restore()
        first.train(iter(batches))
        again = trainer("split", 4)
        again.init_or_restore()
        if (again.step, again.cursor) != (2, 2):
            raise AssertionError(f"resume at step {again.step}, cursor "
                                 f"{again.cursor}")
        again.train(iter(batches[again.cursor:]))
        a = flatten_with_names(whole.state)
        b = flatten_with_names(again.state)
        for (name, x), (_, y) in zip(a, b):
            same = x == y if isinstance(x, int) else torch.equal(x, y)
            if not same:
                raise AssertionError(f"{arch}: resumed run differs at "
                                     f"{name}")
    log(f"[lm_train] LMTrainer resume on the card ({cfg.name} reduced, "
        f"{cfg.n_layers} layers): steps 0-2, save, restore, steps 2-4 equal "
        f"an uninterrupted 4-step run in all {len(a)} leaves, exactly")


def lm_launcher():
    """``python -m repro_torch.launch.train lm --arch yi-6b`` (the reduced
    config, on the card) in a subprocess must exit 0."""
    import os
    import tempfile

    src = Path(__file__).resolve().parent / "src"
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{src}{os.pathsep}{env.get('PYTHONPATH', '')}"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "lm",
             "--arch", "yi-6b", "--steps", "12", "--ckpt", tmp], env=env,
            capture_output=True, text=True, timeout=300)
    if p.returncode != 0:
        raise AssertionError(f"launch.train lm exited {p.returncode}:\n"
                             f"{p.stdout}\n{p.stderr}")
    log(f"[lm_train] python -m repro_torch.launch.train lm --arch yi-6b "
        f"--steps 12: exit 0 in {time.perf_counter() - t0:.1f} s; "
        f"{' | '.join(p.stdout.strip().splitlines())}")


def lm_train_phase(torch, dev, args, measured=None):
    """Every arch of ``LM_TRAIN_OF``: train steps at full width; the mesh
    train step; then the two backward kernels against the plain autograd
    (flash also at the mesh step's context-parallel offsets); the
    card-vs-CPU train step of each arch's depth cut (and the mesh holds
    on Qwen3-MoE's); the resume of a dense and a moe arch; the launcher.
    Returns the rows of flash_attention_bwd and selective_scan_bwd."""
    from repro_torch.configs import get_arch

    t0 = time.perf_counter()
    launches = {}
    for arch in LM_TRAIN_OF:
        launches[arch] = lm_train_steps(torch, dev, args, get_arch(arch),
                                        measured)
        torch.cuda.empty_cache()
    mesh = mesh_train_steps(torch, dev, args, get_arch(MESH_ARCH))
    torch.cuda.empty_cache()
    tp = time.perf_counter()
    process_mesh_part(torch, dev, args, get_arch(MESH_ARCH), measured)
    torch.cuda.empty_cache()
    tp = time.perf_counter() - tp
    t1 = time.perf_counter()
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    rows = flash_bwd_rows(torch, dev, flush, launches, args.ab)
    rows.append(mesh_flash_bwd_row(torch, dev, get_arch(MESH_ARCH), flush,
                                   mesh))
    rows.append(scan_bwd_row(torch, dev, flush,
                             get_arch("falcon-mamba-7b"),
                             launches["falcon-mamba-7b"], args.ab))
    del flush
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    for arch in LM_TRAIN_OF:
        lm_train_cut(torch, dev, args, get_arch(arch))
        torch.cuda.empty_cache()
    t3 = time.perf_counter()
    for arch in ("yi-6b", MESH_ARCH):
        lm_resume(torch, dev, args, arch)
    lm_launcher()
    log(f"[lm_train] LM training phase done in "
        f"{time.perf_counter() - t0:.1f} s (train steps {t1 - t0 - tp:.1f}, "
        f"the process mesh part {tp:.1f}, "
        f"backward kernel rows {t2 - t1:.1f}, card-vs-CPU cuts "
        f"{t3 - t2:.1f})")
    return rows


# ---------------------------------------------------------------------------
# the process mesh part of the LM training phase
# ---------------------------------------------------------------------------

# Qwen3-MoE's full-width prefill as four ranks of a (1, 4) process mesh
# on the one card: the depth phase 9's mesh part serves (8 layers), each
# rank holding 1/4 of the expert blocks (about 13.3 GB of bf16 a rank);
# cut here, and say so, if four ranks do not fit beside each other
PROCESS_PREFILL_DEPTH = LM_SERVE_DEPTH[MESH_ARCH]
# 3 train steps on the process mesh: the full-width one-layer float32
# cut does not fit four times with an optimizer (each rank holds the
# whole embedding and head: its old and new parameters, its gradients
# and the update's temporaries come to about 33 GB a rank), so the
# steps run at the reduced config with block remat; the full-width cut
# is held by one train step's loss and gradients
PROCESS_TRAIN_STEPS = LM_TRAIN_STEPS
PROCESS_FLEET_TIMEOUT_S = 480.0


def process_fleet_jobs(args, tmp) -> list:
    """The jobs of the process mesh part's one fleet (``launch.
    mesh_fleet``): the full-width prefill, the float32 depth cut's
    hidden state and one train step's loss and gradients (the CP blocked
    branch: the score budget lowered), and 3 Adafactor train steps at
    the reduced config."""
    depth, B, S = LM_CUT_OF[MESH_ARCH]
    cut = {"job": "lm", "mesh": list(MESH), "arch": MESH_ARCH,
           "cfg": {"n_layers": depth}, "compute": "float32",
           "cp_score_limit": 1.0, "dir": str(tmp),
           "params": {"seed": args.seed + 2, "dtype": "float32"},
           "batch": {"seed": args.seed + 2, "B": B, "S": S}}
    Bp, Sp = MESH_PREFILL
    return [
        {"job": "lm", "mode": "prefill", "name": "prefill",
         "mesh": list(MESH), "arch": MESH_ARCH,
         "cfg": {"n_layers": PROCESS_PREFILL_DEPTH}, "save_hidden": False,
         "params": {"seed": args.seed, "dtype": "bfloat16"},
         "batch": {"seed": args.seed + 2, "B": Bp, "S": Sp},
         "dir": str(tmp)},
        dict(cut, name="cut", mode="grads"),
        {"job": "lm", "mode": "train", "name": "train", "mesh": list(MESH),
         "arch": MESH_ARCH, "reduced": True, "cfg": {"remat": "block"},
         "compute": "float32", "cp_score_limit": 1.0, "dir": str(tmp),
         "steps": PROCESS_TRAIN_STEPS,
         "optimizer": {"name": "adafactor", "peak_lr": 1e-2, "warmup": 1},
         "params": {"seed": args.seed + 7, "dtype": "float32"},
         "batch": {"seed": args.seed + 7, "B": 2, "S": 64}},
    ]


def collective_note(rows) -> str:
    """Count, wire bytes and host-staged seconds of a rank's record, by
    what ran and its kind."""
    from repro_torch.dist import spmd
    return "; ".join(
        f"{k}: {v['count']} x, {v['bytes'] / 1e6:.1f} MB, staged "
        f"{v['staged'] / 1e6:.1f} MB, {v['s'] * 1e3:.1f} ms"
        for k, v in sorted(spmd.summarize(rows).items()))


def process_mesh_part(torch, dev, args, cfg, measured):
    """Qwen3-MoE as four ranks of a (1, 4) process mesh on the one card
    (``launch.mesh_fleet``: one OS process a shard over gloo, the
    collectives staged through host memory, each rank holding 1/4 of the
    expert blocks): (a) the full-width prefill at 2 x 8,192 (CP blocked,
    EP): each rank launches flash exactly once a layer at its own
    q_offset, all ranks' logits equal bit for bit and finite, within
    ATOL_LOGITS of the logical mesh's (phase 9), each rank's time,
    peak, drop fraction and collective record printed beside the
    logical mesh's; (b) the float32 depth cut (one full-width layer, B 1
    x 128, the score budget lowered: CP blocked), against the logical
    mesh on the card: the prefill's hidden state within ATOL_SERVED,
    one train step's loss within ATOL_LOSS and each gradient leaf within
    RTOL_GRAD of its max (rank 0's whole leaves, every rank's expert
    block against its rows; the whole leaves' digests the same on every
    rank), each token's experts equal, flash twice and 5b once a layer
    on every rank (block remat); (c) 3 Adafactor train steps at the
    reduced config with block remat: the loss falling at every step and
    the same on every rank, flash twice and 5b once a layer a step."""
    import gc
    import tempfile

    from repro_torch.launch import mesh_fleet as MF
    from repro_torch.models import lm_zoo as Z
    from repro_torch.models import transformer_lm as T

    t0 = time.perf_counter()
    logical = measured["mesh_prefill"]
    gc.collect()                       # the card is the four ranks' now
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[process] before the fleet: this process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"({torch.cuda.memory_reserved() / 1e9:.2f} reserved), the card "
        f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free")
    with tempfile.TemporaryDirectory() as tmp:
        jobs = process_fleet_jobs(args, tmp)
        results = MF.launch(jobs, MESH[0] * MESH[1], device=dev.type,
                            timeout_s=PROCESS_FLEET_TIMEOUT_S)
        t1 = time.perf_counter()
        by = {j["name"]: [next(x for x in r["jobs"] if x["name"] == j["name"])
                          for r in results] for j in jobs}

        # (a) the full-width prefill
        ranks = by["prefill"]
        L = PROCESS_PREFILL_DEPTH
        logits = [np.load(r["file"])["logits"] for r in ranks]
        for i, r in enumerate(ranks):
            if r["launches"] != {"flash_attention": L}:
                raise AssertionError(f"process mesh: rank {i}'s prefill "
                                     f"launched {r['launches']}")
            if not (logits[i].shape == (MESH_PREFILL[0], cfg.vocab)
                    and np.isfinite(logits[i]).all()):
                raise AssertionError(f"process mesh: rank {i}'s logits")
            if not np.array_equal(logits[i], logits[0]):
                raise AssertionError(f"process mesh: rank {i}'s logits "
                                     f"differ from rank 0's")
        vs_logical = (float(np.abs(logits[0] - logical["logits"].numpy())
                            .max()) if logical["layers"] == L else None)
        if vs_logical is not None and not vs_logical <= ATOL_LOGITS:
            raise AssertionError(f"process mesh: logits {vs_logical} from "
                                 f"the logical mesh's")
        peaks = [r["peak_bytes"] / 1e9 for r in ranks]
        log(f"[process] {cfg.name} ({L} layers, full width) as {MESH} "
            f"process mesh ranks on one card: prefill "
            f"{MESH_PREFILL[0]} x {MESH_PREFILL[1]} "
            f"{' / '.join(f'{r['prefill_ms']:.1f}' for r in ranks)} ms a "
            f"rank (the logical mesh {logical['ms']:.1f} ms, off the mesh "
            f"{logical['flat_ms']:.1f}); flash launches "
            f"{[r['launches']['flash_attention'] for r in ranks]} (one a "
            f"layer a rank, at q_offset rank x {MESH_PREFILL[1] // MESH[1]}"
            f"; the logical mesh {MESH[1] * L}); logits equal on all ranks, "
            f"max|diff| from the logical mesh's "
            f"{vs_logical if vs_logical is not None else 'n/a'} (tol "
            f"{ATOL_LOGITS}); moe_drop_frac "
            f"{ranks[0]['aux']['moe_drop_frac']:.6f} (the logical mesh "
            f"{logical['drop']:.6f}); peak a rank "
            f"{' / '.join(f'{p:.2f}' for p in peaks)} GB (the logical mesh "
            f"{logical['peak'] / 1e9:.2f}); init in turns "
            f"{' / '.join(f'{r['init_s']:.1f}' for r in ranks)} s")
        for i, r in enumerate(ranks):
            log(f"[process] prefill rank {i} collectives: "
                f"{collective_note(r['record'])}")

        # (b) the float32 depth cut against the logical mesh on the card
        depth, B, S = LM_CUT_OF[MESH_ARCH]
        cut = train_cut(cfg, depth)
        params = Z.init_params(cut, torch.Generator(device=dev).manual_seed(
            args.seed + 2), device=dev)
        toks = seeded_tokens(torch, cut, B, S, args.seed + 2, dev)
        limit, T._CP_SCORE_BYTES_LIMIT = T._CP_SCORE_BYTES_LIMIT, 1.0
        try:
            with MF.float32_compute(), mesh_ctx(dev):
                with MF.routing() as r_h, torch.no_grad():
                    x = Z.embed_input(cut, params, toks)
                    pos = torch.arange(S, device=dev)[None].expand(B, S)
                    h_ref = T.forward_hidden(cut, params, x, pos)[0]
                with MF.routing() as r_g:
                    l_ref, g_ref, _ = cut_loss_grads(torch, cut, params,
                                                     toks["tokens"], dev)
        finally:
            T._CP_SCORE_BYTES_LIMIT = limit
        names = [n for n, _ in MF._paths(params)]
        del params
        rel, l_err, h_err = 0.0, 0.0, 0.0
        want_launch = train_launches(cut)
        for i, r in enumerate(by["cut"]):
            got = np.load(r["file"])
            h_err = max(h_err, float(np.abs(got["hidden"]
                                            - h_ref.cpu().numpy()).max()))
            # the forward's routing (the logical mesh routes shard by
            # shard; block remat's recompute may stop before routing)
            for what, key, ref in (("prefill", "hidden_experts/0", r_h),
                                   ("train", "experts/0", r_g)):
                if not np.array_equal(got[key], ref[i][1].numpy()):
                    raise AssertionError(f"process mesh cut: rank {i}'s "
                                         f"{what} experts differ")
            if r["launches"] != want_launch:
                raise AssertionError(f"process mesh cut: rank {i} launched "
                                     f"{r['launches']}, expected "
                                     f"{want_launch}")
            if r["whole_grad_digest"] != by["cut"][0]["whole_grad_digest"]:
                raise AssertionError(f"process mesh cut: rank {i}'s whole "
                                     f"gradients differ from rank 0's")
            l_err = max(l_err, abs(r["metrics"]["loss"] - l_ref))
            for name, g in zip(names, g_ref):
                key = f"grad/{name}"
                if key not in got.files:
                    continue
                mine = torch.from_numpy(got[key]).to(dev)
                if name in r["held"]:
                    size = mine.shape[1]
                    g = g.narrow(1, i * size, size)
                rel = max(rel, float((mine - g).abs().max())
                          / max(float(g.abs().max()), 1e-30))
            del got
        del g_ref
        if not (h_err <= ATOL_SERVED and l_err <= ATOL_LOSS
                and rel <= RTOL_GRAD):
            raise AssertionError(f"process mesh cut: hidden {h_err}, loss "
                                 f"{l_err}, gradients {rel} of a leaf's max")
        cut_peaks = [r["peak_bytes"] / 1e9 for r in by["cut"]]
        log(f"[process] {cfg.name} float32 cut ({depth} layer, B {B} x S "
            f"{S}, CP blocked, EP) as {MESH} process mesh ranks against the "
            f"logical mesh on the card: hidden max|diff| {h_err:.3g} (tol "
            f"{ATOL_SERVED}), one train step's loss |diff| {l_err:.3g} (tol "
            f"{ATOL_LOSS}) and gradients {rel:.3g} of a leaf's max (tol "
            f"{RTOL_GRAD}), each token's experts equal, launches a rank "
            f"{want_launch} (exact), peak a rank "
            f"{' / '.join(f'{p:.2f}' for p in cut_peaks)} GB; rank 0 "
            f"collectives: {collective_note(by['cut'][0]['record'])}")

        # (c) 3 Adafactor train steps at the reduced config
        ranks = by["train"]
        red = MF.arch_config(jobs[-1])
        want = train_launches(red)
        for i, r in enumerate(ranks):
            losses = r["losses"]
            if r["losses"] != ranks[0]["losses"] or not all(
                    b < a for a, b in zip(losses, losses[1:])):
                raise AssertionError(f"process mesh train: rank {i}'s "
                                     f"losses {losses}")
            if any(c != want for c in r["launches"]):
                raise AssertionError(f"process mesh train: rank {i} "
                                     f"launched {r['launches']}")
        log(f"[process] reduced {cfg.name} (block remat, float32, CP "
            f"blocked, EP, Adafactor) trained {PROCESS_TRAIN_STEPS} steps as {MESH} "
            f"process mesh ranks on the card: losses "
            f"{[round(x, 5) for x in ranks[0]['losses']]} on every rank, "
            f"step ms {[round(x, 1) for x in ranks[0]['step_ms']]}, "
            f"launches a step {want} (exact); the fleet "
            f"{t1 - t0:.1f} s (rank 0's jobs: "
            f"{', '.join(f'{j['name']} {j['wall_s']:.1f}' for j in results[0]['jobs'])}"
            f" s), the part {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# dry-run phase
# ---------------------------------------------------------------------------

# the measured steps the dry run's (1, 1) predictions are held against:
# (arch, kind) -> its phase's cut (layers, B, S); Yi-6B's 8-layer train
# step (``LM_TRAIN_OF``) and its whole 32-layer prefill (``LM_PREFILL``)
DRYRUN_OF = {("yi-6b", "train"): LM_TRAIN_OF["yi-6b"][:3],
             ("yi-6b", "prefill"): (32,) + LM_PREFILL}
DRYRUN_PEAK_REL = 0.10        # predicted peak within 10 % of the card's
# one production cell traced on meta: yi-6b x train_4k x single takes
# about 185 s of host time (its 256 logical shards' context-parallel
# attention, 32 layers, forward, recompute and backward), past the
# phase's 60 s for it, so the decode cell is traced instead
DRYRUN_PRODUCTION = ("yi-6b", "decode_32k")


def dryrun_phase(torch, args, measured):
    """The dry run's per-device predictions on a (1, 1) mesh (its meta
    trace of the same step: ``launch.dryrun.run_cell`` with the cut's
    config and shape, the context-parallel rule off as the measured
    steps run off any mesh) beside what the card measured in the LM
    phases (``measured``): argument bytes within the allocator's
    rounding (512 B a leaf) of the memory the state and batch hold;
    argument + temp bytes within ``DRYRUN_PEAK_REL`` of the step's peak;
    the trace's kernel calls equal to one step's launches; the roofline
    bound no longer than the measured step.  Then one production cell
    traced on meta, its line and wall time printed."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    for (arch, kind), (depth, B, S) in DRYRUN_OF.items():
        m = measured[arch, kind]
        if (m["depth"], m["B"], m["S"]) != (depth, B, S):
            raise AssertionError(f"dry run {arch} {kind}: measured at "
                                 f"{m['depth'], m['B'], m['S']}")
        t1 = time.perf_counter()
        res = dryrun.run_cell(
            arch, f"{kind}_cut", False, {"seq_act": "None"}, False,
            cfg=dataclasses.replace(get_arch(arch), n_layers=depth),
            shape=ShapeSpec(f"{kind}_cut", S, B, kind), mesh_shape=(1, 1))
        mem = res["memory"]
        arg, peak = mem["argument_bytes"], mem["argument_bytes"] + \
            mem["temp_bytes"]
        calls = res["trace"]["kernel_calls"]
        bound_ms = res["step_time_bound_s"] * 1e3
        log(f"[dryrun] {arch} {kind} {depth} layers, B {B} x S {S}, (1, 1) "
            f"mesh, traced in {time.perf_counter() - t1:.1f} s: predicted "
            f"| card: argument bytes {arg} | {m['args']} (allocated "
            f"{m['allocated']}, {m['leaves']} leaves); argument + temp "
            f"{peak / 1e9:.3f} | peak {m['peak'] / 1e9:.3f} GB (ratio "
            f"{peak / m['peak']:.4f}); kernel calls {calls} | launches "
            f"{m['launches']}; step_time_bound {bound_ms:.1f} ms "
            f"({res['dominant']}: compute {res['roofline']['compute_s'] * 1e3:.1f}, "
            f"memory {res['roofline']['memory_s'] * 1e3:.1f}) | step "
            f"{m['ms']:.1f} ms (ratio {bound_ms / m['ms']:.4f})")
        if arg != m["args"] or abs(arg - m["allocated"]) > 512 * m["leaves"]:
            raise AssertionError(f"dry run {arch} {kind}: argument bytes "
                                 f"{arg}, the card's {m['args']} "
                                 f"(allocated {m['allocated']})")
        if abs(peak / m["peak"] - 1) > DRYRUN_PEAK_REL:
            raise AssertionError(f"dry run {arch} {kind}: predicted peak "
                                 f"{peak} against {m['peak']}")
        if calls != m["launches"]:
            raise AssertionError(f"dry run {arch} {kind}: kernel calls "
                                 f"{calls}, launches {m['launches']}")
        if not bound_ms <= m["ms"]:
            raise AssertionError(f"dry run {arch} {kind}: bound {bound_ms} "
                                 f"ms above the measured {m['ms']} ms")
    t1 = time.perf_counter()
    res = dryrun.run_cell(*DRYRUN_PRODUCTION, False, {}, False)
    log(f"{dryrun.summary(res)}; wall {time.perf_counter() - t1:.1f} s, "
        f"params {res['params_total']}, kernel calls "
        f"{res['trace']['kernel_calls']}")
    log(f"[dryrun] dry-run phase done in {time.perf_counter() - t0:.1f} s")


class _Owner:
    def __init__(self, params):
        self.params = params


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


if __name__ == "__main__":
    sys.exit(main())
