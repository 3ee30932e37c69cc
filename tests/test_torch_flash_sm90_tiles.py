"""The tile walk of the Hopper flash attention forward at head dim 192
(``csrc/flash_attention_sm90.cu``: 128-row q tiles in two 64-row
warpgroups, 112-key K/V tiles), copied in numpy and held against the JAX
package's ``blocked_attention`` (which takes a ``q_offset``; the Pallas
body has only the default offset).

The copy walks what a CTA walks: for each q tile, ``kv_tiles`` key tiles
(up to the last real row's diagonal, the last one partial where the keys
or the diagonal end inside it; keys past Skv read as zeros, as TMA fills
them); a tile is masked only where it crosses the ragged key edge or the
diagonal of one of the warpgroup's rows (its first row sees the fewest
keys), each row at its own limit; the online softmax runs in log2 units
(``exp2(s * scale * log2 e - m)``), p is rounded to bf16 before P.V
while l sums the unrounded p, O is rescaled between tiles, and the
output is O / max(l, 1e-30) in bf16.  With 112-key tiles the diagonal of
a 128-row tile crosses two key tiles, and an error there shows only on
late rows, so the bars are the card's per-row bf16 bars.

It shows that this walk keeps the bars at D 192, GQA 12, ragged S and
causal offsets 0, the default Skv - Sq and past it, and that two planted
faults fail them: the masks reckoned with the q tile's 128 in place of
the key tile's 112, and the last partial key tile dropped.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.layers import blocked_attention as j_blocked

BQ, BK, WG = 128, 112, 64       # q tile rows, keys a tile, warpgroup rows
ROW_REL = 1.6e-2                # the card's bf16 bars (chip_smoke.py)
ATOL = 4e-2
LOG2E = np.float32(1.4426950408889634)
f32 = np.float32


def bf16(x):
    """x rounded to bfloat16 (to nearest even), as float32."""
    return np.asarray(x, jnp.bfloat16).astype(f32)


def kv_tiles(qt, Sq, Skv, causal, off, bk, floor=False):
    """csrc/flash_attention_sm90.cu::kv_tiles; ``floor`` drops the last
    partial tile (a planted fault)."""
    last_row = min((qt + 1) * BQ, Sq) - 1
    k_end = min(Skv, last_row + off + 1) if causal else Skv
    return k_end // bk if floor else (k_end + bk - 1) // bk


def tile_walk(q, k, v, causal, q_offset=None, fault=None):
    """The kernel's forward on bf16-valued float32 arrays q (B, Sq, Hq, D),
    k, v (B, Skv, Hkv, D) -> (B, Sq, Hq, D) rounded to bf16.  ``fault``:
    "bq_masks" (the masks at kt * 128 in place of kt * 112) or
    "last_tile_dropped"."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    off = (Skv - Sq if q_offset is None else q_offset) if causal else 0
    scale_log2 = f32(D ** -0.5) * LOG2E
    pad = (-Skv) % BK + BK                   # zeros past Skv, as TMA reads
    kz = np.concatenate([k, np.zeros((B, pad, Hkv, D), f32)], 1)
    vz = np.concatenate([v, np.zeros((B, pad, Hkv, D), f32)], 1)
    out = np.zeros((B, Sq, Hq, D), f32)
    mask_step = BQ if fault == "bq_masks" else BK
    for qt in range((Sq + BQ - 1) // BQ):
        n_kt = kv_tiles(qt, Sq, Skv, causal, off, BK,
                        floor=fault == "last_tile_dropped")
        for wg in range(BQ // WG):
            r0 = qt * BQ + wg * WG
            if r0 >= Sq:
                continue
            rows = np.arange(r0, min(r0 + WG, Sq))
            lim = (np.minimum(Skv - 1, rows + off) if causal
                   else np.full(rows.shape, Skv - 1))
            wg_pos = r0 + off
            qb = q[:, rows].reshape(B, len(rows), Hkv, G, D)
            m = np.full((B, Hkv, G, len(rows)), -np.inf, f32)
            l = np.zeros_like(m)
            o = np.zeros((B, Hkv, G, len(rows), D), f32)
            for kt in range(n_kt):
                k0 = kt * BK
                s = np.einsum("bqhgd,bkhd->bhgqk", qb,
                              kz[:, k0:k0 + BK]).astype(f32)
                m0 = kt * mask_step
                if m0 + BK > Skv or (causal and m0 + BK - 1 > wg_pos):
                    cols = m0 + np.arange(BK)
                    s = np.where(cols[None, :] > lim[:, None], -np.inf, s)
                n = np.maximum(m, s.max(-1) * scale_log2)
                u = np.where(n == -np.inf, f32(0), n)
                f = np.exp2(m - u)
                m = n
                p = np.exp2(s * scale_log2 - u[..., None]).astype(f32)
                l = l * f + p.sum(-1)
                o = o * f[..., None] + np.einsum(
                    "bhgqk,bkhd->bhgqd", bf16(p), vz[:, k0:k0 + BK])
            res = o / np.maximum(l, f32(1e-30))[..., None]
            out[:, rows] = np.moveaxis(res, 3, 1).reshape(B, len(rows), Hq,
                                                          D)
    return bf16(out)


def rows_over(got, want):
    """(max |err| of a row over its max |want|, max |err|)."""
    err = np.abs(got - want).max(-1)
    return (float((err / np.maximum(np.abs(want).max(-1), 1e-30)).max()),
            float(err.max()))


def _case(Sq, Skv, causal, q_offset, seed, Hq=12, Hkv=1, D=192):
    rng = np.random.default_rng(seed)
    q, k, v = (bf16(rng.normal(size=sh)) for sh in (
        (1, Sq, Hq, D), (1, Skv, Hkv, D), (1, Skv, Hkv, D)))
    off = None if q_offset is None else jnp.full((1,), q_offset, jnp.int32)
    want = np.asarray(j_blocked(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal,
        q_chunk=64, kv_chunk=96, q_offset=off), f32)
    return (q, k, v), want


# (Sq, Skv, causal, q_offset): 300 = 2 whole key tiles and a partial one
CASES = {"causal_square": (300, 300, True, None),
         "causal_offset_0": (300, 520, True, 0),
         "causal_default_offset": (300, 520, True, None),
         "causal_past_default": (300, 520, True, 400),
         "causal_one_tile": (70, 70, True, None),
         "full_ragged": (130, 300, False, None)}


@pytest.mark.parametrize("case", list(CASES))
def test_sm90_d192_tile_walk_matches_jax(case):
    Sq, Skv, causal, off = CASES[case]
    (q, k, v), want = _case(Sq, Skv, causal, off, seed=len(case))
    rel, err = rows_over(tile_walk(q, k, v, causal, off), want)
    assert rel <= ROW_REL and err <= ATOL, (rel, err)


def test_sm90_d192_diagonal_crosses_two_key_tiles():
    """The walk's premise: with 112-key tiles the diagonal of a 128-row q
    tile lies in two key tiles, so a warpgroup masks more than one."""
    for qt in range(3):
        first, last = qt * BQ // BK, (qt * BQ + BQ - 1) // BK
        assert last - first == 1
    assert kv_tiles(0, 300, 300, True, 0, BK) == 2
    assert kv_tiles(2, 300, 300, True, 0, BK) == 3


@pytest.mark.parametrize("fault", ["bq_masks", "last_tile_dropped"])
def test_sm90_d192_planted_faults_fail_the_bars(fault):
    """Each fault fails the bars on some case, and every case that a
    fault leaves within them is one it does not reach."""
    failed = []
    for case, (Sq, Skv, causal, off) in CASES.items():
        (q, k, v), want = _case(Sq, Skv, causal, off, seed=len(case))
        rel, err = rows_over(tile_walk(q, k, v, causal, off, fault), want)
        if rel > ROW_REL or err > ATOL:
            failed.append(case)
    assert "causal_square" in failed and "causal_default_offset" in failed
