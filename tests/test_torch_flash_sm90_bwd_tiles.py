"""The tile walk of the Hopper flash attention backward at head dim 192
(``csrc/flash_attention_bwd_sm90.cu``), copied in numpy and held against
``jax.grad`` of the JAX package's ``blocked_attention`` in float32.

The copy walks what the kernel's CTAs walk:

* the dk/dv pass over 64-key tiles: from the first 64-row q tile whose
  rows see the tile's first key (``q_first``; none at all for a key tile
  past every row's position, whose dk and dv stay zero), for each of the
  G query heads; the two warpgroups split each q tile's S^T = K Q^T and
  dP^T = V dO^T by q rows (32 each), form P^T = exp2(S^T scale log2 e -
  LSE_2) and dS^T = P^T (dP^T - D) in float32, masked only on tiles that
  cross the diagonal (the key tile's last key past the stage's first
  row's position), and hand them over rounded to bf16; dV += P^T dO and
  dK += dS^T Q then run over each warpgroup's columns (0-95 and 96-191);
* the dq pass over 128-row q tiles of two 64-row warpgroups and 64-key
  tiles up to the last real row's diagonal, masked where a tile crosses
  a warpgroup's first row's diagonal or the ragged key edge, dS rounded
  to bf16 before dQ += dS K;
* rows past Sq read as zeros with LSE +inf (P = 0), keys past Skv as
  zeros; LSE and the float32 output O (whose P.V took p in bf16) are the
  forward's; dq, dk, dv are rounded to bf16.

The bar is the card's (``tests/test_torch_cuda.py``): each row of dq and
each key of dk and dv within 0.02 of its max |grad| beyond the rounding
budget (``flash_attention_grad_budget``, ``grad_rows_beyond_budget``).
It holds at ragged S (130, 520: no multiple of 64 or 128), GQA 12, and
causal offsets 0, the default Skv - Sq and past it; three planted faults
each fail it: the last partial q tile dropped from the dk/dv walk, warp-
group 1's half of the dS^T hand-over left out of dK, and the masks
reckoned with 128 keys a tile (the D 128 plan's) in place of 64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import blocked_attention as j_blocked
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_grad_budget, grad_rows_beyond_budget)

KEYS, ROWS, QROWS, HALF = 64, 64, 128, 32   # dk/dv keys, rows; dq rows
COLS = 96                                   # dK, dV columns a warpgroup
GRAD_ROW = 0.02                             # the card's bar
LOG2E = np.float32(1.4426950408889634)
f32 = np.float32


def bf16(x):
    """x rounded to bfloat16 (to nearest even), as float32."""
    return np.asarray(x, jnp.bfloat16).astype(f32)


def forward(q, k, v, causal, off):
    """The forward's row LSEs (B, Hq, Sq) and float32 output, its P.V on
    p rounded to bf16 (csrc/flash_attention_sm90.cu)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = np.einsum("bqhgd,bkhd->bhgqk", qg, k).astype(f32) * f32(D ** -0.5)
    if causal:
        seen = np.arange(Skv)[None, :] <= np.arange(Sq)[:, None] + off
        s = np.where(seen, s, -np.inf)
    m = s.max(-1, keepdims=True)
    e = np.exp(s - m)
    l = e.sum(-1, keepdims=True)
    o = np.einsum("bhgqk,bkhd->bqhgd", bf16(e), v) / np.moveaxis(
        l, 3, 1)
    lse = (m + np.log(l))[..., 0].reshape(B, Hq, Sq)
    return lse.astype(f32), o.reshape(B, Sq, Hq, D).astype(f32)


def q_first(k0, causal, off):
    return max(0, k0 - off) // ROWS if causal else 0


def dkdv_pass(q, k, v, dout, lse2, dd, causal, off, fault=None):
    """dk, dv (float32, before rounding) of the 64-key tiles' walk."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale_log2 = f32(D ** -0.5) * LOG2E
    n_qt = Sq // ROWS if fault == "last_q_tile_dropped" else -(-Sq // ROWS)
    mask_keys = 2 * KEYS if fault == "mask_tile" else KEYS
    pq = -(-Sq // ROWS) * ROWS + ROWS - Sq        # zero rows past Sq
    qz = np.concatenate([q, np.zeros((B, pq, Hq, D), f32)], 1)
    doz = np.concatenate([dout, np.zeros((B, pq, Hq, D), f32)], 1)
    l2z = np.concatenate([lse2, np.full((B, Hq, pq), np.inf, f32)], 2)
    ddz = np.concatenate([dd, np.zeros((B, Hq, pq), f32)], 2)
    pk = -(-Skv // KEYS) * KEYS - Skv             # zero keys past Skv
    kz = np.concatenate([k, np.zeros((B, pk, Hkv, D), f32)], 1)
    vz = np.concatenate([v, np.zeros((B, pk, Hkv, D), f32)], 1)
    dk = np.zeros(kz.shape, f32)
    dv = np.zeros(vz.shape, f32)
    for kt in range(kz.shape[1] // KEYS):
        k0 = kt * KEYS
        keys = (kt * mask_keys + np.arange(KEYS))[:, None]
        kk, vv = kz[:, k0:k0 + KEYS], vz[:, k0:k0 + KEYS]  # (B, 64, Hkv, D)
        for qt in range(q_first(k0, causal, off), n_qt):
            q0 = qt * ROWS
            pt = np.zeros((B, Hkv, G, KEYS, ROWS), f32)   # hand-over tiles
            dst = np.zeros_like(pt)
            for wg in range(2):                           # q rows 32 wg..
                r0 = q0 + HALF * wg
                rows = slice(r0, r0 + HALF)
                qh = qz[:, rows].reshape(B, HALF, Hkv, G, D)
                dh = doz[:, rows].reshape(B, HALF, Hkv, G, D)
                st = np.einsum("bkhd,bqhgd->bhgkq", kk, qh).astype(f32)
                dpt = np.einsum("bkhd,bqhgd->bhgkq", vv, dh).astype(f32)
                l2 = l2z[:, :, rows].reshape(B, Hkv, G, 1, HALF)
                dc = ddz[:, :, rows].reshape(B, Hkv, G, 1, HALF)
                p = np.exp2(st * scale_log2 - l2).astype(f32)
                edge = causal and kt * mask_keys + KEYS - 1 > q0 + off
                if edge:
                    cols = (r0 + np.arange(HALF))[None, :]
                    p = np.where(keys > cols + off, f32(0), p)
                ds = p * (dpt - dc)
                half = slice(HALF * wg, HALF * wg + HALF)
                pt[..., half] = bf16(p)
                if not (fault == "dk_half" and wg == 1):
                    dst[..., half] = bf16(ds)
            qt_q = qz[:, q0:q0 + ROWS].reshape(B, ROWS, Hkv, G, D)
            qt_do = doz[:, q0:q0 + ROWS].reshape(B, ROWS, Hkv, G, D)
            for wg in range(2):                           # columns 96 wg..
                c = slice(COLS * wg, COLS * wg + COLS)
                dv[:, k0:k0 + KEYS, :, c] += np.einsum(
                    "bhgkq,bqhgd->bkhd", pt, qt_do[..., c])
                dk[:, k0:k0 + KEYS, :, c] += np.einsum(
                    "bhgkq,bqhgd->bkhd", dst, qt_q[..., c])
    return dk[:, :Skv], dv[:, :Skv]


def dq_pass(q, k, v, dout, lse2, dd, causal, off):
    """dq (float32, before rounding) of the 128-row q tiles' walk."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale_log2 = f32(D ** -0.5) * LOG2E
    pk = -(-Skv // KEYS) * KEYS - Skv
    kz = np.concatenate([k, np.zeros((B, pk, Hkv, D), f32)], 1)
    vz = np.concatenate([v, np.zeros((B, pk, Hkv, D), f32)], 1)
    dq = np.zeros(q.shape, f32)
    for qt in range(-(-Sq // QROWS)):
        last_row = min((qt + 1) * QROWS, Sq) - 1
        k_end = min(Skv, last_row + off + 1) if causal else Skv
        for wg in range(2):
            r0 = qt * QROWS + wg * ROWS
            if r0 >= Sq:
                continue
            rows = np.arange(r0, min(r0 + ROWS, Sq))
            lim = (np.minimum(Skv - 1, rows + off) if causal
                   else np.full(rows.shape, Skv - 1))
            qg = q[:, rows].reshape(B, len(rows), Hkv, G, D)
            dg = dout[:, rows].reshape(B, len(rows), Hkv, G, D)
            l2 = np.moveaxis(lse2[:, :, rows].reshape(B, Hkv, G, len(rows)),
                             -1, 1)[..., None]
            dc = np.moveaxis(dd[:, :, rows].reshape(B, Hkv, G, len(rows)),
                             -1, 1)[..., None]
            acc = np.zeros(qg.shape, f32)
            for kt in range(-(-k_end // KEYS)):
                k0 = kt * KEYS
                kk, vv = kz[:, k0:k0 + KEYS], vz[:, k0:k0 + KEYS]
                s = np.einsum("bqhgd,bkhd->bqhgk", qg, kk).astype(f32)
                dp = np.einsum("bqhgd,bkhd->bqhgk", dg, vv).astype(f32)
                p = np.exp2(s * scale_log2 - l2).astype(f32)
                if k0 + KEYS > Skv or (causal and k0 + KEYS - 1 > r0 + off):
                    cols = k0 + np.arange(KEYS)
                    masked = cols[None, :] > lim[:, None]     # (rows, keys)
                    p = np.where(masked[None, :, None, None], f32(0), p)
                ds = bf16(p * (dp - dc))
                acc += np.einsum("bqhgk,bkhd->bqhgd", ds, kk)
            dq[:, rows] = acc.reshape(B, len(rows), Hq, D)
    return dq


def tile_walk(q, k, v, dout, causal, q_offset=None, fault=None):
    """The kernel's dq, dk, dv (bf16-valued float32) on bf16-valued
    float32 inputs.  ``fault``: "last_q_tile_dropped", "dk_half" or
    "mask_tile"."""
    Sq, D = q.shape[1], q.shape[3]
    Skv = k.shape[1]
    off = (Skv - Sq if q_offset is None else q_offset) if causal else 0
    lse, o32 = forward(q, k, v, causal, off)
    dd = np.einsum("bqhd,bqhd->bhq", dout, o32).astype(f32)
    lse2 = (lse * LOG2E).astype(f32)
    scale = f32(D ** -0.5)
    dk, dv = dkdv_pass(q, k, v, dout, lse2, dd, causal, off, fault)
    dq = dq_pass(q, k, v, dout, lse2, dd, causal, off)
    return bf16(dq * scale), bf16(dk * scale), bf16(dv)


def _case(Sq, Skv, causal, q_offset, seed, Hq=12, Hkv=1, D=192):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (bf16(rng.normal(size=sh)) for sh in (
        (1, Sq, Hq, D), (1, Skv, Hkv, D), (1, Skv, Hkv, D), (1, Sq, Hq, D)))
    off = None if q_offset is None else jnp.full((1,), q_offset, jnp.int32)

    def attn(a, b, c):
        return j_blocked(a, b, c, causal=causal, q_chunk=64, kv_chunk=96,
                         q_offset=off)

    grads = jax.jit(lambda a, b, c, d: jax.vjp(attn, a, b, c)[1](d))
    want = [np.array(g, f32) for g in grads(
        *(jnp.asarray(a) for a in (q, k, v, dout)))]
    budget = flash_attention_grad_budget(
        *(torch.from_numpy(a) for a in (q, k, v, dout)), causal=causal,
        q_offset=q_offset)
    return (q, k, v, dout), want, budget


def beyond(got, want, budget) -> float:
    return max(grad_rows_beyond_budget(torch.from_numpy(a),
                                       torch.from_numpy(w), b)
               for a, w, b in zip(got, want, budget))


# (Sq, Skv, causal, q_offset): 130 and 520 ragged against 64 and 128
CASES = {"causal_square": (130, 130, True, None),
         "causal_long": (520, 520, True, None),
         "causal_offset_0": (130, 520, True, 0),
         "causal_default_offset": (130, 520, True, None),
         "causal_past_default": (130, 520, True, 450),
         "full_ragged": (130, 300, False, None)}


@pytest.fixture(scope="module")
def cases():
    return {name: _case(*spec, seed=len(name)) for name, spec in
            CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_sm90_d192_backward_walk_matches_jax(cases, case):
    Sq, Skv, causal, off = CASES[case]
    ins, want, budget = cases[case]
    got = tile_walk(*ins, causal, off)
    assert beyond(got, want, budget) <= GRAD_ROW
    if causal and off is not None and off + Sq < Skv:   # keys no row sees
        for g in got[1:]:
            assert not g[:, off + Sq:].any()


def test_sm90_d192_backward_walk_premises():
    """A causal walk starts at the q tile of the key tile's first key; a
    key tile past every row's position walks none; at q_offset 0 the
    128-key plan's masks would differ from the 64-key tiles' on a
    tile's second half."""
    assert q_first(0, True, 0) == 0 and q_first(128, True, 0) == 2
    assert q_first(448, True, 0) == 7 > -(-130 // ROWS) - 1
    assert q_first(448, True, 390) == 0 and q_first(64, False, 0) == 0
    assert (-(-130 // ROWS), 130 // ROWS) == (3, 2)   # a partial last tile


@pytest.mark.parametrize("fault,must_fail", [
    ("last_q_tile_dropped", ("causal_square", "causal_long",
                             "full_ragged")),
    ("dk_half", ("causal_square", "full_ragged")),
    ("mask_tile", ("causal_square", "causal_long", "causal_offset_0"))])
def test_sm90_d192_backward_planted_faults_fail_the_bar(cases, fault,
                                                        must_fail):
    for case in must_fail:
        Sq, Skv, causal, off = CASES[case]
        ins, want, budget = cases[case]
        got = tile_walk(*ins, causal, off, fault=fault)
        assert beyond(got, want, budget) > GRAD_ROW, (fault, case)
