"""Plain PyTorch version of the flash_attention kernel: dense masked GQA
attention.

Scores are float32 (operands converted to float32, which is exact for
bfloat16), scaled by D^-0.5 after the dot product; causal masking is
``k_pos > q_pos + q_offset``, ``q_offset`` the absolute position of query
row 0 (default ``Skv - Sq``).  As in the kernel and in the JAX
package's ``blocked_attention``, the unnormalised weights
``p = exp(s - max s)`` are rounded to v's dtype before P.V, and the
float32 row sum of the unrounded ``p`` divides the result, floored at
1e-30.  A row with no key in its causal window gives zeros.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool,
                        q_offset: int | None = None) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (D ** -0.5)
    if causal:
        kpos = torch.arange(Skv, device=q.device)
        qpos = torch.arange(Sq, device=q.device) + (
            Skv - Sq if q_offset is None else q_offset)
        masked = kpos[None, :] > qpos[:, None]                  # (Sq, Skv)
        s = s.masked_fill(masked, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)                                           # (B,h,g,q)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    o = o / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def flash_attention_grad_budget(q, k, v, dout, *, causal: bool,
                                q_offset: int | None = None):
    """How far a kernel's bfloat16 gradients may lie from those of this
    plain version's autograd through the two sides' roundings of the
    softmax gradient alone, element by element: (bq, bk, bv) float32 of
    the shapes of q, k and v.

    Both sides round p to v's dtype before P.V, so their outputs and D
    agree; the plain version's autograd then rounds dL/dp (P_ij dP_ij up
    to 1 / l) to bfloat16 through that cast, and a kernel rounds dS_ij =
    P_ij (dP_ij - D_i) and P to bfloat16 for its products.  Each budget
    is 2^-8 (one 2^-9 rounding on each side) times the magnitude of the
    terms its element sums:
      bq_i = 2^-8 scale sum_j P_ij (|dP_ij| + |D_i|) |k_j|,
      bk_j = 2^-8 scale sum_i P_ij (|dP_ij| + |D_i|) |q_i|,
      bv_j = 2^-8 sum_i P_ij |dO_i|,
    bk and bv summed over the G query heads of the KV head; P is the
    softmax (query row i at i + ``q_offset``, default Skv - Sq),
    dP_ij = <dO_i, v_j>, D_i = sum_j P_ij dP_ij.  The plain version
    subtracts each row's max score, and its autograd sends the
    gradient of that max, zero but for the same roundings, to the row's
    largest score: that key's term also gets the row's whole sum.  Where
    a row's gradient is a near-cancelling sum (a causal row with a few
    keys) these roundings can be as large as the gradient itself, so a
    bar relative to the row's own size holds the error beyond them."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    dog = dout.reshape(B, Sq, Hkv, G, D).float()
    kf = k.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    if causal:
        kpos = torch.arange(Skv, device=q.device)
        qpos = torch.arange(Sq, device=q.device) + (
            Skv - Sq if q_offset is None else q_offset)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num_(0.0)
    top = s.argmax(dim=-1, keepdim=True)                  # the max's key
    del s
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    dd = (p * dp).sum(-1, keepdim=True).abs_()            # |D_i|
    a = dp.abs_().add_(dd).mul_(p)                        # P (|dP| + |D|)
    a.scatter_add_(-1, top, a.sum(-1, keepdim=True))
    del dp, dd, top
    u = 2.0 ** -8
    bq = torch.einsum("bhgqk,bkhd->bqhgd", a, kf.abs()).reshape(
        B, Sq, Hq, D) * (u * scale)
    bk = torch.einsum("bhgqk,bqhgd->bkhd", a, qg.abs()) * (u * scale)
    del a
    bv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog.abs()) * u
    return bq, bk, bv


def grad_rows_beyond_budget(got, want, budget) -> float:
    """The largest over the rows (last axis) of max(0, |got - want| -
    budget) over the row's max |want|: a gradient's error beyond
    ``flash_attention_grad_budget``, relative to each row's size."""
    want = want.float()
    if not want.numel():
        return 0.0
    over = ((got.float() - want).abs() - budget).clamp_min(0).amax(-1)
    return float((over / want.abs().amax(-1).clamp_min(1e-30)).max())
