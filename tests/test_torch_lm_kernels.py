"""The LM kernels' plain versions in the PyTorch port against the JAX
package: ``flash_attention`` and ``selective_scan`` as the CPU path of
their wrappers (the path a CPU tensor takes) against the Pallas kernels
in interpret mode, their jnp oracles and the model paths they stand in
for (``blocked_attention``, ``_mamba1_scan_y``).

Tolerances are the reference's own (tests/test_flash_attention.py,
tests/test_selective_scan.py): 2e-5 in float32, 4e-2 in bfloat16.
The kernels themselves are held against these plain versions on the
card in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention_pallas
from repro.kernels.flash_attention.ref import (
    flash_attention_ref as j_flash_ref)
from repro.kernels.selective_scan.ops import selective_scan_pallas
from repro.kernels.selective_scan.ref import (
    selective_scan_ref as j_scan_ref)
from repro.models.layers import blocked_attention as j_blocked
from repro.models.mamba import _mamba1_scan_y as j_scan_y
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.models.layers import blocked_attention

F32_TOL = 2e-5
BF16_TOL = 4e-2


def _qkv(B, Sq, Hq, Hkv, D, seed=0, Skv=None, bf16=False):
    rng = np.random.default_rng(seed)
    Skv = Sq if Skv is None else Skv
    arrs = [rng.normal(size=(B, Sq, Hq, D)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)]
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [
    (1, 64, 4, 2, 16),     # GQA 2:1
    (2, 128, 8, 8, 8),     # MHA
    (2, 96, 6, 2, 32),     # GQA 3:1, non-pow2 S
    (1, 32, 4, 2, 320),    # D > 256, which the card's kernel takes too
])
def test_flash_plain_matches_pallas_and_ref(causal, shape):
    (qj, kj, vj), (q, k, v) = _qkv(*shape, seed=sum(shape))
    runtime.reset_launch_counts()
    got = _np(flash_attention(q, k, v, causal=causal))
    assert runtime.launch_counts() == {}      # the CPU takes no kernel
    pallas = flash_attention_pallas(qj, kj, vj, causal=causal, qb=32, kb=32)
    for want in (pallas, j_flash_ref(qj, kj, vj, causal=causal)):
        np.testing.assert_allclose(got, _np(want), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_flash_plain_causal_ragged_length():
    """S = 57 is no tile multiple: the Pallas wrapper pads, the port's
    plain version (and kernel) take it as it is."""
    (qj, kj, vj), (q, k, v) = _qkv(2, 57, 4, 2, 16, seed=9)
    got = _np(flash_attention(q, k, v, causal=True))
    pallas = flash_attention_pallas(qj, kj, vj, causal=True, qb=16, kb=16)
    for want in (pallas, j_flash_ref(qj, kj, vj, causal=True)):
        np.testing.assert_allclose(got, _np(want), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_flash_plain_bf16():
    (qj, kj, vj), (q, k, v) = _qkv(1, 64, 4, 4, 16, seed=3, bf16=True)
    got = flash_attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    pallas = flash_attention_pallas(qj, kj, vj, causal=True, qb=32, kb=32)
    for want in (pallas, j_flash_ref(qj, kj, vj, causal=True)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL,
                                   atol=BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(32, 64), (5, 70), (64, 64)])
def test_flash_plain_matches_model_blocked_path(causal, sq, skv):
    """Query row i sits at i + Skv - Sq, as in blocked_attention; a
    non-causal Skv that is no chunk multiple is taken too."""
    (qj, kj, vj), (q, k, v) = _qkv(2, sq, 8, 4, 16, seed=sq + skv, Skv=skv)
    got = _np(blocked_attention(q, k, v, causal=causal))
    want = j_blocked(qj, kj, vj, causal=causal, q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(got, _np(want), rtol=F32_TOL, atol=F32_TOL)


def test_flash_plain_bf16_matches_model_blocked_path():
    """In bfloat16 the weights p are rounded to v's dtype before P.V in
    both; one chunk makes the rounding points the same."""
    (qj, kj, vj), (q, k, v) = _qkv(2, 48, 8, 2, 32, seed=4, bf16=True)
    got = _np(blocked_attention(q, k, v, causal=True))
    want = j_blocked(qj, kj, vj, causal=True)
    np.testing.assert_allclose(got, _np(want), rtol=BF16_TOL, atol=BF16_TOL)


def test_pallas_flash_lacks_causal_offset():
    """Records a fault of the reference: the Pallas body masks
    k_pos > q_pos with no Skv - Sq offset, so with Sq < Skv it drops the
    keys the model's attention sees (max |diff| 3.16 here).  The
    port follows the model (blocked_attention), not the Pallas body."""
    (qj, kj, vj), (q, k, v) = _qkv(2, 32, 8, 4, 16, seed=96, Skv=64)
    port = _np(flash_attention(q, k, v, causal=True))
    model = _np(j_blocked(qj, kj, vj, causal=True, q_chunk=16, kv_chunk=16))
    pallas = _np(flash_attention_pallas(qj, kj, vj, causal=True, qb=16,
                                        kb=16))
    np.testing.assert_allclose(port, model, rtol=F32_TOL, atol=F32_TOL)
    assert np.abs(pallas - model).max() > 0.5


def test_flash_plain_row_without_keys_is_zero():
    _, (q, k, v) = _qkv(1, 8, 2, 1, 4, seed=1, Skv=4)
    out = flash_attention(q, k, v, causal=True)     # rows 0-3 see no key
    assert torch.isfinite(out).all()
    assert (out[:, :4] == 0).all()


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 128, "sm90"),      # Yi-6B and the other dense archs
    (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 80, "sm90"),       # Zamba2, HuBERT: the tail box
    (torch.bfloat16, 192, "sm90"),      # Nemotron-4: 112-key tiles
    (torch.bfloat16, 16, "general"),    # the reduced archs
    (torch.bfloat16, 256, "general"),
    (torch.float32, 128, "general"),
    (torch.float32, 64, "general")])
def test_flash_dispatch_rule(dtype, head_dim, want):
    """Which forward kernel a CUDA call launches is decided by dtype and
    head dim alone, before the launch."""
    assert flash_ops.instance(dtype, head_dim) == want


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 128, "sm90"), (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 80, "sm90"), (torch.bfloat16, 192, "sm90"),
    (torch.float32, 128, "general"), (torch.bfloat16, 16, "general")])
@pytest.mark.parametrize("forced", [None, "general"])
def test_flash_backward_dispatch_rule(dtype, head_dim, want, forced):
    """The backward's instance comes from dtype and head dim alone, the
    forward's (at D 192, Nemotron-4's, the Hopper one with its 64-key
    dk/dv tiles split between two warpgroups); only the general one can
    be asked for instead."""
    assert flash_ops.backward_instance(dtype, head_dim) == want
    q = torch.zeros((1, 8, 4, head_dim), dtype=dtype)
    k = torch.zeros((1, 8, 2, head_dim), dtype=dtype)
    got = flash_ops.bwd_instance(q, k, k, q, forced)
    assert got == (forced or want)


@pytest.mark.parametrize("head_dim", [128, 80, 192])
@pytest.mark.parametrize("which", ["q", "k", "v", "dout"])
def test_flash_backward_hopper_instance_rejects_misaligned(which,
                                                           head_dim):
    """The Hopper backward reads q, k, v and dout by TMA: one that is not
    16-byte aligned raises before any launch (no fallback); the general
    instance takes it."""
    ins = {n: torch.zeros((1, 16, 4 if n in ("q", "dout") else 2,
                           head_dim), dtype=torch.bfloat16)
           for n in ("q", "k", "v", "dout")}
    ins[which] = _misaligned(tuple(ins[which].shape), torch.bfloat16)
    args = [ins[n] for n in ("q", "k", "v", "dout")]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_ops.bwd_instance(*args)
    assert flash_ops.bwd_instance(*args, "general") == "general"
    with pytest.raises(ValueError, match="instance"):
        flash_ops.bwd_instance(*args, "sm90")


def _misaligned(shape, dtype):
    """A contiguous tensor whose data starts 2 bytes past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)


@pytest.mark.parametrize("dtype,head_dim", [
    (torch.float32, 128), (torch.bfloat16, 192), (torch.bfloat16, 256)])
def test_flash_wrapper_takes_misaligned_general_inputs(dtype, head_dim):
    """Only the TMA instance needs 16-byte aligned q, k, v: the general
    one takes them, as the instance of the dtype and head dim or, at
    bf16 D 192, whose forward is the Hopper one's, asked for."""
    q = _misaligned((1, 16, 4, head_dim), dtype)
    k = _misaligned((1, 16, 2, head_dim), dtype)
    assert q.is_contiguous() and q.data_ptr() % 16
    forced = "general" if flash_ops.instance(dtype, head_dim) == "sm90" \
        else None
    assert forced == ("general" if head_dim == 192 else None)
    flash_ops._check(q, k, k, True, forced)


@pytest.mark.parametrize("head_dim", [128, 80, 192])
def test_flash_forward_instance_choice(head_dim):
    """The forward's private ``_instance`` takes only None or "general",
    as the backward's does: anything else raises, on the CPU path too.
    Asked for, the general instance takes misaligned bf16 inputs that
    the Hopper one refuses (at D 192 too, whose forward is Hopper's)."""
    q = _misaligned((1, 16, 4, head_dim), torch.bfloat16)
    k = _misaligned((1, 16, 2, head_dim), torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_ops._check(q, k, k, True)
    flash_ops._check(q, k, k, True, "general")
    for bad in ("sm90", "plain", ""):
        with pytest.raises(ValueError, match="instance"):
            flash_attention(q, k, k, causal=True, _instance=bad)
    _, (q, k, v) = _qkv(1, 16, 4, 2, 8, seed=3)
    torch.testing.assert_close(
        flash_attention(q, k, v, causal=True, _instance="general"),
        flash_attention(q, k, v, causal=True), atol=0, rtol=0)


@pytest.mark.parametrize("bad,match", [
    ("dtype", "dtype"), ("heads", "multiple"), ("head_dim", "head dim"),
    ("causal_long_q", "Sq <= Skv"), ("strided", "contiguous"),
    ("shapes", "disagree"), ("misaligned", "16-byte aligned")])
def test_flash_wrapper_rejects(bad, match):
    """The checks a CUDA call goes through before the launch."""
    _, (q, k, v) = _qkv(1, 16, 4, 2, 8, seed=2)
    causal = True
    if bad == "misaligned":     # bf16, D 128: the Hopper instance
        q = _misaligned((1, 16, 4, 128), torch.bfloat16)
        k = v = torch.zeros((1, 16, 2, 128), dtype=torch.bfloat16)
    if bad == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif bad == "heads":
        _, (q, k, v) = _qkv(1, 16, 5, 2, 8, seed=2)
    elif bad == "head_dim":      # any D >= 1 is taken, as by the Pallas body
        _, (q, k, v) = _qkv(1, 4, 2, 1, 0, seed=2)
    elif bad == "causal_long_q":
        _, (q, k, v) = _qkv(1, 16, 4, 2, 8, seed=2, Skv=8)
    elif bad == "strided":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "shapes":
        v = v[:, :8].contiguous()
    with pytest.raises((TypeError, ValueError), match=match):
        flash_ops._check(q, k, v, causal)


# ---------------------------------------------------------------------------
# selective_scan
# ---------------------------------------------------------------------------


def _scan_inputs(B, L, Din, N, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.uniform(0.001, 0.1, (B, L, Din)),
            rng.normal(size=(B, L, Din)),
            -rng.uniform(0.5, 4.0, (Din, N)),
            rng.normal(size=(B, L, N)),
            rng.normal(size=(B, L, N)),
            rng.normal(size=(B, Din, N))]
    arrs = [a.astype(np.float32) for a in arrs]
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a) for a in arrs])


@pytest.mark.parametrize("shape", [
    (1, 16, 8, 4), (2, 32, 16, 8), (2, 48, 64, 16), (3, 24, 128, 4),
    (2, 21, 16, 4),      # L = 21: no chunk multiple
    (2, 24, 16, 32),     # d_state > 16, which the card's kernel takes too
])
def test_scan_plain_matches_pallas_ref_and_model(shape):
    ja, ta = _scan_inputs(*shape, seed=sum(shape))
    runtime.reset_launch_counts()
    y, h = selective_scan(*ta)
    assert runtime.launch_counts() == {}
    assert y.dtype == h.dtype == torch.float32
    chunk = 8
    wants = (selective_scan_pallas(*ja, chunk=chunk, dtile=16),
             j_scan_ref(*ja), j_scan_y(*ja, chunk=16))
    for y_w, h_w in wants:
        np.testing.assert_allclose(y.numpy(), _np(y_w), rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(h.numpy(), _np(h_w), rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("bad,match", [
    ("dtype", "dtype"), ("state", "d_state"), ("strided", "contiguous"),
    ("shapes", "disagree")])
def test_scan_wrapper_rejects(bad, match):
    _, ta = _scan_inputs(2, 8, 16, 4, seed=5)
    if bad == "dtype":
        ta[1] = ta[1].double()
    elif bad == "state":         # any d_state >= 1 is taken
        _, ta = _scan_inputs(1, 4, 8, 0, seed=5)
    elif bad == "strided":
        ta[0] = ta[0].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "shapes":
        ta[3] = ta[3][:, :4].contiguous()
    with pytest.raises((TypeError, ValueError), match=match):
        scan_ops._check(*ta)


# tests/test_torch_cuda.py's bar on the backward kernel's bf16 gradients:
# each row's error beyond flash_attention_grad_budget, over its max |grad|
GRAD_ROW_BF16 = 0.02


def _kernel_arithmetic(q, k, v, dout, causal, dq_drop=0):
    """The bf16 backward kernels' arithmetic (csrc/flash_attention_bwd.cu
    and csrc/flash_attention_bwd_sm90.cu round at the same points) in
    plain PyTorch: P from the row log-sum-exp, D from the forward's
    float32 output (whose P.V takes p rounded to bf16), dS and P rounded
    to bf16 for the products, the gradients rounded to bf16.  With
    ``dq_drop``, dq leaves out the terms of that many last keys (a fault:
    a dq pass that misses the last KV tile)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    qg = q.reshape(B, S, Hkv, G, D).float()
    dog = dout.reshape(B, S, Hkv, G, D).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                          float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o32 = torch.einsum("bhgqk,bkhd->bqhgd", e.to(torch.bfloat16).float(),
                       vf) / e.sum(-1).permute(0, 3, 1, 2)[..., None]
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    dd = (dog * o32).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = (p * (dp - dd)).to(torch.bfloat16).float()
    ds_q = ds[..., :ds.shape[-1] - dq_drop]
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds_q, kf[:, :ds_q.shape[-1]])
    dq = dq.reshape(q.shape) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(torch.bfloat16).float(),
                      dog)
    return [t.to(torch.bfloat16) for t in (dq, dk, dv)]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", [
    (2, 127, 8, 2, 80, True), (1, 300, 8, 1, 128, True),
    (2, 127, 4, 4, 128, True), (2, 127, 8, 2, 80, False),
    (1, 200, 4, 1, 64, False)])
def test_flash_grad_budget_passes_roundings_and_fails_faults(B, S, Hq, Hkv,
                                                            D, causal):
    """The card's bar on bf16 attention gradients, on the CPU: the kernel's
    arithmetic in plain PyTorch lies within GRAD_ROW_BF16 of the plain
    version's autograd beyond flash_attention_grad_budget in every row of
    dq and every key of dk and dv, and the same bar fails the gradients
    with the last KV tile's (64 keys') terms left out of dq, or its dk
    and dv zeroed, and, unmasked, against a plain version that hides the
    last key."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_grad_budget, flash_attention_ref,
        grad_rows_beyond_budget as _beyond_budget)

    g = torch.Generator().manual_seed(S + D)
    q, k, v = (torch.randn(sh, generator=g).to(torch.bfloat16)
               for sh in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    dout = torch.randn((B, S, Hq, D), generator=g).to(torch.bfloat16)

    def plain_grads(k_, v_):
        ins = [t.clone().requires_grad_(True) for t in (q, k_, v_)]
        out = flash_attention_ref(*ins, causal=causal)
        return torch.autograd.grad(out, ins, dout)

    want = plain_grads(k, v)
    budget = flash_attention_grad_budget(q, k, v, dout, causal=causal)
    got = _kernel_arithmetic(q, k, v, dout, causal)
    for name, a, w, b in zip(("dq", "dk", "dv"), got, want, budget):
        assert _beyond_budget(a, w, b) <= GRAD_ROW_BF16, name
    for a, w, b in zip(got[1:], want[1:], budget[1:]):
        a = a.clone()
        a[:, -64:] = 0
        assert _beyond_budget(a, w, b) > GRAD_ROW_BF16
    dq_short = _kernel_arithmetic(q, k, v, dout, causal, dq_drop=64)[0]
    assert _beyond_budget(dq_short, want[0], budget[0]) > GRAD_ROW_BF16
    if not causal:
        hidden = plain_grads(k[:, :-1], v[:, :-1])
        fault = [hidden[0]] + [torch.cat([h, torch.zeros_like(h[:, :1])], 1)
                               for h in hidden[1:]]
        assert max(_beyond_budget(a, w, b) for a, w, b in zip(
            got, fault, budget)) > GRAD_ROW_BF16
