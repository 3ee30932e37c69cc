"""The arithmetic of the general flash attention kernels' float32 route
(``csrc/tf32.cuh``: split TF32 on the tensor cores), copied in numpy and
held against the JAX package's float32 ``blocked_attention`` and
``jax.grad`` of it.

The copy splits each operand as the kernels do: ``hi`` is x rounded to
nearest at TF32's 11 significant bits by Veltkamp's split (``c = x *
(2^13 + 1)``, ``hi = c - (c - x)``, float32 operations), ``lo = x - hi``
exactly, and the tensor core reads ``lo`` with its low 13 mantissa bits
dropped (a bit mask).  It adds as ``mma.sync`` m16n8k8 adds: every 8-wide
step of a product's k adds its 8 exact products of ``lo.hi``, then of
``hi.lo``, then of ``hi.hi`` to the float32 accumulator, each sum cut
toward zero to float32 (``scripts/tf32_split_bench.cu`` part 3 holds
that model against the card: the card cuts toward zero too, a little
less hard).  The accumulators follow the kernels: each stage (64 columns
of D for S and dP, one whole rows-kernel chain over D <= 128 for the
forward's S, a 64-key tile for P.V and dq, a 64-row q tile for dv and
dk) starts a fresh partial that float32 adds to the running sum (to
nearest); the forward's running max rescales the output between tiles;
dk and dv come from a 32-key tile's walk over (head, q tile) in two
groups that take alternate steps and add their sums at the end.

It shows on the CPU that this arithmetic keeps the kernels' 1e-5 bar
against JAX, and that two other arithmetics miss it: one TF32 product
(``hi.hi`` alone, what a plain TF32 matmul gives), and the whole chain
of a product in one truncated accumulator with no fresh partials (the
first tensor-core design, which missed 1e-5 on the card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.layers import blocked_attention as j_blocked

ATOL = 1e-5
TILE = 64     # q rows and keys of a tile, columns of a ring piece
f32, f64 = np.float32, np.float64

# (B, Sq, Skv, Hq, Hkv, D, causal, q_offset): GQA 4:1 or 2:1, long enough
# (G Sq = 2,048 and 1,280 terms in dk and dv) or wide enough (D 512 over
# 48 keys) for a whole chain's drift to pass the bar
CASES = {"d80_full": (1, 512, 512, 4, 1, 80, False, None),
         "d128_causal_offset": (1, 320, 384, 4, 1, 128, True, 40),
         "d512_full": (1, 48, 48, 4, 2, 512, False, None)}


def tensor_core_read(x):
    """A float32 value as the tensor core reads a tf32 operand: its low
    13 mantissa bits dropped."""
    bits = np.asarray(x, f32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(f32)


def split(x):
    """(hi, lo) of ``csrc/tf32.cuh``'s ``split``, as the mma reads them."""
    x = np.asarray(x, f32)
    c = x * f32(8193.0)
    hi = c - (c - x)
    return hi, tensor_core_read(x - hi)


_CUT = np.uint64(~((1 << 29) - 1) & (2 ** 64 - 1))


def cut(x):
    """float64 x cut toward zero to float32's 24 significant bits, in
    place (its low 29 mantissa bits dropped)."""
    x.view(np.uint64)[...] &= _CUT
    return x


class Arith:
    """How a product is formed: the TF32 terms of each 8-wide step (in
    the kernels' order) and whether each stage starts a fresh partial."""

    def __init__(self, terms=("lh", "hl", "hh"), fold=True):
        self.terms, self.fold = terms, fold


SPLIT = Arith()                 # the kernels
SINGLE = Arith(("hh",))         # one TF32 product
CHAIN = Arith(fold=False)       # split, one truncated chain a product


def _steps(x, y):
    """(..., K/8, M, N): the exact sum of each 8-wide step's products."""
    K = x.shape[-1]
    xs = np.ascontiguousarray(
        x.astype(f64).reshape(x.shape[:-1] + (K // 8, 8)).swapaxes(-3, -2))
    ys = y.astype(f64).reshape(y.shape[:-2] + (K // 8, 8, y.shape[-1]))
    return xs @ ys


def tc(a, b, arith, stage=None, acc=None):
    """a (..., M, K) @ b (..., K, N) (K a multiple of 8) as the kernels'
    mma.sync chains: with ``arith.fold``, each ``stage`` columns of K
    (all of K by default) in a fresh partial, added to ``acc`` in float32;
    without, one chain continuing from ``acc``."""
    K = a.shape[-1]
    (ah, al), (bh, bl) = split(a), split(b)
    ops = {"lh": (al, bh), "hl": (ah, bl), "hh": (ah, bh)}
    steps = [_steps(*ops[t]) for t in arith.terms]
    shape = steps[0].shape[:-3] + steps[0].shape[-2:]
    if not arith.fold:
        part = np.zeros(shape)
        if acc is not None:
            part[...] = acc
        for s in range(K // 8):
            for t in steps:
                part += t[..., s, :, :]
                cut(part)
        return part.astype(f32)
    stage = (stage or K) // 8
    out = acc
    for s0 in range(0, K // 8, stage):
        part = np.zeros(shape)
        for s in range(s0, min(s0 + stage, K // 8)):
            for t in steps:
                part += t[..., s, :, :]
                cut(part)
        out = part.astype(f32) if out is None else out + part.astype(f32)
    return out


def _inputs(B, Sq, Skv, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(f32)
               for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    w = rng.normal(size=(B, Sq, Hq, D)).astype(f32)
    return q, k, v, w


def _pad(x, axis, to):
    n = (-x.shape[axis]) % to
    if not n:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, n)
    return np.pad(x, widths)


def kernel_copy(arith, q, k, v, w, causal, q_offset):
    """(out, dq, dk, dv) as the kernels form them with ``arith``: the
    forward over 64-key tiles, then the backward of sum(out * w) (P from
    the row LSE, D = rowsum(dO * O), dS = P (dP - D))."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = f32(D ** -0.5)
    off = (Skv - Sq if q_offset is None else q_offset) if causal else 0
    # (B, Hkv, G, S, D) and (B, Hkv, S, D), zero-padded to whole tiles and
    # to 8 columns, as the ring's copies fill them
    def heads(x):
        x = x.reshape(B, Sq, Hkv, G, D).transpose(0, 2, 3, 1, 4)
        return _pad(_pad(x, 3, TILE), 4, 8)
    qh, do = heads(q), heads(w)
    kh, vh = (_pad(_pad(x.transpose(0, 2, 1, 3), 2, TILE), 3, 8)
              for x in (k, v))
    Sqp, Skp, Dp = qh.shape[3], kh.shape[2], qh.shape[4]
    rows, keys = np.arange(Sqp)[:, None], np.arange(Skp)[None, :]
    seen = (rows < Sq) & (keys < Skv)
    if causal:
        seen &= keys <= rows + off
    # the forward: the rows kernel (D <= 128) keeps S over all of D in one
    # chain, the column-pair kernel folds it by 64 columns
    s_stage = Dp if Dp <= 128 else TILE
    m = np.full((B, Hkv, G, Sqp, 1), -np.inf, f32)
    l = np.zeros_like(m)
    o = np.zeros(qh.shape, f32)
    with np.errstate(invalid="ignore", over="ignore"):
        for k0 in range(0, Skp, TILE):
            ks = slice(k0, k0 + TILE)
            s = tc(qh, kh[:, :, None, ks].swapaxes(-1, -2), arith, s_stage)
            s = np.where(seen[:, ks], s * scale, -np.inf).astype(f32)
            m_new = np.maximum(m, s.max(-1, keepdims=True))
            cf = np.where(m_new == -np.inf, f32(1),
                          np.exp(m - m_new)).astype(f32)
            m = m_new
            p = np.where(s == -np.inf, f32(0), np.exp(s - m)).astype(f32)
            l = (l * cf + p.sum(-1, keepdims=True, dtype=f32)).astype(f32)
            if arith.fold:
                o = (o.astype(f64) * cf +
                     tc(p, vh[:, :, None, ks], arith)).astype(f32)
            else:
                o = tc(p, vh[:, :, None, ks], arith,
                       acc=(o * cf).astype(f32))
        lse = np.where(l > 0, m + np.log(np.maximum(l, f32(1e-30))),
                       np.inf).astype(f32)
    o = (o / np.maximum(l, f32(1e-30))).astype(f32)
    dd = (do * o).sum(-1, keepdims=True, dtype=f32)
    nq = Sqp // TILE
    # dk, dv: the walk of each 32-key tile, from its first seen q tile
    kt = np.arange(Skp) // 32
    first = (np.minimum(nq, np.maximum(0, kt * 32 - off) // TILE)
             if causal else np.zeros_like(kt))
    acc_v = [np.zeros(kh.shape, f32) for _ in range(2)]
    acc_k = [np.zeros(kh.shape, f32) for _ in range(2)]
    for g in range(G):
        for qt in range(nq):
            qs = slice(qt * TILE, (qt + 1) * TILE)
            qg, dog = qh[:, :, g, qs], do[:, :, g, qs]
            st = tc(kh, qg.swapaxes(-1, -2), arith, TILE)
            dpt = tc(vh, dog.swapaxes(-1, -2), arith, TILE)
            with np.errstate(over="ignore"):
                pt = np.where(seen[qs].T, np.exp(
                    st * scale - lse[:, :, g, qs, 0][:, :, None, :]),
                    0).astype(f32)
            dst = (pt * (dpt - dd[:, :, g, qs, 0][:, :, None, :])
                   ).astype(f32)
            if not arith.fold:
                acc_v[0] = tc(pt, dog, arith, acc=acc_v[0])
                acc_k[0] = tc(dst, qg, arith, acc=acc_k[0])
                continue
            walk = qt >= first
            grp = (g * (nq - first) + qt - first) % 2
            pv, pk = tc(pt, dog, arith), tc(dst, qg, arith)
            for j in range(2):
                sel = (walk & (grp == j))[:, None]
                acc_v[j] = np.where(sel, acc_v[j] + pv, acc_v[j])
                acc_k[j] = np.where(sel, acc_k[j] + pk, acc_k[j])
    dv = acc_v[0] + acc_v[1]
    dk = (acc_k[0] + acc_k[1]) * scale
    # dq: every row over the 64-key tiles (tiles a row does not see add 0)
    dq = np.zeros(qh.shape, f32) if arith.fold else None
    for k0 in range(0, Skp, TILE):
        ks = slice(k0, k0 + TILE)
        s = tc(qh, kh[:, :, None, ks].swapaxes(-1, -2), arith, TILE)
        dp = tc(do, vh[:, :, None, ks].swapaxes(-1, -2), arith, TILE)
        with np.errstate(over="ignore"):
            p = np.where(seen[:, ks], np.exp(s * scale - lse), 0)
        ds = (p.astype(f32) * (dp - dd)).astype(f32)
        dq = tc(ds, kh[:, :, None, ks], arith, acc=dq)
    dq = (dq * scale).astype(f32)

    def rows_out(x):
        x = x[:, :, :, :Sq, :D].transpose(0, 3, 1, 2, 4)
        return x.reshape(B, Sq, Hq, D)

    def keys_out(x):
        return x[:, :, :Skv, :D].transpose(0, 2, 1, 3)

    return rows_out(o), rows_out(dq), keys_out(dk), keys_out(dv)


def jax_reference(q, k, v, w, causal, q_offset):
    kw = {}
    if q_offset is not None:
        kw["q_offset"] = jnp.full((q.shape[0],), q_offset, jnp.int32)

    def loss(q, k, v):
        out = j_blocked(q, k, v, causal=causal, **kw)
        return (out * w).sum(), out

    grads, out = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    return (np.asarray(out),) + tuple(np.asarray(g) for g in grads)


_REFS = {}


def _case(name):
    if name not in _REFS:
        B, Sq, Skv, Hq, Hkv, D, causal, off = CASES[name]
        q, k, v, w = _inputs(B, Sq, Skv, Hq, Hkv, D)
        _REFS[name] = ((q, k, v, w, causal, off),
                       jax_reference(q, k, v, w, causal, off))
    return _REFS[name]


def _errors(got, want):
    """(forward max |err|, gradients' max |err| over max(1, max |grad|))."""
    fwd = float(np.abs(got[0] - want[0]).max())
    grad = max(float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
               for a, b in zip(got[1:], want[1:]))
    return fwd, grad


@pytest.mark.parametrize("name", list(CASES))
def test_split_tf32_holds_the_float32_bar_against_jax(name):
    args, want = _case(name)
    fwd, grad = _errors(kernel_copy(SPLIT, *args), want)
    assert fwd <= ATOL, fwd
    assert grad <= ATOL, grad


@pytest.mark.parametrize("name", list(CASES))
def test_single_tf32_product_misses_the_bar(name):
    """The control: with hi.hi alone the same copy misses the bars, so
    the bars see the split."""
    args, want = _case(name)
    fwd, grad = _errors(kernel_copy(SINGLE, *args), want)
    assert fwd > ATOL, fwd
    assert grad > ATOL, grad


@pytest.mark.parametrize("name", list(CASES))
def test_whole_chain_accumulation_misses_the_bar(name):
    """The second control: the split products with each product's whole
    chain in one accumulator, cut toward zero at every step and never
    refreshed, drift past a bar (the forward at D 512, where S sums 192
    cut steps over 48 keys; dk and dv at the long walks), so the bars see
    the fresh partials."""
    args, want = _case(name)
    fwd, grad = _errors(kernel_copy(CHAIN, *args), want)
    assert max(fwd, grad) > ATOL, (fwd, grad)


def test_cut_is_float32_toward_zero():
    """``cut`` gives the float32 next to x on zero's side: x itself when
    x is a float32, else the float32 of x to nearest stepped toward zero
    where that rounding went away from it."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=20000) * 2.0 ** rng.integers(-30, 30, size=20000)
    x[:4] = [0.0, -0.0, 1.0, -3.0]
    near = x.astype(f32)
    away = np.abs(near.astype(f64)) > np.abs(x)
    want = np.where(away, np.nextafter(near, f32(0)), near)
    assert (cut(x.copy()) == want.astype(f64)).all()


def test_split_gives_tf32_hi_and_the_exact_rest():
    """hi has TF32's 11 significant bits and is x to nearest (half an ulp
    at 11 bits, 2^-11 of |x|); hi + lo before the tensor core's read is x
    exactly, and the read drops under 2^-10 of lo."""
    x = np.random.default_rng(1).normal(size=4096).astype(np.float32)
    x *= np.float32(2.0) ** np.arange(-20, 20, 10, dtype=np.float32)[
        np.arange(4096) % 4]
    c = x * np.float32(8193.0)
    hi = c - (c - x)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    x64, hi64 = x.astype(np.float64), hi.astype(np.float64)
    assert (np.abs(x64 - hi64) <= 2.0 ** -11 * np.abs(x64)).all()
    rest = (x - hi).astype(np.float64)
    assert (hi64 + rest == x64).all()
    lo = split(x)[1].astype(np.float64)
    assert (np.abs(rest - lo) < 2.0 ** -10 * np.abs(rest) + 1e-45).all()
