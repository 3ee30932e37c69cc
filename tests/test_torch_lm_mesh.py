"""The port's LM mesh paths against the JAX package's, in-process on the
suite's 8 fake CPU devices (``tests/conftest.py``), a (2, 4) mesh of
``Auto`` axes with ``default_rules()`` on both sides, and a fresh
``jax.jit`` closure under each context (a reused one keeps the trace it
made outside it):

* ``direct_attention``, and ``blocked_attention`` with ``q_offset``
  (the plain flash version on the CPU), within 1e-5; the flash
  wrapper's offset check (a negative offset raises; any other passes,
  under autograd too); the shards' gradients at their offsets, summed
  as the all-gather's transpose sums them, equal to the whole
  sequence's within 1e-5;
* ``_cp_attention_shard_map``, both the direct and the blocked branch
  (``blocked`` is JAX's own argument: a small S never reaches the
  blocked branch through ``attn_full``): forward within 1e-5, q/k/v
  gradients within 1e-4;
* ``moe_apply``'s expert-parallel path with the reference EP test's
  config (8 experts, top 2, cf 8.0: no drops), with a dropping cf and
  with a shared expert: output, balance loss and drop fraction within
  1e-5, gradients within 1e-4.  The balance loss is each shard's,
  averaged (JAX's EP convention), so it is held against JAX's EP and
  not the dense path;
* reduced qwen3-moe-235b-a22b and llama4-scout-17b-a16e (the shared
  expert) under the mesh: the same branches as JAX (CP direct, or
  blocked with the score budget lowered in both packages; EP),
  float32 ``forward_hidden`` within 1e-4 and bf16 prefill logits within
  the 0.1 bar of ``tests/test_torch_lm_serving.py``;
* decode after the mesh prefill (dense MoE, no CP: one token does not
  split) equal to the same decode without the mesh.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_arch as j_get_arch
from repro.configs.base import MoEConfig
from repro.dist import sharding as JS
from repro.models import layers as JL
from repro.models import lm_zoo as JZ
from repro.models import moe as JMoE
from repro.models import transformer_lm as JT
from repro_torch.configs import get_arch
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.dist import sharding as TS
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import layers as TL
from repro_torch.models import lm_zoo as TZ
from repro_torch.models import moe as TMoE
from repro_torch.models import transformer_lm as TT
from repro_torch.models.convert import params_from_jax

TOL = 1e-5
GRAD_TOL = 1e-4
HIDDEN_TOL = 1e-4
BF16_TOL = 0.1          # tests/test_torch_lm_serving.py's bar


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _jax_ctx():
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return JS.sharding_ctx(mesh, JS.default_rules())


def _torch_ctx():
    return TS.sharding_ctx(make_local_mesh(2, 4, device="cpu"),
                           TS.default_rules())


def _qkv(B, Sq, Skv, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


# ---------------------------------------------------------------------------
# attention with an offset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,q_offset", [
    (True, None), (True, 0), (True, 5), (True, 11), (False, None)])
def test_direct_attention_matches_jax(causal, q_offset):
    q, k, v = _qkv(2, 7, 19, 8, 2, 16, seed=3)
    got = TL.direct_attention(_t(q), _t(k), _t(v), causal=causal,
                              q_offset=q_offset)
    want = JL.direct_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               q_offset=q_offset)
    _close(got, want)


@pytest.mark.parametrize("q_offset", [None, 0, 3, 12, 30])
def test_blocked_attention_q_offset_matches_jax(q_offset):
    """The port's blocked_attention (the flash kernel's plain version on
    the CPU) against JAX's online-softmax scan with its (B,) offset; 30
    puts the last rows past every key."""
    B = 2
    q, k, v = _qkv(B, 9, 21, 4, 2, 8, seed=4)
    got = TL.blocked_attention(_t(q), _t(k), _t(v), causal=True,
                               q_offset=q_offset)
    jo = None if q_offset is None else jnp.full((B,), q_offset, jnp.int32)
    want = JL.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, q_chunk=4,
                                kv_chunk=8, q_offset=jo)
    _close(got, want)


def test_flash_q_offset_check():
    """The wrapper's check: the default offset is Skv - Sq and any other
    offset >= 0 passes (both backward kernels take the forward's); a
    negative one raises on any device, under autograd too; a call that
    is not causal masks nothing and takes any."""
    q, k = torch.zeros(1, 4, 2, 8), torch.zeros(1, 10, 2, 8)
    check = flash_ops.q_offset_of
    assert check(q, k, True) == 6 and check(q, k, True, 2) == 2
    assert check(q, k, True, 6) == 6 and check(q, k, False, 3) == 0
    assert check(q, k, True, 0) == 0 and check(q, k, True, 9) == 9
    with pytest.raises(ValueError, match="q_offset -1"):
        check(q, k, True, -1)
    with pytest.raises(ValueError, match="q_offset -1"):
        flash_ops.flash_attention(q, k, k, causal=True, q_offset=-1)
    with pytest.raises(ValueError, match="q_offset -1"):
        flash_ops.flash_attention(q.requires_grad_(), k, k, causal=True,
                                  q_offset=-1)
    # an explicit offset lifts the causal Sq <= Skv check
    flash_ops._check(k, q, q, True, None, 0)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        flash_ops._check(k, q, q, True)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (8, 1)])
def test_flash_shard_offsets_sum_to_the_whole_gradient(shards, Hq, Hkv):
    """Each context-parallel shard's queries at its ``q_offset`` against
    the whole K/V, through the flash wrapper's autograd (the plain
    version on the CPU): dq of the shards concatenated, and dk, dv summed
    over the shards (the all-gather's transpose), equal the causal
    gradient of the whole sequence in one call within 1e-5.  Shard 0's
    keys past its last row get exactly zero from it."""
    B, S, D = 2, 48, 16
    q, k, v = (_t(a) for a in _qkv(B, S, S, Hq, Hkv, D, seed=8))
    w = _t(np.random.default_rng(9).normal(size=(B, S, Hq, D)).astype(
        np.float32))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    whole = torch.autograd.grad(
        (flash_ops.flash_attention(*ins, causal=True) * w).sum(), ins)
    Sl = S // shards
    dq, dk, dv = [], torch.zeros_like(k), torch.zeros_like(v)
    for i in range(shards):
        sl = slice(i * Sl, (i + 1) * Sl)
        part = [q[:, sl].clone().requires_grad_(True),
                k.clone().requires_grad_(True),
                v.clone().requires_grad_(True)]
        out = flash_ops.flash_attention(*part, causal=True,
                                        q_offset=i * Sl)
        g = torch.autograd.grad((out * w[:, sl]).sum(), part)
        if i == 0:
            assert not g[1][:, Sl:].any() and not g[2][:, Sl:].any()
        dq.append(g[0])
        dk, dv = dk + g[1], dv + g[2]
    for got, want in zip((torch.cat(dq, 1), dk, dv), whole):
        _close(got, want.numpy())


# ---------------------------------------------------------------------------
# context-parallel attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blocked", [False, True])
def test_cp_attention_matches_jax(blocked, causal):
    q, k, v = _qkv(4, 32, 32, 8, 4, 16, seed=5)
    w = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)

    def j_loss(qq, kk, vv):
        return jnp.sum(JT._cp_attention_shard_map(
            qq, kk, vv, causal=causal, blocked=blocked) * w)

    with _jax_ctx():
        want = jax.jit(lambda a, b, c: JT._cp_attention_shard_map(
            a, b, c, causal=causal, blocked=blocked))(q, k, v)
        j_grads = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(q, k, v)
    ins = [_t(a).requires_grad_(True) for a in (q, k, v)]
    with _torch_ctx():
        got = TT._cp_attention_shard_map(*ins, causal=causal,
                                         blocked=blocked)
    _close(got, want)
    t_grads = torch.autograd.grad((got * _t(w)).sum(), ins)
    for g_t, g_j in zip(t_grads, j_grads):
        _close(g_t, g_j, GRAD_TOL)


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------


def _ep_only(monkeypatch):
    """Make the port's dense path raise, so a call must take EP."""
    def no(*a, **k):
        raise AssertionError("took the dense path")
    monkeypatch.setattr(TMoE, "_moe_apply_dense", no)


@pytest.mark.parametrize("cf,shared", [(8.0, 0), (1.0, 0), (0.5, 24)])
def test_moe_ep_matches_jax(cf, shared, monkeypatch):
    cfg = MoEConfig(num_experts=8, top_k=2, expert_d_ff=32,
                    capacity_factor=cf, shared_expert_d_ff=shared)
    tcfg = TMoEConfig(num_experts=8, top_k=2, expert_d_ff=32,
                      capacity_factor=cf, shared_expert_d_ff=shared)
    jp = JMoE.moe_init(jax.random.PRNGKey(0), cfg, 16, "swiglu")
    x = np.random.default_rng(1).normal(size=(4, 16, 16)).astype(np.float32)

    def j_loss(p, xx):
        return jnp.sum(JMoE.moe_apply(p, xx, cfg, "swiglu")[0] ** 2)

    with _jax_ctx():
        y_j, aux_j = jax.jit(lambda p, xx: JMoE.moe_apply(
            p, xx, cfg, "swiglu"))(jp, x)
        g_j = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jp, x)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for leaf in jax.tree.leaves(tp):
        leaf.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    _ep_only(monkeypatch)
    with _torch_ctx():
        y_t, aux_t = TMoE.moe_apply(tp, xt, tcfg, "swiglu")
    _close(y_t, y_j)
    for key in ("moe_lb_loss", "moe_drop_frac"):
        _close(aux_t[key], aux_j[key])
    assert (float(aux_t["moe_drop_frac"]) == 0.0) == (cf == 8.0)
    names = sorted(n for n in tp if n != "shared")
    leaves = [tp[n] for n in names] + (
        [tp["shared"][n] for n in sorted(tp["shared"])] if shared else [])
    grads = torch.autograd.grad((y_t ** 2).sum(), leaves + [xt])
    want = [g_j[0][n] for n in names] + (
        [g_j[0]["shared"][n] for n in sorted(tp["shared"])] if shared
        else []) + [g_j[1]]
    for g_t, g_w in zip(grads, want):
        _close(g_t, g_w, GRAD_TOL)


# ---------------------------------------------------------------------------
# serving reduced archs under the mesh
# ---------------------------------------------------------------------------

ARCHS = ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _params(arch):
    cfg = j_get_arch(arch).reduced()
    jp = JZ.init_params(cfg, jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, get_arch(arch).reduced(), jp, tp


def _branches(monkeypatch):
    """Record the port's CP branches (direct or blocked) and make its
    dense MoE path raise: under the mesh, a prefill at S 16 must take CP
    and EP."""
    taken = []
    real = TT._cp_attention_shard_map

    def cp(*a, **k):
        taken.append(k["blocked"])
        return real(*a, **k)
    monkeypatch.setattr(TT, "_cp_attention_shard_map", cp)
    _ep_only(monkeypatch)
    return taken


@pytest.mark.parametrize("arch,budget", [(a, "direct") for a in ARCHS]
                         + [(ARCHS[0], "blocked")])
def test_prefill_under_mesh_matches_jax(arch, budget, monkeypatch):
    """Both packages branch on the same score budget: at S 16 the score
    block is far under 5e9 (direct); with the budget lowered in both,
    the blocked branch."""
    jcfg, tcfg, jp, tp = _params(arch)
    if budget == "blocked":
        monkeypatch.setattr(JT, "_CP_SCORE_BYTES_LIMIT", 1.0)
        monkeypatch.setattr(TT, "_CP_SCORE_BYTES_LIMIT", 1.0)
    rng = np.random.default_rng(len(arch))
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    with _jax_ctx():
        h_j, aux_j, _ = jax.jit(lambda p, xx, pp: JT.forward_hidden(
            jcfg, p, xx, pp))(jp, x, pos)
        l_j, _ = jax.jit(JZ.make_prefill_step(jcfg))(jp, {"tokens": toks})
    taken = _branches(monkeypatch)
    with _torch_ctx():
        h_t, aux_t, _ = TT.forward_hidden(tcfg, tp, _t(x), _t(pos))
        l_t, st_t = TZ.make_prefill_step(tcfg)(tp, {"tokens": _t(toks)})
    assert taken == [budget == "blocked"] * (2 * tcfg.n_layers)
    _close(h_t, h_j, HIDDEN_TOL)
    for key in ("moe_lb_loss", "moe_drop_frac"):
        _close(aux_t[key], aux_j[key])
    diff = float(np.abs(l_t.numpy() - np.asarray(l_j, np.float32)).max())
    assert diff <= BF16_TOL, diff
    assert st_t["pos"].tolist() == [S] * B


def test_decode_after_mesh_prefill_matches_no_mesh():
    """The mesh prefill's state continues into decode; decode under the
    mesh (one token: dense MoE, decode attention) equals decode off it,
    and the mesh prefill's K/V stay within the bf16 bar of the no-mesh
    prefill's (neither drops a slot at this size)."""
    _, tcfg, _, tp = _params("qwen3-moe-235b-a22b")
    toks = _t(np.random.default_rng(9).integers(
        0, tcfg.vocab, (B, S + 3)).astype(np.int32))
    prefill, serve = TZ.make_prefill_step(tcfg), TZ.make_serve_step(tcfg)
    with _torch_ctx():
        l_m, st_m = prefill(tp, {"tokens": toks[:, :S]})
    l_n, st_n = prefill(tp, {"tokens": toks[:, :S]})
    assert float((l_m - l_n).abs().max()) <= BF16_TOL
    for key in ("k", "v"):
        assert float((st_m[key].float() - st_n[key].float()).abs().max()
                     ) <= BF16_TOL
    pad = lambda st: dict(st, **{key: torch.nn.functional.pad(
        st[key], (0, 0, 0, 0, 0, 3)) for key in ("k", "v")})
    d_m, d_n = pad(st_m), pad(st_m)
    for i in range(3):
        tok = toks[:, S + i:S + i + 1]
        with _torch_ctx():
            o_m, d_m = serve(tp, d_m, tok)
        o_n, d_n = serve(tp, d_n, tok)
        assert torch.equal(o_m, o_n), i
    assert d_m["pos"].tolist() == [S + 3] * B
