"""The PyTorch port's MoE layer and Mamba-2 (SSD) block against the JAX
package, in float32 on the CPU, from numpy seeds and the JAX weights
(``params_from_jax``):

* ``moe_apply`` (the dense path, which the JAX package takes off a
  mesh) with and without the shared expert, at a capacity that drops
  slots and one that does not: the output within 1e-5, ``moe_lb_loss``
  within 1e-6, ``moe_drop_frac`` and the routing (each token's experts)
  exactly; ties in the router's top-k go to the lower expert as in
  ``lax.top_k``, and a top-k that breaks them the other way is caught;
* ``_ssd_chunked`` at a length its chunk divides and one it does not,
  from a nonzero state; ``mamba2_forward`` with its decode state; three
  ``mamba2_decode_step``\\ s: all within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import MoEConfig
from repro.models import mamba as JM
from repro.models import moe as JMoE
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.models import mamba as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.convert import params_from_jax

TOL = 1e-5
D_MODEL = 32


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _moe(cf, shared, act="swiglu", seed=0):
    """A small MoE layer in both packages: 4 experts, top 2."""
    cfg = MoEConfig(num_experts=4, top_k=2, expert_d_ff=24,
                    capacity_factor=cf, shared_expert_d_ff=16 * shared)
    jp = JMoE.moe_init(jax.random.PRNGKey(seed), cfg, D_MODEL, act)
    tcfg = TMoEConfig(**dataclasses.asdict(cfg))
    return cfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def _routed(tp, tcfg, x, act):
    """The port's moe_apply, with each token's experts as its top-k
    picked them."""
    picked = []
    real = TMoE._top_k

    def record(probs, k):
        out = real(probs, k)
        picked.append(out[1])
        return out
    TMoE._top_k = record
    try:
        y, aux = TMoE.moe_apply(tp, _t(x), tcfg, act)
    finally:
        TMoE._top_k = real
    return y, aux, picked[0]


def _jax_routing(jp, x, k):
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


def test_moe_capacity_matches_jax():
    for cf in (0.5, 1.25, 2.0):
        for k, E in ((1, 16), (2, 4), (8, 128)):
            cfg = MoEConfig(num_experts=E, top_k=k, capacity_factor=cf)
            tcfg = TMoEConfig(**dataclasses.asdict(cfg))
            for S in (1, 7, 128, 4096):
                assert TMoE.moe_capacity(tcfg, S) == JMoE.moe_capacity(cfg, S)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("cf,drops", [(2.0, False), (0.5, True)])
def test_moe_apply_matches_jax(cf, drops, shared, act):
    """S 24 over 4 experts, top 2: capacity 24 (cf 2) takes every slot,
    capacity 6 (cf 0.5) drops some."""
    cfg, tcfg, jp, tp = _moe(cf, shared, act)
    x = np.random.default_rng(int(cf * 10) + shared).normal(
        size=(2, 24, D_MODEL)).astype(np.float32)
    y_j, aux_j = JMoE._moe_apply_dense(jp, jnp.asarray(x), cfg, act)
    y_t, aux_t, idx = _routed(tp, tcfg, x, act)
    np.testing.assert_array_equal(idx.numpy(), _jax_routing(jp, x, 2))
    _close(y_t, y_j)
    _close(aux_t["moe_lb_loss"], aux_j["moe_lb_loss"], 1e-6)
    assert float(aux_t["moe_drop_frac"]) == float(aux_j["moe_drop_frac"])
    assert (float(aux_t["moe_drop_frac"]) > 0) == drops
    assert ("shared" in tp) == shared


def _tied_moe():
    """Router columns 1 and 3 zero: experts 1 and 3 tie exactly at
    logit 0 for every token, and a token whose experts 0 and 2 straddle
    0 has the tie at its top-2 boundary."""
    cfg, tcfg, jp, tp = _moe(2.0, False, seed=4)
    router = np.asarray(jp["router"]).copy()
    router[:, 1] = router[:, 3] = 0.0
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=_t(router))
    x = np.random.default_rng(5).normal(size=(2, 16, D_MODEL)).astype(
        np.float32)
    return cfg, tcfg, jp, tp, x


def _tie_check(tp, tcfg, jp, cfg, x):
    """(routing equal to lax.top_k's, max |port - JAX| of the output)."""
    y_j, _ = JMoE._moe_apply_dense(jp, jnp.asarray(x), cfg, "swiglu")
    y_t, _, idx = _routed(tp, tcfg, x, "swiglu")
    same = np.array_equal(idx.numpy(), _jax_routing(jp, x, 2))
    return same, float(np.abs(y_t.numpy() - np.asarray(y_j)).max())


def test_moe_ties_go_to_the_lower_expert(monkeypatch):
    cfg, tcfg, jp, tp, x = _tied_moe()
    one, three = (_jax_routing(jp, x, 2) == e for e in (1, 3))
    assert (one.any(-1) & ~three.any(-1)).any()     # a tie at the boundary
    assert not (three.any(-1) & ~one.any(-1)).any()
    same, err = _tie_check(tp, tcfg, jp, cfg, x)
    assert same and err <= TOL

    def higher_first(probs, k):         # the planted fault
        E = probs.shape[-1]
        vals, idx = torch.sort(probs.flip(-1), dim=-1, descending=True,
                               stable=True)
        return vals[..., :k], E - 1 - idx[..., :k]
    monkeypatch.setattr(TMoE, "_top_k", higher_first)
    same, err = _tie_check(tp, tcfg, jp, cfg, x)
    assert not same and err > 100 * TOL


# ---------------------------------------------------------------------------
# Mamba-2 / SSD
# ---------------------------------------------------------------------------


def _mamba2():
    cfg = j_get_arch("zamba2-2.7b").reduced()
    jp = JM.mamba2_init(jax.random.PRNGKey(7), cfg.ssm, cfg.d_model)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")


@pytest.mark.parametrize("L", [32, 21])
def test_ssd_chunked_matches_jax(L):
    """Chunk 8: L 32 is 4 whole chunks, L 21 pads the third."""
    rng = np.random.default_rng(L)
    B, H, P, N = 2, 3, 4, 5
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, size=(B, L, H)).astype(np.float32)
    A = -rng.uniform(0.5, 3.0, size=H).astype(np.float32)
    Bt, Ct = (rng.normal(size=(B, L, N)).astype(np.float32)
              for _ in range(2))
    h0 = rng.normal(size=(B, H, N, P)).astype(np.float32)
    args = (x, dt, A, Bt, Ct)
    y_j, h_j = JM._ssd_chunked(*(jnp.asarray(a) for a in args), 8,
                               jnp.asarray(h0))
    y_t, h_t = TM._ssd_chunked(*(_t(a) for a in args), 8, _t(h0))
    assert tuple(y_t.shape) == (B, L, H, P)
    _close(y_t, y_j)
    _close(h_t, h_j)


def test_mamba2_forward_and_state_match_jax():
    cfg, jp, tp = _mamba2()
    x = np.random.default_rng(8).normal(size=(2, 19, cfg.d_model)).astype(
        np.float32)
    y_j, st_j = jax.jit(JM.mamba2_forward, static_argnums=(2, 3))(
        jp, jnp.asarray(x), cfg.ssm, True)
    y_t, st_t = TM.mamba2_forward(tp, _t(x), cfg.ssm, return_state=True)
    _close(y_t, y_j)
    _close(st_t["conv"], st_j["conv"])
    _close(st_t["h"], st_j["h"])
    _close(TM.mamba2_forward(tp, _t(x), cfg.ssm), y_j)


def test_mamba2_decode_step_matches_jax():
    cfg, jp, tp = _mamba2()
    rng = np.random.default_rng(9)
    s_j = JM.mamba2_init_state(cfg.ssm, cfg.d_model, 2)
    s_t = TM.mamba2_init_state(cfg.ssm, cfg.d_model, 2, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in s_t.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in s_j.items()}
    for _ in range(3):
        x = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
        y_j, s_j = JM.mamba2_decode_step(jp, jnp.asarray(x), s_j, cfg.ssm)
        y_t, s_t = TM.mamba2_decode_step(tp, _t(x), s_t, cfg.ssm)
        _close(y_t, y_j)
        _close(s_t["h"], s_j["h"])
        _close(s_t["conv"], s_j["conv"])
