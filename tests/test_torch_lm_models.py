"""LM model parity of the PyTorch port against the JAX package, in
float32 on the CPU (the point here is the algorithm, not bf16 rounding):

* ``rms_norm``, ``apply_rope``, ``decode_attention`` and ``mlp_apply``
  (swiglu, sq_relu, gelu), and the Mamba-1 block, its conv step and its
  decode step, within 1e-5 (one float32 op's bar);
* ``forward_hidden`` of the ten archs at their ``reduced()`` size
  (dense, vlm, audio, ssm, moe and hybrid), with JAX weights loaded by
  ``params_from_jax``, with and without ``collect_state``, within 1e-5
  (rtol and atol; for the moe archs, whose hidden reaches 200 under
  JAX's init, where a float32 ulp is 1.5e-5, within 1e-5 of the
  tensor's max |value|; their aux metrics too, the drop fraction
  exactly);
* the port's own init gives the JAX tree's names, shapes and dtypes, in
  float32 and, for the moe and hybrid archs, in bf16 (the router and
  Mamba-2's A_log, D and dt_bias stay float32); an unknown family
  raises ``ValueError``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import layers as JL
from repro.models import lm_zoo as JZ
from repro.models import mamba as JM
from repro.models import transformer_lm as JT
from repro_torch.configs import get_arch
from repro_torch.models import layers as TL
from repro_torch.models import lm_zoo as TZ
from repro_torch.models import mamba as TM
from repro_torch.models import transformer_lm as TT
from repro_torch.models.convert import params_from_jax

TOL = 1e-5
ARCHS = ["qwen3-14b", "yi-6b", "granite-3-8b", "nemotron-4-340b",
         "chameleon-34b", "hubert-xlarge", "falcon-mamba-7b",
         "qwen3-moe-235b-a22b", "llama4-scout-17b-a16e", "zamba2-2.7b"]
MOE_HYBRID = ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e", "zamba2-2.7b"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_to_scale(got, want, tol=TOL):
    """max |got - want| within ``tol`` of max(1, max |want|)."""
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


@functools.lru_cache(maxsize=None)
def _params(arch):
    cfg = j_get_arch(arch).reduced()
    jp = JZ.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, get_arch(arch).reduced(), jp, tp


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=64).astype(np.float32)
    _close(TL.rms_norm(_t(x), _t(w), 1e-5),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("pos_rank", [1, 2])
def test_apply_rope(pos_rank):
    rng = np.random.default_rng(pos_rank)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = np.arange(100, 109, dtype=np.int32)
    if pos_rank == 2:
        pos = np.stack([pos, pos * 3])
    _close(TL.apply_rope(_t(x), _t(pos), 1e6),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


def test_decode_attention():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(3, 1, 8, 16)).astype(np.float32)
    k = rng.normal(size=(3, 12, 2, 16)).astype(np.float32)
    v = rng.normal(size=(3, 12, 2, 16)).astype(np.float32)
    valid = np.array([1, 7, 12], np.int32)
    _close(TL.decode_attention(_t(q), _t(k), _t(v), _t(valid)),
           JL.decode_attention(*(jnp.asarray(a) for a in (q, k, v, valid))))


@pytest.mark.parametrize("act", ["swiglu", "sq_relu", "gelu"])
def test_mlp_apply(act):
    rng = np.random.default_rng(2)
    shapes = TL.mlp_param_shapes(32, 48, act)
    assert shapes == JL.mlp_param_shapes(32, 48, act)
    p = {n: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in shapes.items()}
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    _close(TL.mlp_apply(_t(x), {n: _t(a) for n, a in p.items()}, act),
           JL.mlp_apply(jnp.asarray(x), {n: jnp.asarray(a)
                                         for n, a in p.items()}, act))


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------


def _mamba():
    cfg = j_get_arch("falcon-mamba-7b").reduced()
    jp = JM.mamba1_init(jax.random.PRNGKey(3), cfg.ssm, cfg.d_model)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def test_mamba1_forward_and_state():
    cfg, jp, tp = _mamba()
    x = np.random.default_rng(4).normal(size=(2, 13, cfg.d_model)).astype(
        np.float32)
    y_j, st_j = JM.mamba1_forward(jp, jnp.asarray(x), cfg.ssm,
                                  return_state=True)
    y_t, st_t = TM.mamba1_forward(tp, _t(x), cfg.ssm, return_state=True)
    _close(y_t, y_j)
    _close(st_t["conv"], st_j["conv"])
    _close(st_t["h"], st_j["h"])
    _close(TM.mamba1_forward(tp, _t(x), cfg.ssm), y_j)


def test_causal_conv1d_and_conv_step():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=12).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32)
    _close(TM.causal_conv1d(_t(x), _t(w), _t(b)),
           JM.causal_conv1d(*(jnp.asarray(a) for a in (x, w, b))))
    y_t, s_t = TM.conv_step(_t(x[:, 0]), _t(st), _t(w), _t(b))
    y_j, s_j = JM.conv_step(*(jnp.asarray(a) for a in (x[:, 0], st, w, b)))
    _close(y_t, y_j)
    _close(s_t, s_j)


def test_mamba1_decode_step():
    cfg, jp, tp = _mamba()
    rng = np.random.default_rng(6)
    s_j = JM.mamba1_init_state(cfg.ssm, cfg.d_model, 2)
    s_t = TM.mamba1_init_state(cfg.ssm, cfg.d_model, 2, device="cpu")
    assert {k: tuple(v.shape) for k, v in s_t.items()} == \
        {k: v.shape for k, v in s_j.items()}
    for _ in range(3):
        x = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
        y_j, s_j = JM.mamba1_decode_step(jp, jnp.asarray(x), s_j, cfg.ssm)
        y_t, s_t = TM.mamba1_decode_step(tp, _t(x), s_t, cfg.ssm)
        _close(y_t, y_j)
        _close(s_t["h"], s_j["h"])
        _close(s_t["conv"], s_j["conv"])


# ---------------------------------------------------------------------------
# forward_hidden
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_f32(arch, collect):
    jcfg, tcfg, jp, tp = _params(arch)
    B, S = 2, 11
    rng = np.random.default_rng(len(arch))
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    h_j, aux_j, st_j = JT.forward_hidden(jcfg, jp, jnp.asarray(x),
                                         jnp.asarray(pos),
                                         collect_state=collect)
    h_t, aux_t, st_t = TT.forward_hidden(tcfg, tp, _t(x), _t(pos.copy()),
                                         collect_state=collect)
    (_close_to_scale if jcfg.moe is not None else _close)(h_t, h_j)
    assert set(aux_t) == set(aux_j)
    if jcfg.moe is not None:
        _close(aux_t["moe_lb_loss"], aux_j["moe_lb_loss"], 1e-6)
        assert float(aux_t["moe_drop_frac"]) == float(aux_j["moe_drop_frac"])
    if not collect:
        assert st_t is None and st_j is None
        return
    for path, leaf in jax.tree_util.tree_leaves_with_path(st_j):
        node = st_t
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape
        _close(node, leaf)


def _leaf_specs(tree, prefix=""):
    """{JAX keystr path: (shape, dtype name)} of a port tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_specs(v, f"{prefix}['{k}']"))
        else:
            out[f"{prefix}['{k}']"] = (tuple(v.shape),
                                       str(v.dtype).split(".")[1])
    return out


def _jax_specs(tree):
    return {jax.tree_util.keystr(p): (x.shape, str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_tree(arch):
    jcfg, tcfg, jp, _ = _params(arch)
    tp = TZ.init_params(tcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    assert _leaf_specs(tp) == _jax_specs(jp)
    if jcfg.family in ("ssm", "hybrid"):
        key = "layers" if jcfg.family == "ssm" else "superlayers"
        m = tp[key][f"mamba{jcfg.ssm.version}"]
        _close(m["A_log"], jp[key][f"mamba{jcfg.ssm.version}"]["A_log"])
        dt = torch.nn.functional.softplus(m["dt_bias"])
        assert float(dt.min()) >= 1e-3 - 1e-6 and float(dt.max()) <= 0.1


@pytest.mark.parametrize("arch", MOE_HYBRID)
def test_init_matches_jax_tree_bf16(arch):
    jcfg, tcfg = j_get_arch(arch).reduced(), get_arch(arch).reduced()
    want = _jax_specs(jax.eval_shape(
        lambda k: JT.init_lm(jcfg, k, jnp.bfloat16), jax.random.PRNGKey(0)))
    tp = TZ.init_params(tcfg, torch.Generator().manual_seed(0),
                        torch.bfloat16, device="cpu")
    assert _leaf_specs(tp) == want
    assert {v[1] for v in want.values()} == {"bfloat16", "float32"}


def test_unknown_family_raises():
    cfg = dataclasses.replace(get_arch("yi-6b").reduced(), family="rnn")
    with pytest.raises(ValueError, match="rnn"):
        TZ.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="rnn"):
        TT.init_decode_state(cfg, 1, 4, device="cpu")


def test_params_from_jax_bf16_and_int_leaves():
    tree = {"w": jnp.asarray([[1.5, -2.25], [3e-3, 7.0]], jnp.bfloat16),
            "pos": jnp.asarray([3, 4], jnp.int32)}
    got = params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].float(),
                       torch.from_numpy(np.asarray(tree["w"], np.float32)))
    assert got["pos"].dtype == torch.int32 and got["pos"].tolist() == [3, 4]
