"""LM training under a mesh, the port against the JAX package, in
float32 on the suite's 8 fake CPU devices (``tests/conftest.py``): a
(2, 4) mesh of ``Auto`` axes with ``default_rules()`` on both sides, a
fresh ``jax.jit`` under each context, both packages' compute cast and
the embedding's bf16 output set aside, and the per-shard score budget
lowered in both so that context-parallel attention takes its blocked
branch (flash at each shard's ``q_offset``; its plain version here):

* ``make_loss_fn``'s value and gradient for reduced qwen3-moe-235b-a22b
  and llama4-scout-17b-a16e (the shared expert) against
  ``jax.value_and_grad`` of JAX's under its mesh: the loss and the
  metrics within 1e-5 of max(1, |value|) (the balance loss is each
  expert-parallel shard's, averaged: JAX's EP convention), and each
  gradient leaf within 1e-4 of its own max |value|, so that a leaf of
  small gradients (the router, the norms) is held as closely as a large
  one;
* one ``make_train_step`` under the mesh against the same step off it,
  at a capacity factor of E / k (no slot drops on either path) with the
  router's balance term weighted 0 (the EP balance loss is a per-shard
  mean by design, so it differs from the dense path's): the loss within
  1e-4 of max(1, |loss|), and each leaf of the new parameters and of
  the optimizer's moments within 1e-4 of its own max |value|.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_arch as j_get_arch
from repro.dist import sharding as JS
from repro.models import lm_zoo as JZ
from repro.models import transformer_lm as JT
from repro_torch.configs import get_arch
from repro_torch.dist import sharding as TS
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import lm_zoo as TZ
from repro_torch.models import moe as TMoE
from repro_torch.models import transformer_lm as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.train import optimizer as TO

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 16


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close_to_scale(got, want, tol, what):
    """max |got - want| within ``tol`` of max(1, max |want|)."""
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _close_to_leaf(got, want, tol, what):
    """max |got - want| within ``tol`` of the leaf's own max |want| (an
    all-zero leaf must be matched exactly)."""
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _jax_ctx():
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return JS.sharding_ctx(mesh, JS.default_rules())


def _torch_ctx():
    return TS.sharding_ctx(make_local_mesh(2, 4, device="cpu"),
                           TS.default_rules())


@pytest.fixture
def blocked_float32(monkeypatch):
    """Both packages' loss in float32 and their CP attention on the
    blocked branch; records the port's CP branches and the moe paths it
    takes."""
    for Z, T, f32 in ((JZ, JT, jnp.float32), (TZ, TT, torch.float32)):
        monkeypatch.setattr(Z, "_cast_compute",
                            lambda params, dtype=None: params)
        monkeypatch.setattr(Z, "embed_input",
                            functools.partial(T.embed_input, dtype=f32))
        monkeypatch.setattr(T, "_CP_SCORE_BYTES_LIMIT", 1.0)
    taken = []
    for mod, name in ((TT, "_cp_attention_shard_map"),
                      (TMoE, "_moe_apply_ep"), (TMoE, "_moe_apply_dense")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            taken.append((_name, k.get("blocked")))
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return taken


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = j_get_arch(arch).reduced()
    jp = jax.tree.map(np.asarray, JZ.init_params(jcfg,
                                                 jax.random.PRNGKey(3)))
    return jcfg, get_arch(arch).reduced(), jp


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "valid": rng.random((B, S)) < 0.8}


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-scout-17b-a16e"])
def test_loss_and_gradients_under_mesh_match_jax(blocked_float32, arch):
    jcfg, tcfg, jp = _model(arch)
    batch = _batch(jcfg, len(arch))
    with _jax_ctx():
        (lj, mj), gj = jax.jit(jax.value_and_grad(
            JZ.make_loss_fn(jcfg), has_aux=True))(
            jax.tree.map(jnp.asarray, jp),
            {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_jax(jp, device="cpu")
    leaves = [p.requires_grad_() for p in TO.tree_leaves(tp)]
    with _torch_ctx():
        lt, mt = TZ.make_loss_fn(tcfg)(tp, {k: _t(v)
                                            for k, v in batch.items()})
    gt = torch.autograd.grad(lt, leaves, allow_unused=True,
                             materialize_grads=True)
    L = tcfg.n_layers
    assert blocked_float32 == [("_cp_attention_shard_map", True),
                               ("_moe_apply_ep", None)] * L
    _close_to_scale(lt, lj, LOSS_TOL, "loss")
    assert set(mt) == set(mj)
    for k in mj:
        if k == "tokens":
            assert int(mt[k]) == int(mj[k])
        else:
            _close_to_scale(mt[k], mj[k], LOSS_TOL, k)
    names = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(gj)]
    assert len(names) == len(gt)
    for name, a, b in zip(names, gt, jax.tree.leaves(gj)):
        assert tuple(a.shape) == b.shape, name
        _close_to_leaf(a, b, GRAD_TOL, name)


def test_train_step_under_mesh_matches_no_mesh(blocked_float32):
    _, tcfg, jp = _model("qwen3-moe-235b-a22b")
    moe = tcfg.moe
    cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k,
        router_aux_weight=0.0))
    batch = {k: _t(v) for k, v in _batch(cfg, 5).items()}
    step = TZ.make_train_step(cfg)
    params = params_from_jax(jp, device="cpu")
    state = {"params": params, "opt": TZ.make_optimizer(cfg).init(params)}
    with _torch_ctx():
        s_m, m_m = step(state, batch)
    L = cfg.n_layers
    assert blocked_float32 == [("_cp_attention_shard_map", True),
                               ("_moe_apply_ep", None)] * L
    s_n, m_n = step(state, batch)
    assert blocked_float32[2 * L:] == [("_moe_apply_dense", None)] * L
    assert float(m_m["moe_drop_frac"]) == float(m_n["moe_drop_frac"]) == 0
    _close_to_scale(m_m["loss"], m_n["loss"].numpy(), GRAD_TOL, "loss")
    assert s_m["opt"].step == s_n["opt"].step == 1
    for what, a, b in (("params", s_m["params"], s_n["params"]),
                       ("mu", s_m["opt"].mu, s_n["opt"].mu),
                       ("nu", s_m["opt"].nu, s_n["opt"].nu)):
        for x, y in zip(TO.tree_leaves(a), TO.tree_leaves(b)):
            _close_to_leaf(x, y.numpy(), GRAD_TOL, what)


def test_remat_recompute_keeps_the_mesh(blocked_float32):
    """On the card autograd runs a backward, and a block remat's
    recompute with it, on its device thread, where the caller's
    per-thread ``sharding_ctx`` is not open.  Here the loss is taken
    under the mesh with block remat and its gradient outside the
    context, so the recompute runs where none is open, as on the card:
    it takes the CP and EP paths again, and the gradients are the same
    bits as those taken inside the context."""
    _, tcfg, jp = _model("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(tcfg, remat="block")
    batch = {k: _t(v) for k, v in _batch(cfg, 6).items()}

    def grads(inside):
        tp = params_from_jax(jp, device="cpu")
        leaves = [p.requires_grad_() for p in TO.tree_leaves(tp)]
        with _torch_ctx():
            loss, _ = TZ.make_loss_fn(cfg)(tp, batch)
            if inside:
                return torch.autograd.grad(loss, leaves)
        return torch.autograd.grad(loss, leaves)

    first = grads(True)
    n = len(blocked_float32)
    again = grads(False)
    assert blocked_float32[n:] == blocked_float32[:n]
    assert blocked_float32[:n].count(("_moe_apply_ep", None)) == 2 * (
        cfg.n_layers)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
