"""LM training of the PyTorch port against the JAX package, on the CPU,
from numpy seeds:

* ``chunked_softmax_xent``: loss, count and the gradients with respect
  to h and w_out within 1e-5, with and without a valid mask, for a B
  that ``n_chunks`` divides and two it does not;
* the schedules, equal to float32 rounding at a dozen steps; ``sgd``
  (nesterov on and off) and ``adafactor_lite`` (rank 1, 2 and 3 leaves)
  within 1e-6 over 3 updates;
* the train step of the reduced dense, vlm, audio and ssm archs in
  float32 (both packages' ``_cast_compute`` and the embedding's bf16
  output set aside): the loss and every gradient leaf of one step
  within 1e-5, the loss per step within 1e-4 over 4 steps of
  ``make_train_step``; with block remat too; the moe archs (with their
  ``router_aux_weight * moe_lb_loss`` term and aux metrics) and the
  hybrid (with its superlayer remat too): loss and gradients of one
  step within 1e-5 of max(1, the largest value), since JAX's init of
  the reduced experts (E^-1/2 = 0.5) gives values of 100 and more;
* ``train_state_specs`` on ``meta`` against ``jax.eval_shape``, leaf by
  leaf;
* ``CheckpointManager``: roundtrip, keep-k, no partial dir after a crash
  mid-write, the writer joined on close, bf16, and a checkpoint written
  by the JAX manager restored by the port's;
* ``LMTrainer``: save -> restore -> continue equals an uninterrupted run
  exactly; the elastic policy's decisions equal JAX's; the launcher's
  ``lm`` mode on the CPU, for a dense arch and, in a subprocess, a moe
  one.
"""
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import layers as JL
from repro.models import lm_zoo as JZ
from repro.models import transformer_lm as JT
from repro.train import checkpoint as JC
from repro.train import elastic as JE
from repro.train import optimizer as JO
from repro_torch.configs import get_arch
from repro_torch.models import layers as TL
from repro_torch.models import lm_zoo as TZ
from repro_torch.models import transformer_lm as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.train import checkpoint as TC
from repro_torch.train import elastic as TE
from repro_torch.train import optimizer as TO
from repro_torch.train.trainer import LMTrainer, TrainerConfig

TOL = 1e-5
FAMILY_ARCHS = {"dense": "yi-6b", "vlm": "chameleon-34b",
                "audio": "hubert-xlarge", "ssm": "falcon-mamba-7b"}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol)


def _close_to_scale(got, want, tol=TOL, what=""):
    """max |got - want| within ``tol`` of max(1, max |want|)."""
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


# ---------------------------------------------------------------------------
# chunked_softmax_xent
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [4, 3, 5])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_softmax_xent_matches_jax(B, masked):
    rng = np.random.default_rng(B + 10 * masked)
    S, d, V = 7, 16, 50
    h = rng.normal(size=(B, S, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) / 4).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    valid = rng.random((B, S)) < 0.6 if masked else None

    def j_loss(h_, w_):
        v = None if valid is None else jnp.asarray(valid)
        return JL.chunked_softmax_xent(h_, w_, jnp.asarray(labels), v)

    (lj, cj), = [j_loss(jnp.asarray(h), jnp.asarray(w))]
    gj = jax.grad(lambda a, b: j_loss(a, b)[0], argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    ht, wt = _t(h).requires_grad_(), _t(w).requires_grad_()
    lt, ct = TL.chunked_softmax_xent(
        ht, wt, _t(labels), None if valid is None else _t(valid))
    gt = torch.autograd.grad(lt, (ht, wt))
    assert ct.dtype == torch.int32 and int(ct) == int(cj)
    _close(lt, lj)
    for a, b in zip(gt, gj):
        _close(a, b)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,make", [
    ("warmup_cosine", lambda m: m.warmup_cosine_schedule(3e-4, 4, 10)),
    ("warmup_cosine_frac", lambda m: m.warmup_cosine_schedule(1.0, 3, 9,
                                                              0.25)),
    ("linear_warmup", lambda m: m.linear_warmup_schedule(2e-3, 5))])
def test_schedules_match_jax(name, make):
    js, ts = make(JO), make(TO)
    for step in range(12):
        want = np.float32(js(step))
        got = ts(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(np.float32(got), want, rtol=2e-7,
                                   atol=0, err_msg=f"{name} step {step}")


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5,)).astype(np.float32),
            "b": {"w": rng.normal(size=(4, 6)).astype(np.float32)},
            "c": [rng.normal(size=(3, 4, 5)).astype(np.float32)]}


def _run_optimizer(mk, n=3):
    """n updates of the same optimizer in both packages on the same
    parameters and gradients; returns (port params, JAX params, port
    state, JAX state)."""
    p0 = _opt_tree(0)
    jo, to = mk(JO), mk(TO)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = params_from_jax(p0, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    for i in range(n):
        g = _opt_tree(i + 1)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(params_from_jax(g, device="cpu"), ts, tp)
    return tp, jp, ts, js


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_matches_jax(nesterov):
    tp, jp, ts, js = _run_optimizer(
        lambda m: m.sgd(m.warmup_cosine_schedule(0.1, 2, 10),
                        nesterov=nesterov, weight_decay=0.01))
    assert ts.step == int(js.step) == 3
    for a, b in zip(TO.tree_leaves(tp), jax.tree.leaves(jp)):
        _close(a, b, 1e-6)
    for a, b in zip(TO.tree_leaves(ts.momentum),
                    jax.tree.leaves(js.momentum)):
        _close(a, b, 1e-6)


def test_adafactor_lite_matches_jax():
    """Rank 1 (a full second moment), rank 2 and rank 3 (row and column
    factors over the last two axes) leaves."""
    tp, jp, ts, js = _run_optimizer(
        lambda m: m.adafactor_lite(0.05, weight_decay=0.01))
    assert ts.step == int(js.step) == 3 and ts.nu is None
    for a, b in zip(TO.tree_leaves(tp), jax.tree.leaves(jp)):
        _close(a, b, 1e-6)
    j_state = jax.tree.leaves(js.mu)
    t_state = [x for _, x in TC.flatten_with_names(ts.mu)]
    assert [tuple(x.shape) for x in t_state] == [x.shape for x in j_state]
    for a, b in zip(t_state, j_state):
        _close(a, b, 1e-6)


def test_optimizers_map():
    assert set(TO.OPTIMIZERS) == set(JO.OPTIMIZERS)
    assert TZ.make_optimizer(get_arch("nemotron-4-340b")).init(
        {"w": torch.zeros(2, 3)}).nu is None       # adafactor
    assert isinstance(TZ.make_optimizer(get_arch("yi-6b")).init(
        {"w": torch.zeros(2)}), TO.AdamWState)


# ---------------------------------------------------------------------------
# the train step, float32
# ---------------------------------------------------------------------------


@pytest.fixture
def float32_compute(monkeypatch):
    """Both packages' loss in float32: the compute cast and the
    embedding's bf16 output set aside."""
    for Z, T, f32 in ((JZ, JT, jnp.float32), (TZ, TT, torch.float32)):
        monkeypatch.setattr(Z, "_cast_compute",
                            lambda params, dtype=None: params)
        monkeypatch.setattr(Z, "embed_input",
                            functools.partial(T.embed_input, dtype=f32))


# archs reduced with their full-size head dim (the reduced config's is
# 16): Nemotron-4's 192, whose attention backward on the card is the
# Hopper instance's 64-key dk/dv walk
HEAD_DIM_OF = {"nemotron-4-340b": 192}


@functools.lru_cache(maxsize=None)
def _model(arch, remat):
    kw = dict(remat=remat)
    if arch in HEAD_DIM_OF:
        kw["head_dim"] = HEAD_DIM_OF[arch]
    jcfg = dataclasses.replace(j_get_arch(arch).reduced(), **kw)
    tcfg = dataclasses.replace(get_arch(arch).reduced(), **kw)
    jp = jax.tree.map(np.asarray, JZ.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    return jcfg, tcfg, jp


def _batches(cfg, n, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if cfg.input_kind == "tokens":
            b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(
                np.int32)}
            b["valid"] = rng.random((B, S)) < 0.8
        else:
            b = {"frames": rng.normal(size=(B, S, cfg.d_model)).astype(
                     np.float32),
                 "labels": rng.integers(0, cfg.vocab, (B, S)).astype(
                     np.int32),
                 "mask": rng.random((B, S)) < 0.4}
        out.append(b)
    return out


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: _t(v) for k, v in b.items()}


@pytest.mark.parametrize("family,remat", [
    ("dense", "none"), ("vlm", "none"), ("audio", "none"), ("ssm", "none"),
    ("dense", "block"), ("ssm", "block")])
def test_loss_and_gradients_match_jax(float32_compute, family, remat):
    arch = FAMILY_ARCHS[family]
    jcfg, tcfg, jp = _model(arch, remat)
    batch = _batches(jcfg, 1, seed=len(arch))[0]
    (lj, mj), gj = jax.value_and_grad(JZ.make_loss_fn(jcfg), has_aux=True)(
        jax.tree.map(jnp.asarray, jp), _jb(batch))
    tp = params_from_jax(jp, device="cpu")
    leaves = [p.requires_grad_() for p in TO.tree_leaves(tp)]
    lt, mt = TZ.make_loss_fn(tcfg)(tp, _tb(batch))
    gt = torch.autograd.grad(lt, leaves, allow_unused=True,
                             materialize_grads=True)
    _close(lt, lj)
    assert set(mt) == {"ce_loss", "tokens", "loss"}
    assert int(mt["tokens"]) == int(mj["tokens"])
    names = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(gj)]
    for name, a, b in zip(names, gt, jax.tree.leaves(gj)):
        assert tuple(a.shape) == b.shape, name
        _close(a, b)


@pytest.mark.parametrize("arch,remat", [
    ("qwen3-moe-235b-a22b", "none"), ("llama4-scout-17b-a16e", "none"),
    ("zamba2-2.7b", "none"), ("zamba2-2.7b", "block"),
    ("nemotron-4-340b", "block")])
def test_moe_and_hybrid_loss_and_gradients_match_jax(float32_compute, arch,
                                                     remat):
    jcfg, tcfg, jp = _model(arch, remat)
    batch = _batches(jcfg, 1, seed=len(arch))[0]
    (lj, mj), gj = jax.jit(jax.value_and_grad(JZ.make_loss_fn(jcfg),
                                              has_aux=True))(
        jax.tree.map(jnp.asarray, jp), _jb(batch))
    tp = params_from_jax(jp, device="cpu")
    leaves = [p.requires_grad_() for p in TO.tree_leaves(tp)]
    lt, mt = TZ.make_loss_fn(tcfg)(tp, _tb(batch))
    gt = torch.autograd.grad(lt, leaves, allow_unused=True,
                             materialize_grads=True)
    assert set(mt) == set(mj)
    for k in mj:
        if k == "moe_drop_frac":
            assert float(mt[k]) == float(mj[k])
        else:
            _close_to_scale(mt[k], mj[k], what=k)
    if jcfg.moe is not None:     # the router term is in the loss
        assert float(mj["loss"]) != float(mj["ce_loss"])
    names = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(gj)]
    assert len(names) == len(gt)
    for name, a, b in zip(names, gt, jax.tree.leaves(gj)):
        assert tuple(a.shape) == b.shape, name
        _close_to_scale(a, b, what=name)


@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_train_steps_match_jax(float32_compute, family):
    arch = FAMILY_ARCHS[family]
    jcfg, tcfg, jp = _model(arch, "none")
    js = {"params": jax.tree.map(jnp.asarray, jp),
          "opt": JZ.make_optimizer(jcfg).init(jax.tree.map(jnp.asarray,
                                                          jp))}
    ts = {"params": params_from_jax(jp, device="cpu")}
    ts["opt"] = TZ.make_optimizer(tcfg).init(ts["params"])
    j_step = jax.jit(JZ.make_train_step(jcfg))
    t_step = TZ.make_train_step(tcfg)
    for i, batch in enumerate(_batches(jcfg, 4, seed=7)):
        js, mj = j_step(js, _jb(batch))
        ts, mt = t_step(ts, _tb(batch))
        _close(mt["loss"], mj["loss"], 1e-4)
        assert ts["opt"].step == int(js["opt"].step) == i + 1


@pytest.mark.parametrize("arch", ["nemotron-4-340b"])
def test_one_adafactor_step_matches_jax(float32_compute, arch):
    """One step of ``make_train_step`` with the config's own Adafactor
    (Nemotron-4 reduced at its head dim of 192, block remat): the loss
    and every updated parameter leaf within 1e-5 of JAX's."""
    jcfg, tcfg, jp = _model(arch, "block")
    assert tcfg.optimizer == jcfg.optimizer == "adafactor"
    assert tcfg.head_dim_ == 192
    batch = _batches(jcfg, 1, seed=29)[0]
    jparams = jax.tree.map(jnp.asarray, jp)
    js = {"params": jparams, "opt": JZ.make_optimizer(jcfg).init(jparams)}
    ts = {"params": params_from_jax(jp, device="cpu")}
    ts["opt"] = TZ.make_optimizer(tcfg).init(ts["params"])
    js, mj = jax.jit(JZ.make_train_step(jcfg))(js, _jb(batch))
    ts, mt = TZ.make_train_step(tcfg)(ts, _tb(batch))
    _close(mt["loss"], mj["loss"])
    assert ts["opt"].step == int(js["opt"].step) == 1
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(js["params"])]
    got = TO.tree_leaves(ts["params"])
    assert len(got) == len(names)
    moved = 0
    for name, a, b, b0 in zip(names, got, jax.tree.leaves(js["params"]),
                              jax.tree.leaves(jp)):
        assert tuple(a.shape) == b.shape, name
        _close(a, b)
        moved += not np.array_equal(np.asarray(b), np.asarray(b0))
    assert moved > len(names) // 2        # the update reached the weights


@pytest.mark.parametrize("arch", ["yi-6b", "nemotron-4-340b"])
def test_train_step_leaves_no_tensor_in_a_reference_cycle(arch):
    """With the cyclic garbage collector off, a train step's input leaves
    (and with them the float32 masters' storage) are freed when the step
    returns: nothing of the step is kept in a reference cycle.  On the
    card one was (``tree_unflatten``'s recursive closure held an
    iterator over the leaves), and three full-width Nemotron-4 steps ran
    out of memory on the train states it kept."""
    import gc
    import weakref

    cfg = dataclasses.replace(get_arch(arch).reduced(), remat="block",
                              n_layers=1)
    opt = TZ.make_optimizer(cfg)
    state = TZ.init_train_state(cfg, torch.Generator().manual_seed(0), opt,
                                device="cpu")
    step = TZ.make_train_step(cfg, opt)
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)))}
    state, _ = step(state, batch)          # first-call imports
    gc.collect()
    gc.disable()
    try:
        for _ in range(2):
            refs = [weakref.ref(t) for t in TO.tree_leaves(state["params"])]
            state, _ = step(state, batch)
            assert not [r for r in refs if r() is not None]
    finally:
        gc.enable()


def test_remat_checkpoints_only_under_grad():
    """Block remat wraps the block in torch.utils.checkpoint when
    autograd records the call, and calls it directly otherwise."""
    cfg = dataclasses.replace(get_arch("yi-6b").reduced(), remat="block")
    block = lambda *a: a
    assert TT._remat(cfg, block) is not block
    with torch.no_grad():
        assert TT._remat(cfg, block) is block
    assert TT._remat(dataclasses.replace(cfg, remat="none"), block) is block


@pytest.mark.parametrize("arch", list(FAMILY_ARCHS.values()))
def test_train_state_specs_match_eval_shape(arch):
    """Full-size specs on ``meta`` (no memory) against JAX's eval_shape:
    the same leaves, shapes and dtypes; the step count is a host int."""
    want = JZ.train_state_specs(j_get_arch(arch))
    got = TZ.train_state_specs(get_arch(arch))
    t_leaves = TC.flatten_with_names(got)
    j_leaves = jax.tree.leaves(want)
    assert len(t_leaves) == len(j_leaves)
    for (name, a), b in zip(t_leaves, j_leaves):
        if name == "opt/.step":
            assert isinstance(a, int) and b.dtype == jnp.int32
            continue
        assert a.device.type == "meta", name
        assert tuple(a.shape) == b.shape, name
        assert str(a.dtype).split(".")[-1] == str(b.dtype), name


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(4, 3, generator=g),
              "b": torch.randn(3, generator=g).to(torch.bfloat16),
              "layers": [torch.randn(2, generator=g)]}
    return {"params": params, "opt": TO.adamw(0.1).init(params)}


def _assert_same(a, b):
    la, lb = TC.flatten_with_names(a), TC.flatten_with_names(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        if isinstance(x, int):
            assert x == y, n
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), n


def test_checkpoint_roundtrip_keep_k_and_bf16(tmp_path):
    mgr = TC.CheckpointManager(tmp_path, keep=2)
    states = {}
    for step in (1, 2, 3):
        st = _state(step)
        st["opt"] = st["opt"]._replace(step=step)
        mgr.save(step, st, extra={"cursor": 10 * step})
        states[step] = st
    mgr.close()
    assert mgr.all_steps() == [2, 3]
    manifest = (tmp_path / "step-0000000003" / "MANIFEST.json").read_text()
    assert '"bfloat16"' in manifest and '"opt/.step"' in manifest
    step, got, extra = mgr.restore(_state(9))
    assert step == 3 and extra == {"cursor": 30}
    _assert_same(got, states[3])
    step, got, _ = mgr.restore(_state(9), step=2)
    _assert_same(got, states[2])
    assert got["params"]["b"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"w": torch.zeros(1)})


def test_checkpoint_crash_mid_write_leaves_no_partial_dir(tmp_path,
                                                          monkeypatch):
    mgr = TC.CheckpointManager(tmp_path, keep=3, async_save=False)
    mgr.save(1, _state(1))

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(TC.np, "savez", boom)
    with pytest.raises(OSError):
        mgr.save(2, _state(2))
    assert mgr.all_steps() == [1]
    assert not (tmp_path / "step-0000000002").exists()
    _assert_same(mgr.restore(_state(0))[1], _state(1))


def test_checkpoint_writer_is_joined_on_close(tmp_path, monkeypatch):
    """The writer is a non-daemon thread, still writing after save()
    returns (host copies already taken), and joined by close()."""
    gate = threading.Event()
    real = TC.CheckpointManager._write
    monkeypatch.setattr(TC.CheckpointManager, "_write",
                        lambda self, *a: (gate.wait(5), real(self, *a)))
    mgr = TC.CheckpointManager(tmp_path)
    st = _state(4)
    saved = st["params"]["w"].clone()
    mgr.save(4, st)
    thread = mgr._thread
    assert thread.is_alive() and not thread.daemon
    st["params"]["w"].add_(1.0)     # the host copy was taken at save()
    gate.set()
    mgr.close()
    assert not thread.is_alive()
    assert mgr.all_steps() == [4]
    got = mgr.restore(_state(0))[1]
    assert torch.equal(got["params"]["w"], saved)
    mgr.close()                     # idempotent


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    cfg = j_get_arch("yi-6b").reduced()
    jstate = JZ.init_train_state(cfg, jax.random.PRNGKey(3))
    jstate["params"]["final_norm"] = jstate["params"]["final_norm"].astype(
        jnp.bfloat16)
    jm = JC.CheckpointManager(tmp_path)
    jm.save(5, jstate, extra={"cursor": 5})
    jm.close()
    template = TZ.train_state_specs(get_arch("yi-6b").reduced())
    template["params"]["final_norm"] = torch.empty(
        template["params"]["final_norm"].shape, dtype=torch.bfloat16,
        device="meta")
    step, got, extra = TC.CheckpointManager(tmp_path).restore(template)
    assert step == 5 and extra == {"cursor": 5}
    t_leaves = TC.flatten_with_names(got)
    j_leaves = JC._flatten_with_names(jstate)
    assert [n for n, _ in t_leaves] == [n for n, _ in j_leaves]
    for (name, a), (_, b) in zip(t_leaves, j_leaves):
        if isinstance(a, int):
            assert a == int(b), name
            continue
        assert a.device.type == "cpu" and a.dtype == (
            torch.bfloat16 if b.dtype == jnp.bfloat16 else a.dtype), name
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32), name)


# ---------------------------------------------------------------------------
# LMTrainer, elastic policy, launcher
# ---------------------------------------------------------------------------


def test_trainer_resume_continues_exactly(tmp_path):
    """2 steps, a save, a new trainer restores and runs to 4: every leaf
    of the state equals an uninterrupted 4-step run's, exactly."""
    cfg = get_arch("yi-6b").reduced()
    rng = np.random.default_rng(0)
    batches = [{"tokens": _t(rng.integers(0, cfg.vocab, (2, 16)).astype(
        np.int32))} for _ in range(4)]

    def trainer(name, steps):
        return LMTrainer(cfg, TrainerConfig(
            ckpt_dir=str(tmp_path / name), ckpt_every=100, log_every=2,
            max_steps=steps), seed=0, device="cpu")

    whole = trainer("whole", 4)
    whole.init_or_restore()
    m = whole.train(iter(batches))
    assert whole.step == 4 and set(m) >= {"loss", "steps_per_s"}
    first = trainer("split", 2)
    first.init_or_restore()
    first.train(iter(batches))
    again = trainer("split", 4)
    again.init_or_restore()
    assert (again.step, again.cursor) == (2, 2)
    again.train(iter(batches[again.cursor:]))
    assert again.step == 4
    _assert_same(again.state, whole.state)


def test_elastic_policy_matches_jax():
    hosts = range(6)
    jc = JE.ElasticCoordinator(hosts, devices_per_host=8,
                               heartbeat_timeout=10.0, model_parallel=4)
    tc = TE.ElasticCoordinator(hosts, devices_per_host=8,
                               heartbeat_timeout=10.0, model_parallel=4)
    events = [("beat", 0, 5.0), ("beat", 1, 5.0), ("sweep", None, 12.0),
              ("join", 9, 13.0), ("beat", 2, 14.0), ("sweep", None, 25.0),
              ("reform", None, None)]
    for what, host, now in events:
        for co in (jc, tc):
            out = {"beat": lambda: co.heartbeat(host, now),
                   "sweep": lambda: co.sweep(now),
                   "join": lambda: co.join(host, now),
                   "reform": co.reform}[what]()
            co._last = out
        assert dataclasses.asdict(jc._last) == dataclasses.asdict(
            tc._last) if what == "reform" else jc._last == tc._last
        assert jc.healthy_hosts() == tc.healthy_hosts()
        assert dataclasses.asdict(jc.plan()) == dataclasses.asdict(tc.plan())
    js, ts = JE.StragglerPolicy(), TE.StragglerPolicy()
    times = np.random.default_rng(1).uniform(0.9, 1.1, 40)
    times[[10, 11, 12, 30, 31]] = 5.0
    for i, t in enumerate(times):
        assert js.observe(i % 2, float(t)) == ts.observe(i % 2, float(t))


def test_launcher_lm_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as L

    L.main(["lm", "--arch", "yi-6b", "--steps", "2", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "starting at step 0" in out and "step 2" in out
    assert TC.CheckpointManager(tmp_path / "yi-6b").all_steps() == [2]


def test_launcher_lm_moe_in_a_subprocess(tmp_path, subprocess_env):
    """``python -m repro_torch.launch.train lm`` for a moe arch: two
    steps whose metrics carry the router's terms."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "lm", "--arch",
         "qwen3-moe-235b-a22b", "--steps", "2", "--batch", "2", "--seq",
         "16", "--device", "cpu", "--ckpt", str(tmp_path)],
        env=subprocess_env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "family=moe" in out.stdout and "step 2:" in out.stdout
    assert "moe_lb_loss=" in out.stdout and "moe_drop_frac=" in out.stdout
