"""Training parity of the PyTorch port against the JAX package (CPU).

* ``temporal_attn``'s backward (plain autograd on the CPU) against
  ``jax.grad`` through the JAX ``temporal_attn_ref`` (1e-5);
* ``make_forward``'s loss and every parameter gradient for all five
  models, TGN's in-graph memory GRU included, against
  ``jax.value_and_grad`` (1e-5);
* one functional AdamW step, clip active and inactive (1e-6);
* the helpers: ``bce_logits``, ``average_precision``,
  ``EventLog.eids_for``, ``pad_tail``, ``pow2_pad_len``;
* ``PipelineEngine`` schedules, drain and error surfacing, and
  pipelined == serial training, step for step;
* three ``train_round``s against the JAX ``ContinuousTrainer``
  (``use_pallas=False``) from the same parameters: TGN and TGAT with
  ``recent`` sampling within 1e-4 per round with identical cache hit
  rates; TGAT with ``uniform`` sampling (other RNG streams) within an AP
  band;
* ``QueryEngine.attach`` against ``offline_forward``, and a pinned
  handle's parameters across a round.

The streams span 1,500 time units.  The time encoding's fastest channel
(w = 1) turns a one-ulp difference of w into a phase difference of
dt·ulp, and Adam's normalised first steps turn float noise in
near-zero gradients into lr-sized moves, so on a stream with dt in the
tens of thousands float noise alone (XLA against PyTorch, summation
order) grows past 1e-4 within three rounds, on both sides alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tgn_gdelt as JC
from repro.core import continuous as JCont
from repro.core import pipeline as JP
from repro.data.events import synth_ctdg as j_synth
from repro.kernels.temporal_attn.ref import temporal_attn_ref as j_attn_ref
from repro.models import gnn as JG
from repro.train import optimizer as JO
from repro_torch.configs import tgn_gdelt as TC
from repro_torch.core import continuous as TCont
from repro_torch.core import pipeline as TP
from repro_torch.data.events import synth_ctdg as t_synth
from repro_torch.kernels.temporal_attn.ops import temporal_attn
from repro_torch.models import gnn as TG
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import QueryEngine
from repro_torch.train import optimizer as TO

TOL = 1e-5
STREAM_KW = dict(n_nodes=160, n_events=1200, t_span=1_500, d_node=8,
                 d_edge=8, seed=9)
J_STREAM, T_STREAM = j_synth(**STREAM_KW), t_synth(**STREAM_KW)
WARM, ROUND = 384, 192
SMALL = dict(d_node=8, d_edge=8, d_time=8, d_hidden=16)
TGN_KW = dict(SMALL, d_memory=12, fanouts=(4,), batch_size=64)
TGAT_KW = dict(SMALL, fanouts=(4, 4), batch_size=64)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0, err_msg=what)


def _leaf_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [jax.tree_util.keystr(p) for p, _ in flat]


# ---------------------------------------------------------------------------
# temporal_attn backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,h,dh", [(7, 10, 2, 50), (16, 3, 4, 8),
                                      (5, 1, 1, 33)])
def test_temporal_attn_backward_matches_jax_grad(n, k, h, dh):
    rng = np.random.default_rng(n * k + dh)
    q = rng.normal(size=(n, h, dh)).astype(np.float32)
    kk = rng.normal(size=(n, k, h, dh)).astype(np.float32)
    v = rng.normal(size=(n, k, h, dh)).astype(np.float32)
    g = rng.normal(size=(n, h, dh)).astype(np.float32)
    mask = rng.random((n, k)) < 0.6
    mask[0] = False                       # a target with no neighbour
    mask[1, 0] = True

    def j_loss(q_, k_, v_):
        return jnp.sum(j_attn_ref(q_, k_, v_, jnp.asarray(mask))
                       * jnp.asarray(g))

    want = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, kk, v))
    out = temporal_attn(tq, tk, tv, torch.from_numpy(mask))
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                              (tq, tk, tv))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, TOL, name)
        assert (a[0] == 0).all(), name    # no valid neighbour: zeros


# ---------------------------------------------------------------------------
# forward loss and gradients, all five models
# ---------------------------------------------------------------------------


def _hops(cfg, n0, rng):
    hops, n = [], n0
    for k in cfg.fanouts:
        mask = rng.random((n, k)) < 0.7
        mask[::4] = False
        hops.append({
            "dst_feat": rng.normal(size=(n, cfg.d_node)).astype(np.float32),
            "nbr_feat": rng.normal(size=(n, k, cfg.d_node)
                                   ).astype(np.float32),
            "edge_feat": rng.normal(size=(n, k, cfg.d_edge)
                                    ).astype(np.float32),
            "dt": np.where(mask, rng.uniform(0, 500, (n, k)), 0.0
                           ).astype(np.float32),
            "mask": mask})
        n *= k
    return hops


def _blob(cfg, n, rng):
    return {"mem": rng.normal(size=(n, cfg.d_memory)).astype(np.float32),
            "last_upd": rng.uniform(0, 100, n).astype(np.float32),
            "other_mem": rng.normal(size=(n, cfg.d_memory)
                                    ).astype(np.float32),
            "e_feat": rng.normal(size=(n, cfg.d_edge)).astype(np.float32),
            "msg_t": rng.uniform(50, 200, n).astype(np.float32),
            "has": rng.random(n) < 0.6}


def _batch(cfg, rng, n0=9):
    batch = {"seed_mask": np.array([1, 1, 0], np.float32)}
    if cfg.model == "dysat":
        batch["snapshots"] = [_hops(cfg, n0, rng)
                              for _ in range(cfg.n_snapshots)]
        return batch
    batch["hops"] = _hops(cfg, n0, rng)
    if cfg.use_memory:
        batch["mem_blobs"] = [
            (_blob(cfg, hop["mask"].shape[0], rng),
             _blob(cfg, hop["mask"].size, rng)) for hop in batch["hops"]]
    return batch


@pytest.mark.parametrize("name", ["tgn", "tgat", "dysat", "graphsage",
                                  "gat"])
def test_forward_loss_and_gradients_match_jax(name):
    kw = dict(d_node=12, d_edge=10, d_time=8, d_hidden=16, d_memory=6)
    cfg = getattr(JC, name)(**kw)
    tcfg = getattr(TC, name)(**kw)
    jparams = JG.init_params(cfg, jax.random.PRNGKey(5))
    tparams = params_from_jax(_np_tree(jparams), device="cpu")
    batch = _batch(cfg, np.random.default_rng(2))
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        JCont.make_forward(cfg), has_aux=True))(
            jparams, jax.tree.map(jnp.asarray, batch))
    t_batch = TO.tree_map(torch.from_numpy, batch)
    (t_loss, (scores, _, w)), t_grads = TCont.value_and_grad(
        TCont.make_forward(tcfg))(tparams, t_batch)
    assert scores.shape == (6,) and w.tolist() == [1, 1, 0, 1, 1, 0]
    _close(t_loss, j_loss, TOL, "loss")
    jl, tl = jax.tree.leaves(j_grads), TO.tree_leaves(t_grads)
    assert len(jl) == len(tl)
    for path, a, b in zip(_leaf_paths(j_grads), tl, jl):
        assert tuple(a.shape) == b.shape, path
        _close(a, b, TOL, path)
    # the parameters themselves never joined a graph
    assert not any(p.requires_grad for p in TO.tree_leaves(tparams))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale,clipped", [(50.0, True), (1e-3, False)])
def test_adamw_step_matches_jax(scale, clipped):
    cfg = JC.tgn(**TGN_KW)
    jparams = JG.init_params(cfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    grads = jax.tree.map(
        lambda p: (scale * rng.normal(size=p.shape)).astype(np.float32),
        _np_tree(jparams))
    norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                             for g in jax.tree.leaves(grads))))
    assert (norm > 1.0) == clipped
    j_opt = JO.adamw(1e-2, weight_decay=0.1)
    j_update = jax.jit(j_opt.update)
    t_opt = TO.adamw(1e-2, weight_decay=0.1)
    tparams = params_from_jax(_np_tree(jparams), device="cpu")
    before = [p.clone() for p in TO.tree_leaves(tparams)]
    j_state, t_state = j_opt.init(jparams), t_opt.init(tparams)
    for _ in range(2):                    # bias corrections of t = 1, 2
        jparams, j_state = j_update(jax.tree.map(jnp.asarray, grads),
                                    j_state, jparams)
        tparams_new, t_state = t_opt.update(
            params_from_jax(grads, device="cpu"), t_state, tparams)
        # functional: the old tree is untouched
        for a, b in zip(TO.tree_leaves(tparams), before):
            assert torch.equal(a, b)
        tparams = tparams_new
        before = [p.clone() for p in TO.tree_leaves(tparams)]
    assert t_state.step == int(j_state.step) == 2
    for jt, tt in ((jparams, tparams), (j_state.mu, t_state.mu),
                   (j_state.nu, t_state.nu)):
        for path, a, b in zip(_leaf_paths(jt), TO.tree_leaves(tt),
                              jax.tree.leaves(jt)):
            _close(a, b, 1e-6, path)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [rng.normal(size=5).astype(np.float32)]}
    j_clipped, j_norm = JO.clip_by_global_norm(
        jax.tree.map(jnp.asarray, tree), 0.5)
    t_clipped, t_norm = TO.clip_by_global_norm(
        TO.tree_map(torch.from_numpy, tree), 0.5)
    _close(t_norm, j_norm, 1e-6)
    for a, b in zip(TO.tree_leaves(t_clipped), jax.tree.leaves(j_clipped)):
        _close(a, b, 1e-6)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def test_bce_logits_and_average_precision_match_jax():
    rng = np.random.default_rng(6)
    s = rng.normal(size=40).astype(np.float32) * 4
    y = (rng.random(40) < 0.5).astype(np.float32)
    w = (rng.random(40) < 0.8).astype(np.float32)
    for weights in (None, w):
        want = JG.bce_logits(jnp.asarray(s), jnp.asarray(y),
                             None if weights is None else jnp.asarray(w))
        got = TG.bce_logits(torch.from_numpy(s), torch.from_numpy(y),
                            None if weights is None else torch.from_numpy(w))
        _close(got, want, 1e-6)
    s[5] = s[6]                           # a tie keeps the stable order
    assert TG.average_precision(s, y) == JG.average_precision(s, y)
    assert TG.average_precision(s, np.zeros(40)) == 0.0


def test_event_log_eids_for_tie_runs_matches_jax():
    rng = np.random.default_rng(7)
    jl, tl = JCont.EventLog(), TCont.EventLog()
    base = 0
    for _ in range(5):                    # grows past the first arrays
        ts = np.sort(rng.integers(0, 60, 300)).astype(np.float64)
        eids = base + np.arange(300)
        jl.append(ts, eids)
        tl.append(ts, eids)
        base += 300
    queries = [np.array([3.0, 3.0, 3.0, 4.0]), np.sort(jl.ts[:jl.size]),
               np.array([-1.0, 1e9]), np.array([7.0])]
    for q in queries:
        np.testing.assert_array_equal(tl.eids_for(q), jl.eids_for(q))
    assert np.array_equal(TCont.EventLog().eids_for(np.ones(3)),
                          np.zeros(3, np.int64))


@pytest.mark.parametrize("n,full", [(0, 64), (1, 64), (5, 64), (8, 64),
                                    (33, 64), (64, 64), (70, 64),
                                    (100, 80), (3, 6)])
def test_pad_helpers_match_jax(n, full):
    assert TP.pow2_pad_len(n, full) == JP.pow2_pad_len(n, full)
    m = TP.pow2_pad_len(n, full)
    arrs = (np.arange(n, dtype=np.int64), np.linspace(0, 1, n))
    for a, b in zip(TP.pad_tail(arrs, n, m), JP.pad_tail(arrs, n, m)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype and len(a) == m


# ---------------------------------------------------------------------------
# PipelineEngine
# ---------------------------------------------------------------------------


def _traced_run(overlap):
    calls = []
    out = TP.PipelineEngine(overlap=overlap).run(
        [1, 2, 3],
        prefetch=lambda it: (calls.append(("prefetch", it)), it)[1],
        launch=lambda it, st: (calls.append(("launch", it)), it)[1],
        complete=lambda h, it: (calls.append(("complete", it)), h)[1])
    return calls, out


@pytest.mark.parametrize("overlap,order", [
    (True, ["p1", "l1", "p2", "c1", "l2", "p3", "c2", "l3", "c3"]),
    (False, ["p1", "l1", "c1", "p2", "l2", "c2", "p3", "l3", "c3"])])
def test_engine_schedule_order(overlap, order):
    calls, out = _traced_run(overlap)
    assert out == [1, 2, 3]
    assert [f"{name[0]}{it}" for name, it in calls] == order


def test_engine_drains_on_empty_and_single():
    eng = TP.PipelineEngine(overlap=True)
    assert eng.run([], prefetch=lambda i: i, launch=lambda i, s: i,
                   complete=lambda h, i: h) == []
    assert eng.run([7], prefetch=lambda i: i, launch=lambda i, s: i,
                   complete=lambda h, i: h) == [7]


class _Boom(RuntimeError):
    pass


def _failing_run(overlap, fail_stage, fail_item):
    calls = []

    def stage(name, it):
        calls.append((name, it))
        if name == fail_stage and it == fail_item:
            raise _Boom(f"{name}({it})")
        return it

    with pytest.raises(_Boom):
        TP.PipelineEngine(overlap=overlap).run(
            [1, 2, 3], prefetch=lambda it: stage("prefetch", it),
            launch=lambda it, st: stage("launch", it),
            complete=lambda h, it: stage("complete", it))
    return calls


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("fail_stage", ["prefetch", "launch"])
def test_engine_surfaces_stage_error_and_drains_inflight(overlap,
                                                         fail_stage):
    calls = _failing_run(overlap, fail_stage, 2)
    ok_launched = [i for (n, i) in calls if n == "launch"
                   and not (fail_stage == "launch" and i == 2)]
    completed = [i for (n, i) in calls if n == "complete"]
    assert completed == ok_launched == [1]
    assert ("prefetch", 3) not in calls and ("launch", 3) not in calls


@pytest.mark.parametrize("overlap", [True, False])
def test_engine_complete_error_not_doubled(overlap):
    calls = _failing_run(overlap, "complete", 1)
    assert [i for (n, i) in calls if n == "complete"] == [1]


class _StubMemory:
    """Stands in for TGNMemory: gather() returns the CURRENT version, so
    the test sees when the blobs were assembled."""

    def __init__(self):
        self.version = 0

    def gather(self, ids, edge_feat_fn):
        return {"v": np.full(len(ids), self.version)}


def _one_layer(seeds, ts):
    from repro_torch.core.sampling import SampledLayer
    n = len(seeds)
    return [SampledLayer(
        dst_nodes=torch.as_tensor(seeds, dtype=torch.int32),
        dst_times=torch.as_tensor(ts), dst_mask=torch.ones(n, dtype=torch.bool),
        nbr_ids=torch.zeros((n, 2), dtype=torch.int32),
        nbr_eids=torch.zeros((n, 2), dtype=torch.int32),
        nbr_ts=torch.zeros((n, 2)), mask=torch.ones((n, 2), dtype=torch.bool))]


def test_assembler_memory_blobs_are_late_bound():
    """TGN memory blobs reflect the memory at finalize() time (after the
    previous step's commit), not at prefetch() time."""
    cfg = TC.tgat(d_node=4, d_edge=4, d_time=4, d_hidden=8, fanouts=(2,))
    mem = _StubMemory()
    zeros = lambda ids: np.zeros((len(ids), 4), np.float32)
    asm = TP.FeatureAssembler(cfg, fetch_node=zeros, fetch_edge=zeros,
                              memory=mem, device="cpu")
    assert asm.needs_finalize
    staged = asm.prefetch(np.arange(6), np.zeros(6, np.float32), _one_layer)
    assert "mem_blobs" not in staged["batch"]
    assert staged["batch"]["hops"][0]["nbr_feat"].shape == (6, 2, 4)
    mem.version = 42                      # the "previous step's commit"
    dstb, nbrb = asm.finalize(staged)["mem_blobs"][0]
    assert (dstb["v"] == 42).all() and len(nbrb["v"]) == 12


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------


def _t_trainer(tcfg, *, overlap=True, jparams=None):
    tr = TCont.ContinuousTrainer(tcfg, T_STREAM, threshold=16,
                                 cache_ratio=0.2, lr=5e-4, seed=0,
                                 overlap=overlap, device="cpu")
    if jparams is not None:
        tr.params = params_from_jax(_np_tree(jparams), device="cpu")
        tr.opt_state = tr.optimizer.init(tr.params)
    return tr


def _rounds(tr, stream, n_rounds=3):
    tr.ingest(stream.slice(0, WARM))
    out = []
    for i in range(n_rounds):
        sl = stream.slice(WARM + i * ROUND, WARM + (i + 1) * ROUND)
        out.append(tr.train_round(sl, epochs=2,
                                  replay_ratio=0.2 if i else 0.0))
    return out


@pytest.mark.parametrize("name,kw", [("tgn", TGN_KW),
                                     ("tgat", dict(TGAT_KW,
                                                   sampling="recent"))])
def test_pipelined_matches_serial(name, kw):
    tcfg = getattr(TC, name)(**kw)
    serial, piped = _t_trainer(tcfg, overlap=False), _t_trainer(tcfg)
    for a, b in zip(_rounds(serial, T_STREAM, 2), _rounds(piped, T_STREAM,
                                                          2)):
        assert a.step_losses == b.step_losses and a.ap == b.ap
        assert (a.node_hit_rate, a.edge_hit_rate) == (b.node_hit_rate,
                                                      b.edge_hit_rate)
    for a, b in zip(TO.tree_leaves(serial.params),
                    TO.tree_leaves(piped.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,kw", [("tgn", TGN_KW),
                                     ("tgat", dict(TGAT_KW,
                                                   sampling="recent"))])
def test_trainer_matches_jax_over_three_rounds(name, kw):
    cfg, tcfg = getattr(JC, name)(**kw), getattr(TC, name)(**kw)
    jt = JCont.ContinuousTrainer(cfg, J_STREAM, threshold=16,
                                 cache_ratio=0.2, lr=5e-4, seed=0,
                                 use_pallas=False)
    tt = _t_trainer(tcfg, jparams=jt.params)
    for i, (a, b) in enumerate(zip(_rounds(jt, J_STREAM),
                                   _rounds(tt, T_STREAM))):
        for key in ("loss", "eval_loss", "ap"):
            assert abs(getattr(a, key) - getattr(b, key)) <= 1e-4, (
                i, key, getattr(a, key), getattr(b, key))
        assert (a.node_hit_rate, a.edge_hit_rate) == (
            b.node_hit_rate, b.edge_hit_rate), i
        assert np.isfinite(b.step_losses).all() and len(b.step_losses) \
            == 2 * -(-(ROUND + (ROUND // 5 if i else 0)) // 64)


def test_uniform_tgat_within_band_of_jax():
    """Uniform sampling draws from jax.random in the JAX package and from
    a torch.Generator in the port, so the neighbourhoods differ: the
    rounds must stay finite and each AP within 0.1 of the JAX one."""
    cfg, tcfg = JC.tgat(**TGAT_KW), TC.tgat(**TGAT_KW)
    jt = JCont.ContinuousTrainer(cfg, J_STREAM, threshold=16,
                                 cache_ratio=0.2, lr=5e-4, seed=0,
                                 use_pallas=False)
    tt = _t_trainer(tcfg, jparams=jt.params)
    for a, b in zip(_rounds(jt, J_STREAM), _rounds(tt, T_STREAM)):
        assert np.isfinite([b.loss, b.eval_loss]).all()
        assert abs(a.ap - b.ap) <= 0.1, (a.ap, b.ap)


# ---------------------------------------------------------------------------
# serving attached to the trainer
# ---------------------------------------------------------------------------


def test_attached_engine_matches_offline_and_pins_params():
    tcfg = TC.tgat(**dict(TGAT_KW, sampling="recent"))
    tr = _t_trainer(tcfg)
    tr.ingest(T_STREAM.slice(0, WARM))
    eng = QueryEngine.attach(tr, device="cpu", max_batch=8)
    try:
        s = T_STREAM
        t_q = float(s.ts[WARM - 1]) + 1.0
        idx = np.arange(0, WARM, 37)
        res = eng.query_link(s.src[idx], s.dst[idx], np.full(len(idx), t_q))
        want = eng.offline_forward(res.version, s.src[idx], s.dst[idx],
                                   np.full(len(idx), t_q))
        assert res.scores.shape == (len(idx),)
        _close(res.scores, want, 1e-4)
        pinned = eng.publisher.current()
        before = [p.clone() for p in TO.tree_leaves(pinned.params)]
        tr.train_round(s.slice(WARM, WARM + ROUND), epochs=1)
        assert eng.publisher.current().params is tr.params
        assert not all(torch.equal(a, b) for a, b in zip(
            TO.tree_leaves(tr.params), before))
        for a, b in zip(TO.tree_leaves(pinned.params), before):
            assert torch.equal(a, b)      # bit-identical after the round
        res2 = eng.query_link(s.src[idx], s.dst[idx],
                              np.full(len(idx), t_q + 1500))
        assert res2.version > res.version
        _close(res2.scores, eng.offline_forward(
            res2.version, s.src[idx], s.dst[idx],
            np.full(len(idx), t_q + 1500)), 1e-4)
    finally:
        eng.stop()
    with pytest.raises(ValueError, match="trainer's device"):
        QueryEngine.attach(tr, device="meta", start=False)
