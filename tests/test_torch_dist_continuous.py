"""The port's ``DistributedContinuousTrainer`` against the JAX package's
(CPU, P 4 x G 2, the JAX side on the 8 fake devices), and against the
port's single-host trainer.

* bucketed, TGN and TGAT (recent sampling), 2 rounds from the same
  parameters (the second round's replay mix makes a ragged tail batch):
  per round the loss, eval loss and AP within 1e-4 of JAX's, and the
  load CV, reduce bytes, collective steps, dispatch, request and
  response bytes and per-partition hit rates equal (the refresh bytes
  differ by design: the port's mirrors always carry the page
  descriptors, ROADMAP §3);
* against the port's single-host trainer: loss within 1e-4, AP within
  1e-3 (the reference's bands), also with ``grad_accum`` 2 and on a
  ragged stream (batch 60) whose every step takes the collective;
* the lossy collectives within 0.05 of the exact one, at a fraction of
  its payload; ``state="sharded"`` equal to ``"replicated"`` for TGN;
* an unknown state mode, an unknown collective, a negative
  ``memory_staleness`` and a transport spanning processes without an
  initialized ``torch.distributed`` process group are refused;
* ``memory_staleness`` > 0 ships memory rows in the state prefetch of
  train batches too (0: eval batches only).

The stream spans 1,500 time units, as in ``tests/test_torch_training.py``
(float noise over rounds on wide spans, ROADMAP §3).
"""
import jax
import numpy as np
import pytest

from repro.configs import tgn_gdelt as JC
from repro.dist.continuous import DistributedContinuousTrainer as JDist
from repro.data.events import synth_ctdg as j_synth
from repro_torch.configs import tgn_gdelt as TC
from repro_torch.core.continuous import ContinuousTrainer
from repro_torch.data.events import synth_ctdg as t_synth
from repro_torch.dist.collectives import grad_payload_bytes
from repro_torch.dist.continuous import DistributedContinuousTrainer
from repro_torch.dist.transport import LocalTransport
from repro_torch.models.convert import params_from_jax
from repro_torch.train.optimizer import tree_leaves

needs8 = pytest.mark.skipif(len(jax.devices()) < 8,
                            reason="needs 8 (fake) devices")

STREAM_KW = dict(n_nodes=160, n_events=1200, t_span=1_500, d_node=8,
                 d_edge=8, seed=9)
J_STREAM, T_STREAM = j_synth(**STREAM_KW), t_synth(**STREAM_KW)
WARM, ROUND, LR = 384, 192, 5e-4
SMALL = dict(d_node=8, d_edge=8, d_time=8, d_hidden=16, batch_size=64)
KW = {"tgn": dict(SMALL, d_memory=12, fanouts=(4,)),
      "tgat": dict(SMALL, fanouts=(4, 4), sampling="recent")}
TRAINER_KW = dict(threshold=16, cache_ratio=0.2, lr=LR, seed=0)


def _rounds(tr, stream, n=2, *, warm=WARM, size=ROUND, epochs=2):
    tr.ingest(stream.slice(0, warm))
    return [tr.train_round(stream.slice(warm + i * size,
                                        warm + (i + 1) * size),
                           epochs=epochs, replay_ratio=0.2 if i else 0.0)
            for i in range(n)]


def _port(name, dist=None, *, single=False, jparams=None, **kw):
    cfg = getattr(TC, name)(**dict(KW[name], **kw.pop("cfg", {})))
    if single:
        tr = ContinuousTrainer(cfg, T_STREAM, device="cpu", **TRAINER_KW)
    else:
        tr = DistributedContinuousTrainer(
            cfg, T_STREAM, dist or TC.DistConfig(4, 2, "bucketed"),
            device="cpu", **TRAINER_KW, **kw)
    if jparams is not None:
        tr.params = params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        tr.opt_state = tr.optimizer.init(tr.params)
    return tr


@pytest.fixture(scope="module")
def runs():
    """name -> (JAX dist rounds, port dist trainer and rounds, port
    single-host rounds), the port trainers from JAX's parameters."""
    out = {}
    for name in ("tgn", "tgat"):
        jt = JDist(getattr(JC, name)(**KW[name]), J_STREAM,
                   JC.DistConfig(4, 2, "bucketed"), **TRAINER_KW)
        tt = _port(name, jparams=jt.params)
        st = _port(name, single=True, jparams=jt.params)
        out[name] = (_rounds(jt, J_STREAM), tt, _rounds(tt, T_STREAM),
                     _rounds(st, T_STREAM))
    return out


@needs8
@pytest.mark.parametrize("name", ["tgn", "tgat"])
def test_matches_jax_over_two_rounds(runs, name):
    ref, tr, got, _ = runs[name]
    for i, (a, b) in enumerate(zip(ref, got, strict=True)):
        for key in ("loss", "eval_loss", "ap"):
            assert abs(getattr(a, key) - getattr(b, key)) <= 1e-4, (
                i, key, getattr(a, key), getattr(b, key))
        for key in ("load_cv", "reduce_bytes", "collective_steps",
                    "dispatch_bytes", "request_bytes", "response_bytes",
                    "node_hit_per_part", "edge_hit_per_part",
                    "node_hit_rate", "edge_hit_rate"):
            assert getattr(a, key) == getattr(b, key), (i, key)
        assert b.collective_steps == len(b.step_losses) > 0
        assert b.reduce_bytes == b.collective_steps * \
            tr.reduce_bytes_per_step
        assert 0 < b.route_syncs and 0 <= b.route_sync_s <= b.sample_s
    assert len(got[-1].node_hit_per_part) == 4
    if name == "tgn":
        active = np.unique(T_STREAM.src[:WARM + 2 * ROUND])
        assert np.abs(tr.state.get_memory(active)[0]).sum() > 0


@pytest.mark.parametrize("name", ["tgn", "tgat"])
def test_matches_the_single_host_trainer(runs, name):
    _, _, got, ref = runs[name]
    for a, b in zip(ref, got, strict=True):
        assert abs(a.loss - b.loss) <= 1e-4, (a.loss, b.loss)
        assert abs(a.ap - b.ap) <= 1e-3, (a.ap, b.ap)
        np.testing.assert_allclose(a.step_losses, b.step_losses,
                                   atol=1e-4, rtol=0)


def test_grad_accum_keeps_parity():
    single = _rounds(_port("tgat", single=True), T_STREAM)
    tr = _port("tgat", TC.DistConfig(4, 2, "bucketed", grad_accum=2))
    for a, b in zip(single, _rounds(tr, T_STREAM), strict=True):
        assert abs(a.loss - b.loss) <= 1e-4, (a.loss, b.loss)
        assert abs(a.ap - b.ap) <= 1e-3


def test_ragged_batches_all_take_the_collective_path():
    """batch_size 60 never splits evenly over W 8: every step pads its
    shards and still reproduces the single-host loss."""
    ref = _rounds(_port("tgat", single=True, cfg={"batch_size": 60}),
                  T_STREAM, epochs=1)
    tr = _port("tgat", cfg={"batch_size": 60})
    got = _rounds(tr, T_STREAM, epochs=1)
    for i, (a, b) in enumerate(zip(ref, got, strict=True)):
        assert abs(a.loss - b.loss) <= 1e-4, (a.loss, b.loss)
        assert abs(a.ap - b.ap) <= 1e-3, (a.ap, b.ap)
        n = ROUND + (ROUND // 5 if i else 0)      # + the replay mix
        assert b.collective_steps == -(-n // 60)
        assert b.reduce_bytes == b.collective_steps * \
            tr.reduce_bytes_per_step


@pytest.mark.parametrize("mode,kw", [("quantized", {"quant_bits": 8}),
                                     ("topk", {"topk_frac": 0.25})])
def test_lossy_collectives_track_within_band(mode, kw):
    bucketed = _rounds(_port("tgat"), T_STREAM)
    tr = _port("tgat", TC.DistConfig(4, 2, mode, **kw))
    exact = grad_payload_bytes(tr.params, "bucketed")
    for a, b in zip(bucketed, _rounds(tr, T_STREAM), strict=True):
        assert np.isfinite(b.loss) and abs(a.loss - b.loss) <= 0.05, (
            a.loss, b.loss)
        assert b.reduce_bytes == b.collective_steps * \
            tr.reduce_bytes_per_step > 0
    if mode == "quantized":
        assert tr.reduce_bytes_per_step * 3 < exact
    else:
        assert tr.reduce_bytes_per_step < exact
    assert len(tr.err) == 8 and all(            # one residual a worker
        np.isfinite(l.numpy()).all() for e in tr.err
        for l in tree_leaves(e))


def test_sharded_state_equals_replicated_for_tgn():
    rep, shd = (_port("tgn", state=s) for s in ("replicated", "sharded"))
    for a, b in zip(_rounds(rep, T_STREAM), _rounds(shd, T_STREAM),
                    strict=True):
        assert abs(a.loss - b.loss) <= 1e-6, (a.loss, b.loss)
        assert abs(a.eval_loss - b.eval_loss) <= 1e-6
        assert a.step_losses == b.step_losses
        assert b.state_calls > 0 and b.state_bytes > 0
        assert b.state_resident_bytes > 0
    assert shd.state.stats()["mode"] == "sharded"
    assert shd.state.resident_bytes() == rep.state.resident_bytes()


def test_refuses_an_unknown_state_mode_or_collective():
    with pytest.raises(ValueError, match="unknown state mode"):
        _port("tgat", state="magic")
    with pytest.raises(ValueError, match="unknown collective"):
        _port("tgat", TC.DistConfig(2, 1, "ring"))


class _TwoProcesses(LocalTransport):
    process_id, n_processes = 0, 2


def test_refuses_a_fleet_transport_without_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        _port("tgat", transport=_TwoProcesses())


def test_refuses_a_negative_memory_staleness():
    with pytest.raises(ValueError, match="memory_staleness"):
        _port("tgn", state="sharded", memory_staleness=-1)


@pytest.mark.parametrize("staleness", [0, 1])
def test_memory_staleness_ships_train_memory_rows(staleness):
    """Which batches' state prefetch carries memory rows: eval batches
    always, train batches only when stale reads may serve them."""
    tr = _port("tgn", TC.DistConfig(2, 1, "bucketed"), state="sharded",
               memory_staleness=staleness)
    assert tr.memory_staleness == staleness
    phase, shipped = {"now": None}, {"train": 0, "eval": 0}
    prefetch = tr.state.prefetch_async

    def spy(node_ids=None, eids=None, mem_ids=None):
        if mem_ids is not None and len(mem_ids):
            shipped[phase["now"]] += 1
        return prefetch(node_ids=node_ids, eids=eids, mem_ids=mem_ids)

    def staged(name, stage):
        def run(item):
            phase["now"] = name
            return stage(item)
        return run

    tr.state.prefetch_async = spy
    tr._stage_train = staged("train", tr._stage_train)
    tr._stage_eval = staged("eval", tr._stage_eval)
    _rounds(tr, T_STREAM, n=1, epochs=1)
    assert shipped["eval"] > 0
    assert (shipped["train"] > 0) == (staleness > 0), shipped
