"""Feature-cache parity of the PyTorch port against the JAX package.

One id trace — with repeats, NULL padding, invalidations and a round
snapshot/restore — replays through both packages' ``FeatureCache`` for
every policy; ``slot_of``, ``ids``, ``score``, ``feats`` and ``clock``
must be identical after every step (exact: ties in the eviction top-k
are broken by slot index in both), and the port's ``cache_lookup``
must equal the JAX ``cache_gather_ref``.  The port's ``cache_gather``
equals the JAX oracle and the Pallas kernel (interpret mode) exactly on
ids that are negative, out of range, repeated or behind stale
``slot_of`` entries, and when every id misses or every id hits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.feature_cache import FeatureCache as JCache
from repro.kernels.cache_gather.ops import cache_gather_pallas
from repro.kernels.cache_gather.ref import cache_gather_ref as j_gather_ref
from repro_torch.core.feature_cache import FeatureCache, cache_lookup
from repro_torch.kernels.cache_gather.ops import cache_gather

FIELDS = ("slot_of", "ids", "score", "feats", "clock")


def _feat(ids, dim):
    ids = np.asarray(ids, np.float32)[:, None]
    return np.sin(ids * (1.0 + np.arange(dim, dtype=np.float32)))


def _assert_same_state(jc, tc, step):
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(tc.state, f).numpy(), np.asarray(getattr(jc.state, f)),
            err_msg=f"{f} after step {step}")


@pytest.mark.parametrize("policy", ["lru", "lfu", "fifo"])
def test_trace_replay_matches_jax_state(policy):
    rng = np.random.default_rng({"lru": 0, "lfu": 1, "fifo": 2}[policy])
    dim, cap, space = 6, 16, 64
    jc = JCache(cap, dim, space, policy=policy, lam=0.25)
    tc = FeatureCache(cap, dim, space, policy=policy, lam=0.25,
                      device="cpu")
    hot = rng.integers(0, 12, 200)
    for step in range(24):
        n = int(rng.integers(1, 21))      # ragged: NULL bucket padding
        ids = np.where(rng.random(n) < 0.6, rng.choice(hot, n),
                       rng.integers(0, space, n)).astype(np.int32)
        if step % 5 == 3:
            ids[rng.random(n) < 0.2] = -1                 # NULL lanes
        cacheable = (rng.random(n) < 0.8) if step % 4 == 1 else None
        out_j = jc.fetch(ids, lambda m: _feat(m, dim), cacheable=cacheable)
        out_t = tc.fetch(ids, lambda m: _feat(m, dim), cacheable=cacheable)
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
        np.testing.assert_array_equal(tc.last_hit, jc.last_hit)
        _assert_same_state(jc, tc, step)
        # the port's lookup equals the JAX kernel oracle on this state
        probe = rng.integers(-2, space + 2, 40).astype(np.int32)
        probe = np.clip(probe, -1, space - 1)
        fj, hj = j_gather_ref(*(jnp.asarray(np.asarray(getattr(jc.state, f)))
                                for f in ("slot_of", "ids", "feats")),
                              jnp.asarray(probe))
        ft, ht = cache_lookup(tc.state, torch.from_numpy(probe))
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
        np.testing.assert_array_equal(tc.probe(probe), jc.probe(probe))
        if step % 6 == 2:
            drop = rng.integers(0, 16, 5)
            assert tc.invalidate(drop) == jc.invalidate(drop)
            _assert_same_state(jc, tc, step)
        if step == 8:
            jc.snapshot_round()
            tc.snapshot_round()
        if step in (14, 20):
            jc.restore_epoch()
            tc.restore_epoch()
            _assert_same_state(jc, tc, step)
    assert (tc.hits, tc.accesses, tc.bypassed) == \
        (jc.hits, jc.accesses, jc.bypassed)
    assert tc.contents() == jc.contents()


def _gather_case(dim, kind, seed):
    """A cache of C slots over an id space of M, and N requested ids."""
    rng = np.random.default_rng(seed)
    M, C, N = 500, 48, 96
    slot_ids = np.full(C, -1, np.int32)
    cached = rng.choice(M, C - 6, replace=False).astype(np.int32)
    slot_ids[:C - 6] = cached                       # 6 empty slots
    slot_of = np.full(M, -1, np.int32)
    slot_of[cached] = np.arange(C - 6, dtype=np.int32)
    stale = rng.choice(np.setdiff1d(np.arange(M), cached), 20,
                       replace=False)
    slot_of[stale] = rng.integers(0, C, 20)          # point at other ids
    absent = np.setdiff1d(np.arange(M), cached)
    if kind == "all_hit":
        ids = rng.choice(cached, N)                  # with repeats
    elif kind == "all_miss":                         # stale ids among them
        ids = np.concatenate([rng.choice(absent, N - 6),
                              [-1, -5, M, M + 3, -2, -3]])
    else:
        ids = np.concatenate([rng.choice(cached, N // 2),
                              rng.choice(stale, 16),
                              rng.integers(-3, M + 3, N // 2 - 16)])
        ids[:6] = ids[6]                             # duplicates
        ids[-4:] = [-1, M, M + 7, -2]                # negative, >= M
    ids = rng.permutation(ids).astype(np.int32)
    feats = rng.normal(size=(C, dim)).astype(np.float32)
    return slot_of, slot_ids, feats, ids


@pytest.mark.parametrize("kind", ["mixed", "all_miss", "all_hit"])
@pytest.mark.parametrize("dim", [7, 128, 172])
def test_cache_gather_matches_jax_ref_and_pallas(dim, kind):
    arrays = _gather_case(dim, kind, seed=dim)
    out, hit = cache_gather(*(torch.from_numpy(a) for a in arrays))
    j_arrays = [jnp.asarray(a) for a in arrays]
    for name, (f, h) in (("ref", j_gather_ref(*j_arrays)),
                         ("pallas", cache_gather_pallas(*j_arrays))):
        np.testing.assert_array_equal(hit.numpy(), np.asarray(h),
                                      err_msg=name)
        np.testing.assert_array_equal(out.numpy(), np.asarray(f),
                                      err_msg=name)
    n_hit = int(hit.sum())
    if kind == "mixed":
        assert 0 < n_hit < len(hit)
    else:
        assert n_hit == (len(hit) if kind == "all_hit" else 0)
    assert not out.numpy()[~hit.numpy()].any()


def test_save_and_load_host_round_trip():
    c = FeatureCache(8, 3, 32, policy="lfu", lam=1.0, device="cpu")
    c.fetch(np.array([1, 2, 3, 2], np.int32), lambda m: _feat(m, 3))
    blob = c.save_host()
    c.fetch(np.array([4, 5, 6, 7], np.int32), lambda m: _feat(m, 3))
    assert blob["ids"].tolist().count(4) == 0      # a copy, not a view
    back = FeatureCache.load_host(blob, policy="lfu", lam=1.0,
                                  device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back.state, f).numpy(),
                                      blob[f])
    assert back.contents() == {1, 2, 3}
