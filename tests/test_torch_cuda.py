"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA card and ``nvcc`` and skips
without them; run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Ids and masks must match exactly, floats within 1e-5 (one float32 op;
1.6e-2 of each row's scale for bfloat16 attention),
served scores within 1e-4 of the same engine on the CPU.  The LM
backward kernels' gradients: within 1e-5 of max(1, max |grad|) in
float32; in bfloat16, each query row of dq and each key of dk and dv
within 0.02 of that row's max |grad| beyond each element's rounding
budget (``flash_attention_grad_budget``), set from the readings that
``python tests/test_torch_cuda.py`` prints on the card;
``python tests/test_torch_cuda.py logits`` prints the readings behind
``chip_smoke.py``'s bf16 logits bar for zamba2's depth cut.
"""
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.dgraph import DynamicGraph
from repro_torch.core.rand import gumbel_noise
from repro_torch.core.snapshot import build_snapshot
from repro_torch.kernels import runtime
from repro_torch.kernels.cache_gather.ops import cache_gather
from repro_torch.kernels.cache_gather.ref import cache_gather_ref
from repro_torch.kernels.temporal_attn.ops import temporal_attn
from repro_torch.kernels.temporal_attn.ref import temporal_attn_ref
from repro_torch.kernels.temporal_sample.ops import temporal_sample
from repro_torch.kernels.temporal_sample.ref import (
    temporal_sample_ref, temporal_sample_uniform_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _snapshot(tau, n_nodes=60, n_events=3000, seed=0):
    rng = np.random.default_rng(seed)
    g = DynamicGraph(threshold=tau, min_block=2, undirected=True)
    g.add_edges(rng.zipf(1.5, n_events) % n_nodes,
                rng.integers(0, n_nodes, n_events),
                np.sort(rng.uniform(0, 1000.0, n_events)))
    return build_snapshot(g), n_nodes


def _uniform_noise(card, kind, shape, seed):
    if kind == "tied":                      # integer scores 0-3: heavy ties
        g = torch.Generator(device=card).manual_seed(seed)
        return torch.randint(0, 4, shape, generator=g, device=card,
                             dtype=torch.int32).float()
    return gumbel_noise(torch.Generator(device=card).manual_seed(seed),
                        shape, card)


def _sample_and_check(card, snap, targets, t_end, t_start, tmask, *, k,
                      policy, scan, noise_kind="gumbel"):
    """One kernel launch against the plain version: exact, in order."""
    pages = [torch.from_numpy(np.ascontiguousarray(a)).to(card) for a in
             (snap.page_table, snap.page_tmin, snap.page_tmax, snap.nbr,
              snap.eid, snap.ts, snap.valid)]
    q = [torch.from_numpy(np.asarray(a)).to(card) for a in
         (targets, t_end, t_start, tmask)]
    plain_pt = pages[0][:, :scan].contiguous()
    noise = None
    if policy == "uniform":
        noise = _uniform_noise(card, noise_kind,
                               (len(targets), scan, snap.ts.shape[1]), k)
    runtime.reset_launch_counts()
    got = temporal_sample(*pages, *q, k=k, policy=policy, noise=noise,
                          scan=scan)
    assert runtime.launch_counts() == {f"temporal_sample_{policy}": 1}
    if policy == "uniform":
        want = temporal_sample_uniform_ref(plain_pt, *pages[1:], *q, noise,
                                           k=k)
    else:
        want = temporal_sample_ref(plain_pt, *pages[1:], *q, k=k)
    torch.cuda.synchronize()
    for name, g, w in zip(("nbr", "eid", "ts", "mask"), got, want):
        assert torch.equal(g, w), name
    return got


@pytest.mark.parametrize("tau,k,policy,n,scan,noise", [
    (8, 5, "recent", 300, 16, "gumbel"),
    (64, 10, "recent", 300, 16, "gumbel"),
    (128, 32, "recent", 300, 16, "gumbel"),
    (8, 5, "uniform", 300, 16, "gumbel"),
    (64, 10, "uniform", 300, 16, "gumbel"),
    (128, 32, "uniform", 300, 16, "gumbel"),
    (64, 10, "uniform", 300, 16, "tied"),
    (8, 32, "uniform", 300, 16, "tied"),
    (64, 1, "uniform", 300, 1, "gumbel"),     # fewer pages than warps
    (64, 10, "uniform", 300, 2, "tied"),
    (64, 10, "uniform", 300, 3, "gumbel"),
    (8, 10, "uniform", 300, 32, "gumbel"),    # the most pages a group
    (8, 32, "uniform", 300, 32, "tied"),
    (8, 10, "uniform", 300, 40, "tied"),      # two page groups
    (64, 10, "uniform", 1, 16, "gumbel"),
    (64, 10, "uniform", 1280, 16, "gumbel"),   # past one wave of CTAs
    (64, 10, "uniform", 1800, 16, "tied"),
    (64, 10, "uniform", 2400, 16, "gumbel"),   # past two waves
    (8, 32, "uniform", 3000, 32, "tied"),
    (64, 10, "uniform", 18000, 16, "gumbel"),
    (8, 1, "uniform", 18000, 32, "tied"),
    # K > 32: the shared-memory reservoir, at each W the launch picks
    (64, 33, "uniform", 128, 16, "gumbel"),
    (64, 33, "uniform", 1280, 16, "tied"),
    (64, 33, "uniform", 18000, 16, "gumbel"),
    (64, 50, "uniform", 128, 16, "tied"),
    (64, 50, "uniform", 1280, 16, "gumbel"),
    (64, 50, "uniform", 18000, 16, "tied"),
    (128, 64, "uniform", 128, 16, "gumbel"),
    (8, 64, "uniform", 1280, 32, "tied"),
    (64, 64, "uniform", 18000, 16, "gumbel"),
    (8, 50, "recent", 300, 32, "gumbel"),
    (64, 10, "recent", 12000, 16, "gumbel")])
def test_temporal_sample_kernel_matches_plain(card, tau, k, policy, n, scan,
                                              noise):
    snap, n_nodes = _snapshot(tau, seed=tau + k)
    scan = min(scan, snap.page_table.shape[1])    # tau 8: 150+ pages wide
    rng = np.random.default_rng(k + n)
    targets = rng.integers(-3, n_nodes + 3, n).astype(np.int32)
    t_end = rng.uniform(50, 1100, n).astype(np.float32)
    t_start = np.where(rng.random(n) < 0.5, -np.inf,
                       t_end - 200).astype(np.float32)
    empty = rng.random(n) < 0.1                      # some empty windows
    t_start[empty] = t_end[empty]
    tmask = rng.random(n) < 0.9
    targets[0], t_start[0], tmask[0] = 1, -np.inf, True   # a live target
    got = _sample_and_check(card, snap, targets, t_end, t_start, tmask,
                            k=k, policy=policy, scan=scan, noise_kind=noise)
    assert int(got[3].sum()) > 0


@pytest.mark.parametrize("k,noise", [(10, "gumbel"), (32, "tied"),
                                     (1, "gumbel"), (50, "gumbel"),
                                     (64, "tied")])
def test_temporal_sample_uniform_kernel_hub(card, k, noise):
    """A hub whose window holds 2,000 candidates over 32 full pages, next
    to targets with an empty window, a masked one and one out of range."""
    g = DynamicGraph(threshold=64, min_block=64, undirected=False)
    n_ev = 2000
    g.add_edges(np.zeros(n_ev, np.int64), 1 + np.arange(n_ev) % 50,
                np.arange(n_ev, dtype=float))
    snap = build_snapshot(g)
    scan = snap.page_table.shape[1]
    assert scan >= 32 and snap.ts.shape[1] == 64
    targets = np.array([0, 0, 0, 0, 7, 0, 999], np.int32)
    t_end = np.array([3000, 1500, 10, 3000, 3000, 3000, 3000], np.float32)
    t_start = np.array([-np.inf, -np.inf, 10, 0, -np.inf, -np.inf, 0],
                       np.float32)
    tmask = np.array([1, 1, 1, 1, 1, 0, 1], bool)
    got = _sample_and_check(card, snap, targets, t_end, t_start, tmask,
                            k=k, policy="uniform", scan=scan,
                            noise_kind=noise)
    counts = got[3].sum(1).tolist()
    assert counts == [k, k, 0, k, 0, 0, 0]


@pytest.mark.parametrize("tau,scan", [(8, 32), (64, 16)])
def test_temporal_sample_recent_skips_pages_at_12000_targets(card, tau,
                                                             scan):
    """The TGN train step's hop (12,000 targets) on a graph whose targets'
    windows end before their newest pages: those pages' [t_min, t_max]
    miss the window and are skipped, and the picks come from older
    pages, newest first, exactly as the plain version walks them."""
    snap, n_nodes = _snapshot(tau, seed=tau)
    scan = min(scan, snap.page_table.shape[1])
    rng = np.random.default_rng(tau)
    n = 12000
    targets = rng.integers(0, n_nodes, n).astype(np.int32)
    t_end = rng.uniform(100, 900, n).astype(np.float32)
    t_start = np.where(rng.random(n) < 0.7, -np.inf,
                       t_end - 150).astype(np.float32)
    tmask = rng.random(n) < 0.95
    newest = snap.page_table[targets, 0]
    skipped = (newest >= 0) & (snap.page_tmin[np.maximum(newest, 0)]
                               >= t_end)
    assert skipped.sum() > n // 4
    got = _sample_and_check(card, snap, targets, t_end, t_start, tmask,
                            k=10, policy="recent", scan=scan)
    mask = got[3].cpu().numpy()
    assert mask[skipped & tmask].sum(1).max() == 10


def _cache(card, dim, n, kind, seed):
    """(slot_of, ids, feats, requested ids) on the card, and the number
    of hits among the requests, counted here from the tables."""
    rng = np.random.default_rng(seed)
    M, C = 5000, 300
    slot_of = np.full(M, -1, np.int32)
    ids = rng.choice(M, C, replace=False).astype(np.int32)
    ids[::7] = -1                                   # empty slots
    live = ids >= 0
    slot_of[ids[live]] = np.nonzero(live)[0]
    if kind == "stale_any":     # may also overwrite a cached id's entry
        stale = rng.integers(0, M, 50)
    else:                       # only uncached ids' entries
        stale = rng.choice(np.setdiff1d(np.arange(M), ids[live]), 50)
    slot_of[stale] = rng.integers(0, C, 50)         # point at other ids
    if kind == "all_hit":
        req = rng.choice(ids[live], n)
    elif kind == "all_miss":
        absent = np.setdiff1d(np.arange(-2, M + 3), ids[live])
        req = rng.choice(absent, n)
    else:
        req = rng.integers(-2, M, n)
        req[: n // 2] = rng.choice(ids[live], n // 2)
    feats = rng.normal(size=(C, dim)).astype(np.float32)
    slot = slot_of[np.clip(req, 0, M - 1)]
    n_hit = int(((req >= 0) & (slot >= 0)
                 & (ids[np.clip(slot, 0, C - 1)] == req)).sum())
    args = [torch.from_numpy(a).to(card) for a in (slot_of, ids, feats,
                                                    req.astype(np.int32))]
    return args, n_hit


@pytest.mark.parametrize("dim,n,kind", [
    (172, 4096, "mixed"), (128, 4096, "mixed"), (7, 4096, "mixed"),
    (256, 4096, "mixed"),
    (172, 1, "mixed"), (172, 33, "mixed"), (172, 16384, "mixed"),
    (172, 32768, "mixed"), (128, 33, "mixed"), (7, 32768, "mixed"),
    (256, 16384, "mixed"),
    (172, 16384, "all_miss"), (7, 33, "all_miss"),
    (172, 16384, "all_hit"), (128, 32768, "all_hit"), (7, 33, "all_hit"),
    (172, 4096, "unaligned"), (128, 33, "unaligned"),
    (256, 16384, "unaligned"),
    (172, 4096, "stale_any"), (128, 4096, "stale_any"),
    (7, 4096, "stale_any")])
def test_cache_gather_kernel_matches_plain(card, dim, n, kind):
    # stale_any at n 4,096 draws the inputs of the test's first version
    args, n_want = _cache(card, dim, n,
                          "mixed" if kind == "unaligned" else kind,
                          seed=dim if kind == "stale_any" else dim + n)
    if kind == "unaligned":              # a contiguous view off 16 bytes
        buf = torch.empty(args[2].numel() + 1, device=card)
        buf[1:] = args[2].reshape(-1)
        args[2] = buf[1:].view(args[2].shape)
        assert args[2].data_ptr() % 16 != 0 and args[2].is_contiguous()
    runtime.reset_launch_counts()
    out, hit = cache_gather(*args)
    assert runtime.launch_counts() == {"cache_gather": 1}
    w_out, w_hit = cache_gather_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(hit, w_hit) and torch.equal(out, w_out)
    n_hit = int(hit.sum())
    assert n_hit == n_want
    if kind == "all_hit":
        assert n_hit == n
    elif kind == "all_miss":
        assert n_hit == 0
    else:
        assert n_hit > 0


@pytest.mark.parametrize("n,k,h,dh", [
    (1280, 10, 2, 50), (37, 32, 4, 128), (5, 1, 1, 7),
    (12000, 10, 2, 50), (18000, 10, 2, 50),     # the training hops
    # any K and Dh: past K 32 or Dh 128 the forward's and the backward's
    # shared-memory instances
    (600, 33, 2, 50), (600, 64, 2, 50), (300, 10, 2, 150),
    (300, 10, 2, 256), (257, 33, 2, 150), (200, 64, 2, 256),
    (64, 64, 1, 256), (50, 40, 3, 33), (7, 100, 1, 129),
    (40, 10, 2, 300), (30, 5, 3, 260), (100, 80, 2, 50), (60, 70, 1, 20)])
def test_temporal_attn_kernel_matches_plain(card, n, k, h, dh):
    g = torch.Generator(device=card).manual_seed(n + k + dh)
    q = torch.randn((n, h, dh), generator=g, device=card)
    kk = torch.randn((n, k, h, dh), generator=g, device=card)
    v = torch.randn((n, k, h, dh), generator=g, device=card)
    mask = torch.rand((n, k), generator=g, device=card) < 0.6
    mask[0] = False
    got = temporal_attn(q, kk, v, mask)
    want = temporal_attn_ref(q, kk, v, mask)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5
    assert (got[0] == 0).all()
    # the backward kernel against the plain version's autograd
    dout = torch.randn((n, h, dh), generator=g, device=card)
    ins = [t.clone().requires_grad_() for t in (q, kk, v)]
    runtime.reset_launch_counts()
    got = torch.autograd.grad(temporal_attn(*ins, mask), ins, dout)
    assert runtime.launch_counts() == {"temporal_attn": 1,
                                       "temporal_attn_bwd": 1}
    want = torch.autograd.grad(temporal_attn_ref(*ins, mask), ins, dout)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5
        assert (a[0] == 0).all()
    with pytest.raises(TypeError):
        temporal_attn(q.double(), kk, v, mask)


@pytest.mark.parametrize("k,dh", [(64, 50), (64, 256), (10, 50)])
def test_temporal_attn_forward_all_masked_rows(card, k, dh):
    """Targets with no valid neighbour, in every chunk of K = 64, next to
    rows whose only valid neighbour is the last one: zero rows, and the
    rest within 1e-5 of the plain version."""
    n, h = 500, 2
    g = torch.Generator(device=card).manual_seed(k + dh)
    q = torch.randn((n, h, dh), generator=g, device=card)
    kk = torch.randn((n, k, h, dh), generator=g, device=card)
    v = torch.randn((n, k, h, dh), generator=g, device=card)
    mask = torch.rand((n, k), generator=g, device=card) < 0.5
    mask[1::7] = False
    mask[1::7, -1] = True
    mask[::3] = False
    with torch.no_grad():
        got = temporal_attn(q, kk, v, mask)
    want = temporal_attn_ref(q, kk, v, mask)
    torch.cuda.synchronize()
    assert (got[::3] == 0).all()
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("n,k,dh", [(300, 10, 50), (64, 40, 64),
                                    (2000, 10, 50)])
def test_temporal_attn_forward_unaligned_views(card, n, k, dh):
    """q, k and v one float into larger buffers: not 16-byte aligned, so
    the forward copies them by its lanes instead of by TMA bulk copies;
    the result is the plain version's within 1e-5, empty rows zero."""
    h = 2
    g = torch.Generator(device=card).manual_seed(n + k)

    def view(shape):
        buf = torch.randn(int(np.prod(shape)) + 1, generator=g, device=card)
        return buf[1:].view(shape)

    q, kk, v = view((n, h, dh)), view((n, k, h, dh)), view((n, k, h, dh))
    assert q.data_ptr() % 16 and kk.data_ptr() % 16 and v.data_ptr() % 16
    mask = torch.rand((n, k), generator=g, device=card) < 0.6
    mask[::4] = False
    runtime.reset_launch_counts()
    with torch.no_grad():
        got = temporal_attn(q, kk, v, mask)
    assert runtime.launch_counts() == {"temporal_attn": 1}
    want = temporal_attn_ref(q, kk, v, mask)
    torch.cuda.synchronize()
    assert (got[::4] == 0).all()
    assert float((got - want).abs().max()) <= 1e-5


def test_engine_on_the_card_matches_the_cpu_engine(card):
    from repro_torch.configs.tgn_gdelt import tgat
    from repro_torch.core.feature_store import ReplicatedStateService
    from repro_torch.data.events import synth_ctdg
    from repro_torch.models.gnn import init_params
    from repro_torch.serve import HandlePublisher, QueryEngine

    cfg = tgat(d_node=16, d_edge=12, d_time=8, d_hidden=20,
               sampling="recent")
    stream = synth_ctdg(n_nodes=200, n_events=4000, d_node=16, d_edge=12,
                        seed=1)
    state = ReplicatedStateService(1, d_node=16, d_edge=12)
    g = DynamicGraph(threshold=16, undirected=True)
    eids = g.add_edges(stream.src, stream.dst, stream.ts)
    nodes = np.unique(np.concatenate([stream.src, stream.dst]))
    state.put_node_feats(nodes, stream.node_features(nodes))
    state.register_edges(np.unique(eids), np.zeros_like(np.unique(eids)))
    state.put_edge_feats(np.unique(eids), stream.edge_features(
        np.unique(eids)))
    snap = build_snapshot(g)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    engines = []
    for dev, p in ((card, {k: _to(v, card) for k, v in params.items()}),
                   ("cpu", params)):
        pub = HandlePublisher(device=dev)
        pub.publish(snap, params=p)
        engines.append(QueryEngine(pub, cfg=cfg, state=state, device=dev,
                                   record_neighbors=True, cache_nodes=32,
                                   cache_edges=256))
    t_q = float(stream.ts.max()) + 1
    rng = np.random.default_rng(0)
    qs = [(rng.integers(0, 200, 5), rng.integers(0, 200, 5),
           np.full(5, t_q, np.float32)) for _ in range(6)]
    runtime.reset_launch_counts()
    with engines[0], engines[1]:
        res = [[e.query_link(*q) for q in qs] for e in engines]
    counts = runtime.launch_counts()
    for name in ("temporal_sample_recent", "cache_gather", "temporal_attn"):
        assert counts.get(name, 0) > 0, name
    for a, b in zip(*res):
        for key in a.nbrs:
            np.testing.assert_array_equal(a.nbrs[key], b.nbrs[key])
        np.testing.assert_allclose(a.scores, b.scores, atol=1e-4, rtol=0)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("name", ["tgn", "tgat"])
def test_trainer_on_the_card_matches_the_cpu_trainer(card, name):
    """One continuous round (recent sampling) on the card and on the CPU
    from the same seed: the same cache hits, per-step losses and AP
    within 1e-4, and every kernel of the training path launched — the
    attention backward once per train step and layer."""
    from repro_torch.configs import tgn_gdelt as TC
    from repro_torch.core.continuous import ContinuousTrainer
    from repro_torch.data.events import synth_ctdg

    small = dict(d_node=16, d_edge=12, d_time=8, d_hidden=20, d_memory=10,
                 sampling="recent", batch_size=128)
    cfg = getattr(TC, name)(**small)
    stream = synth_ctdg(n_nodes=300, n_events=3000, t_span=3000,
                        d_node=16, d_edge=12, seed=2)
    out = []
    for dev in (card, "cpu"):
        tr = ContinuousTrainer(cfg, stream, threshold=16, cache_ratio=0.1,
                               seed=0, device=dev)
        tr.ingest(stream.slice(0, 2000))
        runtime.reset_launch_counts()
        m = tr.train_round(stream.slice(2000, 2500), epochs=2)
        out.append((m, runtime.launch_counts()))
    (a, counts), (b, cpu_counts) = out
    assert cpu_counts == {}
    steps = len(a.step_losses)
    assert steps == 2 * 4 and len(b.step_losses) == steps
    assert counts["temporal_attn_bwd"] == steps * cfg.n_layers
    assert counts["temporal_attn"] == (steps + 4) * cfg.n_layers
    assert counts["temporal_sample_recent"] > 0 and counts["cache_gather"] > 0
    np.testing.assert_allclose(a.step_losses, b.step_losses, atol=1e-4,
                               rtol=0)
    assert abs(a.ap - b.ap) <= 1e-4 and abs(a.eval_loss - b.eval_loss) <= 1e-4
    assert (a.node_hit_rate, a.edge_hit_rate) == (b.node_hit_rate,
                                                  b.edge_hit_rate)


@pytest.mark.parametrize("name", ["tgn", "tgat"])
def test_distributed_trainer_on_the_card_matches_the_cpu(card, name):
    """One one-batch round of the distributed trainer (P 4 x G 2,
    bucketed, recent sampling) on the card and on the CPU from the same
    seed: per-step losses, eval loss and AP within 1e-4; the load
    matrix, request and response bytes and per-partition hit rates
    equal; the attention kernels launched W·L times a train step
    (backward) and W·L times a step (forward)."""
    from repro_torch.configs import tgn_gdelt as TC
    from repro_torch.data.events import synth_ctdg
    from repro_torch.dist.continuous import DistributedContinuousTrainer

    small = dict(d_node=16, d_edge=12, d_time=8, d_hidden=20, d_memory=10,
                 sampling="recent", batch_size=256)
    cfg = getattr(TC, name)(**small)
    stream = synth_ctdg(n_nodes=300, n_events=3000, t_span=3000,
                        d_node=16, d_edge=12, seed=2)
    out = []
    for dev in (card, "cpu"):
        tr = DistributedContinuousTrainer(
            cfg, stream, TC.DistConfig(4, 2, "bucketed"), threshold=16,
            cache_ratio=0.1, seed=0, device=dev)
        tr.ingest(stream.slice(0, 2000))
        runtime.reset_launch_counts()
        m = tr.train_round(stream.slice(2000, 2256), epochs=2)
        out.append((m, runtime.launch_counts(),
                    tr.samplers.load_stats().per_worker_targets))
    (a, counts, load_a), (b, cpu_counts, load_b) = out
    assert cpu_counts == {}
    W, L = 8, cfg.n_layers
    assert len(a.step_losses) == 2 == len(b.step_losses)
    assert counts["temporal_attn_bwd"] == 2 * W * L
    assert counts["temporal_attn"] == (2 + 1) * W * L
    assert counts["temporal_sample_recent"] > 0 and counts["cache_gather"] > 0
    np.testing.assert_allclose(a.step_losses, b.step_losses, atol=1e-4,
                               rtol=0)
    assert abs(a.ap - b.ap) <= 1e-4 and abs(a.eval_loss - b.eval_loss) <= 1e-4
    np.testing.assert_array_equal(load_a, load_b)
    for key in ("request_bytes", "response_bytes", "node_hit_per_part",
                "edge_hit_per_part"):
        assert getattr(a, key) == getattr(b, key), key


# ---------------------------------------------------------------------------
# LM wing: flash_attention and selective_scan
# ---------------------------------------------------------------------------


def _attn_inputs(card, B, Sq, Skv, Hq, Hkv, D, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=card).to(dtype)
            for shape in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


def _assert_bf16_rows_close(got, want):
    """Each output row within 1.6e-2 of the row's max |out| (2 bf16 ulps
    of its scale) and every output within the reference's 4e-2."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    assert float((err / scale).max()) <= 1.6e-2
    assert float(err.max()) <= 4e-2


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D", [
    (1, 64, 64, 4, 2, 16), (2, 96, 96, 6, 2, 32), (2, 57, 57, 4, 2, 16),
    (2, 32, 64, 8, 4, 16), (1, 5, 70, 2, 1, 80), (2, 130, 130, 8, 1, 128),
    (1, 33, 40, 2, 2, 20),     # D % 8 != 0: element-wise staging
    (1, 70, 70, 12, 1, 192),   # Nemotron-4's head dim: Hopper in bf16
    (1, 40, 72, 4, 2, 136), (2, 65, 65, 2, 2, 256),
    # D > 256: chunks of output columns, scores over slices of D
    (1, 70, 70, 4, 2, 320), (2, 65, 90, 4, 1, 512),
    (1, 40, 40, 2, 2, 300),    # D % 8 != 0, a ragged last slice
    (1, 200, 200, 32, 32, 80)])  # zamba2's shared attention: MHA, D 80
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(card, B, Sq, Skv, Hq, Hkv, D,
                                              causal, dtype):
    """Ragged Sq/Skv, Sq < Skv (row i at i + Skv - Sq), GQA, D up to 256:
    within 1e-5 in float32; in bfloat16 each output row within 1.6e-2 of
    the row's max |out| (2 bf16 ulps of its scale) and every output
    within the reference's 4e-2."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q, k, v = _attn_inputs(card, B, Sq, Skv, Hq, Hkv, D, dtype, Sq + D)
    runtime.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    assert runtime.launch_counts() == {"flash_attention": 1}
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        _assert_bf16_rows_close(got, want)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D", [
    (2, 200, 200, 8, 1, 128),    # ragged S, GQA 8:1
    (1, 77, 77, 4, 4, 64),       # ragged S, GQA 1:1, D 64
    (2, 100, 333, 4, 2, 128),    # Sq < Skv: row i at i + 233
    (1, 5, 70, 2, 1, 64),        # Sq < Skv inside one tile
    (1, 2048, 2048, 4, 2, 128),  # 16 K/V tiles: many ring wraps
    (4, 384, 384, 32, 4, 128),   # 384 CTAs, more than the card's SMs
    (2, 300, 300, 40, 8, 128),   # llama4-scout's heads: G 5
    (1, 500, 500, 64, 4, 128),   # qwen3-moe's heads: G 16
    # D 80: a 64-column box and a 16-column tail box, a 3-stage ring
    (2, 300, 300, 32, 32, 80),   # zamba2's shared attention: MHA
    (2, 250, 250, 16, 16, 80),   # hubert-xlarge's 16/16 (not causal there)
    (2, 200, 200, 8, 2, 80),     # ragged S, GQA 8:2
    (2, 100, 333, 4, 2, 80),     # Sq < Skv: row i at i + 233
    (1, 5, 70, 2, 1, 80),        # Sq < Skv inside one tile
    (1, 2048, 2048, 4, 2, 80),   # 16 K/V tiles: many wraps of 3 stages
    (4, 384, 384, 32, 32, 80),   # 384 CTAs, more than the card's SMs
    # D 192 (Nemotron-4): three 64-column boxes, 112-key tiles, so a q
    # tile's diagonal crosses two key tiles; S ragged against both sizes
    (1, 70, 70, 12, 1, 192),     # GQA 12, inside one key tile
    (2, 130, 130, 12, 1, 192),   # two q tiles, two key tiles
    (1, 520, 520, 96, 8, 192),   # Nemotron-4's heads
    (2, 100, 333, 4, 2, 192),    # Sq < Skv: row i at i + 233
    (1, 5, 70, 2, 1, 192),       # Sq < Skv inside one tile
    (1, 2048, 2048, 4, 2, 192),  # 19 K/V tiles: many ring wraps
    (4, 384, 384, 32, 4, 192)])  # 384 CTAs, more than the card's SMs
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_hopper_instance_matches_plain(card, B, Sq, Skv, Hq,
                                                       Hkv, D, causal):
    """The wgmma/TMA instance (bf16, D 64, 80, 128 or 192): ragged edges
    masked in the kernel, the model's causal offset, GQA, non-causal,
    long rings and more CTAs than SMs, at the bf16 bars."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         instance)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    assert instance(torch.bfloat16, D) == "sm90"
    q, k, v = _attn_inputs(card, B, Sq, Skv, Hq, Hkv, D, torch.bfloat16,
                           Sq + Skv + D)
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    _assert_bf16_rows_close(got, want)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,dtype,inst", [
    # a context-parallel shard: Sq = Skv / 4, qwen3-moe's heads
    (2, 512, 2048, 64, 4, 128, torch.bfloat16, "sm90"),
    (1, 300, 1000, 4, 2, 64, torch.bfloat16, "sm90"),    # ragged tiles
    (2, 200, 700, 32, 32, 80, torch.bfloat16, "sm90"),   # the tail box
    (2, 512, 2048, 64, 4, 128, torch.bfloat16, "general"),
    (1, 300, 1000, 4, 2, 64, torch.float32, "general"),
    (1, 70, 200, 4, 1, 192, torch.bfloat16, "general"),  # the wide one
    (1, 70, 200, 4, 1, 192, torch.bfloat16, "sm90"),     # 112-key tiles
    (1, 300, 1000, 12, 1, 192, torch.bfloat16, "sm90")])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_q_offset_matches_plain(card, B, Sq, Skv, Hq, Hkv,
                                                D, dtype, inst, causal):
    """Query row i at i + q_offset, for offsets from 0 (the first
    context-parallel shard) through the default Skv - Sq to past it (the
    last rows see every key), on both instances: within 1e-5 in float32
    and at the bf16 row bars; one launch a call.  Under autograd any
    offset passes (the backward kernels take the forward's; their
    gradients at offsets are held by
    ``test_flash_attention_backward_at_q_offsets``)."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         instance)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    assert inst == "general" or instance(dtype, D) == "sm90"
    forced = "general" if inst == "general" else None
    q, k, v = _attn_inputs(card, B, Sq, Skv, Hq, Hkv, D, dtype, Sq + Skv)
    for off in sorted({0, 1, Sq // 2 + 3, Skv - Sq, Skv - Sq // 2,
                       2 * Skv}):
        runtime.reset_launch_counts()
        got = flash_attention(q, k, v, causal=causal, q_offset=off,
                              _instance=forced)
        assert runtime.launch_counts() == {"flash_attention": 1}
        want = flash_attention_ref(q, k, v, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        else:
            _assert_bf16_rows_close(got, want)
    qg = q.detach().clone().requires_grad_(True)
    for off in (0, Skv - Sq):
        out = flash_attention(qg, k, v, causal=causal, q_offset=off,
                              _instance=forced)
        assert out.requires_grad
    with pytest.raises(ValueError, match="q_offset -1"):
        flash_attention(q, k, v, causal=causal, q_offset=-1)


def _tail_only(ts):
    """The tensors with every column outside 64-79 set to zero."""
    for t in ts:
        t[..., :64] = 0
    return ts


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv", [
    (2, 300, 300, 8, 2), (1, 100, 333, 4, 4)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_hopper_head_dim_80_tail(card, B, Sq, Skv, Hq, Hkv,
                                                 causal):
    """q, k and v zero outside columns 64-79, the 16-column tail box: the
    scores and the output come from the tail alone, so a kernel that
    drops, misplaces or mis-swizzles that box gives wrong rows.  Columns
    0-63 of the output must be exactly 0; the rest hold the bf16 bars,
    forward and backward."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         instance)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_grad_budget, flash_attention_ref,
        grad_rows_beyond_budget)

    D = 80
    assert instance(torch.bfloat16, D) == "sm90"
    # scores of a few units: the softmax is far from uniform
    q, k, v = _tail_only([2 * t for t in _attn_inputs(
        card, B, Sq, Skv, Hq, Hkv, D, torch.bfloat16, 80)])
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(got[..., :64], torch.zeros_like(got[..., :64]))
    _assert_bf16_rows_close(got[..., 64:], want[..., 64:])
    w = _tail_only([torch.randn((B, Sq, Hq, D), device=card,
                                generator=torch.Generator(
                                    device=card).manual_seed(81))])[0]
    grads = _flash_grads(flash_attention, q, k, v, causal, w)[1]
    ref = _flash_grads(flash_attention_ref, q, k, v, causal, w)[1]
    budgets = flash_attention_grad_budget(q, k, v, w.to(torch.bfloat16),
                                          causal=causal)
    torch.cuda.synchronize()
    for name, g, r, b in zip(("dq", "dk", "dv"), grads, ref, budgets):
        assert torch.equal(g[..., :64], torch.zeros_like(g[..., :64])), name
        rel = grad_rows_beyond_budget(g, r, b)
        assert rel <= BF16_GRAD_ROW, f"{name}: {rel} of a row's max"


@pytest.mark.parametrize("B,S,Hq,Hkv", [(2, 200, 32, 32), (1, 300, 8, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_general_instance_at_head_dim_80(card, B, S, Hq,
                                                         Hkv, causal):
    """The general instance stays covered at bf16 D 80, which the Hopper
    one now takes, through the private ``_instance="general"``: forward
    at the bf16 bars and backward at the budget bar against the plain
    version, one launch each way."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_grad_budget, flash_attention_ref,
        grad_rows_beyond_budget)

    D = 80
    q, k, v = _attn_inputs(card, B, S, S, Hq, Hkv, D, torch.bfloat16, 17)
    general = lambda *a, causal: flash_attention(*a, causal=causal,
                                                 _instance="general")
    with torch.no_grad():
        got = general(q, k, v, causal=causal)
    _assert_bf16_rows_close(got, flash_attention_ref(q, k, v,
                                                     causal=causal))
    w = torch.randn((B, S, Hq, D), device=card,
                    generator=torch.Generator(device=card).manual_seed(18))
    runtime.reset_launch_counts()
    grads = _flash_grads(general, q, k, v, causal, w)[1]
    assert runtime.launch_counts() == {"flash_attention": 1,
                                       "flash_attention_bwd": 1}
    ref = _flash_grads(flash_attention_ref, q, k, v, causal, w)[1]
    budgets = flash_attention_grad_budget(q, k, v, w.to(torch.bfloat16),
                                          causal=causal)
    torch.cuda.synchronize()
    for name, g, r, b in zip(("dq", "dk", "dv"), grads, ref, budgets):
        rel = grad_rows_beyond_budget(g, r, b)
        assert rel <= BF16_GRAD_ROW, f"{name}: {rel} of a row's max"


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv", [
    (1, 70, 70, 12, 1), (2, 130, 130, 12, 1), (1, 520, 520, 96, 8),
    (1, 300, 1000, 12, 1),
    (4, 384, 384, 32, 4)])   # more dq CTAs (384) than SMs
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_hopper_head_dim_192_agrees_with_general(
        card, B, Sq, Skv, Hq, Hkv, causal):
    """At bf16 D 192 the forward (112-key tiles) and the backward (64-key
    dk/dv tiles split between two warpgroups, the dq pass's 128-row
    tiles) are the Hopper instance's.  The output holds the bf16 bars
    against the plain version and against the general instance (asked
    for).  On the Hopper forward's row log-sum-exps and float32 output,
    the Hopper backward (picked: one launch, the same bits twice) holds
    each row of dq and each key of dk and dv within BF16_GRAD_ROW beyond
    its rounding budget against the plain version's autograd and against
    the general backward (asked for), and the same bar fails its dk and
    dv with the last 64 keys zeroed."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_grad_budget, flash_attention_ref,
        grad_rows_beyond_budget)

    D = 192
    assert ops.instance(torch.bfloat16, D) == "sm90"
    assert ops.backward_instance(torch.bfloat16, D) == "sm90"
    q, k, v = _attn_inputs(card, B, Sq, Skv, Hq, Hkv, D, torch.bfloat16,
                           Sq + Hq)
    got = ops.flash_attention(q, k, v, causal=causal)
    general = ops.flash_attention(q, k, v, causal=causal,
                                  _instance="general")
    _assert_bf16_rows_close(got, flash_attention_ref(q, k, v,
                                                     causal=causal))
    _assert_bf16_rows_close(general, got)
    lse = torch.empty((B, Hq, Sq), device=card)
    o32 = torch.empty((B, Sq, Hq, D), device=card)
    out = ops._forward(q, k, v, causal, lse, o32)
    assert torch.equal(out, got)
    w = torch.randn((B, Sq, Hq, D), device=card,
                    generator=torch.Generator(device=card).manual_seed(Sq))
    dout = w.to(torch.bfloat16)
    runtime.reset_launch_counts()
    picked = ops.flash_attention_bwd(q, k, v, o32, lse, dout, causal=causal)
    assert runtime.launch_counts() == {"flash_attention_bwd": 1}
    again = ops.flash_attention_bwd(q, k, v, o32, lse, dout, causal=causal)
    asked = ops.flash_attention_bwd(q, k, v, o32, lse, dout, causal=causal,
                                    _instance="general")
    want = _flash_grads(flash_attention_ref, q, k, v, causal, w)[1]
    budgets = flash_attention_grad_budget(q, k, v, dout, causal=causal)
    torch.cuda.synchronize()
    for name, a, b, g, r, bud in zip(("dq", "dk", "dv"), picked, again,
                                     asked, want, budgets):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), name
        rel = grad_rows_beyond_budget(a, r, bud)
        assert rel <= BF16_GRAD_ROW, f"{name}: {rel} against the plain"
        rel = grad_rows_beyond_budget(g, a, bud)
        assert rel <= BF16_GRAD_ROW, f"{name}: {rel} general vs Hopper"
    dropped = [t.clone() for t in picked[1:]]   # every key is seen
    for t in dropped:
        t[:, -64:] = 0
    assert max(grad_rows_beyond_budget(t, r, bud) for t, r, bud in zip(
        dropped, want[1:], budgets[1:])) > BF16_GRAD_ROW


@pytest.mark.parametrize("dtype,D,inst", [
    (torch.bfloat16, 128, "sm90"), (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 80, "sm90"), (torch.float32, 128, "general"),
    (torch.bfloat16, 192, "sm90")])
def test_flash_attention_one_launch_per_call(card, dtype, D, inst):
    """Either instance is one counted ``flash_attention`` launch."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         instance)

    assert instance(dtype, D) == inst
    q, k, v = _attn_inputs(card, 2, 96, 96, 4, 2, D, dtype, D)
    runtime.reset_launch_counts()
    flash_attention(q, k, v, causal=True)
    assert runtime.launch_counts() == {"flash_attention": 1}
    flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert runtime.launch_counts() == {"flash_attention": 2}


@pytest.mark.parametrize("B,L,Din,N", [
    (1, 16, 8, 4), (2, 21, 16, 4), (2, 48, 64, 16), (3, 200, 100, 8),
    (2, 130, 96, 6),
    # d_state > 16: 4 or 8 threads a channel, then groups of 64 states
    (2, 130, 96, 24), (2, 200, 100, 32), (1, 150, 64, 64),
    (2, 70, 40, 100), (1, 90, 48, 70), (1, 65, 30, 130)])
def test_selective_scan_kernel_matches_plain(card, B, L, Din, N):
    from repro_torch.kernels.selective_scan.ops import selective_scan
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    g = torch.Generator(device=card).manual_seed(L)
    r = lambda *s: torch.rand(s, generator=g, device=card)
    n = lambda *s: torch.randn(s, generator=g, device=card)
    args = (0.001 + 0.099 * r(B, L, Din), n(B, L, Din),
            -(0.5 + 3.5 * r(Din, N)), n(B, L, N), n(B, L, N), n(B, Din, N))
    runtime.reset_launch_counts()
    y, h = selective_scan(*args)
    assert runtime.launch_counts() == {"selective_scan": 1}
    y_w, h_w = selective_scan_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_w, atol=1e-5, rtol=0)
    torch.testing.assert_close(h, h_w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,L,Din,N", [
    (1, 333, 8192, 16),   # Falcon's width, L no multiple of the chunk
    (2, 130, 8192, 13),   # N < 16: padded states
    (2, 64, 256, 16)])
def test_selective_scan_kernel_exp2_over_model_ranges(card, B, L, Din, N):
    """exp(dt A) as ex2.approx(dt A log2 e) with A down to -16 (A =
    -exp(A_log) in the model) and dt up to 1 (a softplus), from a
    nonzero h0: within 1e-5 of the float32 reference."""
    from repro_torch.kernels.selective_scan.ops import selective_scan
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    g = torch.Generator(device=card).manual_seed(Din + L)
    r = lambda *s: torch.rand(s, generator=g, device=card)
    n = lambda *s: torch.randn(s, generator=g, device=card)
    args = (0.001 + 0.999 * r(B, L, Din), n(B, L, Din),
            -(0.5 + 15.5 * r(Din, N)), n(B, L, N), n(B, L, N), n(B, Din, N))
    runtime.reset_launch_counts()
    y, h = selective_scan(*args)
    assert runtime.launch_counts() == {"selective_scan": 1}
    y_w, h_w = selective_scan_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_w, atol=1e-5, rtol=0)
    torch.testing.assert_close(h, h_w, atol=1e-5, rtol=0)


def _grad_close(got, want, what, tol):
    """max |got - want| within ``tol`` of max(1, max |want|)."""
    err = float((got.float() - want.float()).abs().max()) if want.numel() \
        else 0.0
    scale = max(1.0, float(want.float().abs().max()) if want.numel() else 0)
    assert err <= tol * scale, f"{what}: max |err| {err} > {tol} * {scale}"


# bf16 attention gradients, held per row as the forward's output is: over
# dq's query rows and dk's and dv's keys, the largest error beyond each
# element's rounding budget over the row's max |grad|
# (``grad_rows_beyond_budget``); set from readings on the card
# (``python tests/test_torch_cuda.py``; PERF.md section 2)
BF16_GRAD_ROW = 0.02


def _flash_grads(fn, q, k, v, causal, w):
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = fn(qs, ks, vs, causal=causal)
    return out, torch.autograd.grad((out.float() * w).sum(), (qs, ks, vs))


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (1, 1, 4, 4, 64),        # G 1, one row
    (2, 127, 8, 2, 80),      # G 4, ragged S, D 80
    (1, 1000, 8, 1, 128),    # G 8, Yi's head dim
    (2, 127, 8, 1, 300),     # G 8, D past 128: chunks and slices
    (1, 1000, 4, 1, 64),     # G 4
    (2, 127, 4, 4, 128),     # G 1
    # the Hopper instance (bf16, D 64 and 128): S no multiple of its 128-
    # key and 128-row tiles, and Sq < Skv (row i at i + Skv - Sq)
    (2, 200, 8, 2, 64),      # G 4
    (1, 300, 16, 2, 128),    # G 8
    (1, (100, 333), 8, 1, 128),  # G 8, Sq < Skv
    (2, (77, 200), 4, 4, 64),    # G 1, Sq < Skv
    # D 80 (bf16: the Hopper instance with its tail box; G 4 above)
    (2, 200, 8, 8, 80),      # G 1
    (1, 300, 16, 2, 80),     # G 8
    (1, (100, 333), 8, 1, 80),   # G 8, Sq < Skv
    # D 192 (bf16: the Hopper forward and backward, the backward's dk/dv
    # tiles 64 keys split between two warpgroups)
    (2, 130, 12, 1, 192),    # G 12, ragged against 64, 112 and 128
    (1, (70, 520), 12, 1, 192)])  # G 12, Sq < Skv
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_matches_plain_autograd(card, B, S, Hq,
                                                         Hkv, D, causal,
                                                         dtype):
    """dq, dk, dv of the backward kernel (the instance of dtype and head
    dim, after the forward's: the same instance) against
    the plain version's autograd on the same inputs: float32 within 1e-5
    of max(1, max |grad|); bfloat16 each row within BF16_GRAD_ROW beyond
    its rounding budget.  One counted launch each way.  ``S`` is Sq =
    Skv, or (Sq, Skv)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_grad_budget, flash_attention_ref,
        grad_rows_beyond_budget)

    Sq, Skv = S if isinstance(S, tuple) else (S, S)
    q, k, v = _attn_inputs(card, B, Sq, Skv, Hq, Hkv, D, dtype, Sq + D)
    w = torch.randn((B, Sq, Hq, D), device=card,
                    generator=torch.Generator(device=card).manual_seed(D))
    runtime.reset_launch_counts()
    _, got = _flash_grads(flash_attention, q, k, v, causal, w)
    assert runtime.launch_counts() == {"flash_attention": 1,
                                       "flash_attention_bwd": 1}
    _, want = _flash_grads(flash_attention_ref, q, k, v, causal, w)
    budgets = flash_attention_grad_budget(q, k, v, w.to(dtype),
                                          causal=causal)
    torch.cuda.synchronize()
    for name, g, r, b in zip(("dq", "dk", "dv"), got, want, budgets):
        assert g.dtype == dtype and g.shape == r.shape
        if dtype == torch.float32:
            _grad_close(g, r, name, 1e-5)
        else:
            rel = grad_rows_beyond_budget(g, r, b)
            assert rel <= BF16_GRAD_ROW, f"{name}: {rel} of a row's max"


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,dtype,inst", [
    # a context-parallel shard: Skv = 4 Sq, qwen3-moe's heads (G 16)
    (1, 512, 2048, 64, 4, 128, torch.bfloat16, "sm90"),
    (1, 512, 2048, 64, 4, 128, torch.bfloat16, "general"),
    (2, 200, 800, 32, 32, 80, torch.bfloat16, "sm90"),    # the tail box
    (1, 300, 1000, 4, 2, 64, torch.bfloat16, "sm90"),     # ragged tiles
    (1, 300, 1000, 4, 2, 64, torch.bfloat16, "general"),
    (2, 150, 700, 8, 2, 80, torch.float32, "general"),    # ragged, f32
    (1, 70, 200, 4, 1, 192, torch.float32, "general"),    # D past 128
    (1, 70, 200, 4, 1, 192, torch.bfloat16, "sm90"),      # Hopper, D 192
    (1, 130, 520, 12, 1, 192, torch.bfloat16, "sm90"),    # G 12, ragged
    (1, 130, 520, 12, 1, 192, torch.bfloat16, "general")])
def test_flash_attention_backward_at_q_offsets(card, B, Sq, Skv, Hq, Hkv,
                                               D, dtype, inst):
    """The backward at each context-parallel shard's q_offset (0, Sq, 2
    Sq, ... up to the default Skv - Sq) and past the default, on both
    instances, against the plain version's autograd at the same offset:
    float32 within 1e-5 of max(1, max |grad|), bfloat16 each row within
    BF16_GRAD_ROW beyond its rounding budget.  At offset 0 the keys past
    the last row's position are seen by no query: their dk and dv must
    be exactly 0 (the dk/dv pass starts from uninitialised memory).
    One forward and one backward launch a call."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         instance)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_grad_budget, flash_attention_ref,
        grad_rows_beyond_budget)

    assert inst == "general" or instance(dtype, D) == "sm90"
    forced = "general" if inst == "general" else None
    q, k, v = _attn_inputs(card, B, Sq, Skv, Hq, Hkv, D, dtype, Sq + Skv)
    w = torch.randn((B, Sq, Hq, D), device=card,
                    generator=torch.Generator(device=card).manual_seed(Sq))
    offsets = sorted(set(range(0, Skv - Sq + 1, Sq)) | {Skv - Sq,
                                                       Skv - Sq + 7})
    for off in offsets:
        kern = lambda *a, causal: flash_attention(
            *a, causal=causal, q_offset=off, _instance=forced)
        plain = lambda *a, causal: flash_attention_ref(*a, causal=causal,
                                                       q_offset=off)
        runtime.reset_launch_counts()
        _, got = _flash_grads(kern, q, k, v, True, w)
        assert runtime.launch_counts() == {"flash_attention": 1,
                                           "flash_attention_bwd": 1}
        _, want = _flash_grads(plain, q, k, v, True, w)
        torch.cuda.synchronize()
        if off + Sq < Skv:       # keys past the last row: exactly zero
            for g in got[1:]:
                assert not bool(g[:, off + Sq:].any()), off
        if dtype == torch.float32:
            for name, g, r in zip(("dq", "dk", "dv"), got, want):
                _grad_close(g, r, f"{name} q_offset {off}", 1e-5)
            continue
        budgets = flash_attention_grad_budget(q, k, v, w.to(dtype),
                                              causal=True, q_offset=off)
        for name, g, r, b in zip(("dq", "dk", "dv"), got, want, budgets):
            rel = grad_rows_beyond_budget(g, r, b)
            assert rel <= BF16_GRAD_ROW, (name, off, rel)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,q_offset", [
    (2, 150, 700, 8, 2, 80, True, 0),       # keys past row 149: no query
    (1, 77, 77, 4, 4, 80, False, None),     # ragged, MHA
    (1, 200, 333, 8, 1, 128, True, 50),     # ragged, offset below default
    (1, 130, 260, 4, 2, 128, True, 130),    # a shard's offset
    (2, 100, 100, 4, 2, 128, False, None),  # ragged tiles, full
    (2, 65, 90, 4, 1, 512, False, None),    # D 512: the column pair
    (1, 40, 200, 4, 2, 512, True, 0),       # D 512, keys no query sees
    (1, 64, 64, 2, 1, 20, True, None),      # D % 8 != 0: 4-byte copies
    (1, 64, 64, 4, 2, 16, True, None),      # one piece, mostly padding
    (2, 57, 57, 4, 2, 16, False, None),
    (1, 5, 70, 2, 1, 80, True, None),       # Sq < Skv, default offset
    (1, 33, 40, 2, 2, 20, True, None),
    (1, 7, 9, 2, 1, 1, False, None),        # D 1
    (2, 130, 130, 8, 1, 128, True, None),   # G 8
    (1, 70, 70, 12, 1, 192, True, None),    # Nemotron-4's head dim
    (1, 40, 40, 2, 2, 300, True, None),     # column pair, ragged pieces
    (1, 40, 72, 4, 2, 136, False, None),    # chunks of 80 and 56 columns
    (1, 30, 30, 2, 1, 600, True, None),     # past 512: chunks
    (2, 150, 700, 8, 2, 80, True, 300),     # an offset past 0
    (1, 70, 200, 4, 1, 192, True, 0),       # column pair, unseen keys
    (1, 512, 2048, 16, 4, 128, True, 1024), # a CP shard's offset
    (2, 1000, 1000, 8, 2, 80, False, None)])  # the 5b row's shape
def test_flash_attention_float32_split_tf32_route(card, B, Sq, Skv, Hq,
                                                  Hkv, D, causal,
                                                  q_offset):
    """The general instance's float32 route (split TF32 on the tensor
    cores: the rows kernel up to D 128, the column-pair kernel past it;
    the backward's two passes), forward and backward, against the plain
    version and its autograd: the output within 1e-5, each gradient
    within 1e-5 of max(1, max |grad|), one counted launch each way, and
    dk and dv exactly 0 on keys that no query of the call sees."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q, k, v = _attn_inputs(card, B, Sq, Skv, Hq, Hkv, D, torch.float32,
                           Sq + Skv + D)
    w = torch.randn((B, Sq, Hq, D), device=card,
                    generator=torch.Generator(device=card).manual_seed(D))
    given = {} if q_offset is None else {"q_offset": q_offset}
    kern = lambda *a, causal: flash_attention(*a, causal=causal, **given)
    plain = lambda *a, causal: flash_attention_ref(*a, causal=causal,
                                                   **given)
    runtime.reset_launch_counts()
    out, got = _flash_grads(kern, q, k, v, causal, w)
    assert runtime.launch_counts() == {"flash_attention": 1,
                                       "flash_attention_bwd": 1}
    ref, want = _flash_grads(plain, q, k, v, causal, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == r.shape
        _grad_close(g, r, name, 1e-5)
    if causal and q_offset is not None and q_offset + Sq < Skv:
        for g in got[1:]:
            assert not bool(g[:, q_offset + Sq:].any())


@pytest.mark.parametrize("D", [64, 136, 20])
def test_flash_attention_float32_backward_same_bits_every_run(card, D):
    """The float32 backward's dk/dv pass gives the same bits on every run.
    Its two warp groups take alternate q tiles and group 1 hands its sums
    to group 0 through its own ring's first slot; at these shapes (G 2,
    3 q tiles) group 1 walks 3 tiles of an odd number of stages each, so
    its last stage sits in that slot (D 64 and 20: one 64-column output
    stage; D 136: a last chunk of 56 columns).  20 backward calls on the
    same inputs: dq, dk and dv equal bit for bit, and within 1e-5 of
    max(1, max |grad|) of the plain version's autograd."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q, k, v = _attn_inputs(card, 2, 160, 160, 4, 2, D, torch.float32, D)
    w = torch.randn((2, 160, 4, D), device=card,
                    generator=torch.Generator(device=card).manual_seed(1))
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = flash_attention(qs, ks, vs, causal=False)
    first = torch.autograd.grad((out * w).sum(), (qs, ks, vs),
                                retain_graph=True)
    for _ in range(19):
        again = torch.autograd.grad((out * w).sum(), (qs, ks, vs),
                                    retain_graph=True)
        for name, a, b in zip(("dq", "dk", "dv"), again, first):
            assert torch.equal(a, b), name
    _, want = _flash_grads(flash_attention_ref, q, k, v, False, w)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv"), first, want):
        _grad_close(g, r, name, 1e-5)


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 80),
                                     (torch.float32, 80)])
def test_flash_attention_backward_is_deterministic(card, dtype, D):
    """Two backward calls on the same inputs give the same bits (no
    atomics: dk and dv in one pass over the q tiles, dq in another), for
    the Hopper instance (bf16, D 128 and 80) and the general one."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    q, k, v = _attn_inputs(card, 2, 300, 300, 8, 2, D, dtype, 3)
    w = torch.randn((2, 300, 8, D), device=card)
    first = _flash_grads(flash_attention, q, k, v, True, w)[1]
    again = _flash_grads(flash_attention, q, k, v, True, w)[1]
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [128, 80])
@pytest.mark.parametrize("which", ["q", "k", "v", "dout"])
def test_flash_attention_hopper_backward_refuses_misaligned(card, which, D):
    """The Hopper backward reads q, k, v and dout by TMA: one that is not
    16-byte aligned is refused before the launch, with no fallback; the
    general instance, asked for, takes it."""
    from repro_torch.kernels.flash_attention import ops

    B, S, Hq, Hkv = 1, 96, 4, 2
    q, k, v = _attn_inputs(card, B, S, S, Hq, Hkv, D, torch.bfloat16, 4)
    dout = torch.randn((B, S, Hq, D), device=card).to(torch.bfloat16)
    lse = torch.empty((B, Hq, S), device=card)
    o32 = torch.empty((B, S, Hq, D), device=card)
    ops._forward(q, k, v, True, lse, o32)
    ins = dict(q=q, k=k, v=v, dout=dout)
    t = ins[which]
    shifted = torch.empty(t.numel() + 8, dtype=t.dtype, device=card)[1:]
    ins[which] = shifted[:t.numel()].view(t.shape).copy_(t)
    assert ins[which].is_contiguous() and ins[which].data_ptr() % 16
    args = (ins["q"], ins["k"], ins["v"], o32, lse, ins["dout"])
    runtime.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention_bwd(*args, causal=True)
    assert runtime.launch_counts() == {}
    got = ops.flash_attention_bwd(*args, causal=True, _instance="general")
    want = ops.flash_attention_bwd(q, k, v, o32, lse, dout, causal=True,
                                   _instance="general")
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 80),
                                     (torch.float32, 320),
                                     (torch.bfloat16, 192)])
def test_flash_attention_lse_leaves_forward_unchanged(card, dtype, D):
    """The forward with its log-sum-exp store (grad on) gives the same
    output bits as without it (serving), for both instances."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    q, k, v = _attn_inputs(card, 2, 200, 200, 4, 2, D, dtype, 5)
    with torch.no_grad():
        plain = flash_attention(q, k, v, causal=True)
    train = flash_attention(q.requires_grad_(True), k, v, causal=True)
    torch.cuda.synchronize()
    assert train.grad_fn is not None
    assert torch.equal(plain, train.detach())


@pytest.mark.parametrize("D,causal", [(128, True), (64, False), (80, True),
                                      (320, False), (192, True)])
def test_flash_attention_float32_output_rounds_to_the_output(card, D,
                                                            causal):
    """Under autograd a bfloat16 forward also writes its output's float32
    values (the backward's D = rowsum(dO * O) reads them), for both
    instances: rounded to bfloat16 they are the output bit for bit, and
    they hold the output's bar against the plain version's float32 output
    before its rounding."""
    from repro_torch.kernels.flash_attention import ops

    B, S, Hq, Hkv = 2, 200, 4, 2
    q, k, v = _attn_inputs(card, B, S, S, Hq, Hkv, D, torch.bfloat16, 7)
    lse = torch.empty((B, Hq, S), device=card)
    o32 = torch.full((B, S, Hq, D), float("nan"), device=card)
    out = ops._forward(q, k, v, causal, lse, o32)
    torch.cuda.synchronize()
    assert torch.equal(o32.to(torch.bfloat16), out)
    # the plain version's math (kernels/flash_attention/ref.py) with its
    # final cast left out
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * D ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=card)
                          .triu(1), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(torch.bfloat16).float(),
                     v.float()) / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    _assert_bf16_rows_close(o32, o.reshape(B, S, Hq, D))


def _scan_args(card, B, L, Din, N, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g, device=card)
    n = lambda *s: torch.randn(s, generator=g, device=card)
    return (0.001 + 0.099 * r(B, L, Din), n(B, L, Din),
            -(0.5 + 3.5 * r(Din, N)), n(B, L, N), n(B, L, N), n(B, Din, N))


def _scan_grads(fn, args, wy, wh):
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    y, h = fn(*leaves)
    loss = (y * wy).sum() + (h * wh).sum()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("B,L,Din,N", [
    (2, 130, 96, 16), (1, 64, 64, 16), (2, 201, 40, 24), (1, 77, 48, 64),
    (2, 150, 30, 130), (2, 1, 16, 16), (1, 333, 8192, 16),
    (2, 520, 8192, 16)])   # Falcon's train width, B 2: 256 CTAs, one wave
def test_selective_scan_backward_matches_plain_autograd(card, B, L, Din, N):
    """ddt, dx, dA, dB, dC and dh0 of the backward kernel against the
    plain loop's autograd, from a nonzero h0 with a gradient flowing in
    through h_last too: each within 1e-5 of max(1, max |grad|).  One
    counted launch each way."""
    from repro_torch.kernels.selective_scan.ops import selective_scan
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    args = _scan_args(card, B, L, Din, N, L + N)
    wy = torch.randn((B, L, Din), device=card)
    wh = torch.randn((B, Din, N), device=card)
    runtime.reset_launch_counts()
    got = _scan_grads(selective_scan, args, wy, wh)
    assert runtime.launch_counts() == {"selective_scan": 1,
                                       "selective_scan_bwd": 1}
    want = _scan_grads(selective_scan_ref, args, wy, wh)
    torch.cuda.synchronize()
    for name, g, r in zip(("ddt", "dx", "dA", "dB", "dC", "dh0"), got,
                          want):
        _grad_close(g, r, name, 1e-5)


def test_selective_scan_backward_is_deterministic(card):
    """Two backward calls give the same bits: the sums over Din (dB,
    dC) and over B and L (dA) are taken in a fixed order."""
    from repro_torch.kernels.selective_scan.ops import selective_scan

    args = _scan_args(card, 2, 300, 512, 16, 9)
    wy = torch.randn((2, 300, 512), device=card)
    wh = torch.randn((2, 512, 16), device=card)
    first = _scan_grads(selective_scan, args, wy, wh)
    again = _scan_grads(selective_scan, args, wy, wh)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("launch", ["forward", "backward"])
def test_selective_scan_launchers_refuse_another_state_chunk(card,
                                                             monkeypatch,
                                                             launch):
    """The stored states' chunk is the wrapper's CHUNK; each launcher
    takes it and refuses one other than the chunk it was built for
    (rather than read or write past the buffer)."""
    from repro_torch.kernels.selective_scan import ops

    args = [a.requires_grad_(True) for a in _scan_args(card, 1, 100, 64,
                                                       16, 4)]
    if launch == "forward":
        monkeypatch.setattr(ops, "CHUNK", 32)
        with pytest.raises(RuntimeError, match="selective_scan"):
            ops.selective_scan(*args)
        return
    y, h = ops.selective_scan(*args)
    monkeypatch.setattr(ops, "CHUNK", 32)
    with pytest.raises(RuntimeError, match="selective_scan_bwd"):
        torch.autograd.grad(y.sum() + h.sum(), args)


@pytest.mark.parametrize("arch", ["yi-6b", "hubert-xlarge",
                                  "falcon-mamba-7b"])
def test_lm_gradients_on_the_card_match_the_plain_path(card, arch):
    """A 2-layer model's forward_hidden under autograd on the card goes
    through the forward and backward kernels (one launch of each a layer)
    and gives the float32 gradients of the CPU's plain path: the input's
    and every parameter leaf's within 1e-4 of the leaf's max |value|."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import lm_zoo as Z
    from repro_torch.models import transformer_lm as T
    from repro_torch.train.optimizer import tree_leaves

    cfg = dataclasses.replace(get_arch(arch).reduced(), n_layers=2)
    params = Z.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                           device=card)
    cpu = _to(params, "cpu")
    B, S = 2, 40
    g = np.random.default_rng(1)
    x = torch.from_numpy(g.normal(size=(B, S, cfg.d_model)).astype(
        np.float32))
    w = torch.from_numpy(g.normal(size=(B, S, cfg.d_model)).astype(
        np.float32))
    pos = torch.arange(S)[None].expand(B, S)

    def grads(tree, dev):      # forward_hidden reads only the layers
        leaves = [t.requires_grad_(True)
                  for t in tree_leaves(tree["layers"])]
        xs = x.to(dev).requires_grad_(True)
        h, _, _ = T.forward_hidden(cfg, tree, xs, pos.to(dev))
        return torch.autograd.grad((h * w.to(dev)).sum(), [xs] + leaves)

    kernel = "selective_scan" if cfg.family == "ssm" else "flash_attention"
    runtime.reset_launch_counts()
    got = grads(params, card)
    assert runtime.launch_counts() == {kernel: cfg.n_layers,
                                       f"{kernel}_bwd": cfg.n_layers}
    want = grads(cpu, "cpu")
    for i, (a, b) in enumerate(zip(got, want)):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-4 * max(float(b.abs().max()), 1e-30), (i, err)


@pytest.mark.parametrize("arch", ["yi-6b", "hubert-xlarge",
                                  "falcon-mamba-7b", "qwen3-moe-235b-a22b",
                                  "llama4-scout-17b-a16e", "zamba2-2.7b"])
def test_lm_serving_on_the_card_matches_the_cpu(card, arch):
    """The reduced model's float32 forward within 1e-4 and its bf16
    prefill and decode logits within 5e-2 (chip_smoke.py's bar) of the
    same weights on the CPU; one kernel launch per attention layer (the
    hybrid's: per superlayer), or per Mamba-1 layer, of a prefill."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm_zoo as Z
    from repro_torch.models import transformer_lm as T

    cfg = get_arch(arch).reduced()
    params = Z.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                           device=card)
    cpu = _to(params, "cpu")
    B, S = 2, 40
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.normal(size=(B, S, cfg.d_model)).astype(
        np.float32))
    pos = torch.arange(S)[None].expand(B, S)
    h_c, _, _ = T.forward_hidden(cfg, cpu, x, pos)
    h_g, _, _ = T.forward_hidden(cfg, params, x.to(card), pos.to(card))
    torch.testing.assert_close(h_g.cpu(), h_c, atol=1e-4, rtol=0)
    if cfg.input_kind == "tokens":
        batch = {"tokens": torch.from_numpy(
            g.integers(0, cfg.vocab, (B, S)).astype(np.int32))}
    else:
        batch = {"frames": x}
    kernel = "selective_scan" if cfg.family == "ssm" else "flash_attention"
    runtime.reset_launch_counts()
    l_g, st_g = Z.make_prefill_step(cfg)(
        params, {k: v.to(card) for k, v in batch.items()})
    assert runtime.launch_counts() == {
        kernel: T.attention_layers(cfg) or cfg.n_layers}
    l_c, st_c = Z.make_prefill_step(cfg)(cpu, batch)
    torch.testing.assert_close(l_g.cpu(), l_c, atol=5e-2, rtol=0)
    if cfg.is_encoder:
        return
    serve = Z.make_serve_step(cfg)
    if cfg.family != "ssm":      # a dense prefill's K/V stacks are full
        st_g = T.init_decode_state(cfg, B, S, device=card)
        st_c = T.init_decode_state(cfg, B, S, device="cpu")
    tok = batch["tokens"][:, :1]
    for _ in range(3):
        l_g, st_g = serve(params, st_g, tok.to(card))
        l_c, st_c = serve(cpu, st_c, tok)
        torch.testing.assert_close(l_g.cpu(), l_c, atol=5e-2, rtol=0)
        tok = l_c.argmax(-1, keepdim=True).to(torch.int32)


@pytest.mark.parametrize("shared,cf", [(False, 2.0), (True, 0.5)])
def test_moe_apply_on_the_card_matches_the_cpu(card, shared, cf):
    """The MoE layer at a small width (d 256, 16 experts of 128, top 4)
    in float32 on the card against the CPU: each token's experts equal,
    the output within 1e-4 of its max |value|, the load-balance loss
    within 1e-6 and the drop fraction equal; with the shared expert and
    a capacity that drops slots, and without either."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as M

    cfg = MoEConfig(num_experts=16, top_k=4, expert_d_ff=128,
                    capacity_factor=cf, shared_expert_d_ff=192 * shared)
    params = M.moe_init(torch.Generator().manual_seed(3), cfg, 256,
                        "swiglu")
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 96, 256)).astype(np.float32))
    picked = []
    real = M._top_k

    def record(probs, k):
        out = real(probs, k)
        picked.append(out[1].cpu())
        return out
    M._top_k = record
    try:
        y_c, aux_c = M.moe_apply(params, x, cfg, "swiglu")
        y_g, aux_g = M.moe_apply(_to(params, card), x.to(card), cfg,
                                 "swiglu")
    finally:
        M._top_k = real
    assert torch.equal(picked[0], picked[1])
    err = float((y_g.cpu() - y_c).abs().max())
    assert err <= 1e-4 * float(y_c.abs().max()), err
    assert abs(float(aux_g["moe_lb_loss"]) - float(aux_c["moe_lb_loss"])) \
        <= 1e-6
    assert float(aux_g["moe_drop_frac"]) == float(aux_c["moe_drop_frac"])
    assert (float(aux_c["moe_drop_frac"]) > 0) == (cf < 1)


@pytest.mark.parametrize("shared,cf,dtype", [
    (False, 1.25, torch.bfloat16), (True, 0.5, torch.bfloat16),
    (False, 2.0, torch.float32)])
def test_moe_backward_is_deterministic(card, shared, cf, dtype):
    """Two backward runs of the MoE layer on the same inputs give the
    same bits, gradients of x and of every weight (each token's k rows
    are written and gathered without repeated indices, and summed over
    the choices in a fixed order); with drops and the shared expert."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as M

    cfg = MoEConfig(num_experts=16, top_k=4, expert_d_ff=128,
                    capacity_factor=cf, shared_expert_d_ff=192 * shared)
    params = _to(M.moe_init(torch.Generator().manual_seed(5), cfg, 256,
                            "swiglu", dtype), card)
    names = sorted(n for n in params if n != "shared")
    g = torch.Generator(device=card).manual_seed(6)
    x = torch.randn((2, 512, 256), device=card, generator=g).to(dtype)
    w = torch.randn((2, 512, 256), device=card, generator=g)

    def grads():
        ins = [params[n].detach().clone().requires_grad_(True)
               for n in names] + [x.clone().requires_grad_(True)]
        y, _ = M.moe_apply(dict(params, **dict(zip(names, ins))), ins[-1],
                           cfg, "swiglu")
        return torch.autograd.grad((y.float() * w).sum(), ins)

    first, again = grads(), grads()
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def _ref_without_the_diagonal(q, k, v, *, causal):
    """The plain attention with a faulty causal mask that also hides each
    row's own key (row 0 keeps its key, so no row is empty): the fault
    the bfloat16 gradient bar must catch."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    if not causal:
        return flash_attention_ref(q, k, v, causal=False)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (D ** -0.5)
    kpos = torch.arange(Skv, device=q.device)
    qpos = torch.arange(Sq, device=q.device) + (Skv - Sq)
    masked = kpos[None, :] >= qpos[:, None]
    masked[0, 0] = False
    p = torch.softmax(s.masked_fill(masked, float("-inf")), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def _ref_without_the_last_key(q, k, v, *, causal):
    """The plain attention, not causal, with the last key hidden from
    every row (a ragged tile edge dropped): the fault the bfloat16
    gradient bar must catch where there is no causal mask."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    return flash_attention_ref(q, k[:, :-1], v[:, :-1], causal=causal)


def _bf16_logit_readings():
    """Zamba2-2.7B at full width cut to one superlayer (6 layers, B 2, S
    256) and Falcon-Mamba-7B cut to 2 layers, over 4 seeds: max |card -
    CPU| of the bf16 prefill logits and of 4 decode steps from a fresh
    state, sound and with each row's newest key hidden from the card's
    decode attention."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import lm_zoo as Z
    from repro_torch.models import transformer_lm as T

    dev, real = torch.device("cuda"), T.decode_attention

    def hide_newest(q, k, v, valid_len):
        return real(q, k, v, (valid_len - 1).clamp_min(1))

    for arch, depth in (("zamba2-2.7b", 6), ("falcon-mamba-7b", 2)):
        B, S = 2, 256
        cut = dataclasses.replace(get_arch(arch), n_layers=depth)
        for seed in range(4):
            params = Z.init_params(
                cut, torch.Generator(device=dev).manual_seed(seed + 1),
                device=dev)
            cp_g, cp_c = Z._cast_compute(params), Z._cast_compute(
                _to(params, "cpu"))
            del params
            toks = torch.from_numpy(np.random.default_rng(seed).integers(
                0, cut.vocab, (B, S + 1)).astype(np.int32))
            pre, serve = Z.make_prefill_step(cut), Z.make_serve_step(cut)
            l_g, _ = pre(cp_g, {"tokens": toks[:, :S].to(dev)})
            l_c, _ = pre(cp_c, {"tokens": toks[:, :S]})
            out = {"prefill": round(float((l_g.cpu() - l_c).abs().max()), 4)}
            for fault in (False, True):
                d_g = T.init_decode_state(cut, B, S, device=dev)
                d_c = T.init_decode_state(cut, B, S, device="cpu")
                tok, errs = toks[:, S:], []
                for _ in range(4):
                    T.decode_attention = hide_newest if fault else real
                    o_g, d_g = serve(cp_g, d_g, tok.to(dev))
                    T.decode_attention = real
                    o_c, d_c = serve(cp_c, d_c, tok)
                    errs.append(round(float((o_g.cpu() - o_c).abs().max()),
                                      4))
                    tok = o_c.argmax(-1, keepdim=True).to(torch.int32)
                out["newest key hidden" if fault else "sound"] = errs
            print(f"{arch} cut to {depth} layers, seed {seed}: card vs CPU "
                  f"bf16 logits {out}", flush=True)
            del cp_g, cp_c
            torch.cuda.empty_cache()


if __name__ == "__main__" and sys.argv[1:] == ["logits"]:
    _bf16_logit_readings()
elif __name__ == "__main__":
    # The readings behind BF16_GRAD_ROW, on the card: for each bfloat16
    # case of test_flash_attention_backward_matches_plain_autograd (and
    # Yi-6B's train shape) over six seeds, grad_rows_beyond_budget of dq,
    # dk and dv
    # against the plain version's autograd (and, beside them, the same
    # with no rounding budget); then the same for three
    # faults: the kernel's dk and dv of the last KV tile (64 keys)
    # zeroed; against a plain version whose causal mask hides the
    # diagonal key (causal); against one that hides the last key from
    # every row (not causal, S > 1).
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_grad_budget, flash_attention_ref,
        grad_rows_beyond_budget)

    dev = torch.device("cuda")
    cases = [(1, 1, 4, 4, 64), (2, 127, 8, 2, 80), (1, 1000, 8, 1, 128),
             (2, 127, 8, 1, 300), (1, 1000, 4, 1, 64), (2, 127, 4, 4, 128),
             (2, 4096, 32, 4, 128)]

    def rels(got, want, budgets):
        return [round(grad_rows_beyond_budget(g, r, b), 5)
                for g, r, b in zip(got, want, budgets)]

    for B, S, Hq, Hkv, D in cases:
        for causal in (True, False):
            sound, bare = [], []
            for seed in range(6):
                q, k, v = _attn_inputs(dev, B, S, S, Hq, Hkv, D,
                                       torch.bfloat16, seed)
                w = torch.randn((B, S, Hq, D), device=dev,
                                generator=torch.Generator(
                                    device=dev).manual_seed(seed))
                got = _flash_grads(flash_attention, q, k, v, causal, w)[1]
                want = _flash_grads(flash_attention_ref, q, k, v, causal,
                                    w)[1]
                bud = flash_attention_grad_budget(
                    q, k, v, w.to(torch.bfloat16), causal=causal)
                sound.append(rels(got, want, bud))
                bare.append(rels(got, want, (0, 0, 0)))
            tile = [t.clone() for t in got]
            for t in tile[1:]:
                t[:, -64:] = 0
            faults = {"last KV tile's dk dv zeroed": rels(tile, want, bud)}
            if causal:
                faults["diagonal key dropped"] = rels(got, _flash_grads(
                    _ref_without_the_diagonal, q, k, v, causal, w)[1], bud)
            elif S > 1:
                faults["last key dropped"] = rels(got, _flash_grads(
                    _ref_without_the_last_key, q, k, v, causal, w)[1], bud)
            print(f"bf16 B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal="
                  f"{causal}: per-row dq dk dv beyond the budget, sound by "
                  f"seed {sound}; faults {faults}; with no budget, sound "
                  f"{bare}", flush=True)
            del q, k, v, w, got, want, tile, bud
            torch.cuda.empty_cache()
