"""Model parity of the PyTorch port against the JAX package.

* the plain ``temporal_attn`` (the CPU path of the kernel wrapper) is
  within 1e-5 of the JAX ``temporal_attn_ref`` and of the Pallas kernel
  in interpret mode, including targets with no valid neighbour (zero
  rows) and K and Dh past 32 and 128;
* ``gnn_embed`` and ``link_score`` are within 1e-5 for tgat, tgn,
  graphsage and gat, with the JAX weights loaded by ``params_from_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tgn_gdelt import gat, graphsage, tgat, tgn
from repro.kernels.temporal_attn.ops import temporal_attn_pallas
from repro.kernels.temporal_attn.ref import temporal_attn_ref as j_attn_ref
from repro.models import gnn as G
from repro.models.layers import time_encode as j_time_encode
from repro_torch.configs import tgn_gdelt as TC
from repro_torch.kernels.temporal_attn.ops import temporal_attn
from repro_torch.models import gnn as TG
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import time_encode

TOL = 1e-5


@pytest.mark.parametrize("n,k,h,dh", [(7, 10, 2, 50), (16, 3, 4, 8),
                                      (5, 1, 1, 33), (6, 33, 2, 150),
                                      (3, 64, 2, 256)])
def test_temporal_attn_plain_matches_jax_ref(n, k, h, dh):
    rng = np.random.default_rng(n * k)
    q = rng.normal(size=(n, h, dh)).astype(np.float32)
    kk = rng.normal(size=(n, k, h, dh)).astype(np.float32)
    v = rng.normal(size=(n, k, h, dh)).astype(np.float32)
    mask = rng.random((n, k)) < 0.6
    mask[0] = False                       # a target with no neighbour
    want = np.asarray(j_attn_ref(*(jnp.asarray(a) for a in (q, kk, v,
                                                            mask))))
    got = temporal_attn(*(torch.from_numpy(a) for a in (q, kk, v, mask)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert (got[0] == 0).all()
    # the Pallas body in interpret mode, at every K and Dh the card's
    # kernel takes
    pallas = np.asarray(temporal_attn_pallas(
        *(jnp.asarray(a) for a in (q, kk, v, mask))))
    np.testing.assert_allclose(got.numpy(), pallas, atol=TOL, rtol=0)


def test_time_encode_matches_jax():
    rng = np.random.default_rng(0)
    dt = rng.uniform(0, 5e4, (6, 4)).astype(np.float32)
    w = (1.0 / 10.0 ** np.linspace(0, 9, 10)).astype(np.float32)
    b = rng.normal(size=10).astype(np.float32)
    want = np.asarray(j_time_encode(jnp.asarray(dt), jnp.asarray(w),
                                    jnp.asarray(b)))
    got = time_encode(*(torch.from_numpy(a) for a in (dt, w, b)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def _hops(cfg, n0, rng):
    d_in = cfg.d_node + (cfg.d_memory if cfg.use_memory else 0)
    hops, n = [], n0
    for k in cfg.fanouts:
        mask = rng.random((n, k)) < 0.7
        mask[::5] = False
        hops.append({
            "dst_feat": rng.normal(size=(n, d_in)).astype(np.float32),
            "nbr_feat": rng.normal(size=(n, k, d_in)).astype(np.float32),
            "edge_feat": rng.normal(size=(n, k, cfg.d_edge)
                                    ).astype(np.float32),
            "dt": np.where(mask, rng.uniform(0, 500, (n, k)), 0.0
                           ).astype(np.float32),
            "mask": mask})
        n *= k
    return hops


@pytest.mark.parametrize("make", [tgat, tgn, graphsage, gat])
def test_gnn_embed_and_link_score_match_jax(make):
    small = dict(d_node=12, d_edge=10, d_time=8, d_hidden=16, d_memory=6)
    cfg = make(**small)
    tcfg = getattr(TC, make.__name__)(**small)
    jparams = G.init_params(cfg, jax.random.PRNGKey(3))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    hops = _hops(cfg, 6, np.random.default_rng(1))
    jh = [{k: jnp.asarray(v) for k, v in hop.items()} for hop in hops]
    th = [{k: torch.from_numpy(v) for k, v in hop.items()} for hop in hops]
    want = np.asarray(G.gnn_embed(jparams["gnn"], cfg, jh))
    got = TG.gnn_embed(tparams["gnn"], tcfg, th)
    assert got.shape == (6, cfg.d_hidden)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    ws = np.asarray(G.link_score(jparams["head"], jnp.asarray(want[:3]),
                                 jnp.asarray(want[3:])))
    ts = TG.link_score(tparams["head"], got[:3], got[3:])
    np.testing.assert_allclose(ts.numpy(), ws, atol=TOL, rtol=0)
