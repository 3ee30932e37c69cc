"""The port's gradient collectives against the JAX package's (CPU).

The JAX functions run as the distributed trainer runs them: inside a
``shard_map`` over the 8 fake CPU devices, each device holding one
worker's gradient tree.  The port's take the 8 workers' trees as a list
(or one tree with a leading worker axis).  Bars:

* ``bucketed_psum``: the sum within 1e-6 relative (the two sum 8 values
  in different orders);
* ``quantized_psum_grads`` (8 and 16 bits): each worker's residual, so
  each sent value, within 1e-6, and the sum within 1e-6 relative, over
  two calls with error feedback, with inputs that sit on rounding
  halves (``round`` and the fp16 cast round half to even on both);
* ``topk_psum_grads``: the same set of sent coordinates per worker,
  ties at the threshold included, and the same sum;
* ``grad_payload_bytes``: equal for every mode.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.dist import collectives as JC
from repro.dist.sharding import shard_map
from repro_torch.dist import collectives as TC

W = 8
SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 2)}}

needs8 = pytest.mark.skipif(len(jax.devices()) < W,
                            reason="needs 8 (fake) devices")


def _tree(fn, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v) for k, v in shapes.items()}
    return fn(shapes)


def _workers(seed, special=None):
    """W per-worker numpy trees; ``special(w, tree)`` may overwrite."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(W):
        t = _tree(lambda s: rng.normal(size=s).astype(np.float32))
        if special is not None:
            special(w, t)
        out.append(t)
    return out


def _stack(trees):
    return jax.tree.map(lambda *xs: np.stack(xs), *trees)


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy()


def _jax_fn(fn, lossy):
    """``fn(g, e, "dp")`` per worker under shard_map over 8 devices,
    jitted once (its calls share the shapes)."""
    mesh = Mesh(np.asarray(jax.devices()[:W]), ("dp",))
    un = lambda t: jax.tree.map(lambda x: x[0], t)

    def body(g, e):
        if not lossy:
            return fn(un(g), "dp")
        red, new_err = fn(un(g), un(e), "dp")
        return red, jax.tree.map(lambda x: x[None], new_err)

    out_specs = (P(), P("dp")) if lossy else P()
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")),
                          out_specs=out_specs, check_vma=False))

    def run(grads, err=None):
        e = err if err is not None else jax.tree.map(np.zeros_like, grads)
        return jax.tree.map(np.asarray, f(grads, e))
    return run


def _close_rel(got, want, tol=1e-6):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=tol,
                                   atol=tol * np.abs(b).max())


@needs8
@pytest.mark.parametrize("bucket_bytes", [4 << 20, 64])
def test_bucketed_matches_jax(bucket_bytes):
    trees = _workers(0)
    want = _jax_fn(lambda g, ax: JC.bucketed_psum(
        g, ax, bucket_bytes=bucket_bytes), False)(_stack(trees))
    got = TC.bucketed_psum([_torch(t) for t in trees],
                           bucket_bytes=bucket_bytes)
    _close_rel(_np(got), want)
    stacked = TC.bucketed_psum(_torch(_stack(trees)),
                               bucket_bytes=bucket_bytes)
    _close_rel(_np(stacked), want)


def _halves(w, t):
    """Worker 0: max |e| 127, so the int8 scale is 1 and x.5 values sit
    on rounding halves; worker 1: fp16 midpoints (1 + 2^-11 and the
    like)."""
    if w == 0:
        t["a"][:] = np.array([[127.0, 0.5, 1.5, 2.5], [-0.5, -1.5, 3.5,
                             -2.5], [4.5, 0.25, -126.5, 5.5]], np.float32)
    if w == 1:
        mid = np.float32(1.0 + 2.0 ** -11)
        t["b"]["c"][:] = np.array([mid, -mid, 3 * mid, 2.0 + 2.0 ** -10,
                                   0.5 + 2.0 ** -12], np.float32)


@needs8
@pytest.mark.parametrize("bits", [8, 16])
def test_quantized_matches_jax(bits):
    trees = _workers(1, _halves)
    err_j = err_t = None
    jax_fn = _jax_fn(lambda g, e, ax: JC.quantized_psum_grads(
        g, e, ax, bits=bits), True)
    for call in range(2):               # the second feeds the residual
        red_j, err_j = jax_fn(_stack(trees), err_j)
        red_t, err_t = TC.quantized_psum_grads(
            [_torch(t) for t in trees], err_t, bits=bits)
        for w in range(W):
            for a, b in zip(jax.tree.leaves(_np(err_t[w])),
                            jax.tree.leaves(err_j)):
                np.testing.assert_allclose(a, b[w], atol=1e-6, rtol=0)
        _close_rel(_np(red_t), red_j)
        trees = _workers(2 + call, _halves)
    if bits == 8:    # worker 0's halves went to even, as jnp.round sends
        sent = _torch(_workers(1, _halves)[0])["a"].reshape(-1)[:12]
        assert torch.equal(torch.round(sent), torch.tensor(
            [127., 0., 2., 2., -0., -2., 4., -2., 4., 0., -126., 6.]))


def _ties(w, t):
    """Every worker: magnitudes 5 (x2), 3 (x4), then small ones, so a
    k of 4 lands inside the tie group at 3 and sends all six."""
    flat = np.concatenate([t["a"].ravel(), t["b"]["c"],
                           t["b"]["d"].ravel()])
    flat[:] = np.linspace(-0.9, 0.9, flat.size, dtype=np.float32)
    flat[[w, w + 5]] = [5.0, -5.0]
    flat[[w + 1, w + 7, w + 11, w + 13]] = [3.0, -3.0, 3.0, -3.0]
    t["a"][:] = flat[:12].reshape(3, 4)
    t["b"]["c"][:] = flat[12:17]
    t["b"]["d"][:] = flat[17:].reshape(2, 2, 2)


@needs8
@pytest.mark.parametrize("frac,special", [(4 / 25, _ties), (0.2, None),
                                          (1.0, None)])
def test_topk_matches_jax(frac, special):
    trees = _workers(4, special)
    err_j = err_t = None
    jax_fn = _jax_fn(lambda g, e, ax: JC.topk_psum_grads(
        g, e, ax, frac=frac), True)
    for call in range(2):
        red_j, err_j = jax_fn(_stack(trees), err_j)
        red_t, err_t = TC.topk_psum_grads([_torch(t) for t in trees],
                                          err_t, frac=frac)
        for w in range(W):
            for a, b in zip(jax.tree.leaves(_np(err_t[w])),
                            jax.tree.leaves(err_j)):
                # a coordinate is either sent (residual 0) or kept whole
                np.testing.assert_array_equal(a == 0, b[w] == 0)
                np.testing.assert_allclose(a, b[w], atol=1e-6, rtol=0)
        _close_rel(_np(red_t), red_j)
    if special is _ties:
        e0 = _np(TC.topk_psum_grads([_torch(_workers(4, _ties)[0])], None,
                                    frac=frac)[1][0])
        flat = np.concatenate([e0["a"].ravel(), e0["b"]["c"],
                               e0["b"]["d"].ravel()])
        assert (flat == 0).sum() == 6      # k = 4, ties at 3 sent too


def test_payload_bytes_match_jax():
    tree = _tree(lambda s: np.zeros(s, np.float32))
    for mode, kw in (("bucketed", {}), ("quantized", {"bits": 8}),
                     ("quantized", {"bits": 16}), ("topk", {"frac": 0.01}),
                     ("topk", {"frac": 0.3})):
        assert TC.grad_payload_bytes(_torch(tree), mode, **kw) == \
            JC.grad_payload_bytes(tree, mode, **kw)
    with pytest.raises(ValueError, match="unknown collective"):
        TC.grad_payload_bytes(_torch(tree), "ring")
    with pytest.raises(ValueError, match="bits"):
        TC.quantized_psum_grads([_torch(tree)], None, bits=4)
    with pytest.raises(ValueError, match="frac"):
        TC.topk_psum_grads([_torch(tree)], None, frac=0.0)
