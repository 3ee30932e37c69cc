"""The port's cost trace (``repro_torch.launch.op_cost``), the counterpart
of ``repro.launch.hlo_cost``:

* ``tests/test_hlo_cost.py``'s scanned MLP (d 64, ff 256, L 4, V 128,
  B 4, S 32; the same loss and SGD step) in torch on the ``meta``
  device: the trace's FLOPs equal the analytic count exactly (every
  product of the forward, and two of each in the backward: 3 × the
  forward's) and lie within 2 % of ``hlo_cost.total_cost`` on the JAX
  program; one device moves no collective bytes;
* one case per byte rule: views free, a gather 2 × its result plus its
  indices, ``index_put_`` 2 × its updates plus its indices, an add its
  result plus both operands;
* live bytes: the peak of what the traced code holds at once, rounded
  to the allocator's 512 B;
* the kernels' meta paths: a flash call with ``q_offset`` charges
  exactly 4·D × the (query, key) pairs under its mask (counted here by
  brute force), its backward 10·D; the scan's forward and backward
  their formulas; a call on CPU tensors still takes the plain version
  (equal to ``ref.py``) and neither launches nor charges a kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_cost import total_cost
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.launch.op_cost import CostMode

D, FF, L, V, B, S = 64, 256, 4, 128, 4, 32


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def torch_mlp_step(params, tokens):
    """The reference's scanned MLP and SGD step, as eager torch ops."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    x = leaves["embed"][tokens.long()]
    for i in range(L):
        x = x + torch.relu(x @ leaves["w1"][i]) @ leaves["w2"][i]
    logits = x @ leaves["embed"].T
    loss = torch.log_softmax(logits, dim=-1)[..., 0].mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return {k: p - 0.1 * g for (k, p), g in zip(params.items(), grads)}


@pytest.fixture(scope="module")
def mlp_trace():
    params = {"embed": meta(V, D), "w1": meta(L, D, FF),
              "w2": meta(L, FF, D)}
    with CostMode() as trace:
        torch_mlp_step(params, meta(B, S, dtype=torch.int32))
    return trace


@pytest.fixture(scope="module")
def jax_mlp_flops():
    """``tests/test_hlo_cost.py``'s program, compiled on one device."""
    def init():
        k = jax.random.split(jax.random.PRNGKey(0), 3)
        return {"embed": jax.random.normal(k[0], (V, D)) * 0.02,
                "w1": jax.random.normal(k[1], (L, D, FF)) * 0.02,
                "w2": jax.random.normal(k[2], (L, FF, D)) * 0.02}

    def fwd(params, tokens):
        x = jnp.take(params["embed"], tokens, axis=0)

        def body(x, lp):
            w1, w2 = lp
            return x + jax.nn.relu(x @ w1) @ w2, None

        x, _ = jax.lax.scan(body, x, (params["w1"], params["w2"]))
        return x @ params["embed"].T

    def loss(params, tokens):
        return jnp.mean(jax.nn.log_softmax(fwd(params, tokens))[..., 0])

    def step(params, tokens):
        g = jax.grad(loss)(params, tokens)
        return jax.tree.map(lambda p, gg: p - 0.1 * gg, params, g)

    compiled = jax.jit(step).lower(
        jax.eval_shape(init),
        jax.ShapeDtypeStruct((B, S), jnp.int32)).compile()
    return total_cost(compiled.as_text())["flops"]


def test_mlp_flops_equal_the_analytic_count(mlp_trace):
    forward = L * 2 * (2 * B * S * D * FF) + 2 * B * S * D * V
    assert mlp_trace.total_cost()["flops"] == 3 * forward


def test_mlp_flops_within_2_percent_of_hlo_cost(mlp_trace, jax_mlp_flops):
    got = mlp_trace.total_cost()["flops"]
    assert abs(got / jax_mlp_flops - 1) <= 0.02, (got, jax_mlp_flops)


def test_mlp_has_no_collective_bytes_on_one_device(mlp_trace):
    cost = mlp_trace.total_cost()
    assert cost["collective_bytes"] == 0.0
    assert cost["bytes"] > 0 and cost["peak_live_bytes"] > 0


def _charged(fn, *args):
    with CostMode() as trace:
        fn(*args)
    return trace.total_cost()


@pytest.mark.parametrize("rule", ["views", "unsafe_view", "gather",
                                  "index_put", "add"])
def test_byte_rules(rule):
    x, y = meta(64, 32), meta(64, 32)
    idx = meta(10, dtype=torch.int64)
    if rule == "views":
        cost = _charged(lambda: x.view(32, 64).transpose(0, 1)[3:7]
                        .unsqueeze(0).expand(2, 4, 32).split(2, dim=1))
        assert cost["bytes"] == 0
    elif rule == "unsafe_view":
        # a 3-D matmul is a view, an mm and an ``_unsafe_view``, whose
        # schema does not mark it a view though it shares the mm's storage:
        # only the mm's operands and result are charged
        a, b = meta(2, 8, 16), meta(16, 32)
        with CostMode() as trace:
            a @ b
        cost = trace.total_cost()
        assert cost["bytes"] == (2 * 8 * 16 + 16 * 32 + 2 * 8 * 32) * 4
        assert cost["bytes"] == 5120
        assert cost["flops"] == 2 * 16 * 16 * 32
        assert trace.ops["_unsafe_view"][2] == 0
        return
    elif rule == "gather":
        cost = _charged(lambda: x[idx])
        assert cost["bytes"] == 2 * 10 * 32 * 4 + 10 * 8
    elif rule == "index_put":
        t = meta(64, 32)
        cost = _charged(lambda: t.index_put_((idx,), meta(10, 32)))
        assert cost["bytes"] == 2 * 10 * 32 * 4 + 10 * 8
    else:
        cost = _charged(lambda: x + y)
        assert cost["bytes"] == 3 * 64 * 32 * 4
    assert cost["flops"] == 0


def test_live_bytes_peak_and_release():
    x = meta(1000)                               # exists before: not counted

    def work():
        a = x * 2                                # 4,000 B -> 4,096
        b = a + 1                                # both live: 8,192
        del a
        return b * 3                             # b and the result: 8,192

    with CostMode() as trace:
        out = work()
    assert trace.peak_live_bytes == 2 * 4096
    assert trace.live_bytes == 4096              # only the result is left
    del out


def causal_pairs_by_count(sq, skv, causal, off):
    q_pos = np.arange(sq)[:, None] + off
    return int((np.arange(skv)[None, :] <= q_pos).sum()) if causal \
        else sq * skv


@pytest.mark.parametrize("sq,skv,off,causal", [
    (64, 256, 0, True), (64, 256, 64, True), (64, 256, 192, True),
    (64, 256, 300, True), (100, 100, None, True), (37, 90, None, True),
    (64, 256, None, False)])
def test_meta_flash_charges_pairs_under_its_mask(sq, skv, off, causal):
    Bq, Hq, Hkv, Dh = 2, 8, 2, 64
    q = meta(Bq, sq, Hq, Dh, dtype=torch.bfloat16, grad=True)
    k = meta(Bq, skv, Hkv, Dh, dtype=torch.bfloat16, grad=True)
    v = meta(Bq, skv, Hkv, Dh, dtype=torch.bfloat16, grad=True)
    runtime.reset_launch_counts()
    with CostMode() as fwd:
        out = flash_ops.flash_attention(q, k, v, causal=causal, q_offset=off)
    pairs = causal_pairs_by_count(sq, skv, causal,
                                  skv - sq if off is None else off)
    assert out.shape == q.shape and out.device.type == "meta"
    assert dict(fwd.kernel_calls) == {"flash_attention": 1}
    assert fwd.total_cost()["flops"] == 4 * Dh * Bq * Hq * pairs
    with CostMode() as bwd:
        torch.autograd.grad(out, (q, k, v), meta(*q.shape,
                                                 dtype=torch.bfloat16))
    assert dict(bwd.kernel_calls) == {"flash_attention_bwd": 1}
    assert bwd.total_cost()["flops"] == 10 * Dh * Bq * Hq * pairs
    assert runtime.launch_counts() == {}


def test_meta_flash_writes_what_the_kernel_writes():
    """Under autograd the forward also holds the row LSEs and the
    float32 output (bf16), as on the card."""
    q = meta(2, 128, 8, 64, dtype=torch.bfloat16, grad=True)
    k = meta(2, 128, 2, 64, dtype=torch.bfloat16, grad=True)
    with CostMode() as trace:
        out = flash_ops.flash_attention(q, k, k, causal=True)
    lse, o32 = 2 * 8 * 128 * 4, 2 * 128 * 8 * 64 * 4
    assert trace.live_bytes == (2 * 128 * 8 * 64 * 2) + lse + o32
    del out


def test_meta_scan_charges_its_formula():
    Bb, Lq, Din, N = 2, 130, 96, 16
    ins = [meta(Bb, Lq, Din, grad=True), meta(Bb, Lq, Din, grad=True),
           meta(Din, N, grad=True), meta(Bb, Lq, N, grad=True),
           meta(Bb, Lq, N, grad=True), meta(Bb, Din, N, grad=True)]
    with CostMode() as fwd:
        y, h = scan_ops.selective_scan(*ins)
    assert dict(fwd.kernel_calls) == {"selective_scan": 1}
    assert fwd.total_cost()["flops"] == 2 * Bb * Lq * Din * N
    with CostMode() as bwd:
        grads = torch.autograd.grad((y, h), ins, (meta(*y.shape),
                                                  meta(*h.shape)))
    assert dict(bwd.kernel_calls) == {"selective_scan_bwd": 1}
    assert bwd.total_cost()["flops"] == 4 * Bb * Lq * Din * N
    assert [g.shape for g in grads] == [t.shape for t in ins]


def test_cpu_calls_take_the_plain_version_and_charge_no_kernel():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 40, 4, 16, generator=g)
    k = torch.randn(1, 50, 2, 16, generator=g)
    v = torch.randn(1, 50, 2, 16, generator=g)
    sc = [torch.rand(1, 20, 8, generator=g), torch.randn(1, 20, 8,
                                                          generator=g),
          -torch.rand(8, 4, generator=g), torch.randn(1, 20, 4, generator=g),
          torch.randn(1, 20, 4, generator=g), torch.zeros(1, 8, 4)]
    runtime.reset_launch_counts()
    with CostMode() as trace:
        out = flash_ops.flash_attention(q, k, v, causal=True, q_offset=7)
        y, h = scan_ops.selective_scan(*sc)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, causal=True,
                                                        q_offset=7),
                               rtol=0, atol=0)
    y_ref, h_ref = selective_scan_ref(*sc)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(h, h_ref, rtol=0, atol=0)
    assert dict(trace.kernel_calls) == {}
    assert runtime.launch_counts() == {}
    assert trace.total_cost()["flops"] > 0    # the plain versions' products
