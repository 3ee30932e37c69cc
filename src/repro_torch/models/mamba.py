"""Mamba-1 and Mamba-2 (SSD) blocks (counterpart of
``repro.models.mamba``).

Mamba-1's selective scan ``_mamba1_scan_y`` is one launch of the
hand-written ``selective_scan`` kernel on the card (the state stays in
registers across the whole sequence; under autograd, one launch of its
backward kernel too) and its plain float32 loop on the CPU.  The JAX
package's chunking of that scan is a TPU working-set device; the kernel
needs none, so ``ssm.chunk`` is not read there.

Mamba-2's SSD (``_ssd_chunked``) is plain PyTorch, as in the JAX
package, which has no Pallas kernel for it: the chunk decomposition of
the Mamba-2 paper (section 6), with every chunk's intra-chunk terms and
state contribution computed in one batched pass and only the carry of
the state across chunks in a Python loop (``lax.scan``'s order).

Both blocks expose, with the JAX package's names and layouts:
  mamba{1,2}_init(gen, ssm, d_model, ...)       -> params (stacked)
  mamba{1,2}_forward(params, x, ssm)            -> y          (prefill)
  mamba{1,2}_init_state(ssm, d_model, B)        -> state      (decode)
  mamba{1,2}_decode_step(params, x_t, state, ssm) -> (y_t, state)
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.models.layers import dense_init, rms_norm

# ---------------------------------------------------------------------------
# Depthwise causal conv1d (d_conv taps) as shift-and-add
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """x: (B, L, C); w: (K, C); b: (C,). Causal depthwise conv."""
    K = w.shape[0]
    out = x * w[K - 1]
    for k in range(1, K):
        shifted = F.pad(x, (0, 0, k, 0))[:, :-k]
        out = out + shifted * w[K - 1 - k]
    return out + b


def conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. x_t: (B, C); conv_state: (B, K-1, C)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window, w) + b
    return y, window[:, 1:]


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba): per-channel decay selective scan
# ---------------------------------------------------------------------------


def mamba1_init(generator: torch.Generator, ssm: SSMConfig, d_model: int,
                dtype=torch.float32, *, layers: int) -> dict:
    """Parameters of ``layers`` blocks stacked on a leading axis (the
    layout ``jax.vmap`` of the JAX init gives), drawn on the generator's
    device."""
    d_in = ssm.expand * d_model
    dt_rank = max(1, math.ceil(d_model / 16))
    dev = generator.device
    lead = (layers,)

    def dense(shape, scale=None):
        s = scale if scale is not None else shape[0] ** -0.5
        return dense_init(generator, lead + shape, dtype=dtype, scale=s)

    A = torch.arange(1, ssm.d_state + 1, dtype=torch.float32,
                     device=dev).repeat(lead + (d_in, 1))
    u = torch.rand(lead + (d_in,), generator=generator, dtype=torch.float32,
                   device=dev)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001))
                        + math.log(0.001))
    # inverse softplus so softplus(dt_bias) == dt_init
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    return {
        "in_proj": dense((d_model, 2 * d_in)),
        "conv_w": dense((ssm.d_conv, d_in), scale=ssm.d_conv ** -0.5),
        "conv_b": torch.zeros(lead + (d_in,), dtype=dtype, device=dev),
        "x_proj": dense((d_in, dt_rank + 2 * ssm.d_state)),
        "dt_proj": dense((dt_rank, d_in), scale=dt_rank ** -0.5),
        "dt_bias": dt_bias,
        "A_log": torch.log(A),
        "D": torch.ones(lead + (d_in,), dtype=torch.float32, device=dev),
        "out_proj": dense((d_in, d_model)),
    }


def _mamba1_scan_y(dt: torch.Tensor, x: torch.Tensor, A: torch.Tensor,
                   Bt: torch.Tensor, Ct: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, emitting
    y_t = <h_t, C_t> directly; one ``selective_scan`` launch on the card.

    dt, x: (B, L, Din); A: (Din, N); Bt, Ct: (B, L, N); h0: (B, Din, N).
    Returns (y: (B, L, Din) f32, h_last).
    """
    return selective_scan(*(t.float().contiguous()
                            for t in (dt, x, A, Bt, Ct, h0)))


def mamba1_core(params: dict, x: torch.Tensor, ssm: SSMConfig,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, d_in) post-conv. Returns (y, h_last)."""
    B, L, Din = x.shape
    N = ssm.d_state
    dt_rank = params["dt_proj"].shape[0]
    xdbc = x @ params["x_proj"]                 # (B, L, dt_rank + 2N)
    dt = F.softplus((xdbc[..., :dt_rank] @ params["dt_proj"]).float()
                    + params["dt_bias"])        # (B, L, Din)
    Bt = xdbc[..., dt_rank:dt_rank + N].float()
    Ct = xdbc[..., dt_rank + N:].float()
    A = -torch.exp(params["A_log"])             # (Din, N)
    if h0 is None:
        h0 = torch.zeros((B, Din, N), dtype=torch.float32, device=x.device)
    y, h_last = _mamba1_scan_y(dt, x.float(), A, Bt, Ct, h0)
    y = y + params["D"] * x.float()
    return y.to(x.dtype), h_last


def mamba1_forward(params: dict, x: torch.Tensor, ssm: SSMConfig,
                   return_state: bool = False):
    """Full block: x (B, L, d_model) -> (B, L, d_model) [, decode state]."""
    d_in = params["conv_w"].shape[1]
    K = params["conv_w"].shape[0]
    xz = x @ params["in_proj"]
    xi_pre, z = xz[..., :d_in], xz[..., d_in:]
    xi = causal_conv1d(xi_pre, params["conv_w"], params["conv_b"])
    xi = F.silu(xi.float()).to(x.dtype)
    y, h_last = mamba1_core(params, xi, ssm)
    y = y * F.silu(z.float()).to(x.dtype)
    out = y @ params["out_proj"]
    if return_state:
        conv_state = xi_pre[:, -(K - 1):] if K > 1 else xi_pre[:, :0]
        return out, {"conv": conv_state.contiguous(), "h": h_last}
    return out


def mamba1_init_state(ssm: SSMConfig, d_model: int, batch: int,
                      dtype=torch.float32, *, device=None) -> dict:
    d_in = ssm.expand * d_model
    return {
        "conv": torch.zeros((batch, ssm.d_conv - 1, d_in), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, d_in, ssm.d_state), dtype=torch.float32,
                         device=device),
    }


def mamba1_decode_step(params: dict, x_t: torch.Tensor, state: dict,
                       ssm: SSMConfig) -> Tuple[torch.Tensor, dict]:
    """x_t: (B, d_model) -> (y_t: (B, d_model), state)."""
    d_in = params["conv_w"].shape[1]
    N = ssm.d_state
    dt_rank = params["dt_proj"].shape[0]
    xz = x_t @ params["in_proj"]
    xi, z = xz[..., :d_in], xz[..., d_in:]
    xi, conv_state = conv_step(xi, state["conv"], params["conv_w"],
                               params["conv_b"])
    xi = F.silu(xi.float()).to(x_t.dtype)
    xdbc = xi @ params["x_proj"]
    dt = F.softplus((xdbc[..., :dt_rank] @ params["dt_proj"]).float()
                    + params["dt_bias"])        # (B, Din)
    Bt = xdbc[..., dt_rank:dt_rank + N].float()
    Ct = xdbc[..., dt_rank + N:].float()
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt[..., None] * A)           # (B, Din, N)
    h = dA * state["h"] + (dt * xi.float())[..., None] * Bt[:, None, :]
    y = torch.einsum("bhn,bn->bh", h, Ct) + params["D"] * xi.float()
    y = y.to(x_t.dtype) * F.silu(z.float()).to(x_t.dtype)
    return y @ params["out_proj"], {"conv": conv_state, "h": h}


# ---------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2): per-head scalar decay, chunked matmul form
# ---------------------------------------------------------------------------


def mamba2_init(generator: torch.Generator, ssm: SSMConfig, d_model: int,
                dtype=torch.float32, *, lead: Tuple[int, ...] = ()) -> dict:
    """Parameters of one block, or of ``lead`` stacked blocks, drawn on
    the generator's device; ``A_log``, ``D`` and ``dt_bias`` are float32
    whatever ``dtype``."""
    d_in = ssm.expand * d_model
    nheads = d_in // ssm.headdim
    conv_dim = d_in + 2 * ssm.d_state
    dev = generator.device
    lead = tuple(lead)

    def dense(shape, scale=None):
        s = scale if scale is not None else shape[0] ** -0.5
        return dense_init(generator, lead + shape, dtype=dtype, scale=s)

    A = torch.arange(1, nheads + 1, dtype=torch.float32,
                     device=dev).repeat(lead + (1,))
    u = torch.rand(lead + (nheads,), generator=generator,
                   dtype=torch.float32, device=dev)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001))
                        + math.log(0.001))
    return {
        "in_proj": dense((d_model, 2 * d_in + 2 * ssm.d_state + nheads)),
        "conv_w": dense((ssm.d_conv, conv_dim), scale=ssm.d_conv ** -0.5),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(A),
        "D": torch.ones(lead + (nheads,), dtype=torch.float32, device=dev),
        # inverse softplus so softplus(dt_bias) == dt_init
        "dt_bias": dt_init + torch.log(-torch.expm1(-dt_init)),
        "norm_w": torch.ones(lead + (d_in,), dtype=dtype, device=dev),
        "out_proj": dense((d_in, d_model)),
    }


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bt: torch.Tensor, Ct: torch.Tensor, chunk: int,
                 h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunk decomposition (Mamba-2 paper section 6), in float32.

    x: (B, L, H, P); dt: (B, L, H); A: (H,) negative; Bt, Ct: (B, L, N);
    h0: (B, H, N, P). Returns (y: (B, L, H, P), h_last).  Within a chunk,
    y_t = sum_{s<=t} C_t.B_s exp(cum_t - cum_s) dt_s x_s (the intra-chunk
    scores) + exp(cum_t) C_t.h (the carried state), and the state moves
    on as h' = exp(cum_last) h + sum_s exp(cum_last - cum_s) dt_s B_s x_s.
    """
    B, L, H, P = x.shape
    N = Bt.shape[-1]
    chunk = min(chunk, L)
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, Bt, Ct = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bt, Ct))
    nC = x.shape[1] // chunk
    xc = x.float().reshape(B, nC, chunk, H, P)
    dtc = dt.reshape(B, nC, chunk, H)
    Bc, Cc = (t.reshape(B, nC, chunk, N) for t in (Bt, Ct))
    cum = torch.cumsum(dtc * A, dim=2)            # (B, nC, c, H) log-decay
    # intra-chunk: scores[t, s] = C_t.B_s * exp(cum_t - cum_s) * dt_s; the
    # upper triangle is masked before the exp, which would overflow there
    above = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).triu(1)
    lmat = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill(
        above[:, :, None], float("-inf")).exp()   # (B, nC, t, s, H)
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    scores = cb[..., None] * lmat * dtc[:, :, None, :, :]
    y = torch.einsum("bctsh,bcshp->bcthp", scores, xc)
    # each chunk's contribution to the state at its end
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)        # (B, nC, c, H)
    upd = torch.einsum("bcsn,bcshp->bchnp", Bc,
                       (decay_to_end * dtc)[..., None] * xc)
    chunk_decay = torch.exp(cum[:, :, -1])[..., None, None]  # (B, nC, H,1,1)
    h, h_in = h0, []
    for c in range(nC):                           # the carry: lax.scan's
        h_in.append(h)
        h = chunk_decay[:, c] * h + upd[:, c]
    # inter-chunk: the state each chunk starts from, decayed to step t
    y = y + torch.einsum("bctn,bchnp->bcthp", Cc,
                         torch.stack(h_in, 1)) * torch.exp(cum)[..., None]
    return y.reshape(B, nC * chunk, H, P)[:, :L], h


def mamba2_forward(params: dict, x: torch.Tensor, ssm: SSMConfig,
                   return_state: bool = False):
    """Full Mamba-2 block: x (B, L, d_model) -> (B, L, d_model) [, decode
    state]."""
    B, L, _ = x.shape
    d_in = params["norm_w"].shape[-1]
    nheads = params["A_log"].shape[-1]
    P, N = ssm.headdim, ssm.d_state
    K = params["conv_w"].shape[0]
    zxbcdt = x @ params["in_proj"]
    z = zxbcdt[..., :d_in]
    xbc_pre = zxbcdt[..., d_in:d_in + d_in + 2 * N]
    dt_raw = zxbcdt[..., -nheads:]
    xbc = causal_conv1d(xbc_pre, params["conv_w"], params["conv_b"])
    xbc = F.silu(xbc.float()).to(x.dtype)
    xi = xbc[..., :d_in].reshape(B, L, nheads, P)
    Bt = xbc[..., d_in:d_in + N].float()
    Ct = xbc[..., d_in + N:].float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    h0 = torch.zeros((B, nheads, N, P), dtype=torch.float32, device=x.device)
    y, h_last = _ssd_chunked(xi, dt, A, Bt, Ct, ssm.chunk, h0)
    y = y + params["D"][:, None] * xi.float()
    y = y.reshape(B, L, d_in).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), params["norm_w"])
    out = y @ params["out_proj"]
    if return_state:
        conv_state = xbc_pre[:, -(K - 1):] if K > 1 else xbc_pre[:, :0]
        return out, {"conv": conv_state.contiguous(), "h": h_last}
    return out


def mamba2_init_state(ssm: SSMConfig, d_model: int, batch: int,
                      dtype=torch.float32, *, device=None) -> dict:
    d_in = ssm.expand * d_model
    nheads = d_in // ssm.headdim
    conv_dim = d_in + 2 * ssm.d_state
    return {
        "conv": torch.zeros((batch, ssm.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, nheads, ssm.d_state, ssm.headdim),
                         dtype=torch.float32, device=device),
    }


def mamba2_decode_step(params: dict, x_t: torch.Tensor, state: dict,
                       ssm: SSMConfig) -> Tuple[torch.Tensor, dict]:
    """x_t: (B, d_model) -> (y_t: (B, d_model), state)."""
    B = x_t.shape[0]
    d_in = params["norm_w"].shape[-1]
    nheads = params["A_log"].shape[-1]
    P, N = ssm.headdim, ssm.d_state
    zxbcdt = x_t @ params["in_proj"]
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_in + 2 * N]
    dt_raw = zxbcdt[..., -nheads:]
    xbc, conv_state = conv_step(xbc, state["conv"], params["conv_w"],
                                params["conv_b"])
    xbc = F.silu(xbc.float()).to(x_t.dtype)
    xi = xbc[..., :d_in].reshape(B, nheads, P).float()
    Bt = xbc[..., d_in:d_in + N].float()
    Ct = xbc[..., d_in + N:].float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])      # (B, H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)
    h = (decay[..., None, None] * state["h"]
         + torch.einsum("bh,bn,bhp->bhnp", dt, Bt, xi))
    y = torch.einsum("bn,bhnp->bhp", Ct, h) + params["D"][:, None] * xi
    y = y.reshape(B, d_in).to(x_t.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x_t.dtype), params["norm_w"])
    return y @ params["out_proj"], {"conv": conv_state, "h": h}
