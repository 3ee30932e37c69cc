"""Mamba-1 block (counterpart of the Mamba-1 part of
``repro.models.mamba``; Mamba-2/SSD is not ported yet).

The selective scan ``_mamba1_scan_y`` is one launch of the hand-written
``selective_scan`` kernel on the card (the state stays in registers
across the whole sequence; under autograd, one launch of its backward
kernel too) and its plain float32 loop on the CPU.  The
JAX package's chunking of the scan is a TPU working-set device; the
kernel needs none, so ``ssm.chunk`` is not read here.

The block exposes, with the JAX package's names and layouts:
  mamba1_init(gen, ssm, d_model, layers=L)    -> L stacked params
  mamba1_forward(params, x, ssm)              -> y          (prefill)
  mamba1_init_state(ssm, d_model, B)          -> state      (decode)
  mamba1_decode_step(params, x_t, state, ssm) -> (y_t, state)
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.models.layers import dense_init

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
