"""Plain PyTorch version of the selective_scan kernel: the Mamba-1
recurrence as a loop over time, in float32."""
from __future__ import annotations

import torch


def selective_scan_ref(dt, x, A, Bt, Ct, h0):
    """dt, x: (B, L, Din); A: (Din, N); Bt, Ct: (B, L, N);
    h0: (B, Din, N).  Returns (y (B, L, Din) f32, h_last (B, Din, N))::

        h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) (outer) B_t
        y_t = sum_n h_t[:, n] * C_t[n]
    """
    dt, x, A, Bt, Ct = (t.float() for t in (dt, x, A, Bt, Ct))
    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        dtt = dt[:, t]
        dA = torch.exp(dtt[..., None] * A)
        h = dA * h + (dtt * x[:, t])[..., None] * Bt[:, t, None, :]
        ys.append(torch.einsum("bhn,bn->bh", h, Ct[:, t]))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros(x.shape)
    return y, h
