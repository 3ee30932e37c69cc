"""Plain reference of the configurations' optimizer: Adafactor without a
first moment (Shazeer and Stern, arXiv:1804.04235, with beta1 = 0), in
float32, with a warmup-cosine learning rate.

At step t (from 1), with beta_t = 1 - t^(-decay) and eps = 1e-30, a
matrix leaf (rank >= 2) keeps the means of g^2 + eps over its last axis
(row) and over its second-last (col); any other leaf keeps g^2 + eps
itself; each mean moves as s <- beta_t s + (1 - beta_t) new.  The update
is u = g / (sqrt(v) + 1e-8) with v = row col / (mean(row) + eps) for a
matrix and v = s otherwise, divided by max(1, RMS(u)); then
p <- p - lr_t u.  lr_t rises linearly to ``peak_lr`` over ``warmup``
steps, then falls along a half cosine to a tenth of it at ``total``.
"""
from __future__ import annotations

import math
from typing import List

import torch

DECAY, EPS, EPS_U = 0.8, 1e-30, 1e-8


def lr_at(step: int, peak: float, warmup: int, total: int) -> float:
    if step < warmup:
        return peak * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (0.1 + 0.45 * (1.0 + math.cos(math.pi * prog)))


def init(p: torch.Tensor):
    if p.dim() >= 2:
        return [torch.zeros(p.shape[:-1], device=p.device),
                torch.zeros(p.shape[:-2] + p.shape[-1:], device=p.device)]
    return [torch.zeros_like(p, dtype=torch.float32)]


@torch.no_grad()
def update_(p: torch.Tensor, g: torch.Tensor, s: List[torch.Tensor],
            step: int, lr: float) -> None:
    """One step on one leaf, in place on ``p`` and ``s``."""
    beta = 1.0 - step ** (-DECAY)
    g = g.float()
    g2 = g.square() + EPS
    if p.dim() >= 2:
        s[0].mul_(beta).add_((1 - beta) * g2.mean(-1))
        s[1].mul_(beta).add_((1 - beta) * g2.mean(-2))
        del g2
        v = (s[0][..., :, None] * s[1][..., None, :]) / (
            s[0].mean(-1, keepdim=True)[..., None] + EPS)
    else:
        s[0].mul_(beta).add_((1 - beta) * g2)
        v = s[0].clone()
    u = g / (v.sqrt_() + EPS_U)
    del v
    u = u / max(1.0, float(u.square().mean().sqrt()))
    p.sub_(lr * u)
