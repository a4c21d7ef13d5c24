"""Plain PyTorch version of the delay-compensation kernel (CoCoDC
Algorithm 1), the JAX package's `delay_comp_ref` in the same order of
operations:

    g      = sign * (theta_tl - theta_tp) / tau
    g_corr = g + lam * g * g * (theta_g - theta_tp) / H
    out    = theta_g + g_corr * tau

Operands broadcast (the global leaf comes as (1, ...) against the (M, ...)
worker stack); computed in f32, cast back to theta_tl's dtype.
"""
from __future__ import annotations

import torch


def delay_comp_ref(theta_tl, theta_tp, theta_g, *, tau, lam, H, sign=1.0):
    tl = theta_tl.to(torch.float32)
    tp = theta_tp.to(torch.float32)
    tg = theta_g.to(torch.float32)
    g = sign * (tl - tp) / tau
    g_corr = g + lam * g * g * (tg - tp) / H
    return (tg + g_corr * tau).to(theta_tl.dtype)
