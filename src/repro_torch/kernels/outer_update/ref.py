"""Plain PyTorch versions of the fused outer-update kernels: the JAX
package's oracles (`repro/kernels/outer_update/ref.py`), in the same
per-element order of operations.

Scalars are f32: python numbers are rounded to f32 on the host first, and
device scalars (0-d tensors, e.g. the engine's overlap depth tau) are used
as they lie, so no scalar ever crosses to the device with a host sync.
"""
from __future__ import annotations

import numpy as np
import torch

DELIVER_MODES = ("blend", "compensate")


def f32(x):
    """A python number rounded to f32 (kept a python float), or a tensor
    cast to f32."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return float(np.float32(x))


def nesterov_ref(theta, momentum, delta, *, lr, mu):
    """One outer Nesterov step on same-shaped f32 tensors:

        m_new = mu * m + d
        t_new = t + lr * (d + mu * m_new)

    Returns ``(theta_new, momentum_new)``."""
    lr, mu = f32(lr), f32(mu)
    m_new = mu * momentum + delta
    t_new = theta + lr * (delta + mu * m_new)
    return t_new, m_new


def deliver_ref(local, snapshot, g, avail, *, mode: str, alpha=0.0,
                tau=1.0, lam=0.0, H=1.0, sign=1.0):
    """Fold the outer-updated global fragment `g` (rows, LANES) into every
    worker's local fragment `local` (M, rows, LANES), then keep `local` for
    offline workers (`avail` (M,), 0 = offline).

    mode="blend":      new = (1 - alpha) * local + alpha * g
    mode="compensate": gr  = sign * (local - snapshot) / tau
                       gc  = gr + lam * gr * gr * (g - snapshot) / H
                       new = g + gc * tau
    """
    if mode not in DELIVER_MODES:
        raise ValueError(f"unknown deliver mode {mode!r}; "
                         f"options: {DELIVER_MODES}")
    gb = g[None]
    if mode == "blend":
        alpha = f32(alpha)
        one = (1.0 - alpha if isinstance(alpha, torch.Tensor)
               else float(np.float32(1.0) - np.float32(alpha)))
        new = one * local + alpha * gb
    else:
        tau, lam, h, sign = f32(tau), f32(lam), f32(H), f32(sign)
        gr = sign * (local - snapshot) / tau
        gc = gr + lam * gr * gr * (gb - snapshot) / h
        new = gb + gc * tau
    keep = torch.as_tensor(avail, device=local.device).to(torch.float32) != 0
    return torch.where(keep.reshape((-1, 1, 1)), new, local)
