"""Outer optimizer (DiLoCo family): SGD with Nesterov momentum on
pseudo-gradients, per leaf (counterpart of `repro/core/outer_opt.py`):

    m      <- mu * m + Delta
    theta  <- theta + lr * (Delta + mu * m)        (Nesterov)

Under `fused_updates` the engine replaces this loop with the fused
`nesterov_2d` kernel over the flat fragment plane (kernels/outer_update).
"""
from __future__ import annotations

from repro_torch.core.tree import tree_map


def nesterov_update(theta, momentum, delta, *, lr: float, mu: float):
    """One outer step on a (fragment) tree; None leaves pass through.
    Returns new (theta, momentum) trees."""

    def upd(t, m, d):
        m_new = mu * m + d
        return t + lr * (d + mu * m_new), m_new

    out = tree_map(upd, theta, momentum, delta)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)
