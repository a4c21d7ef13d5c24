"""Inner optimizer: AdamW (paper §IV: lr 4e-4, weight decay 0.1), the
counterpart of `repro/optim/adamw.py`: decoupled weight decay, bias
correction ``1 - b**count`` in f32, global-norm clip.

The JAX trainer vmaps one worker's update over the worker axis; here every
leaf carries the worker axis M in front and one update covers every worker:
the clip norm is taken per worker, and `count` is (M,).
The update is IN PLACE on params and moments (the JAX version returns new
trees): together they are the trainer's largest tensors, and nothing reads
their old values.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.tree import leaves_with_path, tree_leaves, tree_map


class AdamWState(NamedTuple):
    mu: object
    nu: object
    count: torch.Tensor


def adamw_init(params_stack) -> AdamWState:
    """Zero f32 moments shaped like the worker-stacked `params_stack`;
    `count` is (M,) int32."""
    first = tree_leaves(params_stack)[0]
    zeros = lambda: tree_map(  # noqa: E731
        lambda p: torch.zeros_like(p, dtype=torch.float32), params_stack)
    return AdamWState(mu=zeros(), nu=zeros(),
                      count=torch.zeros(first.shape[:1], dtype=torch.int32,
                                        device=first.device))


def global_norm(tree) -> torch.Tensor:
    """Per worker, sqrt of the sum of squares over every leaf: (M,)."""
    total = 0.0
    for g in tree_leaves(tree):
        total = total + g.to(torch.float32).square().flatten(1).sum(1)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr, *, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0) -> AdamWState:
    """Update the worker-stacked `params` and the moments in place; returns
    the new state. `lr` may be a float or a 0-d tensor (the schedule's)."""
    count = state.count + 1
    scale = None
    if clip_norm is not None:
        gn = global_norm(grads)
        scale = torch.clamp(clip_norm / (gn + 1e-9), max=1.0)
    c1 = 1 - b1 ** count.to(torch.float32)
    c2 = 1 - b2 ** count.to(torch.float32)
    g_by_path = dict(leaves_with_path(grads))
    mu_by_path = dict(leaves_with_path(state.mu))
    nu_by_path = dict(leaves_with_path(state.nu))

    def lead(x, ndim):
        # a per-worker (M,) factor broadcast over one leaf's dims
        return x.reshape(x.shape + (1,) * (ndim - x.dim()))

    for path, p in leaves_with_path(params):
        g = g_by_path[path].to(torch.float32)
        if scale is not None:
            g = g * lead(scale, g.dim())
        m, v = mu_by_path[path], nu_by_path[path]
        m_new = b1 * m.to(torch.float32) + (1 - b1) * g
        v_new = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g)
        mhat = m_new / lead(c1, p.dim())
        vhat = v_new / lead(c2, p.dim())
        step = mhat / (torch.sqrt(vhat) + eps) \
            + weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * step)
        m.copy_(m_new)
        v.copy_(v_new)
    return AdamWState(mu=state.mu, nu=state.nu, count=count)
