"""Plain PyTorch version of the RG-LRU scan kernel: h_t = a_t h_{t-1} + b_t
with the carry h0 folded into the first step (``b_0 + a_0 h0``), composed
in `jax.lax.associative_scan`'s order (`repro/kernels/rglru_scan/ref.py`):
pairs combined, the half-length scan recursed, the even positions filled
in from it, so its f32 rounding follows JAX's on the CPU. Differentiable.
"""
from __future__ import annotations

import torch


def _combine(e1, e2):
    (a1, b1), (a2, b2) = e1, e2
    return a2 * a1, a2 * b1 + b2


def _interleave(even, odd):
    """Interleave along the time axis: even[0], odd[0], even[1], ..."""
    B, _, D = even.shape
    out = even.new_empty((B, even.shape[1] + odd.shape[1], D))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _scan(a, b):
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = _scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                          (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    even = (torch.cat([a[:, :1], even[0]], dim=1),
            torch.cat([b[:, :1], even[1]], dim=1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def lru_scan_ref(a, b, h0=None):
    """a, b: (B, T, D) f32; h0: (B, D) or None. Returns h (B, T, D)."""
    if h0 is not None:
        b = torch.cat([(b[:, 0] + a[:, 0] * h0.to(b.dtype))[:, None],
                       b[:, 1:]], dim=1)
    return _scan(a, b)[1]
