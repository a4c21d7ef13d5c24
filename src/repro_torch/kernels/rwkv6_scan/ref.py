"""Plain PyTorch version of the WKV kernel: the JAX package's step loop
(`repro/models/rwkv6.py::wkv_scan_ref`), in f32, one step at a time:

    o_t = r_t @ (S + diag(u) k_t v_t^T)
    S   = diag(w_t) S + k_t v_t^T

Differentiable (the training forward runs it under autograd).
"""
from __future__ import annotations

import torch


def wkv_scan_ref(r, k, v, w, u, s0=None):
    """r, k, v, w: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd) f32 or
    None. Returns (o (B, T, H, hd) in r's dtype, sT (B, H, hd, hd) f32)."""
    B, T, H, hd = r.shape
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uu = u.float()[None, :, :, None]                     # (1, H, hd, 1)
    outs = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]   # (B, H, hd, hd)
        outs.append(torch.einsum("bhi,bhij->bhj", rf[:, t], s + uu * kv))
        s = wf[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1).to(r.dtype), s
