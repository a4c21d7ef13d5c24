"""Plain PyTorch version of the flash_decode kernel: the same masked
softmax attention over the whole cache at once, in f32.

Like the TPU kernel (and unlike the JAX package's `flash_decode_ref`, which
goes through `gqa_attention` and gives the mean of V), a query row with no
valid key returns 0."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_decode_ref(q, k_cache, v_cache, kv_positions, q_position, *,
                     window: Optional[int] = None):
    """q: (B, H, hd); caches: (B, C, KV, hd); kv_positions: (B, C) int32
    (-1 = empty); q_position: (B,) int32. Returns (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qg = q.float().reshape(B, KV, G, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float())
    kvp = kv_positions.long()
    qp = q_position.long()[:, None]
    valid = (kvp >= 0) & (kvp <= qp)
    if window is not None:
        valid &= (qp - kvp) < window
    valid = valid[:, None, None, :]                    # (B, 1, 1, C)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    o = o / torch.where(l == 0.0, 1.0, l)
    return o.reshape(B, H, hd).to(q.dtype)
