"""Public wrapper of flash_decode: the kernel for CUDA tensors, the plain
version for CPU tensors. Takes the models' (B, C, KV, hd) cache layer as it
lies (no transpose, no padding of C: the kernel masks the ragged tail).

Positions come shared — kv_positions (C,), q_position () — or per slot —
(B, C), (B,) — as in the JAX wrapper; shared ones are broadcast here."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import check_no_grad
from repro_torch.kernels.flash_decode.flash_decode import flash_decode_cuda
from repro_torch.kernels.flash_decode.ref import flash_decode_ref


def flash_decode(q, k_cache, v_cache, kv_positions, q_position, *,
                 window: Optional[int] = None, impl: str = "auto"):
    """q: (B, H, hd); caches: (B, C, KV, hd); kv_positions: (C,) or (B, C)
    int32 (-1 = empty); q_position: () or (B,) int32. Returns (B, H, hd).
    `impl`: "auto" = the kernel on CUDA, the plain version on CPU; "ref" =
    the plain version on either. The kernel has no backward, so "auto"
    raises if an input needs a gradient (on any device)."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r}; options: auto|ref")
    if impl == "auto":
        check_no_grad("flash_decode", q, k_cache, v_cache)
    B, C = q.shape[0], k_cache.shape[1]
    pos = torch.as_tensor(kv_positions, dtype=torch.int32, device=q.device)
    if pos.dim() == 1:
        pos = pos[None].expand(B, C)
    qpos = torch.as_tensor(q_position, dtype=torch.int32, device=q.device)
    if qpos.dim() == 0:
        qpos = qpos[None].expand(B)
    if impl == "ref" or q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, pos, qpos, window=window)
    return flash_decode_cuda(q, k_cache, v_cache, pos.contiguous(),
                             qpos.contiguous(), window=window)
