"""Launcher of the CUDA C++ kernel ``csrc/flash_decode.cu``: one-token GQA
attention over the models' ``(B, C, KV, hd)`` cache layer, read through its
strides. Replaces the TPU kernel `flash_decode_bkv` of the JAX package
(`repro/kernels/flash_decode/flash_decode.py`); the source says what bounds
it on the card and how its design answers that."""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import count_launch, load_library

MAX_G = 16
MAX_HD = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    fn = load_library("flash_decode").flash_decode_launch
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, vp, vp, vp, vp, vp, vp,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, i64, i64, i64, i64, i64, i64,
                   ctypes.c_int, ctypes.c_float, vp]
    fn.restype = ctypes.c_int
    return fn


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, kv_positions: torch.Tensor,
                      q_position: torch.Tensor, *,
                      window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, hd); caches: (B, C, KV, hd) with unit stride on hd (any
    other strides); kv_positions: (B, C) int32; q_position: (B,) int32, all
    on one CUDA device. Returns (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches must be (B, C, KV, hd) alike, got "
                         f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    Bc, C, KV, hdc = k_cache.shape
    if Bc != B or hdc != hd or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache "
                         f"{tuple(k_cache.shape)}")
    G = H // KV
    if G > MAX_G or hd > MAX_HD:
        raise ValueError(f"flash_decode takes G <= {MAX_G} and hd <= "
                         f"{MAX_HD}, got G={G}, hd={hd}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"flash_decode takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if kv_positions.dtype != torch.int32 or q_position.dtype != torch.int32:
        raise TypeError("positions must be int32")
    if tuple(kv_positions.shape) != (B, C) or tuple(q_position.shape) != (B,):
        raise ValueError(f"positions must be (B, C) and (B,), got "
                         f"{tuple(kv_positions.shape)} and "
                         f"{tuple(q_position.shape)}")
    tensors = (q, k_cache, v_cache, kv_positions, q_position)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("flash_decode tensors must all lie on one CUDA device")
    if not (q.is_contiguous() and kv_positions.is_contiguous()
            and q_position.is_contiguous()):
        raise ValueError("q and positions must be contiguous")
    if k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1:
        raise ValueError("caches need unit stride on the head dim")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(_DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
                    v_cache.data_ptr(), kv_positions.data_ptr(),
                    q_position.data_ptr(), out.data_ptr(), B, C, KV, G, hd,
                    k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
                    v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
                    int(window or 0), 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    count_launch("flash_decode")
    return out
