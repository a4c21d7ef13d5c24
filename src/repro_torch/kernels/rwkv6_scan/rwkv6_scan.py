"""Launcher of the CUDA C++ kernel ``csrc/rwkv6_scan.cu``: the RWKV-6 WKV
recurrence over the models' (B, T, H, hd) layout, one block per (batch,
head) with the state in registers. Replaces the TPU kernel `wkv_scan_bht`
of the JAX package (`repro/kernels/rwkv6_scan/rwkv6_scan.py`); the source
says what bounds it on the card and how the design answers that."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import count_launch, load_library

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    fn = load_library("rwkv6_scan").wkv_scan_launch
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32,
                   vp]
    fn.restype = ctypes.c_int
    return fn


def wkv_scan_cuda(r, k, v, w, u, s0: Optional[torch.Tensor] = None):
    """r, k, v, w: (B, T, H, hd) contiguous, one dtype (float32 or
    bfloat16); u: (H, hd) f32; s0: (B, H, hd, hd) f32 or None; contiguous,
    on one CUDA device; hd in HEAD_DIMS. Returns (o (B, T, H, hd) in r's
    dtype, sT (B, H, hd, hd) f32)."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"r, k, v, w must be (B, T, H, hd) alike, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, T, H, hd = r.shape
    if hd not in HEAD_DIMS or T < 1:
        raise ValueError(f"wkv_scan takes hd in {HEAD_DIMS} and T >= 1, got "
                         f"hd={hd}, T={T}")
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"u must be ({H}, {hd}), got {tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (B, H, hd, hd):
        raise ValueError(f"s0 must be ({B}, {H}, {hd}, {hd}), got "
                         f"{tuple(s0.shape)}")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError(f"wkv_scan takes float32 or bfloat16 r/k/v/w of one "
                        f"dtype, got {[t.dtype for t in (r, k, v, w)]}")
    if u.dtype != torch.float32 or (s0 is not None
                                    and s0.dtype != torch.float32):
        raise TypeError("u and s0 must be float32")
    tensors = [t for t in (r, k, v, w, u, s0) if t is not None]
    if any(t.device != r.device or t.device.type != "cuda" for t in tensors):
        raise ValueError("wkv_scan tensors must all lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("wkv_scan takes contiguous tensors")
    o = torch.empty_like(r)
    sT = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _fn()(_DTYPES[r.dtype], r.data_ptr(), k.data_ptr(),
                    v.data_ptr(), w.data_ptr(), u.data_ptr(),
                    None if s0 is None else s0.data_ptr(), o.data_ptr(),
                    sT.data_ptr(), B, T, H, hd, stream)
    if err != 0:
        raise RuntimeError(f"wkv_scan launch failed: CUDA error {err}")
    count_launch("wkv_scan")
    return o, sT
