"""Launcher of the CUDA C++ kernel ``csrc/rglru_scan.cu``: the RG-LRU's
diagonal recurrence h_t = a_t h_{t-1} + b_t, one thread per (batch,
channel). Replaces the TPU kernel `lru_scan_btd` of the JAX package
(`repro/kernels/rglru_scan/rglru_scan.py`); the source says what bounds it
on the card and how the design answers that."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import count_launch, load_library


def _fn():
    fn = load_library("rglru_scan").lru_scan_launch
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, i32, i32, i32, vp]
    fn.restype = ctypes.c_int
    return fn


def lru_scan_cuda(a, b, h0: Optional[torch.Tensor] = None):
    """a, b: (B, T, D) f32; h0: (B, D) f32 or None; contiguous, on one CUDA
    device, T >= 1. Returns h (B, T, D) f32."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a and b must be (B, T, D) alike, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    B, T, D = a.shape
    if T < 1:
        raise ValueError("lru_scan takes T >= 1")
    if h0 is not None and tuple(h0.shape) != (B, D):
        raise ValueError(f"h0 must be ({B}, {D}), got {tuple(h0.shape)}")
    tensors = [t for t in (a, b, h0) if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("lru_scan takes float32 tensors")
    if any(t.device != a.device or t.device.type != "cuda" for t in tensors):
        raise ValueError("lru_scan tensors must all lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lru_scan takes contiguous tensors")
    h = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _fn()(a.data_ptr(), b.data_ptr(),
                    None if h0 is None else h0.data_ptr(), h.data_ptr(),
                    B, T, D, stream)
    if err != 0:
        raise RuntimeError(f"lru_scan launch failed: CUDA error {err}")
    count_launch("lru_scan")
    return h
