"""Launcher of the CUDA C++ kernel ``csrc/delay_comp.cu``: CoCoDC
Algorithm 1 over one parameter leaf of the worker stack. Replaces the TPU
kernel `delay_comp_2d` of the JAX package
(`repro/kernels/delay_comp/delay_comp.py`); the source says what bounds it
on the card and how the design answers that."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import count_launch, load_library


def _fn():
    fn = load_library("delay_comp").delay_comp_launch
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [vp, vp, vp, vp, vp, i64, i64, vp]
    fn.restype = ctypes.c_int
    return fn


def delay_comp_cuda(theta_tl, theta_tp, theta_g, scalars):
    """theta_tl, theta_tp: (M, ...) f32; theta_g: the same shape or with a
    leading 1 (read by broadcast, not materialised); scalars: (4,) f32
    [tau, lam, H, sign]; all contiguous on one CUDA device, the leaf a
    multiple of 4 elements (the kernel's float4 loads; every leaf of the
    ported models is). Returns the compensated (M, ...) leaf."""
    if theta_tp.shape != theta_tl.shape:
        raise ValueError(f"theta_tl {tuple(theta_tl.shape)} and theta_tp "
                         f"{tuple(theta_tp.shape)} must match")
    if theta_g.shape != theta_tl.shape and not (
            theta_g.dim() == theta_tl.dim() and theta_g.shape[0] == 1
            and theta_g.shape[1:] == theta_tl.shape[1:]):
        raise ValueError(f"theta_g {tuple(theta_g.shape)} must equal theta_tl "
                         f"{tuple(theta_tl.shape)} or broadcast from a "
                         f"leading 1")
    if theta_g.numel() % 4:
        raise ValueError(f"delay_comp takes leaves of a multiple of 4 "
                         f"elements, got {tuple(theta_g.shape[1:])}")
    tensors = (theta_tl, theta_tp, theta_g, scalars)
    dev = theta_tl.device
    if any(t.device != dev or t.device.type != "cuda" for t in tensors):
        raise ValueError("delay_comp tensors must all lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("delay_comp takes float32 tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("delay_comp takes contiguous tensors")
    if tuple(scalars.shape) != (4,):
        raise ValueError(f"scalars must be (4,), got {tuple(scalars.shape)}")
    # float4 loads need 16-byte aligned operands; a fresh allocation is
    # (a contiguous view at an odd offset is copied)
    theta_tl, theta_tp, theta_g = (t if t.data_ptr() % 16 == 0 else t.clone()
                                   for t in (theta_tl, theta_tp, theta_g))
    out = torch.empty_like(theta_tl)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(theta_tl.data_ptr(), theta_tp.data_ptr(),
                    theta_g.data_ptr(), scalars.data_ptr(), out.data_ptr(),
                    theta_tl.numel(), theta_g.numel(), stream)
    if err != 0:
        raise RuntimeError(f"delay_comp launch failed: CUDA error {err}")
    count_launch("delay_comp")
    return out
