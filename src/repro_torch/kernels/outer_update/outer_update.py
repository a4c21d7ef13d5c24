"""Launchers of the CUDA C++ kernels ``csrc/outer_update.cu``: the fused
outer Nesterov step and the fused delivery over the flat fragment plane.
Replace the TPU kernels `nesterov_2d` and `deliver_2d` of the JAX package
(`repro/kernels/outer_update/outer_update.py`); the source says what bounds
them on the card and how the design answers that."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import count_launch, load_library

LANES = 1024
_MODES = {"blend": 0, "compensate": 1}


def _fns():
    lib = load_library("outer_update")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    nest = lib.nesterov_2d_launch
    nest.argtypes = [vp, vp, vp, vp, vp, vp, i64, vp]
    nest.restype = ctypes.c_int
    dlv = lib.deliver_2d_launch
    dlv.argtypes = [ctypes.c_int, vp, vp, vp, vp, vp, vp, i64, i64, i64, i64,
                    vp]
    dlv.restype = ctypes.c_int
    return nest, dlv


def _on_card(name, tensors, device):
    if any(t.device != device or t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name} tensors must all lie on one CUDA device")


def _check_planes(name, tensors):
    """float32 planes whose (rows, LANES) part is contiguous and 16-byte
    aligned (a leading worker axis may have any stride that keeps it so)."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")
        if t.dim() >= 2 and (t.stride(-1) != 1 or t.stride(-2) != LANES):
            raise ValueError(f"{name} takes planes with contiguous "
                             f"(rows, {LANES}) layout")
        if t.dim() == 1 and not t.is_contiguous():
            raise ValueError(f"{name} takes a contiguous vector")
        if t.dim() == 3 and t.stride(0) % 4:
            raise ValueError(f"{name}: worker stride must be a multiple of 4")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} takes 16-byte aligned tensors")


def check_nesterov_operands(theta, momentum, delta):
    """The layout `nesterov_2d` takes (any device)."""
    if theta.dim() != 2 or theta.shape[1] != LANES or \
            momentum.shape != theta.shape or delta.shape != theta.shape:
        raise ValueError(f"nesterov_2d takes three (rows, {LANES}) planes, "
                         f"got {tuple(theta.shape)}, {tuple(momentum.shape)}, "
                         f"{tuple(delta.shape)}")
    _check_planes("nesterov_2d", (theta, momentum, delta))
    for t in (theta, momentum, delta):
        if not t.is_contiguous():
            raise ValueError("nesterov_2d takes contiguous planes")


def check_deliver_operands(local, snapshot, g, avail, mode):
    """The layout `deliver_2d` takes (any device)."""
    if mode not in _MODES:
        raise ValueError(f"unknown deliver mode {mode!r}; options: "
                         f"{tuple(_MODES)}")
    if local.dim() != 3 or local.shape[2] != LANES or \
            tuple(g.shape) != tuple(local.shape[1:]):
        raise ValueError(f"deliver_2d takes local (M, rows, {LANES}) and g "
                         f"(rows, {LANES}), got {tuple(local.shape)} and "
                         f"{tuple(g.shape)}")
    planes = [local, g, avail]
    if mode == "compensate":
        if snapshot is None or snapshot.shape != local.shape:
            raise ValueError("compensate needs a snapshot shaped like local")
        planes.append(snapshot)
    _check_planes("deliver_2d", planes)
    if tuple(avail.shape) != (local.shape[0],):
        raise ValueError(f"avail must be ({local.shape[0]},), got "
                         f"{tuple(avail.shape)}")
    if not g.is_contiguous():
        raise ValueError("deliver_2d takes a contiguous g")


def _scalars(name, scalars, n, device):
    if scalars.shape != (n,) or scalars.dtype != torch.float32 \
            or scalars.device != device:
        raise ValueError(f"{name} scalars must be ({n},) float32 on "
                         f"{device}, got {tuple(scalars.shape)} "
                         f"{scalars.dtype} on {scalars.device}")


def nesterov_cuda(theta, momentum, delta, scalars):
    """theta/momentum/delta: (rows, LANES) f32 on CUDA; scalars: (2,) f32
    [lr, mu] on the same device. Returns (theta_new, momentum_new)."""
    _on_card("nesterov_2d", (theta, momentum, delta, scalars), theta.device)
    check_nesterov_operands(theta, momentum, delta)
    _scalars("nesterov_2d", scalars, 2, theta.device)
    t_out, m_out = torch.empty_like(theta), torch.empty_like(momentum)
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = _fns()[0](theta.data_ptr(), momentum.data_ptr(),
                        delta.data_ptr(), scalars.data_ptr(),
                        t_out.data_ptr(), m_out.data_ptr(), theta.numel(),
                        stream)
    if err != 0:
        raise RuntimeError(f"nesterov_2d launch failed: CUDA error {err}")
    count_launch("nesterov_2d")
    return t_out, m_out


def deliver_cuda(local, snapshot, g, avail, scalars, *, mode: str):
    """local/snapshot: (M, rows, LANES) f32 (snapshot unused for blend, may
    be None; each worker's plane contiguous, the worker axis may be strided,
    as a row slice of the full-model snapshot is); g: (rows, LANES) f32;
    avail: (M,) f32 (0 = offline); scalars: (5,) f32 [alpha, tau, lam, H,
    sign]; all on one CUDA device. Returns the new contiguous
    (M, rows, LANES) local stack."""
    _on_card("deliver_2d", [t for t in (local, snapshot, g, avail, scalars)
                            if t is not None], local.device)
    check_deliver_operands(local, snapshot, g, avail, mode)
    _scalars("deliver_2d", scalars, 5, local.device)
    out = torch.empty(local.shape, dtype=local.dtype, device=local.device)
    snap = snapshot if mode == "compensate" else local
    with torch.cuda.device(local.device):
        stream = torch.cuda.current_stream(local.device).cuda_stream
        err = _fns()[1](_MODES[mode], local.data_ptr(), snap.data_ptr(),
                        g.data_ptr(), avail.data_ptr(), scalars.data_ptr(),
                        out.data_ptr(), local.shape[0], g.numel(),
                        local.stride(0), snap.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"deliver_2d launch failed: CUDA error {err}")
    count_launch("deliver_2d")
    return out
