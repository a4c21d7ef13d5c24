"""Public wrapper of rms_norm: any leading dims; the Triton kernel for CUDA
tensors, the plain version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels import check_no_grad
from repro_torch.kernels.rms_norm.ref import rms_norm_ref
from repro_torch.kernels.rms_norm.rms_norm import rms_norm_triton


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5, *,
             impl: str = "auto") -> torch.Tensor:
    """x: (..., D); weight: (D,). `impl`: "auto" = the kernel on CUDA, the
    plain version on CPU; "ref" = the plain version on either. The kernel
    has no backward, so "auto" raises if an input needs a gradient (on any
    device: a training forward takes impl="ref")."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r}; options: auto|ref")
    if impl == "auto":
        check_no_grad("rms_norm", x, weight)
    if impl == "ref" or x.device.type == "cpu":
        return rms_norm_ref(x, weight, eps)
    shape = x.shape
    return rms_norm_triton(x.reshape(-1, shape[-1]).contiguous(), weight,
                           eps).reshape(shape)
