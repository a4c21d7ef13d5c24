"""Plain PyTorch version of the rms_norm kernel: the models' RMSNorm
(`repro/models/layers.py::rms_norm`), f32 statistics, cast back."""
from __future__ import annotations

import torch


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)
