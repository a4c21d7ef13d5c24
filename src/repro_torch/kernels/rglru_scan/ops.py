"""Public wrapper of the RG-LRU scan kernel.

`impl`: "auto" = the kernel for CUDA tensors, the plain version for CPU
tensors; "ref" = the plain version on either (differentiable). The kernel
has no backward: "auto" raises if an input needs a gradient.
"""
from __future__ import annotations

from repro_torch.kernels import check_no_grad
from repro_torch.kernels.rglru_scan.ref import lru_scan_ref
from repro_torch.kernels.rglru_scan.rglru_scan import lru_scan_cuda


def lru_scan(a, b, h0=None, *, impl: str = "auto"):
    """a, b: (B, T, D): h_t = a_t h_{t-1} + b_t from h0 (B, D) or 0.
    Returns h (B, T, D) f32."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r}; options: auto|ref")
    if impl == "auto":
        check_no_grad("lru_scan", a, b, h0)
    a, b = a.float(), b.float()
    h0 = None if h0 is None else h0.float()
    if impl == "ref" or a.device.type == "cpu":
        return lru_scan_ref(a, b, h0)
    return lru_scan_cuda(a.contiguous(), b.contiguous(),
                         None if h0 is None else h0.contiguous())
