"""Public wrapper of the WKV kernel.

`impl`: "auto" = the kernel for CUDA tensors, the plain version for CPU
tensors; "ref" = the plain version on either (differentiable). The kernel
has no backward: "auto" raises if an input needs a gradient.
"""
from __future__ import annotations

from repro_torch.kernels import check_no_grad
from repro_torch.kernels.rwkv6_scan.ref import wkv_scan_ref
from repro_torch.kernels.rwkv6_scan.rwkv6_scan import wkv_scan_cuda


def wkv_scan(r, k, v, w, u, s0=None, *, impl: str = "auto"):
    """r, k, v, w: (B, T, H, hd), one dtype; u: (H, hd); s0: (B, H, hd, hd)
    or None. Returns (o (B, T, H, hd) in r's dtype, sT (B, H, hd, hd) f32)."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r}; options: auto|ref")
    if impl == "auto":
        check_no_grad("wkv_scan", r, k, v, w, u, s0)
    if impl == "ref" or r.device.type == "cpu":
        return wkv_scan_ref(r, k, v, w, u, s0)
    return wkv_scan_cuda(r.contiguous(), k.contiguous(), v.contiguous(),
                         w.contiguous(), u.float().contiguous(),
                         None if s0 is None else s0.float().contiguous())
