"""Triton kernel: fused RMSNorm, ``x * rsqrt(mean(x^2) + eps) * w`` with f32
statistics, cast back to x's dtype.

Replaces the TPU kernel `rms_norm_2d` of the JAX package
(`repro/kernels/rms_norm/rms_norm.py`). What bounds it on the card: device
memory; it reads each row once and writes it once, with ~4 flops per element.
The design answers that by fusing the reduction and the scale into one pass:
one program normalises ROWS whole rows, each held in registers as one
power-of-two block of BLOCK_D >= D columns with a masked tail, so no
intermediate touches device memory. No tensor cores and nothing to stage
beyond a row, so Triton serves here as well as CUDA C++.

`triton` is imported inside the launcher: the module imports on machines
without it (the CPU tests)."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import count_launch

ROWS = 4            # rows per program
NUM_WARPS = 4


@functools.cache
def _kernel():
    # bound as module globals: Triton resolves a kernel's names (tl) through
    # the function's globals, not its closure
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def rms_norm_kernel(x_ptr, w_ptr, o_ptr, R, D, eps,
                        ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        pid = tl.program_id(0)
        rows = pid * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK_D)
        mask = (rows[:, None] < R) & (cols[None, :] < D)
        offs = rows[:, None].to(tl.int64) * D + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        w = tl.load(w_ptr + cols, mask=cols < D, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=1) / D
        y = x * tl.rsqrt(var + eps)[:, None] * w[None, :]
        tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=mask)

    return triton, rms_norm_kernel


def rms_norm_triton(x: torch.Tensor, weight: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """x: (R, D) contiguous float32/bfloat16 on CUDA; weight: (D,) on the same
    device. Returns (R, D) in x's dtype."""
    if x.dim() != 2 or weight.shape != (x.shape[1],):
        raise ValueError(f"rms_norm takes x (R, D) and weight (D,), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            weight.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rms_norm takes float32/bfloat16, got {x.dtype}, "
                        f"{weight.dtype}")
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError("rms_norm tensors must lie on one CUDA device")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm takes contiguous x and weight")
    triton, kernel = _kernel()
    R, D = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        kernel[(triton.cdiv(R, ROWS),)](
            x, weight, out, R, D, float(eps), ROWS=ROWS,
            BLOCK_D=triton.next_power_of_2(D), num_warps=NUM_WARPS)
    count_launch("rms_norm")
    return out
