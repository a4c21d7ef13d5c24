"""Public wrappers of the fused outer-update kernels, on flat-plane buffers
(``(rows, LANES)``, already packed by the engine).

`impl`: "auto" = the kernel for CUDA tensors, the plain version for CPU
tensors; "ref" = the plain version on either. The kernels have no backward:
"auto" raises if an input needs a gradient.

Scalar operands may be python numbers or 0-d device tensors (the engine's
overlap depth tau); the kernel's (n,) f32 operand is assembled on the
device (`scalar_operand`), so no call syncs the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check_no_grad
from repro_torch.kernels.outer_update.outer_update import (deliver_cuda,
                                                           nesterov_cuda)
from repro_torch.kernels.outer_update.ref import (DELIVER_MODES, deliver_ref,
                                                  f32, nesterov_ref)


def scalar_operand(values, device) -> torch.Tensor:
    """(n,) f32 device tensor of python numbers (filled on the device, no
    host-to-device copy) and 0-d device tensors."""
    return torch.stack([
        v.to(device=device, dtype=torch.float32).reshape(())
        if isinstance(v, torch.Tensor)
        else torch.full((), f32(v), dtype=torch.float32, device=device)
        for v in values])


def _use_ref(name: str, impl: str, *tensors) -> bool:
    """Whether to take the plain version; "auto" first refuses inputs that
    need a gradient (on any device, so a CPU run catches a training path
    that would cut the gradient on the card)."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r}; options: auto|ref")
    if impl == "ref":
        return True
    check_no_grad(name, *tensors)
    return tensors[0].device.type == "cpu"


def outer_nesterov(theta, momentum, delta, *, lr, mu, impl: str = "auto"):
    """Fused Nesterov outer step on (rows, LANES) f32 buffers.
    Returns (theta_new, momentum_new)."""
    if _use_ref("nesterov_2d", impl, theta, momentum, delta):
        return nesterov_ref(theta, momentum, delta, lr=lr, mu=mu)
    return nesterov_cuda(theta, momentum, delta,
                         scalar_operand((lr, mu), theta.device))


def fused_deliver(local, snapshot, g, avail, *, mode: str, alpha=0.0,
                  tau=1.0, lam=0.0, H=1.0, sign=1.0, impl: str = "auto"):
    """Fused delivery (blend|compensate + offline-worker mask) over the
    worker-stacked fragment buffer. `local`/`snapshot`: (M, rows, LANES);
    `g`: (rows, LANES); `avail`: (M,). Returns the new local stack."""
    if mode not in DELIVER_MODES:
        raise ValueError(f"unknown deliver mode {mode!r}; "
                         f"options: {DELIVER_MODES}")
    if _use_ref("deliver_2d", impl, local, snapshot, g):
        return deliver_ref(local, snapshot, g, avail, mode=mode, alpha=alpha,
                           tau=tau, lam=lam, H=H, sign=sign)
    scalars = scalar_operand((alpha, tau, lam, H, sign), local.device)
    return deliver_cuda(local, snapshot, g,
                        avail.to(device=local.device, dtype=torch.float32),
                        scalars, mode=mode)
