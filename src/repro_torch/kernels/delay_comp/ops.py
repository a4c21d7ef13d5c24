"""Public wrapper of the delay-compensation kernel over one leaf or a
tree of leaves (None leaves pass through).

`impl`: "auto" = the kernel for CUDA tensors, the plain version for CPU
tensors; "ref" = the plain version on either. The kernel has no backward:
"auto" raises if an input needs a gradient. Scalars may be python numbers
or 0-d device tensors; callers looping over a tree pass one prebuilt
`scalars` operand (`pack_scalars`), shared by every leaf.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import check_no_grad
from repro_torch.kernels.delay_comp.delay_comp import delay_comp_cuda
from repro_torch.kernels.delay_comp.ref import delay_comp_ref
from repro_torch.kernels.outer_update.ops import scalar_operand


def pack_scalars(tau, lam, H, sign, device) -> torch.Tensor:
    """The kernel's (4,) f32 operand [tau, lam, H, sign] on `device`."""
    return scalar_operand((tau, lam, H, sign), device)


def delay_comp_array(theta_tl, theta_tp, theta_g, *, tau=None, lam=None,
                     H=None, sign=1.0, impl: str = "auto", scalars=None):
    """One leaf: theta_tl/theta_tp (M, ...), theta_g (M, ...) or (1, ...)."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r}; options: auto|ref")
    if impl == "auto":
        check_no_grad("delay_comp", theta_tl, theta_tp, theta_g)
    if impl == "ref" or theta_tl.device.type == "cpu":
        if scalars is not None:
            tau, lam, H, sign = scalars[0], scalars[1], scalars[2], scalars[3]
        return delay_comp_ref(theta_tl, theta_tp, theta_g, tau=tau, lam=lam,
                              H=H, sign=sign)
    if scalars is None:
        scalars = pack_scalars(tau, lam, H, sign, theta_tl.device)
    dtype = theta_tl.dtype
    out = delay_comp_cuda(theta_tl.float().contiguous(),
                          theta_tp.float().contiguous(),
                          theta_g.float().contiguous(), scalars)
    return out.to(dtype)


def delay_comp(theta_tl, theta_tp, theta_g, *, tau, lam, H, sign=1.0,
               impl: str = "auto"):
    """Tree-level delay compensation: one kernel launch per present leaf,
    one shared scalar operand."""
    first = tree_leaves(theta_tl)[0]
    scalars = (pack_scalars(tau, lam, H, sign, first.device)
               if impl == "auto" and first.device.type != "cpu" else None)
    return tree_map(
        lambda tl, tp, tg: delay_comp_array(tl, tp, tg, tau=tau, lam=lam,
                                            H=H, sign=sign, impl=impl,
                                            scalars=scalars),
        theta_tl, theta_tp, theta_g)
