"""CoCoDC delay compensation (paper Algorithm 1, Eqs. 4-8) and Streaming
DiLoCo blending (Eq. 3) at the tree level (counterpart of
`repro/core/delay_comp.py`).

    g      = sign * (theta_tl - theta_tp) / tau          (Eq. 4)
    g_corr = g + lam * g . g . (theta_g - theta_tp)/H    (Eq. 7, Hadamard)
    out    = theta_g + tau * g_corr                      (Eq. 8)

`impl="kernel"` routes through kernels/delay_comp (the CUDA kernel for CUDA
tensors, its plain version on the CPU); "ref" is the plain formula.
"""
from __future__ import annotations

from repro_torch.core.tree import tree_map
from repro_torch.kernels.delay_comp.ops import delay_comp
from repro_torch.kernels.delay_comp.ref import delay_comp_ref


def compensate(theta_tl, theta_tp, theta_g, *, tau, lam, H, sign=1.0,
               impl: str = "ref"):
    """Tree-level Algorithm 1. None leaves pass through as None. `tau` may
    be a 0-d device tensor (the engine's actual overlap depth)."""
    if impl == "kernel":
        return delay_comp(theta_tl, theta_tp, theta_g, tau=tau, lam=lam,
                          H=H, sign=sign, impl="auto")
    if impl != "ref":
        raise ValueError(f"unknown dc_impl {impl!r}; options: ref|kernel")
    return tree_map(lambda tl, tp, tg: delay_comp_ref(
        tl, tp, tg, tau=tau, lam=lam, H=H, sign=sign),
        theta_tl, theta_tp, theta_g)


def blend(theta_local, theta_g, *, alpha: float):
    """Streaming DiLoCo Eq. 3: (1-alpha)*local + alpha*global."""
    return tree_map(lambda l, g: (1.0 - alpha) * l + alpha * g,
                    theta_local, theta_g)
