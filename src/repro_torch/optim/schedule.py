"""LR schedules (counterpart of `repro/optim/schedule.py`). Paper §IV:
linear warmup then cosine decay, evaluated in float32 like the JAX
package's."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, base_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    """LR at `step` (an int, a sequence of ints or a tensor) as a float32
    CPU tensor (a 0-d one for a scalar step)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * step / max(1, warmup_steps)
    progress = torch.clamp((step - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
    cos = final_frac * base_lr + (1 - final_frac) * base_lr * 0.5 * (
        1 + torch.cos(math.pi * progress))
    return torch.where(step < warmup_steps, warm, cos)
