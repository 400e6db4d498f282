"""Learning-rate schedules (counterpart of ``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch


def cosine_warmup(
    step,
    *,
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    min_ratio: float = 0.1,
) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``min_ratio * peak_lr`` at ``total_steps``; a () fp32 tensor
    on ``step``'s device (the CPU for a Python int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = torch.clamp(
        (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
    )
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)
