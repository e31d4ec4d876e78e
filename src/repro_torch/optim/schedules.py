"""Learning-rate schedules: pure functions of the step, returning 0-d
float32 tensors (port of ``repro.optim.schedules``)."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant_lr"]


def warmup_cosine(step, peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup from 0 to ``peak_lr`` over ``warmup_steps``, then a
    cosine down to ``final_frac * peak_lr`` at ``total_steps``."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * s / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps,
                                                1), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac)
                     * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)


def constant_lr(step, lr: float) -> torch.Tensor:
    return torch.full((), lr, dtype=torch.float32,
                      device=torch.as_tensor(step).device)
