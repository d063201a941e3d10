"""Learning-rate schedules (``repro/optim/schedules.py``).

Each schedule maps the integer step to a float32 0-d tensor, computed in
float32 as the reference computes it (``step.astype(jnp.float32)``).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], torch.Tensor]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0) -> Schedule:
    """Linear warmup to ``peak`` over ``warmup_steps``, then a cosine to
    ``floor`` at ``total_steps``."""
    def sched(step) -> torch.Tensor:
        s = _f32(step)
        warm = peak * s / max(warmup_steps, 1)
        prog = ((s - warmup_steps) / max(total_steps - warmup_steps, 1)
                ).clamp(0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, cos)
    return sched


def inverse_sqrt(peak: float, warmup_steps: int) -> Schedule:
    """Linear warmup, then peak · sqrt(warmup_steps / step)."""
    def sched(step) -> torch.Tensor:
        s = _f32(step).clamp_min(1.0)
        warm = peak * s / max(warmup_steps, 1)
        decay = peak * (warmup_steps ** 0.5) / torch.sqrt(s)
        return torch.where(s < warmup_steps, warm, decay)
    return sched


def constant(value: float) -> Schedule:
    return lambda step: _f32(value)
