"""LR schedules: pure functions of the step counter (port of
``repro.optim.schedule``), in float32 as the JAX package computes them."""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def cosine_with_warmup(step, *, warmup: int = 200, total: int = 10_000,
                       min_ratio: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = torch.clamp_max(step / max(warmup, 1), 1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return warm * (min_ratio + (1 - min_ratio) * cos)


def linear_decay(step, *, warmup: int = 200, total: int = 10_000,
                 min_ratio: float = 0.0) -> torch.Tensor:
    step = _step(step)
    warm = torch.clamp_max(step / max(warmup, 1), 1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    return warm * (1.0 - (1.0 - min_ratio) * frac)
