"""Optimizer, schedules and gradient compression (port of ``repro.optim``)."""

from repro_torch.optim import adamw, grad_compress, schedule
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["adamw", "grad_compress", "schedule", "AdamWConfig"]
