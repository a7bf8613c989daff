"""Deterministic synthetic data (port of ``repro.data``)."""

from repro_torch.data.pipeline import DataConfig, host_batch, iterate

__all__ = ["DataConfig", "host_batch", "iterate"]
