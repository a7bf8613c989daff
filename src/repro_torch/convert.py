"""Carry state between the JAX package and the port, as numpy arrays.

The JAX package's state leaves it as numpy (``np.asarray`` of a weight
matrix, of a ``WeightTracker``'s ``latency_ema``, of each field of a
``QuorumResult``); these functions turn such arrays into the port's objects
on a given device, and back. They import nothing from the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.core.quorum import QuorumResult
from repro_torch.core.weights import WeightTracker

# QuorumResult field order, with the dtype each field has in both packages
_RESULT_DTYPES = (torch.bool, torch.float32, torch.int32, torch.float32,
                  torch.bool)


def to_tensor(array, dtype: torch.dtype = torch.float32, *,
              device: str | torch.device | None = None) -> torch.Tensor:
    """A copy of a numpy array (e.g. a weight matrix) as a tensor on
    ``device``; arrays the JAX package hands out are read-only."""
    return torch.tensor(np.asarray(array), dtype=dtype,
                        device=default_device(device))


def to_numpy(tensor: torch.Tensor) -> np.ndarray:
    return tensor.detach().cpu().numpy()


def weight_tracker(latency_ema, decay: float, *,
                   device: str | torch.device | None = None) -> WeightTracker:
    """The port's tracker from a JAX tracker's ``latency_ema`` and ``decay``."""
    return WeightTracker(to_tensor(latency_ema, device=device),
                         float(decay))


def weight_tracker_arrays(tracker: WeightTracker) -> tuple[np.ndarray, float]:
    """``(latency_ema, decay)`` of the port's tracker, for the JAX one."""
    return to_numpy(tracker.latency_ema), tracker.decay


def quorum_result(fields: Sequence, *,
                  device: str | torch.device | None = None) -> QuorumResult:
    """The port's result from the five fields of a JAX ``QuorumResult``."""
    if len(fields) != len(_RESULT_DTYPES):
        raise ValueError(f"a QuorumResult has {len(_RESULT_DTYPES)} fields, "
                         f"got {len(fields)}")
    return QuorumResult(*(to_tensor(f, dtype, device=device)
                          for f, dtype in zip(fields, _RESULT_DTYPES)))


def quorum_result_arrays(result: QuorumResult) -> tuple[np.ndarray, ...]:
    """The five fields of the port's result as numpy arrays."""
    return tuple(to_numpy(f) for f in result)
