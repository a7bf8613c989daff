"""Carry state between the JAX package and the port, as numpy arrays.

The JAX package's state leaves it as numpy (``np.asarray`` of a weight
matrix, of a ``WeightTracker``'s ``latency_ema``, of each field of a
``QuorumResult``; ``jax.tree.map(np.asarray, params)`` for a model's
parameters or decode cache); these functions turn such arrays into the
port's objects on a given device, and back. They import nothing from the
JAX package.

bfloat16 arrays from JAX have numpy dtype ``ml_dtypes.bfloat16``, which
torch cannot read; they cross bit for bit through a uint16 view.
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


def _is_bfloat16(array: np.ndarray) -> bool:
    return array.dtype.name == "bfloat16"


def _from_numpy(array) -> torch.Tensor:
    """A CPU tensor with the array's dtype and a copy of its data (arrays the
    JAX package hands out are read-only)."""
    array = np.asarray(array)
    if _is_bfloat16(array):
        return torch.from_numpy(array.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(array.copy())


def to_tensor(array, dtype: torch.dtype = torch.float32, *,
              device: str | torch.device | None = None) -> torch.Tensor:
    """A copy of a numpy array (e.g. a weight matrix) as a ``dtype`` tensor
    on ``device``."""
    return _from_numpy(array).to(device=default_device(device), dtype=dtype)


def to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """A numpy copy of a tensor; bfloat16 comes back as ``ml_dtypes.bfloat16``,
    the dtype JAX gives such arrays."""
    tensor = tensor.detach().to("cpu", copy=True)
    if tensor.dtype == torch.bfloat16:
        import ml_dtypes    # numpy's bfloat16, installed beside JAX
        return tensor.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return tensor.numpy()


def params_from_jax(tree, *, device: str | torch.device | None = None):
    """A nested dict of numpy arrays, as ``jax.tree.map(np.asarray, params)``
    gives it, as the port's dict of tensors on ``device``, dtypes kept."""
    device = default_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    return _from_numpy(tree).to(device)


def params_to_numpy(tree):
    """The port's nested dict of tensors as numpy arrays, dtypes kept."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return to_numpy(tree)


# a decode cache is a dict of arrays, as parameters are
cache_from_jax = params_from_jax
cache_to_numpy = params_to_numpy


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
