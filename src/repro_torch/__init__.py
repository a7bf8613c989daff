"""repro_torch: the PyTorch and CUDA port of the WOC data plane.

It grows beside the JAX package ``repro`` module for module, under the same
module names (``repro_torch.core.quorum`` ports ``repro.core.quorum``), and
imports nothing from it. Functions that take tensors run on the tensors'
device; functions that create tensors take ``device=``, which defaults to
CUDA and never falls back to the CPU unless the caller asks for it.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch

__version__ = "0.1.0"


def default_device(device: str | torch.device | None = None) -> torch.device:
    """The device a tensor factory should use: ``device``, else CUDA.

    Raises ``RuntimeError`` when CUDA is asked for (or implied by
    ``device=None``) and there is none, so that nothing quietly runs on the
    CPU; pass ``device="cpu"`` for that.
    """
    # imported here, not at the top: the served transport's processes
    # import this package and never touch a tensor
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available; pass device='cpu' to run on "
            "the CPU")
    return device


__all__ = ["default_device"]
