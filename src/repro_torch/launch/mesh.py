"""Device mesh construction (port of ``repro.launch.mesh``).

FUNCTIONS, not module-level constants: importing this module touches no
process group. Both build a torch ``DeviceMesh`` through
``init_device_mesh`` on the default device type (CUDA where it exists,
else the CPU), so the process group (NCCL on the card, gloo on the CPU)
must be initialised first, with one rank per device of the mesh.

Single pod: (16, 16) = 256 chips, axes (data, model).
Multi-pod:  (2, 16, 16) = 512 chips, axes (pod, data, model) — the pod
axis is data-parallel across pods (only gradient reductions cross pods),
and is the axis the WOC-style quorum commit layer
(``repro_torch.coord.grad_quorum``) masks over.
"""

from __future__ import annotations

import torch


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_mesh_for(devices: int, *, model_parallel: int = None):
    """Smaller meshes for tests/examples: squeeze onto whatever exists."""
    from torch.distributed.device_mesh import init_device_mesh

    tp = model_parallel or (2 if devices % 2 == 0 and devices > 1 else 1)
    dp = devices // tp
    return init_device_mesh(_device_type(), (dp, tp),
                            mesh_dim_names=("data", "model"))
