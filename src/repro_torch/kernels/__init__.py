"""Hand-written Hopper kernels for the port's hot spots.

Each kernel ships:
  * ``csrc/<name>.cu``  — the CUDA source, built at first use by ``_build``
  * ``<name>.py``       — its launch wrapper, launch count and plain version
  * ``ops.py``          — public entry points (CUDA -> kernel, CPU -> plain)
  * ``ref.py``          — the plain versions the kernels are held against
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
