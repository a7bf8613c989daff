"""Public kernel entry points (port of ``repro.kernels.ops``).

Each picks by the inputs' device: a CUDA tensor launches the hand-written
kernel or raises, a CPU tensor runs the plain PyTorch version. There is no
fallback from one to the other.
"""

from __future__ import annotations

from repro_torch.kernels import quorum_commit as _qc


def quorum_commit(arrivals, weights):
    """(commit_time, quorum_size, committed, weight_sum) per op row of the
    float32 ``(ops, n)`` inputs."""
    return _qc.quorum_commit(arrivals, weights)[:4]
