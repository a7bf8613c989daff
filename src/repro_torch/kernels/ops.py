"""Public kernel entry points (port of ``repro.kernels.ops``).

Each picks by the inputs' device: a CUDA tensor launches the hand-written
kernel or raises, a CPU tensor runs the plain PyTorch version. There is no
fallback from one to the other, and no ``force_pallas``/``interpret``.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quorum_commit as _qc
from repro_torch.kernels import ssd_scan as _ssd


def quorum_commit(arrivals, weights):
    """(commit_time, quorum_size, committed, weight_sum) per op row of the
    float32 ``(ops, n)`` inputs."""
    return _qc.quorum_commit(arrivals, weights)[:4]


def flash_attention(q, k, v, *, causal: bool = True):
    """Attention, q (B,S,H,hd) and k/v (B,Sk,KV,hd) -> (B,S,H,hd) (K2);
    causal needs Sk == S."""
    return _fa.flash_attention(q, k, v, causal=causal)


def ssd(x, dt, A, Bm, Cm, D, chunk, initial_state=None):
    """The chunked SSD scan, its intra-chunk block on K3 -> (y, final_state)."""
    return _ssd.ssd_chunked(x, dt, A, Bm, Cm, D, chunk,
                            initial_state=initial_state)
