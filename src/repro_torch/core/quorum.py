"""Vectorized weighted-quorum mathematics (paper §3.1, §4.3-4.4).

Port of ``repro.core.quorum``. The computational hot spot of WOC is quorum
formation: given, for a batch of operations, the time each replica's vote
arrives and the weight each vote carries, find the earliest moment the
accumulated weight strictly crosses the consensus threshold ``T = sum(w)/2``
(strict: at exactly sum/2 two disjoint vote sets could both "commit").

Non-voting replicas (crashed, timed out, or replying CONFLICT) are encoded
with ``arrival = +inf`` so they sort to the end and never enter a quorum.

:func:`quorum_commit` runs on the inputs' device: on a CUDA device it
launches the hand-written kernel of ``repro_torch.kernels.quorum_commit``,
on the CPU that module's plain PyTorch version. Both order tied arrivals by
replica index, as the stable ``jnp.argsort`` of the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import quorum_commit as _qc


class QuorumResult(NamedTuple):
    """Result of quorum formation for a batch of operations.

    All fields have shape ``(ops,)`` except ``members`` (``(ops, n)``).
    """

    committed: torch.Tensor     # bool    — threshold crossed by voting replicas
    commit_time: torch.Tensor   # float32 — time of the crossing vote (inf if not)
    quorum_size: torch.Tensor   # int32   — number of votes in the quorum
    weight_sum: torch.Tensor    # float32 — accumulated weight at commit
    members: torch.Tensor       # bool (ops, n) — replicas inside the quorum


def quorum_commit(arrivals: torch.Tensor, weights: torch.Tensor,
                  threshold: torch.Tensor | None = None) -> QuorumResult:
    """Earliest weighted-quorum crossing per operation.

    Args:
      arrivals: (ops, n) or (n,) vote arrival times; ``inf`` = no vote.
      weights:  same shape, per-replica vote weight for this op's object.
      threshold: (ops,) consensus threshold; defaults to ``sum(weights)/2``
        (paper §3.1). The default sums *all* weights, including non-voters —
        the threshold is a property of the object, not of who answers.

    Inputs are cast to float32, as the JAX package computes with x64 off.
    Returns a :class:`QuorumResult`.
    """
    if arrivals.ndim == 1:
        arrivals = arrivals[None]
        weights = weights[None]
    arrivals, weights = _float32(arrivals), _float32(weights)
    if threshold is not None:
        threshold = _float32(torch.broadcast_to(threshold, arrivals.shape[:1]))
    commit_time, quorum_size, committed, weight_sum, members = \
        _qc.quorum_commit(arrivals, weights, threshold, members=True)
    return QuorumResult(committed, commit_time, quorum_size, weight_sum,
                        members)


def _float32(x: torch.Tensor) -> torch.Tensor:
    """x as contiguous float32, without a call where it already is one."""
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    return x if x.is_contiguous() else x.contiguous()


def quorums_intersect(members_a: torch.Tensor, members_b: torch.Tensor
                      ) -> torch.Tensor:
    """Theorem 1 checker: do two quorum membership masks intersect?

    ``members_*``: (..., n) bool. Returns (...,) bool.
    """
    return torch.any(members_a & members_b, dim=-1)


def min_quorum_latency(latencies: torch.Tensor, weights: torch.Tensor
                       ) -> torch.Tensor:
    """Lower bound on fast-path commit latency for an object.

    The best possible commit time is reached by waiting for replicas in
    latency order until the threshold is crossed. Shape: latencies/weights
    (ops, n) or (n,) -> (ops,).
    """
    return quorum_commit(latencies, weights).commit_time
