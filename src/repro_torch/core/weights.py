"""Geometric weight assignment and weighted-quorum invariants (paper §3.1–3.2).

Port of ``repro.core.weights``. Weight vectors are computed for batches of
objects at once (shape ``(num_objects, n_replicas)``), because the Object
Manager re-derives weights continuously from latency statistics and a
production deployment tracks millions of objects.

Notation (paper §3.1):
  * object weight vector  W^O = [w_1^O .. w_n^O]
  * consensus threshold   T^O = sum(W^O) / 2
  * quorum                any S with sum_{i in S} w_i^O > T^O

Geometric assignment (paper §3.2, eq. 1): replicas sorted by decreasing
efficiency get ``w_i = R^(n-1-i)`` for rank i in [0, n).

Numerics against the JAX package: ``geometric_weights`` computes in float32
``torch.pow`` and differs from JAX's float32 result by at most 1.2e-7
relative; ``geometric_weights_np`` and ``solve_steepness`` are numpy copies
and agree bit for bit. Ranks come from stable sorts, as ``jnp.argsort`` is
stable, so tied latencies rank replicas by index in both packages; the sort
runs on canonical keys (-0.0 as +0.0, every NaN last), so that the card
orders such values as the CPU and ``jnp.argsort`` do.

The module imports ``torch`` inside the functions that use it: the protocol
stack, and so each process of the served transport, reads only the numpy
functions (``geometric_weights_np``, ``solve_steepness``), and torch's import
would take most of such a process's start.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Tuple

import numpy as np

from repro_torch import default_device

if TYPE_CHECKING:
    import torch

# Steepness bounds from the paper (§3.2): R in [1.0, 2.0].
R_MIN = 1.0
R_MAX = 2.0


def _check_n_r(n: int, r: float) -> None:
    if n < 1:
        raise ValueError(f"need at least one replica, got n={n}")
    if not (R_MIN <= r <= R_MAX):
        raise ValueError(f"steepness r={r} outside paper range [{R_MIN}, {R_MAX}]")


def _overflows_float32(n: int, r: float) -> bool:
    return (n - 1) * np.log(max(r, 1.0 + 1e-12)) > 60.0


def geometric_weights(n: int, r: float, dtype: torch.dtype | None = None,
                      *, device: str | torch.device | None = None
                      ) -> torch.Tensor:
    """Weights for ``n`` replicas ordered fastest-first: w_i = r^(n-1-i).

    Returns a descending weight vector of ``dtype`` (float32 by default);
    ``w[-1] == 1.0`` always (rank n-1 gets r^0), matching Table 1/2 of the
    paper.
    """
    import torch

    _check_n_r(n, r)
    dtype = torch.float32 if dtype is None else dtype
    device = default_device(device)
    exponents = torch.arange(n - 1, -1, -1, dtype=dtype, device=device)
    if _overflows_float32(n, r):
        # large fleets: r^(n-1) overflows float32. Quorum math is scale-
        # invariant (threshold = sum/2), so normalize to w_max = 1
        # (descending from 1 instead of descending to 1).
        exponents = exponents - (n - 1)
    return torch.pow(torch.tensor(r, dtype=dtype, device=device), exponents)


def geometric_weights_np(n: int, r: float,
                         dtype=np.float32) -> np.ndarray:
    """Pure-numpy twin of :func:`geometric_weights`, as the event-driven
    simulator's replica constructors use it (float64 powers, then cast)."""
    _check_n_r(n, r)
    exponents = np.arange(n - 1, -1, -1, dtype=np.float64)
    if _overflows_float32(n, r):
        exponents = exponents - (n - 1)
    return np.power(np.float64(r), exponents).astype(dtype)


def consensus_threshold(weights: torch.Tensor) -> torch.Tensor:
    """T = sum(w)/2 over the last axis (paper §3.1)."""
    import torch

    return torch.sum(weights, dim=-1) / 2.0


def cabinet_size(weights_desc: torch.Tensor) -> torch.Tensor:
    """Smallest k such that the k heaviest replicas form a quorum (int32).

    ``weights_desc`` must be sorted descending along the last axis. The
    paper calls these k replicas the *cabinet* (top t+1 weighted replicas).
    Vectorized over leading axes.
    """
    import torch

    csum = torch.cumsum(weights_desc, dim=-1)
    thresh = consensus_threshold(weights_desc)[..., None]
    # first index where cumulative weight STRICTLY exceeds T (see
    # repro_torch.core.quorum: >= admits disjoint quorums at exactly sum/2)
    meets = csum > thresh
    return (meets.to(torch.uint8).argmax(dim=-1) + 1).to(torch.int32)


def _descending(weights: torch.Tensor) -> torch.Tensor:
    import torch

    return torch.sort(weights, dim=-1, descending=True).values


def check_invariant_progress(weights: torch.Tensor, t: int) -> torch.Tensor:
    """Invariant I1 (progress): sum of top t+1 weights > T.

    ``weights`` need not be sorted. Vectorized over leading axes; returns a
    boolean tensor.
    """
    import torch

    top = torch.sum(_descending(weights)[..., : t + 1], dim=-1)
    return top > consensus_threshold(weights)


def check_invariant_safety(weights: torch.Tensor, t: int) -> torch.Tensor:
    """Invariant I2 (safety): no t-subset can form a quorum.

    Under strict-crossing quorums (sum > T) a t-subset is safe iff its
    weight is <= T; the worst case is the t heaviest replicas.
    """
    import torch

    if t == 0:
        return torch.ones(weights.shape[:-1], dtype=torch.bool,
                          device=weights.device)
    top_t = torch.sum(_descending(weights)[..., :t], dim=-1)
    return top_t <= consensus_threshold(weights)


def max_safe_t(weights: torch.Tensor) -> torch.Tensor:
    """Largest t for which I2 holds: the heaviest t sum strictly below T.

    Computed directly from the sorted prefix sums (int32). Vectorized.
    """
    import torch

    csum = torch.cumsum(_descending(weights), dim=-1)
    thresh = consensus_threshold(weights)[..., None]
    below = csum <= thresh * (1 + 1e-7)  # size-k prefix cannot form a quorum
    return torch.sum(below, dim=-1, dtype=torch.int32)


def solve_steepness(n: int, t: int, *, tol: float = 1e-9) -> float:
    """Find the largest steepness R such that invariants I1+I2 hold for
    failure threshold ``t`` with n replicas.

    I2 requires sum(top t) <= T = sum(all)/2, i.e.
        sum_{i<t} R^(n-1-i) <= 0.5 * sum_i R^(n-1-i).
    The LHS/total ratio is monotonically increasing in R, so bisection works.
    Returns the supremum of the feasible region minus a safety margin.
    """
    if not (1 <= t <= (n - 1) // 2):
        raise ValueError(f"t={t} outside 1..floor((n-1)/2) for n={n}")

    def top_t_fraction(r: float) -> float:
        # normalized exponents: scale-invariant and overflow-safe
        w = np.power(r, np.arange(0, -n, -1, dtype=np.float64))
        return float(w[:t].sum() / w.sum())

    # margin keeps I2 strictly safe under floating point: without it,
    # e.g. n=55/t=1 admits R=2.0 whose top-1 weight equals the threshold
    # to within 1 ulp and a SINGLE replica can "form a quorum"
    feasible = lambda r: top_t_fraction(r) <= 0.5 - 1e-9
    lo, hi = R_MIN, R_MAX
    if feasible(hi):
        return hi
    if not feasible(lo):
        return lo
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if feasible(mid):
            lo = mid
        else:
            hi = mid
    # small margin below the supremum so I2 holds strictly
    return max(R_MIN, lo * (1.0 - 1e-6))


def _by_rank(latency: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``values[rank]`` for each replica along the last axis (rank 0 =
    fastest): ``values`` scattered through the order, so that no rank
    tensor is formed. Ties rank by replica index, as the stable
    ``jnp.argsort`` does, on every device: -0.0 ties with +0.0 and NaN ranks
    last (:func:`sort_keys`)."""
    import torch

    from repro_torch.kernels.quorum_commit import sort_keys

    order = torch.sort(sort_keys(latency), dim=-1, stable=True).indices
    out = torch.empty(order.shape, dtype=values.dtype, device=latency.device)
    return out.scatter_(-1, order, values.expand_as(order))


def _ranks(latency: torch.Tensor) -> torch.Tensor:
    """Rank (0 = fastest) of each replica along the last axis."""
    import torch

    return _by_rank(latency, torch.arange(latency.shape[-1], device=latency.device))


# ---------------------------------------------------------------------------
# Dynamic weight assignment (paper §3.1 "Dynamic weight assignment")
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WeightTracker:
    """Latency-EMA state for dynamic per-object weights.

    ``latency_ema``: (num_objects, n) observed response-time EMA in ms.
    ``decay``: EMA decay (closer to 1 = slower adaptation).

    Replicas that respond faster for an object get higher weights for it:
    replicas are ranked per object by the EMA and given geometric weights by
    rank. Unlike the JAX package's immutable tracker, :meth:`observe`
    updates ``latency_ema`` in place, so that a tracker over millions of
    objects is not copied on every batch.
    """

    latency_ema: torch.Tensor  # (num_objects, n) float32
    decay: float = 0.9

    @staticmethod
    def init(num_objects: int, n: int, initial_latency_ms: float = 10.0,
             decay: float = 0.9, *, device: str | torch.device | None = None
             ) -> "WeightTracker":
        import torch

        return WeightTracker(
            latency_ema=torch.full((num_objects, n), initial_latency_ms,
                                   dtype=torch.float32,
                                   device=default_device(device)),
            decay=decay,
        )

    def observe(self, object_ids: torch.Tensor, latencies_ms: torch.Tensor
                ) -> "WeightTracker":
        """Fold a batch of observations into the EMA, in place; returns self.

        ``object_ids``: (batch,) integer; ``latencies_ms``: (batch, n). Which
        update wins for an id repeated within a batch is undefined.
        """
        import torch

        d = self.decay
        ids = object_ids.to(torch.int64)
        cur = self.latency_ema[ids]
        upd = d * cur + (1.0 - d) * latencies_ms.to(torch.float32)
        self.latency_ema[ids] = upd
        return self

    def weights(self, r: float) -> torch.Tensor:
        """Per-object geometric weights, (num_objects, n).

        Fastest (lowest EMA) replica per object gets the highest weight.
        """
        n = self.latency_ema.shape[-1]
        return _by_rank(self.latency_ema, geometric_weights(n, r, device=self.latency_ema.device))

    def ranks(self) -> torch.Tensor:
        """Rank (0 = fastest) of each replica per object."""
        return _ranks(self.latency_ema)


def node_weights_from_latency(latency_ema: torch.Tensor, r: float
                              ) -> torch.Tensor:
    """Global node weights for the slow path (paper §3.1, W^N).

    ``latency_ema``: (n,) cross-object replica latency EMA.
    """
    return _by_rank(latency_ema, geometric_weights(latency_ema.shape[-1], r,
                                                   device=latency_ema.device))


def _table(rs: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    w = np.stack([geometric_weights(7, float(r), device="cpu").numpy()
                  for r in rs])
    return rs, w, w.sum(axis=-1) / 2.0


def paper_table1() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reproduce the object-weighted distributions of paper Table 1.

    Returns (R values, weight matrix (4, 7), thresholds T^O (4,)).
    Rows: ObjA (t=1, R=1.40), ObjB (t=1, R=1.38), ObjC (t=2, R=1.25),
    ObjD (t=3, R=1.10).
    """
    return _table(np.array([1.40, 1.38, 1.25, 1.10]))


def paper_table2() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reproduce the node-weighted distributions of paper Table 2.

    Rows: t=1 (R=1.40), t=2 (R=1.38), t=3 (R=1.19), t=4 (R=1.08).
    """
    return _table(np.array([1.40, 1.38, 1.19, 1.08]))
