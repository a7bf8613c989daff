"""WOC-as-a-training-feature: weighted-quorum gradient commit.

The paper's exact problem — heterogeneous responders, mostly-independent
updates, occasional global coordination — reappears inside a 1000-node
data-parallel training job:

  * object  -> parameter BUCKET (per-layer-group gradients are independent
               objects; optimizer hyper-state is a hot object),
  * replica -> data-parallel worker (a mesh sub-slice),
  * weight  -> per-bucket geometric weight from the worker's step-latency
               EMA (paper §3.1's dynamic rule, clocked by training steps),
  * fast path commit -> a bucket's gradient commits once the contributing
               workers' weight strictly exceeds T^O = sum(w)/2; stragglers'
               contributions are dropped and the mean renormalizes over the
               committed set (unbiased under random assignment),
  * slow path -> full-participation barrier (mask of ones) for "hot" state:
               optimizer hyper updates, membership epochs, checkpoints.

Mechanically the commit is pure data-plane: each batch row belongs to one
dp worker (row block r), so scaling the LOSS MASK rows by the bucket's
committed-worker indicator (renormalized) makes the ordinary backward
reduction produce exactly the quorum-committed gradient — no extra
collectives, no graph change; the decision logic lives host-side where the
arrival information exists. ``quorum_allreduce`` additionally provides the
explicit form (a masked all-reduce over ``torch.distributed``) used when
gradients are reduced outside the autodiff path (e.g. with int8
compression).

Port of ``repro.coord.grad_quorum``: the controller is a numpy copy; the
JAX package's masked ``psum`` inside ``shard_map`` is an all-reduce over a
process group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import weights as W
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class QuorumState:
    latency_ema: np.ndarray        # (n_workers,) seconds
    steepness: float
    decay: float = 0.9
    committed_frac: float = 1.0

    def weights(self) -> np.ndarray:
        order = np.argsort(self.latency_ema, kind="stable")
        ranks = np.empty_like(order)
        ranks[order] = np.arange(len(order))
        # float64 + max-normalized exponents: at fleet sizes (n > ~50) the
        # f32 geometric series loses the light tail entirely and strict
        # majority checks break on precision
        n = len(order)
        expo = np.arange(n - 1, -1, -1, dtype=np.float64) - (n - 1)
        base = np.power(np.float64(self.steepness), expo)
        return base[ranks]


class GradQuorum:
    """Host-side controller: tracks worker step latencies, picks the
    committed set per step, and emits (a) scaled loss-mask row weights and
    (b) commit metrics/certificates."""

    def __init__(self, n_workers: int, *, t_fail: int = 1,
                 decay: float = 0.9):
        self.n = n_workers
        r = W.solve_steepness(n_workers, max(1, min(
            t_fail, (n_workers - 1) // 2))) if n_workers >= 3 else 1.5
        self.state = QuorumState(
            latency_ema=np.full(n_workers, 1.0), steepness=r, decay=decay)

    def observe(self, step_latencies: np.ndarray) -> None:
        d = self.state.decay
        self.state.latency_ema = (d * self.state.latency_ema
                                  + (1 - d) * step_latencies)

    def commit_mask(self, arrivals: Optional[np.ndarray] = None
                    ) -> np.ndarray:
        """Committed-worker mask for this step.

        ``arrivals``: measured per-worker gradient-ready times for the
        step (None -> use the latency EMA as the predictor). Workers join
        the quorum in arrival order until weight strictly exceeds T.
        """
        t = self.state.latency_ema if arrivals is None else arrivals
        w = self.state.weights()
        order = np.argsort(t, kind="stable")
        csum = np.cumsum(w[order])
        thresh = w.sum() / 2.0
        k = int(np.searchsorted(csum, thresh, side="right")) + 1
        k = min(k, self.n)
        mask = np.zeros(self.n, bool)
        mask[order[:k]] = True
        self.state.committed_frac = k / self.n
        return mask

    def row_weights(self, mask: np.ndarray) -> np.ndarray:
        """Per-worker loss-row scale: m_r * n / sum(m) (renormalized)."""
        m = mask.astype(np.float64)
        return (m * self.n / max(m.sum(), 1.0)).astype(np.float32)

    def scale_batch_mask(self, batch: dict, mask: np.ndarray) -> dict:
        """Scale the loss mask rows by the committed-worker weights.

        Batch rows are laid out worker-major (row block r belongs to dp
        worker r), matching the dp sharding of the global batch.
        """
        rw = self.row_weights(mask)
        B = batch["mask"].shape[0]
        per = B // self.n
        rows = np.repeat(rw, per)
        out = dict(batch)
        out["mask"] = batch["mask"] * rows[:, None]
        return out

    def certificate(self, step: int, mask: np.ndarray) -> dict:
        w = self.state.weights()
        return {"step": step, "committed": mask.tolist(),
                "weight": float(w[mask].sum()),
                "threshold": float(w.sum() / 2.0),
                "frac": self.state.committed_frac}

    # ---- analytics: expected step-time win (order statistics) --------------

    def expected_step_time(self, latency_dist: np.ndarray,
                           trials: int = 2000, seed: int = 0
                           ) -> Dict[str, float]:
        """Monte-Carlo E[step time] under full barrier vs quorum commit.

        latency_dist: (n,) per-worker mean step latencies; each trial draws
        exponential noise around the means (heavy straggler tail).
        """
        rng = np.random.default_rng(seed)
        w = self.state.weights()
        thresh = w.sum() / 2.0
        full, quorum = [], []
        for _ in range(trials):
            t = latency_dist * (0.7 + 0.6 * rng.random(self.n)) \
                + rng.exponential(0.1 * latency_dist)
            full.append(t.max())
            order = np.argsort(t)
            csum = np.cumsum(w[order])
            k = int(np.searchsorted(csum, thresh, side="right")) + 1
            quorum.append(t[order[min(k, self.n) - 1]])
        return {"barrier_mean_s": float(np.mean(full)),
                "quorum_mean_s": float(np.mean(quorum)),
                "speedup": float(np.mean(full) / np.mean(quorum))}


# ---------------------------------------------------------------------------
# explicit masked reduction (torch.distributed form)
# ---------------------------------------------------------------------------

def quorum_allreduce(grads, mask, group=None):
    """Masked mean over the ranks of ``group`` (default: the whole world):
    each rank contributes its gradient scaled by its commit bit
    ``mask[rank]``; the sum renormalizes by the committed count, at least 1.
    mask: (n_workers,) float. Every rank calls it with the same tree; as in
    the JAX package, a gradient below float32 comes back in float32. On a
    ``DeviceMesh`` the workers are the dp dimension's ranks: pass
    ``group=mesh.get_group("data")`` and each rank's local gradients (the
    JAX package's masked ``psum`` over the ``"data"`` axis)."""
    m = torch.as_tensor(mask, dtype=torch.float32)[dist.get_rank(group)]
    m = m.to(tree_leaves(grads)[0].device)
    count = m.clone()
    dist.all_reduce(count, group=group)
    summed = tree_map(
        lambda g: g.to(torch.promote_types(g.dtype, torch.float32)) * m, grads)
    for g in tree_leaves(summed):
        dist.all_reduce(g, group=group)
    return tree_map(lambda g: g / torch.clamp_min(count, 1.0), summed)
