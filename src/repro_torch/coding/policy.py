"""Adaptive full-copy vs (k, m) stripe decision (Crossword, PAPERS.md).

Crossword's insight: replication degree is a per-instance dial. A small
value is cheapest as n-1 full copies (one message each, any quorum
commits it); a large value is cheapest split into k data + m parity
shards with ONE distinct shard per quorum member — the coordinator ships
(k+m)/k of the payload instead of (n-1)x, at the price of needing a
*reconstructable* set durable before commit, not just a weighted
majority of acks.

The policy folds in exactly the signals the weighted-quorum machinery
already tracks:

  * payload size (``op.size``) against the configured stripe floor,
  * liveness (heartbeat-fresh peers only get shards — a stripe assigned
    to a suspected-dead replica is a commit stall waiting to happen),
  * the object's weighted-quorum composition (if the healthy set plus
    self cannot strictly cross T^O, a striped round could gather shards
    but never a committing quorum — fall back to full copy),
  * link-health EMAs (data shards, which every reader needs, go to the
    fastest links; parity shards to the slowest).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.coding import rs


@dataclasses.dataclass(frozen=True)
class StripePlan:
    """One op's striping decision.

    ``assign`` maps replica id -> shard index (one distinct shard per
    healthy peer; the coordinator keeps the full value). ``need`` is the
    weighted-reconstructable floor: the number of DISTINCT assigned
    shards that must be acked before commit so that after any further
    ``t_fail - 1`` assignee failures (the origin's own failure being the
    t-th) at least ``k`` shards survive to decode.
    """
    k: int
    m: int
    need: int
    assign: Dict[int, int]


def choose_plan(rep, cfg, op, now: float) -> Optional[StripePlan]:
    """Stripe ``op`` or ship full copies? ``rep`` is the coordinating
    replica (BaseReplica machinery), ``cfg`` a CodingConfig."""
    if op.kind != "w" or op.size < cfg.stripe_min_bytes:
        return None
    hb_to = rep.HB_TIMEOUT
    last_hb = rep.last_hb
    healthy = [r for r in rep._others if now - last_hb[r] <= hb_to]
    m = max(cfg.parity, 1)
    k = len(healthy) - m
    if k < 2:
        return None               # stripe degenerates to replication
    # byte economy: (k+m) shard transmissions must beat n-1 full copies
    # (ceil-division padding can tip small payloads back to full copy)
    if (k + m) * rs.shard_len(op.size, k) >= len(rep._others) * op.size:
        return None
    # weighted feasibility: shards only go to the healthy set, so the
    # healthy set plus self must be able to strictly cross the object's
    # threshold — otherwise the round could gather every shard ack and
    # still never commit
    w = rep.obj_weights.weights_for(op.obj)
    acc = float(w[rep.node_id])
    for r in healthy:
        acc += float(w[r])
    if acc <= rep.obj_weights.threshold_for(op.obj):
        return None
    # link-health EMA ordering: data shards (index < k, the ones every
    # reader wants first) ride the fastest links
    node_ema = rep.node_ema
    order = sorted(healthy, key=lambda r: (node_ema[r], r))
    assign = {r: i for i, r in enumerate(order)}
    need = min(k + rep.t_fail - 1, k + m)
    return StripePlan(k=k, m=m, need=need, assign=assign)
