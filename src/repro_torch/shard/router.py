"""ShardRouter client layer: owner-aware batch routing + redirects.

Each client owns a cached :class:`ShardMap` view. Every generated batch
is split into per-group sub-batches sent to a replica of the believed
owner group; a ``shard_redirect`` (NOT_OWNER, or a fenced op released
after a migration) moves the affected ops into a fresh sub-batch aimed
at the hinted owner, with the epoch guarding against stale hints.

Locality modes (the object-space side of the §5-style workloads):

  * ``uniform``  — the client's private (independent) objects are drawn
    uniformly from the slice of the object space whose hash partition is
    the client's home group: a fully local uniform workload. Shared
    common/hot objects stay wherever the hash puts them.
  * ``mixed``    — like ``uniform`` but only with probability ``p_local``;
    the rest of the private draws land on arbitrary groups (tunable
    cross-group traffic for the degradation sweep).
  * ``drift``    — a skewed working set of ``working_set`` private objects
    (re-drawn gradually every ``drift_every`` submitted batches) hit with
    probability ``p_working``. Working-set objects hash to arbitrary
    groups, so locality is initially poor; repeated remote accesses
    trigger ``shard_steal_hint``s to the client's home gate, and
    WPaxos-style stealing migrates the hot objects home.

Steal hints are only raised for private-namespace objects (below the
shared common/hot bit markers): migrating an object many clients in many
regions share would just make it ping-pong.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.runner import client_target_fn
from repro_torch.core.simulator import Client, Msg, Op, Simulation, Workload
from repro_torch.shard.shard_map import ShardMap

SHARED_OBJ_BASE = 1 << 60       # common/hot namespaces (see Workload)


@dataclasses.dataclass(frozen=True)
class ShardWorkload:
    """Locality layer on top of the base operation mix."""

    locality: str = "uniform"        # "uniform" | "mixed" | "drift"
    p_local: float = 0.9             # mixed: fraction of home-group draws
    working_set: int = 16            # drift: hot private objects per client
    p_working: float = 0.85          # drift: P(draw from working set)
    drift_every: int = 400           # drift: batches between partial refresh
    drift_fraction: float = 0.5      # drift: share of the set replaced
    base: Workload = dataclasses.field(default_factory=Workload)


class ShardClient(Client):
    """Open-loop client + shard router (owner cache, redirects, hints)."""

    def __init__(self, node_id: int, sim: Simulation, *, protocol: str,
                 n_groups: int, group_size: int, home_group: int,
                 client_index: int, shard_workload: ShardWorkload,
                 steal_threshold: int = 3, map_seed: int = 0, **kw):
        super().__init__(node_id, sim, workload=shard_workload.base,
                         target_fn=lambda k: 0, **kw)
        self.protocol = protocol
        self.n_groups = n_groups
        self.gs = group_size
        self.home = home_group
        self.cindex = client_index
        self.swl = shard_workload
        self.smap = ShardMap(n_groups, seed=map_seed)
        # one shared replica-choice policy per group (leader pin vs
        # round-robin), offset into that group's global id block
        self._target_fns = [
            client_target_fn(protocol, client_index, group_size,
                             offset=g * group_size)
            for g in range(n_groups)]
        self.steal_threshold = steal_threshold
        self._remote_hits: Dict[int, int] = {}
        self._wset: List[int] = []
        # metrics
        self.remote_ops = 0
        self.redirected_ops = 0
        self.hints_sent = 0

    # -- object sampling (locality modes) ------------------------------------

    def _sample_local(self) -> int:
        """Rejection-sample a private object whose hash partition is the
        home group (expected n_groups tries; capped for safety)."""
        rng = self.rng
        for _ in range(64):
            obj = (self.node_id << 24) | int(rng.random() * (1 << 20))
            if self.smap.default_group(obj) == self.home:
                return obj
        return obj

    def _sample_private_any(self) -> int:
        return (self.node_id << 24) | int(self.rng.random() * (1 << 20))

    def _refresh_wset(self) -> None:
        w = self.swl
        if not self._wset:
            self._wset = [self._sample_private_any()
                          for _ in range(w.working_set)]
            return
        k = max(1, int(w.working_set * w.drift_fraction))
        for _ in range(k):
            i = int(self.rng.integers(0, len(self._wset)))
            self._wset[i] = self._sample_private_any()

    def _sample_object(self) -> int:
        w = self.swl
        obj = super()._sample_object()       # base operation mix (90/5/5)
        if obj >= SHARED_OBJ_BASE:
            return obj                       # shared objects stay hash-placed
        if w.locality == "drift":
            if self.rng.random() < w.p_working and self._wset:
                return self._wset[int(self.rng.integers(0, len(self._wset)))]
            return obj                       # fresh private draw, any group
        if w.locality == "mixed" and self.rng.random() >= w.p_local:
            return obj                       # deliberate cross-group draw
        # "uniform" and local "mixed": keep the draw when it already lands
        # on the home group (with G=1 that is always, so the rng stream —
        # and hence the whole run — is bit-identical to the flat Client),
        # else redraw from the home-group slice
        if self.smap.default_group(obj) == self.home:
            return obj
        return self._sample_local()

    # -- routing ---------------------------------------------------------------

    def _group_target(self, group: int, k: int) -> int:
        base = group * self.gs
        t = self._target_fns[group](k)
        for _ in range(self.gs):
            if self._suspect.get(t, 0.0) < self.sim.now:
                return t
            t = base + ((t - base) + 1) % self.gs
        return t

    def _note_remote(self, obj: int, group: int) -> None:
        """Count a remote access; hint the home gate at the threshold."""
        self.remote_ops += 1
        if (self.steal_threshold <= 0 or obj >= SHARED_OBJ_BASE
                or group == self.home):
            return
        hits = self._remote_hits.get(obj, 0) + 1
        self._remote_hits[obj] = hits
        if hits % self.steal_threshold == 0:
            self.hints_sent += 1
            self.send(self.home * self.gs, "shard_steal_hint",
                      {"obj": obj, "client": self.node_id})

    def _dispatch(self, ops: List[Op]) -> None:
        """Split ops by believed owner and send one sub-batch per group."""
        by_group: Dict[int, List[Op]] = {}
        for op in ops:
            grp, _ = self.smap.owner(op.obj)
            by_group.setdefault(grp, []).append(op)
            if grp != self.home:
                self._note_remote(op.obj, grp)
        for grp, sub in by_group.items():
            bid = self._new_batch_id()
            target = self._group_target(grp, self.submitted)
            rec = {"ops": sub, "attempt": 0, "target": target, "group": grp,
                   "unacked": {op.op_id for op in sub}}
            self._open[bid] = rec
            self.send(target, "client_req",
                      {"batch_id": bid, "ops": sub}, size_ops=len(sub),
                      size_bytes=self._ops_bytes(sub))
            rec["timer"] = self.set_timer(self.RETRY, "client_retry",
                                          {"bid": bid})

    def _make_batch(self) -> List[Op]:
        if (self.swl.locality == "drift"
                and self.submitted % max(1, self.swl.drift_every) == 0):
            self._refresh_wset()
        return super()._make_batch()

    # -- replies ------------------------------------------------------------------

    def on_shard_redirect(self, msg: Msg, now: float) -> None:
        """NOT_OWNER (or post-migration fence release): learn the custody
        hint and re-dispatch the affected ops to the new owner."""
        rec = self._open.get(msg.payload["batch_id"])
        moved: List[Op] = []
        for op_id, obj, group, epoch in msg.payload["redirects"]:
            self.smap.record(obj, group, epoch)
            if rec is None or op_id in self._acked:
                continue
            for op in rec["ops"]:
                if op.op_id == op_id:
                    moved.append(op)
                    break
        if rec is not None and moved:
            rec["ops"] = [op for op in rec["ops"] if op not in moved]
            rec["unacked"] = {op.op_id for op in rec["ops"]} - self._acked
            if not rec["unacked"]:
                self._close_batch(msg.payload["batch_id"], rec)
        if moved:
            self.redirected_ops += len(moved)
            self._dispatch(moved)

    def on_shard_owner_update(self, msg: Msg, now: float) -> None:
        for obj, group, epoch in msg.payload["updates"]:
            self.smap.record(obj, group, epoch)

    # -- retries -------------------------------------------------------------------

    def _retry_target(self, rec: dict) -> int:
        grp = rec["group"]
        target = self._group_target(grp, self.submitted
                                    + rec["attempt"] * 7 + 1)
        if target == rec["target"]:
            base = grp * self.gs
            target = base + ((target - base) + 1) % self.gs
        return target
