"""Object Manager: classification, in-flight conflict map, dual-path routing.

Paper §3.3 and §4.2: the Object Manager

  * maintains per-object statistics (operation frequency, conflict rate,
    access latency),
  * classifies every object as INDEPENDENT / COMMON / HOT,
  * tracks in-flight operations per object (the Theorem-2 machinery), and
  * routes operations: independent & conflict-free -> fast path, everything
    else -> slow path.

The manager is deliberately a plain-Python control-plane component: in the
discrete-event simulator there is one per replica (the "shared in-flight
map maintained by all replicas" of Fig. 3 is each replica's local view,
kept consistent by the commit broadcasts), and in the training runtime one
per host. The *data-plane* math (quorum formation) lives in
:mod:`repro_torch.core.quorum` / the Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Set


class ObjectClass(enum.Enum):
    INDEPENDENT = "independent"   # single-writer, fast-path eligible
    COMMON = "common"             # shared, occasional conflicts -> slow path
    HOT = "hot"                   # frequent simultaneous access -> slow path


class Route(enum.Enum):
    FAST = "fast"
    SLOW = "slow"


@dataclasses.dataclass(eq=False, slots=True)
class ObjectStats:
    """Continuously-updated per-object access statistics (paper §3.3)."""

    ops: int = 0                      # total operations observed
    conflicts: int = 0                # ops that found another op in flight
    distinct_clients: Set[int] = dataclasses.field(default_factory=set)
    latency_ema_ms: float = 0.0       # commit latency EMA
    last_access: float = 0.0          # sim-time of last access
    concurrent_peak: int = 0          # max simultaneous in-flight ops seen

    def conflict_rate(self) -> float:
        return self.conflicts / self.ops if self.ops else 0.0


# In-flight records are plain ``op_id -> registered_time`` floats (the
# only field any consumer ever read was the start time; a record object
# per operation was pure allocator churn on the route hot path).


class ObjectManager:
    """Routing + conflict tracking for one replica.

    Classification thresholds follow the paper's taxonomy:
      * an object touched by >1 distinct client is at least COMMON,
      * conflict_rate above ``hot_conflict_rate`` (or concurrent access
        beyond ``hot_concurrency``) marks it HOT,
      * objects may be *demoted* back toward INDEPENDENT when a sliding
        window of accesses shows no conflicts (adaptive, §3.3 "adapts
        continuously").
    """

    def __init__(self, *, hot_conflict_rate: float = 0.25,
                 hot_concurrency: int = 3, demote_after_ops: int = 8,
                 latency_decay: float = 0.9, post_migration_slow: int = 1):
        # stats value is either a full ObjectStats record, or — for the
        # overwhelmingly common case of an object seen exactly once (a
        # private single-writer namespace draw) — a compact int marker
        # holding the sole accessing client id; the record materializes
        # on the second access (see route()).
        self.stats: Dict[int, object] = {}
        self.in_flight: Dict[int, Dict[int, float]] = {}  # obj -> op_id -> t0
        self.classes: Dict[int, ObjectClass] = {}
        self.hot_conflict_rate = hot_conflict_rate
        self.hot_concurrency = hot_concurrency
        self.demote_after_ops = demote_after_ops
        self.latency_decay = latency_decay
        self.post_migration_slow = post_migration_slow
        self._clean_streak: Dict[int, int] = {}  # conflict-free ops in a row
        # sharded deployments: per-object ownership epoch (bumped every
        # WPaxos-style ownership transfer) + count of remaining forced-slow
        # ops after a custody change (conservative re-entry window while
        # replayed duplicates from the old owner group may still arrive)
        self.epochs: Dict[int, int] = {}
        self._fresh: Dict[int, int] = {}
        # optional hook (repro_torch.core.leases): custody changes void any read
        # lease this replica holds on the object — the new owner group never
        # saw our grant round, so serving from it would miss their writes
        self.lease_invalidate = None

    # -- ownership epochs (sharded deployments, WPaxos-style stealing) ------

    def note_ownership(self, obj: int, epoch: int) -> bool:
        """Record a custody change for ``obj`` at ownership ``epoch``.

        Returns True (and resets the object's conflict history, in-flight
        entries and classification) when the epoch is new: statistics
        gathered under the previous owner group describe a different
        contention regime and must not leak into routing here. The next
        ``post_migration_slow`` operations are forced onto the slow path —
        the safe re-entry window for ops replayed across the migration.
        """
        if epoch <= self.epochs.get(obj, 0):
            return False
        self.epochs[obj] = epoch
        self.stats.pop(obj, None)
        self.in_flight.pop(obj, None)
        self.classes.pop(obj, None)
        self._clean_streak.pop(obj, None)
        if self.lease_invalidate is not None:
            self.lease_invalidate(obj)
        if self.post_migration_slow > 0:
            self._fresh[obj] = self.post_migration_slow
        return True

    def ownership_epoch(self, obj: int) -> int:
        return self.epochs.get(obj, 0)

    # -- classification ----------------------------------------------------

    def classify(self, obj: int) -> ObjectClass:
        return self.classes.get(obj, ObjectClass.INDEPENDENT)

    def _reclassify(self, obj: int) -> None:
        st = self.stats[obj]
        streak = self._clean_streak.get(obj, 0)
        if (st.conflict_rate() >= self.hot_conflict_rate
                or st.concurrent_peak >= self.hot_concurrency):
            cls = ObjectClass.HOT
        elif len(st.distinct_clients) > 1:
            cls = ObjectClass.COMMON
        else:
            cls = ObjectClass.INDEPENDENT
        # adaptive demotion: a long conflict-free streak clears HOT/COMMON
        if cls is not ObjectClass.INDEPENDENT and streak >= self.demote_after_ops:
            st.conflicts = 0
            st.concurrent_peak = len(self.in_flight.get(obj, {}))
            cls = (ObjectClass.COMMON if len(st.distinct_clients) > 1
                   else ObjectClass.INDEPENDENT)
        self.classes[obj] = cls

    # -- routing (Algorithm 1, lines 2-3) ----------------------------------

    def route(self, obj: int, op_id: int, client: int, coordinator: int,
              now: float) -> Route:
        """Record the op as in flight and decide its path.

        Fast path iff the object is classified INDEPENDENT *and* has no
        conflicting in-flight operation (Theorem 2's cross-path guard).
        """
        st = self.stats.get(obj)
        inflight = self.in_flight.get(obj)
        conflicted = bool(inflight)
        if st is None and not conflicted and not self._fresh:
            # first-ever access on a quiet object (private single-writer
            # namespaces dominate every workload mix): trivially
            # INDEPENDENT and fast-path eligible. Record only the compact
            # client marker; full stats materialize on a second access.
            self.stats[obj] = client
            if inflight is None:
                self.in_flight[obj] = {op_id: now}
            else:
                inflight[op_id] = now
            self._clean_streak[obj] = 1
            return Route.FAST
        if st is None:
            st = self.stats[obj] = ObjectStats()
        elif type(st) is int:
            # upgrade the first-access marker (ops=1, that one client,
            # no conflicts, peak 1 — exactly what the full path would
            # have recorded)
            st = ObjectStats(ops=1, distinct_clients={st},
                             concurrent_peak=1)
            self.stats[obj] = st
        if inflight is None:
            inflight = self.in_flight[obj] = {}

        st.ops += 1
        st.distinct_clients.add(client)
        st.last_access = now
        if len(inflight) >= st.concurrent_peak:
            st.concurrent_peak = len(inflight) + 1
        if conflicted:
            st.conflicts += 1
            self._clean_streak[obj] = 0
        else:
            self._clean_streak[obj] = self._clean_streak.get(obj, 0) + 1

        inflight[op_id] = now
        self._reclassify(obj)

        fresh = self._fresh.get(obj, 0)
        if fresh:                        # just migrated here: route slow
            if fresh <= 1:
                self._fresh.pop(obj, None)
            else:
                self._fresh[obj] = fresh - 1
            return Route.SLOW
        if conflicted or self.classes[obj] is not ObjectClass.INDEPENDENT:
            return Route.SLOW
        return Route.FAST

    def has_conflict(self, obj: int, op_id: Optional[int] = None) -> bool:
        """Does ``obj`` have an in-flight op other than ``op_id``?"""
        inflight = self.in_flight.get(obj, {})
        if op_id is None:
            return bool(inflight)
        return any(k != op_id for k in inflight)

    def complete(self, obj: int, op_id: int, now: float) -> None:
        """Commit/abort notification: remove from in-flight, fold latency."""
        d = self.in_flight.get(obj)
        started = d.pop(op_id, None) if d else None
        if started is not None:
            st = self.stats.get(obj)
            if type(st) is ObjectStats:   # compact markers carry no EMA
                lat = now - started
                d = self.latency_decay
                st.latency_ema_ms = (d * st.latency_ema_ms + (1 - d) * lat
                                     if st.ops > 1 else lat)

    # -- introspection ------------------------------------------------------

    def snapshot(self) -> Dict[int, ObjectClass]:
        # compact first-access markers are INDEPENDENT by construction
        out = {obj: ObjectClass.INDEPENDENT
               for obj, st in self.stats.items() if type(st) is int}
        out.update(self.classes)
        return out

    def inflight_count(self) -> int:
        return sum(len(v) for v in self.in_flight.values())
