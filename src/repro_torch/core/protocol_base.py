"""Shared replica machinery: in-flight map, weights, heartbeats, election.

All four protocol implementations (WOC, Cabinet, EPaxos, MultiPaxos) extend
:class:`BaseReplica`. It provides:

  * an **in-flight map** ``obj -> {op_id: registered_time}`` with lazy
    timeout GC (Theorem 2's shared conflict-tracking state, Fig. 3),
  * **node-weight tracking** (latency EMA -> rank -> geometric weight,
    paper §3.1 "slow path" weights / Cabinet §2.1),
  * **object-weight tracking** (per-object latency EMA -> geometric weight,
    paper §3.2) backed by numpy for event-loop speed,
  * a heartbeat failure detector + rank-order **leader election**
    (simplified Cabinet view change: the highest-weighted replica believed
    alive is the leader; followers only accept proposals from their current
    leader; idempotent RSM apply makes leader hand-off duplicate-safe).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import weights as W
from repro_torch.core.rsm import RSM
from repro_torch.core.simulator import Msg, Node, Simulation


class ObjectWeightTable:
    """Per-object latency EMA -> geometric weights (numpy, event-loop fast).

    The returned weight vectors are permutations of ``base`` and treated as
    read-only by callers, so the node-level fallback (the common case: a
    first-touch object has no EMA of its own) is cached and recomputed only
    when the node EMA changes (``node_version`` is bumped by
    ``BaseReplica.observe_node``).
    """

    def __init__(self, n: int, r: float, node_ema: np.ndarray,
                 decay: float = 0.85):
        self.n = n
        # numpy twin of the jax weight kernel: the simulator path must not
        # execute jax (forked parallel-shard workers — see weights.py)
        self.base = W.geometric_weights_np(n, r)           # descending by rank
        self.half_sum = float(self.base.sum()) / 2.0
        self.decay = decay
        # per-object EMAs are plain float lists: element updates in
        # ``observe`` are ~5x cheaper than numpy scalar writes, and the
        # argsort in ``_weights_of`` converts on the (much rarer) read
        self.ema: Dict[int, list] = {}
        self.node_ema = node_ema  # shared fallback: node-level latency EMA
        self.node_version = 0
        self._nw_version = -1
        self._nw: np.ndarray | None = None
        self._ranks = np.empty(n, dtype=np.int64)   # scratch
        self._arange = np.arange(n)
        # installed weight view (repro_torch.core.reassign): while active, the
        # epoch-stamped ranking overrides BOTH the per-object EMAs and
        # the node-level ranking — the view is the shared truth all
        # replicas quorum under, private telemetry resumes on restore.
        self.rank_of: np.ndarray | None = None
        # flat fallback (graceful degradation): when the view-weighted
        # heartbeat-fresh set cannot strictly cross half_sum, quorums
        # degrade to count-majorities (weights 1, threshold n/2)
        self.flat = False
        self._flat_w = np.ones(n, dtype=np.float64)
        self._flat_threshold = n / 2.0

    def observe(self, obj: int, replica: int, latency: float) -> None:
        e = self.ema.get(obj)
        if e is None:
            e = self.ema[obj] = self.node_ema.tolist()
        e[replica] = self.decay * e[replica] + (1 - self.decay) * latency

    def _weights_of(self, e: np.ndarray) -> np.ndarray:
        order = np.argsort(e, kind="stable")      # fastest first
        ranks = self._ranks
        ranks[order] = self._arange
        return self.base[ranks]

    def view_weights(self) -> np.ndarray:
        """Node weights under the current view, ignoring the flat
        fallback (the fallback's own trigger test needs these)."""
        if self._nw_version != self.node_version:
            ro = self.rank_of
            self._nw = self.base[ro] if ro is not None \
                else self._weights_of(self.node_ema)
            self._nw_version = self.node_version
        return self._nw

    def node_weights(self) -> np.ndarray:
        """Node-level weights, cached per node-EMA/view version."""
        if self.flat:
            return self._flat_w
        return self.view_weights()

    def weights_for(self, obj: int) -> np.ndarray:
        if self.flat:
            return self._flat_w
        if self.rank_of is not None:
            return self.view_weights()
        e = self.ema.get(obj)
        if e is None:
            return self.view_weights()
        return self._weights_of(e)

    def current_threshold(self) -> float:
        return self._flat_threshold if self.flat else self.half_sum

    def threshold_for(self, obj: int) -> float:
        return self.current_threshold()            # T^O = sum(W^O)/2

    def shared_weights(self) -> np.ndarray:
        """Weights under the SHARED election ranking: the epoch-stamped
        installed view when present (``view_weights`` is then exactly
        ``base[rank_of]``, cached), else the static deployment ranking
        (replica id == rank). Unlike ``node_weights`` this never consults
        the private latency EMA: every node zeroes its own EMA entry and
        so ranks ITSELF top-weight in its private view, which would let
        two partition sides both believe they hold the weighted
        majority. The leadership lease and the isolation detector must
        evaluate one vector that is identical at every replica."""
        if self.flat:
            return self._flat_w
        if self.rank_of is not None:
            return self.view_weights()
        return self.base

    def set_rank_override(self, ranking) -> None:
        """Install (or with ``None`` clear) an epoch-stamped ranking:
        ``ranking[0]`` gets the top geometric weight. Per-object EMAs
        are dropped either way — telemetry gathered under the previous
        weight regime must not leak into the new one."""
        if ranking is None:
            self.rank_of = None
        else:
            ro = np.empty(self.n, dtype=np.int64)
            ro[np.asarray(ranking, dtype=np.int64)] = self._arange
            self.rank_of = ro
        self.ema.clear()
        self.node_version += 1


class BaseReplica(Node):
    HB_INTERVAL = 10e-3
    HB_TIMEOUT = 45e-3

    def __init__(self, node_id: int, sim: Simulation, *, t_fail: int,
                 steepness: Optional[float] = None, group_cap: int = 64,
                 leases=None, reassign=None, coding=None):
        super().__init__(node_id, sim)
        n = sim.n
        self.t_fail = t_fail
        # slow-path group-commit cap: one consensus instance carries at most
        # this many ops (= the experiment's client batch size, so Cabinet's
        # per-client-batch instances and WOC's merged forwards amortize the
        # leader round identically — "reordering ... within the same batch")
        self.group_cap = group_cap
        self.r = steepness if steepness is not None else W.solve_steepness(
            n, max(1, min(t_fail, (n - 1) // 2)))
        self.rsm = RSM()
        # node-level latency EMA; initial ranking = replica id order (the
        # simulator's speed() is non-decreasing in id, and a deployment
        # would bootstrap from measured pings). A node is its own fastest
        # responder (zero network distance): EMA[self] = 0, so a slow-path
        # leader carries the top weight w_1 (paper Table 2) and a fast-path
        # coordinator's self-vote is the heaviest for objects it serves.
        self.node_ema = np.array(
            [10e-3 * (1 + 0.01 * i) for i in range(n)], dtype=np.float64)
        self.node_ema[node_id] = 0.0
        self.obj_weights = ObjectWeightTable(n, self.r, self.node_ema)
        # hot-path precomputes: this replica's speed-scaled per-op costs
        # and its broadcast peer list (both constants for the run)
        sp = sim.costs.speed(node_id)
        self._coord_cost = sim.costs.c_coord * sp
        self._apply_cost = sim.costs.c_apply * sp
        self._others = [r for r in range(n) if r != node_id]
        # in-flight conflict map with lazy GC
        self.in_flight: Dict[int, Dict[int, float]] = {}
        self.gc_timeout = sim.costs.timeout * 4
        # failure detector
        self.last_hb = [0.0] * n
        self._hb_armed = False
        # leadership memo: (leader, valid_until). Invalidated by any event
        # that could surface a better (lower-rank) leader: a heartbeat
        # from a smaller id, recovery transitions, self-candidacy opening.
        self._leader_memo = -1
        self._leader_until = -1.0
        # per-(client,batch) commit credits, coalesced per commit handler
        self._credit_buf: Dict[tuple, int] = {}
        # dependency-ordered apply: obj -> FIFO of (op, deps, path) waiting
        # for their cross-path predecessors to be applied first (Theorem 2
        # machinery — see docstring of deferred_apply)
        self._obj_buffer: Dict[int, list] = {}
        # leader-side: last slow-path op applied per object (fast commits on
        # that object must order after it at every replica)
        self.last_slow: Dict[int, int] = {}
        # last op applied per object on ANY path: the leader stamps it as a
        # dependency when co-signing a fast round, so back-to-back fast
        # commits on one object (different coordinators) cannot apply in
        # different orders at replicas outside the second quorum — a
        # reorder window that opens when an object is re-accessed faster
        # than commit broadcasts propagate (sharded drift workloads)
        self.last_applied: Dict[int, int] = {}
        # leader-side: count of queued/in-instance slow ops per object
        self._slow_obj_count: Dict[int, int] = {}
        # crash-recovery state transfer
        self.recovering = False
        self._recovery_buf: list = []
        self._lead_after = 0.0       # no self-candidacy before this time
        # partition-heal re-sync: set while a majority of peers is
        # heartbeat-stale (we may be cut off and missing commits — there
        # is no retransmission of old commits, so our log grows holes);
        # cleared when the heal-triggered state transfer completes.
        self._isolated = False
        self._hb_timer = None
        # accepted-op recovery (the Paxos phase-1 obligation, sweep-style):
        # op_id -> (op, last_seen, driver) for ops this replica accepted
        # (slow proposals, fast co-signs) whose commit it has not applied.
        # If the driving node goes heartbeat-stale, the op may have been
        # DECIDED right before the driver vanished (its commit broadcast
        # lost with it) — re-propose through the slow path, which is safe
        # either way because application is op_id-idempotent. In healthy
        # runs drivers stay fresh and the sweep never sends a message.
        self._accepted_ops: Dict[int, tuple] = {}
        self._sweep_armed = False
        # read leases (repro_torch.core.leases): None unless the Scenario's
        # default-off ``leases`` knob is set — every hook below is guarded
        # by an ``is not None`` test, so disabled runs stay bit-identical.
        # The promise fields back the leader lease: while fresh, this
        # replica accepts slow proposals only from ``_promise_to`` and
        # never self-candidates (with leases off both stay at their
        # sentinels and every check short-circuits).
        self._promise_to = -1
        self._promise_until = -1.0
        if leases is not None:
            from repro_torch.core.leases import LeaseManager
            self.lease_mgr = LeaseManager(self, leases)
        else:
            self.lease_mgr = None
        # online weight reassignment (repro_torch.core.reassign): None unless
        # the Scenario's default-off ``reassign`` knob is set. The
        # manager piggybacks on the heartbeat timer and sends nothing
        # without confirmed fault evidence, so knob-on fault-free runs
        # stay bit-identical to knob-off runs (pinned in tests).
        if reassign is not None:
            from repro_torch.core.reassign import ReassignManager
            self.reassign_mgr = ReassignManager(self, reassign)
        else:
            self.reassign_mgr = None
        # payload striping (repro_torch.coding): None unless the Scenario's
        # default-off ``coding`` knob is set. The manager binds itself as
        # the RSM's read resolver; with the knob off the resolver stays
        # None and every hook below short-circuits on one attribute read.
        if coding is not None:
            from repro_torch.coding.manager import CodingManager
            self.coding_mgr = CodingManager(self, coding)
            self.rsm.resolver = self.coding_mgr.resolve_read
        else:
            self.coding_mgr = None

    # -- weights -------------------------------------------------------------

    def node_weights(self) -> np.ndarray:
        # node and object weights share one geometric base (same n, same
        # steepness): the table's version-cached node-level ranking IS the
        # node weighting, and half_sum is T^N = sum(W^N)/2
        return self.obj_weights.node_weights()

    def node_threshold(self) -> float:
        return self.obj_weights.current_threshold()

    def observe_node(self, replica: int, latency: float, decay=0.85) -> None:
        self.node_ema[replica] = (decay * self.node_ema[replica]
                                  + (1 - decay) * latency)
        self.obj_weights.node_version += 1
        if self.reassign_mgr is not None:
            self.reassign_mgr.note_sample(replica, latency)

    # -- in-flight map (Theorem 2 machinery) ----------------------------------

    def register_inflight(self, obj: int, op_id: int, now: float) -> None:
        d = self.in_flight.get(obj)
        if d is None:
            self.in_flight[obj] = {op_id: now}
        else:
            d[op_id] = now

    def clear_inflight(self, obj: int, op_id: int) -> None:
        d = self.in_flight.get(obj)
        if d is not None:
            d.pop(op_id, None)
            if not d:
                self.in_flight.pop(obj, None)

    def has_conflict(self, obj: int, op_id: int, now: float) -> bool:
        """Any live in-flight op on ``obj`` other than ``op_id``?"""
        d = self.in_flight.get(obj)
        if not d:
            return False
        cutoff = now - self.gc_timeout
        expired = None
        for k, t0 in d.items():
            if t0 < cutoff:
                if expired is None:
                    expired = [k]
                else:
                    expired.append(k)
        if expired:
            for k in expired:
                del d[k]
            if not d:
                self.in_flight.pop(obj, None)
                return False
        return any(k != op_id for k in d)

    # -- leader election -------------------------------------------------------
    #
    # Election rank is the STATIC deployment-wide ordering (replica id; the
    # simulator's speed() is non-decreasing in id, so id 0 is the fastest
    # node — Cabinet elects its top-weighted replica). The *dynamic* latency
    # EMA only drives quorum/vote weights: in real Cabinet, weight changes
    # are agreed through the log itself, so the election ranking every node
    # uses must be a shared, stable view, not each node's private EMA.
    # Liveness comes from an all-to-all heartbeat failure detector.

    def weight_ranking(self) -> List[int]:
        """Replica ids ordered by descending node weight (stable)."""
        return list(np.argsort(self.node_ema, kind="stable"))

    def current_leader(self, now: float) -> int:
        if now <= self._leader_until:
            return self._leader_memo
        candidate = (not self.recovering and now >= self._lead_after
                     and not self._isolated and now >= self._promise_until)
        me = self.node_id
        n = self.sim.n
        last_hb = self.last_hb
        hb_to = self.HB_TIMEOUT
        # scan order: replica id, unless an epoch-stamped weight view is
        # installed (repro_torch.core.reassign) — the view IS the shared,
        # stable ranking the election comment above calls for, so a
        # demoted (degraded) node stops anchoring leadership too
        rm = self.reassign_mgr
        order = rm.ranking if rm is not None else None
        seen_me = False
        for r in (range(n) if order is None else order):
            if r == me:
                seen_me = True
                if not candidate:
                    continue
                # higher-ranked replicas are all dead. Claim leadership
                # only while the heartbeat-fresh set (incl. self) is BOTH
                # a count-majority of the deployment AND a weighted
                # majority under the shared election ranking. The count
                # half is the classic anti-split-brain lease; the
                # weighted half closes the count-majority/weighted-
                # minority hole: without it, a partition that strands
                # the weighted majority (say {0, 2} of five) lets the
                # other side elect by count while fast-path commits land
                # under the old leader's stale lease on the weighted
                # side — and whichever side later resyncs loses them.
                # Weighted quorum speed is untouched: commits still wait
                # only for weight > T^N, the lease just pins who may
                # drive them.
                fresh = [(last_hb[p], p) for p in range(n)
                         if p != me and now - last_hb[p] <= hb_to]
                need = n // 2          # peers needed besides self
                if len(fresh) < need:
                    continue
                if not need:
                    self._leader_memo = me
                    self._leader_until = float("inf")
                    return me
                fresh.sort(reverse=True)
                until = fresh[need - 1][0] + hb_to   # count-lease lapse
                sw = self.obj_weights.shared_weights()
                thr = self.node_threshold()
                acc = float(sw[me])
                w_until = None
                # accumulate freshest-first: the subset that strictly
                # crosses T^N with the latest-lapsing support maximizes
                # the weighted-lease window; the tipping peer's detector
                # window is when weighted support could first fall short
                for t_p, p in fresh:
                    acc += float(sw[p])
                    if acc > thr:
                        w_until = t_p + hb_to
                        break
                if w_until is None:
                    continue    # count majority, weighted minority:
                                # step aside rather than split the paths
                self._leader_memo = me
                self._leader_until = min(until, w_until)
                return me
            if now - last_hb[r] <= hb_to:
                # valid until this leader's detector window lapses, or we
                # become a candidate ourselves at _lead_after (only
                # relevant when r ranks below us), or a better-ranked
                # replica heartbeats
                until = last_hb[r] + hb_to
                if seen_me and self._lead_after > now:
                    until = min(until, self._lead_after)
                self._leader_memo = r
                self._leader_until = until
                return r
        return (me + 1) % n

    def _leader_invalidate(self) -> None:
        self._leader_until = -1.0

    def is_leader(self, now: float) -> bool:
        return self.current_leader(now) == self.node_id

    def start_heartbeats(self) -> None:
        if not self._hb_armed:
            self._hb_armed = True
            now = self.sim.now
            if now:
                # served transport: the clock is wall time since the
                # cluster epoch and already exceeds the detector window
                # when heartbeats start, so seed the failure detector as
                # if every peer just beat — one HB_TIMEOUT of boot grace
                # before anyone can look stale. In the simulator now is
                # exactly 0.0 here and last_hb is already all-zero, so
                # this is a no-op (bit-identity preserved).
                self.last_hb = [now] * self.sim.n
            self._hb_timer = self.set_timer(self.HB_INTERVAL, "hb")

    # -- partition-heal detection ----------------------------------------------
    #
    # A crash gets an explicit engine recovery hook, but a partitioned
    # replica never "recovers" — the network just comes back. While it was
    # cut off it missed commit broadcasts for good (nothing retransmits old
    # commits), so its log has holes and serving reads/sync from it would
    # leak them. Detection: if the heartbeat-fresh set (incl. self) is a
    # weighted MINORITY under the shared election ranking, we are on the
    # losing side of a partition (or the cluster is mostly down —
    # indistinguishable, and the response is the same); once connectivity
    # returns, rejoin through the crash-recovery state transfer. The rule
    # is weighted, not count-based, and it mirrors the leadership lease:
    # the side that can hold the lease (and therefore commit) is exactly
    # the side that must NOT resync-wipe itself at heal, and the side
    # that cannot is exactly the side whose log grows holes. A count rule
    # here wiped the weighted-majority side of a count-minority partition
    # — losing its committed fast-path ops (the CHANGES.md baseline
    # hole). Fault-free and crash-only runs never trip this: the scan
    # costs no simulated time, and the geometric invariant I2 guarantees
    # the surviving n-t replicas strictly cross half.

    def _check_isolation(self, now: float) -> None:
        if self.recovering:
            return                    # sync already in flight
        n = self.sim.n
        if n < 3 or now < self.HB_TIMEOUT * 2:
            return                    # bootstrap: no heartbeats yet
        cutoff = now - self.HB_TIMEOUT
        last_hb = self.last_hb
        me = self.node_id
        sw = self.obj_weights.shared_weights()
        acc = float(sw[me])
        for r in range(n):
            if r != me and last_hb[r] >= cutoff:
                acc += float(sw[r])
        if acc <= self.node_threshold():   # fresh set: weighted minority
            self._isolated = True
        elif self._isolated:
            # connectivity is back after an isolation episode: pull a
            # snapshot exactly like a crash-recovery rejoin (the flag
            # stays set until on_sync_state installs it, so safety
            # checkers keep excluding our possibly-holed log) — but the
            # process never died: durable local holdings (erasure-coded
            # shards) survive the resync
            self.on_recover(now, lost_memory=False)

    # -- accepted-op recovery sweep -------------------------------------------

    def _note_accepted(self, op, driver: int, now: float) -> None:
        """Remember an op this replica accepted on behalf of ``driver``
        (the proposing leader or fast-path coordinator) until it is seen
        applied. The record is what makes a decided-but-unbroadcast
        commit recoverable when the driver is lost."""
        self._accepted_ops[op.op_id] = (op, now, driver)
        if not self._sweep_armed:
            self._sweep_armed = True
            self.set_timer(self.sim.costs.timeout, "accept_sweep")

    def _accept_sweep(self, now: float) -> None:
        acc = self._accepted_ops
        stale_cut = now - self.HB_TIMEOUT
        min_age = self.gc_timeout / 2
        applied_ops = self.rsm.applied_ops
        last_hb = self.last_hb
        me = self.node_id
        done = []
        resend = []
        for op_id, (op, t_seen, driver) in acc.items():
            if op_id in applied_ops:
                done.append(op_id)
            elif (now - t_seen >= min_age and driver != me
                    and last_hb[driver] < stale_cut):
                # accepted long ago, commit never arrived, and the driver
                # is suspected dead: the decision (if there was one) died
                # with its broadcast — re-drive through the slow path
                resend.append(op)
                acc[op_id] = (op, now, driver)     # backoff before retry
        for op_id in done:
            del acc[op_id]
        if resend and not self.recovering and not self._isolated:
            # (an isolated node would only re-drive into its own island)
            self.forward_slow(resend, now)
        if acc:
            self.set_timer(self.sim.costs.timeout, "accept_sweep")
        else:
            self._sweep_armed = False

    def on_protocol_timer(self, name: str, payload: dict, now: float) -> None:
        pass

    def on_heartbeat(self, msg: Msg, now: float) -> None:
        self.last_hb[msg.src] = now
        rm = self.reassign_mgr
        if rm is not None and (rm.epoch or msg.payload):
            # epoch gossip + (with a view installed) rank-order memo
            # invalidation; fault-free runs never enter (epoch 0, empty
            # payload), keeping the hot path identical to knob-off
            if rm.on_heartbeat(msg, now):
                return
        if msg.src < self._leader_memo:
            self._leader_until = -1.0    # a better leader may be back

    # -- crash recovery: state transfer before rejoining --------------------------
    #
    # A recovering replica's pre-crash in-flight/queue state is garbage and
    # its RSM has holes for everything committed while it was down. It (a)
    # wipes volatile protocol state, (b) buffers incoming commits, (c) pulls
    # a snapshot from a live peer, then (d) installs it and replays the
    # buffer (op_id-idempotent). It does not claim leadership until synced.

    def on_recover(self, now: float, lost_memory: bool = True) -> None:
        self.recovering = True
        self._leader_invalidate()
        self._recovery_buf = []
        self.in_flight.clear()
        self._obj_buffer.clear()
        self._credit_buf.clear()
        # accepted-op records die with the crash (volatile): recovery of a
        # lost decision needs only one LIVE accepter, and a wiped node
        # must not re-drive ops from a stale view of who proposed what
        self._accepted_ops.clear()
        self._sweep_armed = False
        if hasattr(self, "slow_queue"):
            self.slow_queue.clear()
            self.slow_mutex = False
            self.slow_inst = None
            self._forwarded.clear()
            self._slow_pending.clear()
            self._slow_obj_count.clear()
        if hasattr(self, "fast_batches"):
            self.fast_batches.clear()
        if hasattr(self, "pending"):
            self.pending.clear()
            self.op2batch.clear()
        if self.lease_mgr is not None:
            self.lease_mgr.on_recover(now)
        if self.reassign_mgr is not None:
            self.reassign_mgr.on_recover(now)
        if self.coding_mgr is not None:
            self.coding_mgr.on_recover(now, lost_memory)
        self._request_sync(now, attempt=0)

    def _request_sync(self, now: float, attempt: int) -> None:
        peer = (self.node_id + 1 + attempt) % self.sim.n
        if peer == self.node_id:
            peer = (peer + 1) % self.sim.n
        self.send(peer, "sync_req", {})
        self.set_timer(0.05, "sync_retry", {"attempt": attempt + 1})

    def on_sync_req(self, msg: Msg, now: float) -> None:
        if self.recovering or self._isolated:
            # our own log may be stale or holed (mid-sync, or cut off by
            # a partition): serving a snapshot would propagate the holes.
            # Stay silent — the requester's sync_retry walks to the next
            # peer. (Regression: rolling crashes used to let a
            # still-recovering node serve its pre-crash state.)
            return
        # any live replica can serve catch-up; cost scales with state size
        c = self.sim.costs
        self.sim.busy(self.node_id, c.c_parse * len(self.rsm.applied_ops)
                      * c.speed(self.node_id))
        payload = {
            "store": dict(self.rsm.store),
            "applied": {k: list(v) for k, v in self.rsm.applied.items()},
            "applied_ops": set(self.rsm.applied_ops),
            "obj_ops": {k: list(v) for k, v in self.rsm.obj_ops.items()},
            "apply_count": self.rsm.apply_count,
            "last_slow": dict(self.last_slow),
            "last_applied": dict(self.last_applied),
            # the PENDING dep-ordered commit queue is part of the apply
            # order: without it a recovered node applies later commits
            # ahead of a blocked earlier one and diverges per-object
            "obj_buffer": {k: list(v) for k, v in self._obj_buffer.items()},
        }
        if self.lease_mgr is not None:
            # lease table + revocation barriers ride the snapshot: a
            # healing replica must know which reads it may NOT serve
            payload["leases"] = self.lease_mgr.export_state()
        if self.reassign_mgr is not None and self.reassign_mgr.epoch:
            # the installed weight view rides the snapshot: a rejoining
            # node must quorum under the ranking the cluster runs on
            payload["wview"] = self.reassign_mgr.export_state()
        if self.coding_mgr is not None:
            # stripe metadata rides the snapshot: a healing replica must
            # know which objects' values it cannot decode locally (its
            # recovery sweep then re-fetches the missing shards)
            payload["coding"] = self.coding_mgr.export_state()
        self.send(msg.src, "sync_state", payload,
                  size_ops=len(self.rsm.applied_ops))

    def on_sync_state(self, msg: Msg, now: float) -> None:
        if not self.recovering:
            return
        p = msg.payload
        self.rsm.install_snapshot(
            store=p["store"], applied=p["applied"],
            applied_ops=p["applied_ops"], obj_ops=p.get("obj_ops", {}),
            apply_count=p["apply_count"])
        self.last_slow = dict(p["last_slow"])
        self.last_applied = dict(p.get("last_applied", {}))
        self._obj_buffer = {k: list(v) for k, v in p["obj_buffer"].items()}
        if self.lease_mgr is not None and "leases" in p:
            self.lease_mgr.install_state(p["leases"], now)
        if self.reassign_mgr is not None and "wview" in p:
            self.reassign_mgr.install_state(p["wview"], now)
        if self.coding_mgr is not None and "coding" in p:
            # install + recovery sweep: re-fetch missing shards before
            # this replica resumes resolving reads on striped objects
            self.coding_mgr.install_state(p["coding"], now)
        for obj, entries in self._obj_buffer.items():
            for op, _, _ in entries:
                self.set_timer(self.gc_timeout, "dep_timeout",
                               {"obj": obj, "op_id": op.op_id})
        self.recovering = False
        self._isolated = False
        buf, self._recovery_buf = self._recovery_buf, []
        for op, deps, path in buf:
            self.apply_commit(op, now, path, deps)
        self.flush_credits()
        # rejoin the failure detector only after a full detector period:
        # reclaiming leadership immediately races the interim leader's
        # in-flight instance (two leaders' commits could interleave in
        # different orders at different replicas — observed in the
        # crash+recover KV-store example before this guard)
        self._lead_after = now + self.HB_TIMEOUT * 1.2
        self._leader_invalidate()
        self.set_timer(self.HB_TIMEOUT * 1.2, "rejoin")

    def on_rejoin(self, now: float) -> None:
        # restart a single heartbeat chain: after a crash the old timer
        # was swallowed while down, but after a partition-heal rejoin the
        # node was alive throughout and its chain is still armed — cancel
        # it so heal cycles don't stack chains (and double the hb rate)
        if self._hb_timer is not None:
            self._hb_timer.cancel()
        self._hb_armed = False
        self.start_heartbeats()


    # -- dependency-ordered apply (cross-path consistency, Thm 2) -------------
    #
    # T^O-weighted fast quorums and T^N-weighted slow quorums need NOT
    # intersect (the weightings differ), so per-object apply order across
    # the two paths cannot come from quorum intersection. The leader is the
    # serialization point: every fast quorum includes the leader's accept,
    # and commit messages carry the op_ids that must apply first. Replicas
    # buffer out-of-order commits per object (FIFO) with a timeout fallback
    # for dependencies that never commit (e.g. a diverted fast op whose
    # coordinator crashed).

    def apply_commit(self, op, now: float, path: str,
                     deps: Optional[List[int]] = None) -> None:
        if self.recovering:
            # no usable local state yet: buffer until the snapshot installs
            self._recovery_buf.append((op, deps, path))
            return
        applied_ops = self.rsm.applied_ops
        if deps:
            deps = [d for d in deps if d not in applied_ops
                    and d != op.op_id]
        buf = self._obj_buffer.get(op.obj)
        if not deps and buf is None:
            # hot path: no unsatisfied dependencies, nothing buffered on
            # this object — apply immediately, nothing to drain
            if op.op_id not in applied_ops:
                self._apply_now(op, now, path)
            return
        deps = deps or []
        if not deps and buf and any(op.op_id in (bdeps or ())
                                    for _, bdeps, _ in buf):
            # a buffered commit is explicitly waiting on THIS op (e.g. the
            # leader's own slow commit raced ahead of a remote fast commit
            # it depends on): the dependency edge, not arrival order, is
            # authoritative — apply now and release the queue, else the
            # buffer deadlocks until dep_timeout force-applies in the
            # wrong (inverted) order. Overtaking is safe: a no-dep arrival
            # cannot be unordered w.r.t. an UNRELATED buffered commit,
            # because the leader blocks fast co-signs while a slow commit
            # on the object is unapplied locally (_slow_obj_count guard)
            # and stamps last_applied afterwards — so any same-object pair
            # either carries a dep edge or left the same sender link in a
            # consistent order.
            if op.op_id not in self.rsm.applied_ops:
                self._apply_now(op, now, path)
            self._drain_obj(op.obj, now)
            return
        if deps or buf:
            # FIFO per object: never overtake an earlier buffered commit
            # (same-object commits without a dep edge share a link, so
            # arrival order is consistent across replicas)
            self._obj_buffer.setdefault(op.obj, []).append((op, deps, path))
            tr = self.sim.tracer
            if tr is not None and tr.sampled(op.op_id):
                tr.ev("dep_stall", now, self.node_id, op.op_id, op.obj,
                      len(deps))
            self.set_timer(self.gc_timeout, "dep_timeout",
                           {"obj": op.obj, "op_id": op.op_id})
            return
        if op.op_id not in self.rsm.applied_ops:
            self._apply_now(op, now, path)
        self._drain_obj(op.obj, now)
        # NOTE: no flush_credits here — callers flush once per handler so
        # per-batch credits coalesce into one client_reply message

    def apply_commit_batch(self, ops, deps: Dict[int, List[int]],
                           now: float, path: str) -> None:
        """Apply a batch of committed ops in order — semantically identical
        to calling :meth:`apply_commit` per op, but with the common case
        (no dependency edges, no per-object FIFO pending) inlined and the
        per-op CPU charge coalesced into one ``busy`` call. This is the
        hot path of every fast_commit / slow_commit handler: committed_ops
        x n_replicas executions per run."""
        if self.recovering:
            for op in ops:
                self.apply_commit(op, now, path, deps.get(op.op_id))
            return
        rsm = self.rsm
        applied_ops = rsm.applied_ops
        log = rsm._log
        store = rsm.store
        obj_buffer = self._obj_buffer
        in_flight = self.in_flight
        last_applied = self.last_applied
        read_results = self.sim.read_results   # transport only (sim: None)
        cm = self.coding_mgr
        is_slow = path == "slow"
        applied_now = []
        for op in ops:
            op_id = op.op_id
            d = deps.get(op_id) if deps else None
            if d or obj_buffer:
                if d and not obj_buffer:
                    # dependency edges are usually already satisfied (the
                    # dep is the object's previously applied op): verify
                    # inline and fall through to the fast path
                    for x in d:
                        if x not in applied_ops and x != op_id:
                            break
                    else:
                        d = None
                if d or obj_buffer:
                    # unsatisfied dependency, or an object FIFO is pending
                    # (an earlier op in this very batch may just have
                    # buffered): take the full ordering path, which
                    # charges its own CPU
                    self.apply_commit(op, now, path, d)
                    continue
            if op_id in applied_ops:
                continue
            applied_now.append(op)
            # RSM.apply, inlined (idempotence pre-checked above)
            obj = op.obj
            applied_ops.add(op_id)
            if op.kind == "w":
                store[obj] = op.value
                log.append((obj, op_id, op.value))
                if cm is not None:
                    cm.note_write_applied(obj, op_id)
            else:
                log.append((obj, op_id, None))
                if op.path != "local":  # lease-answered read keeps its answer
                    if cm is None or cm.resolve_read(op):
                        op.read_result = store.get(obj)
                if read_results is not None:
                    read_results[op_id] = op.read_result
            fl = in_flight.get(obj)
            if fl is not None:
                fl.pop(op_id, None)
                if not fl:
                    del in_flight[obj]
            if is_slow:
                self.last_slow[obj] = op_id
            last_applied[obj] = op_id
        if applied_now:
            rsm.apply_count += len(applied_now)
            self.sim.busy(self.node_id, self._apply_cost * len(applied_now))
            self.on_applied_batch(applied_now, now, path)

    def _apply_now(self, op, now: float, path: str) -> None:
        self.sim.busy(self.node_id, self._apply_cost)
        self.rsm.apply(op)
        if op.kind == "w" and self.coding_mgr is not None:
            self.coding_mgr.note_write_applied(op.obj, op.op_id)
        if op.kind == "r":
            rr = self.sim.read_results         # transport only (sim: None)
            if rr is not None:
                rr[op.op_id] = op.read_result
        self.clear_inflight(op.obj, op.op_id)
        if path == "slow":
            self.last_slow[op.obj] = op.op_id
        self.last_applied[op.obj] = op.op_id
        self.on_applied(op, now, path)

    def on_applied(self, op, now: float, path: str) -> None:
        """Hook for protocol-specific post-apply bookkeeping."""

    def on_applied_batch(self, ops: List, now: float, path: str) -> None:
        """Batch form of :meth:`on_applied` (called once per commit batch
        from apply_commit_batch; subclasses with per-op bookkeeping
        override this with a hoisted loop)."""
        for op in ops:
            self.on_applied(op, now, path)

    def _drain_obj(self, obj: int, now: float) -> None:
        buf = self._obj_buffer.get(obj)
        while buf:
            op, deps, path = buf[0]
            deps = [d for d in deps if d not in self.rsm.applied_ops]
            if deps:
                buf[0] = (op, deps, path)
                return
            buf.pop(0)
            if op.op_id not in self.rsm.applied_ops:
                self._apply_now(op, now, path)
        self._obj_buffer.pop(obj, None)

    def on_timer(self, name: str, payload: dict, now: float) -> None:
        if name == "sync_retry":
            if self.recovering:
                self._request_sync(now, payload["attempt"])
            return
        if name == "rejoin":
            self.on_rejoin(now)
            return
        if name == "accept_sweep":
            self._accept_sweep(now)
            return
        if name == "dep_timeout":
            # force-apply in FIFO order: the missing dependency never
            # committed (it will be retried as a fresh op if still wanted)
            buf = self._obj_buffer.get(payload["obj"])
            if buf and any(op.op_id == payload["op_id"] for op, _, _ in buf):
                while buf:
                    op, _, path = buf.pop(0)
                    if op.op_id not in self.rsm.applied_ops:
                        self._apply_now(op, now, path)
                    if op.op_id == payload["op_id"]:
                        break
                if not buf:
                    self._obj_buffer.pop(payload["obj"], None)
                else:
                    self._drain_obj(payload["obj"], now)
                self.flush_credits()
            return
        if name == "hb":
            rm = self.reassign_mgr
            hb_payload = rm.hb_payload() if rm is not None else {}
            for d in self.sim.replicas():
                if d != self.node_id:
                    self.send(d, "heartbeat", hb_payload)
            tr = self.sim.tracer
            if tr is not None:
                # per-peer latency-EMA samples on the heartbeat cadence:
                # the weight-evolution timeline of §3.1, for free
                node_ema = self.node_ema
                for d in range(self.sim.n):
                    if d != self.node_id:
                        tr.ev("ema", now, self.node_id, d,
                              float(node_ema[d]))
            self._hb_timer = self.set_timer(self.HB_INTERVAL, "hb")
            self._check_isolation(now)
            if rm is not None:
                # health monitor on the heartbeat cadence: pure host-side
                # computation unless confirmed fault evidence exists
                rm.tick(now)
            return
        if name == "lease_t":
            if self.lease_mgr is not None:
                self.lease_mgr.on_timer(payload, now)
            return
        if name == "coding_t":
            if self.coding_mgr is not None:
                self.coding_mgr.on_timer(payload, now)
            return
        self.on_protocol_timer(name, payload, now)

    # -- read leases (repro_torch.core.leases) -----------------------------------
    # Lease traffic only exists when every replica was constructed with a
    # LeaseManager; the None guards make stray messages harmless (e.g. a
    # kill-revoke arriving after a run reconfigures).

    def on_lease_req(self, msg: Msg, now: float) -> None:
        if self.lease_mgr is not None and not self.recovering \
                and not self._isolated:
            self.lease_mgr.on_req(msg, now)

    def on_lease_vote(self, msg: Msg, now: float) -> None:
        if self.lease_mgr is not None and not self.recovering:
            self.lease_mgr.on_vote(msg, now)

    def on_lease_install(self, msg: Msg, now: float) -> None:
        if self.lease_mgr is not None:
            self.lease_mgr.on_install(msg, now)

    def on_lease_abort(self, msg: Msg, now: float) -> None:
        if self.lease_mgr is not None and not self.recovering:
            self.lease_mgr.on_abort(msg, now)

    def on_lease_revoke(self, msg: Msg, now: float) -> None:
        if self.lease_mgr is not None:
            self.lease_mgr.on_revoke(msg, now)

    def on_lease_revoke_ack(self, msg: Msg, now: float) -> None:
        if self.lease_mgr is not None:
            self.lease_mgr.on_revoke_ack(msg, now)

    def on_llease_req(self, msg: Msg, now: float) -> None:
        if self.lease_mgr is not None:
            self.lease_mgr.on_ll_req(msg, now)

    def on_llease_grant(self, msg: Msg, now: float) -> None:
        if self.lease_mgr is not None and not self.recovering:
            self.lease_mgr.on_ll_grant(msg, now)

    # -- payload striping (repro_torch.coding) ------------------------------------
    # Same contract as the lease hooks: stripe traffic only exists when
    # every replica was constructed with a CodingManager, and the None
    # guards make stray messages harmless.

    def on_stripe_push(self, msg: Msg, now: float) -> None:
        if self.coding_mgr is not None and not self.recovering:
            self.coding_mgr.on_push(msg, now)

    def on_stripe_ack(self, msg: Msg, now: float) -> None:
        if self.coding_mgr is not None and not self.recovering:
            self.coding_mgr.on_push_ack(msg, now)

    def on_stripe_fetch(self, msg: Msg, now: float) -> None:
        if self.coding_mgr is not None and not self.recovering \
                and not self._isolated:
            self.coding_mgr.on_fetch(msg, now)

    def on_stripe_fill(self, msg: Msg, now: float) -> None:
        if self.coding_mgr is not None and not self.recovering:
            self.coding_mgr.on_fill(msg, now)

    # -- weight reassignment (repro_torch.core.reassign) --------------------------
    # Same contract as the lease hooks: traffic only exists when every
    # replica was constructed with a ReassignManager, and the None guards
    # make stray messages harmless.

    def on_weight_suspect(self, msg: Msg, now: float) -> None:
        if self.reassign_mgr is not None and not self.recovering \
                and not self._isolated:
            self.reassign_mgr.on_suspect(msg, now)

    def on_weight_install(self, msg: Msg, now: float) -> None:
        if self.reassign_mgr is not None and not self.recovering:
            self.reassign_mgr.on_install(msg, now)

    def on_weight_pull(self, msg: Msg, now: float) -> None:
        if self.reassign_mgr is not None and not self.recovering \
                and not self._isolated:
            self.reassign_mgr.on_pull(msg, now)

    def on_weight_view(self, msg: Msg, now: float) -> None:
        if self.reassign_mgr is not None and not self.recovering:
            self.reassign_mgr.on_view(msg, now)

    # -- client credit flow ------------------------------------------------------
    # credits carry op_ids (not counts): with client retries the same op may
    # be coordinated — and credited — by two replicas, and the client must
    # be able to dedupe per op.

    def credit_op(self, client: int, batch_id: int, op_id: int) -> None:
        key = (client, batch_id)
        buf = self._credit_buf.get(key)
        if buf is None:
            self._credit_buf[key] = [op_id]
        else:
            buf.append(op_id)

    def flush_credits(self) -> None:
        if not self._credit_buf:
            return
        buf, self._credit_buf = self._credit_buf, {}
        for (client, bid), op_ids in buf.items():
            self.send(client, "client_reply",
                      {"batch_id": bid, "op_ids": op_ids})
