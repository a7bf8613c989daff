"""Fast path: leaderless object-weighted consensus (paper §4.3, Algorithm 1).

The coordinator (whichever replica the client contacted) drives one
FAST_PROPOSE round per client batch:

  FASTPATH(op, O):
    1. conflict check at the coordinator        (Alg. 1 lines 2-3)
    2. self-vote w_self^O, broadcast proposal   (lines 4-7)
    3. accumulate FAST_ACCEPT weights           (lines 8-11)
    4. commit at weight > T^O, broadcast        (lines 12-13)
    5. CONFLICT reply or timeout -> slow path   (lines 14-16)

Batches vectorize this with numpy: per-op weight rows are materialized at
propose time so each FAST_ACCEPT folds in as one masked vector add — the
same sort/prefix-sum/threshold math as :mod:`repro_torch.core.quorum` (and the
Pallas kernel), expressed incrementally.

SOUNDNESS DEVIATION (documented in DESIGN.md): the paper's Theorem-2 sketch
(in-flight map + leader mutex) leaves a race open — T^O-weighted and
T^N-weighted quorums need not intersect, and a slow op registers at the
followers only when SLOW_PROPOSE arrives, so a fast commit can slip through
the propagation window and apply in different orders at different replicas.
We close it by (a) requiring the *leader's* FAST_ACCEPT in every fast
quorum (the leader knows every queued slow op the moment it is forwarded),
and (b) carrying per-op dependencies on commit messages so replicas apply
per-object in a consistent order (see BaseReplica.apply_commit). The fast
path remains 1-RTT and coordinator-driven; the leader co-sign costs no
extra round because the leader is one of the broadcast targets anyway.

Diverted ops keep their in-flight registrations at accepting replicas until
their eventual SLOW_COMMIT clears them (op_id-keyed): any concurrent fast
attempt on those objects keeps seeing a conflict.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.simulator import Msg, Op

OBSERVE_CAP = 64   # per-reply cap on per-object latency EMA updates


@dataclasses.dataclass(eq=False, slots=True)
class FastBatch:
    batch_id: int
    ops: List[Op]
    weights: np.ndarray      # (B, n) per-op object weights
    threshold: float         # scalar: weight rows are permutations of the
                             # same base vector, so every op's T^O is equal
    acc: np.ndarray          # (B,) accumulated weight
    resolved: np.ndarray     # (B,) bool: committed or diverted
    propose_time: float
    leader_voted: bool       # the current leader's co-sign arrived (its
                             # accept carries an explicit "lead" flag)
    n_resolved: int = 0      # fast "nothing resolved yet" check
    timer: object = None     # fast_timeout handle (cancelled on resolve)
    observe: List[Op] = dataclasses.field(default_factory=list)
    deps: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    replied: set = dataclasses.field(default_factory=set)
    lease_waits: List[int] = dataclasses.field(default_factory=list)
    coding_waits: List[int] = dataclasses.field(default_factory=list)


class FastPathMixin:
    """Requires BaseReplica fields + ``self.om`` + slow-path ``forward_slow``
    + ``finalize_op`` bookkeeping from WocReplica."""

    def _init_fastpath(self):
        self.fast_batches: Dict[int, FastBatch] = {}
        self._fb_seq = itertools.count()

    # -- coordinator side ------------------------------------------------------

    def start_fast(self, ops: List[Op], now: float) -> None:
        """Propose a batch of fast-path ops (Alg. 1 lines 4-7)."""
        if not ops:
            return
        # per-op coordination cost (ordering, bookkeeping, quorum math);
        # this is the CPU the paper says saturates replicas (§5.4)
        self.sim.busy(self.node_id, self._coord_cost * len(ops))
        B = len(ops)
        table = self.obj_weights
        weights_for = table.weights_for
        # one C-level stack beats B numpy row assignments; rows are mostly
        # the same cached node-level vector object
        wmat = np.array([weights_for(op.obj) for op in ops])
        leader = self.current_leader(now)
        fb = FastBatch(
            batch_id=next(self._fb_seq) | (self.node_id << 48),
            ops=ops, weights=wmat, threshold=table.current_threshold(),
            acc=wmat[:, self.node_id].copy(),        # self-vote (line 4)
            resolved=np.zeros(B, dtype=bool), propose_time=now,
            leader_voted=(leader == self.node_id))
        if fb.leader_voted:
            last_applied = self.last_applied
            for op in ops:
                # order after the object's last applied op on EITHER path
                # (slow predecessors per Thm 2, and the previous fast
                # commit — see last_applied in BaseReplica)
                dep = last_applied.get(op.obj)
                if dep is not None:
                    fb.deps[op.op_id] = [dep]
        # per-object latency EMA targets: only objects with a repeat-access
        # record (COMMON/HOT candidates — where object weights matter);
        # resolved once here instead of on every accept reply
        om_stats = self.om.stats
        fb.observe = [op for op in itertools.islice(ops, OBSERVE_CAP)
                      if type(om_stats.get(op.obj)) is not int]
        self.fast_batches[fb.batch_id] = fb
        tr = self.sim.tracer
        if tr is not None:
            sampled = tr.sampled
            for op in ops:
                if sampled(op.op_id):
                    tr.ev("fast_propose", now, self.node_id,
                          fb.batch_id, op.op_id)
        cm = self.coding_mgr
        if cm is not None and cm.plan_batch(ops, now):
            # striped batch: per-destination sends so each assignee gets
            # its distinct shard (full-copy ops ride along at full size)
            for dst in self._others:
                stripes, nb = cm.stripe_payload_for(ops, dst)
                payload = {"fb": fb.batch_id, "ops": ops}
                if stripes:
                    payload["stripes"] = stripes
                self.send(dst, "fast_propose", payload, size_ops=B,
                          size_bytes=nb)
        else:
            self.broadcast(self._others, "fast_propose",
                           {"fb": fb.batch_id, "ops": ops}, size_ops=B,
                           size_bytes=sum(op.size for op in ops))
        # timeout scales with batch size: large batches legitimately spend
        # longer in per-op parse/apply queues before replies return
        fb.timer = self.set_timer(self.sim.costs.timeout + 50e-6 * B,
                                  "fast_timeout", {"fb": fb.batch_id})
        # single-replica degenerate case: self-vote may already commit
        self._fast_check_commit(fb, now)

    def on_fast_accept(self, msg: Msg, now: float) -> None:
        fb = self.fast_batches.get(msg.payload["fb"])
        if fb is None or msg.src in fb.replied:
            return
        src = msg.src
        fb.replied.add(src)
        if fb.coding_waits:
            # a decided striped write is gated on its reconstructable
            # set: this reply proves the replier durably holds the
            # shards the propose assigned it
            cmgr = self.coding_mgr
            for k in fb.coding_waits:
                cmgr.wait_ack(k, src, now)
            self._fast_gc(fb)
        if fb.lease_waits:
            # a decided write in this batch is gated on a lease: this
            # reply doubles as the replier's revocation ack
            lm = self.lease_mgr
            for k in fb.lease_waits:
                lm.wait_vote(k, src, now)
            self._fast_gc(fb)
        tr = self.sim.tracer
        if tr is not None:       # batch-level: always recorded (no sampling)
            tr.ev("fast_accept", now, self.node_id, fb.batch_id, src,
                  1 if msg.payload.get("lead") else 0)
        bits: int = msg.payload["mask"]             # bit i = FAST_ACCEPT
        B = len(fb.ops)
        conflicted = None
        if bits == (1 << B) - 1 and not fb.n_resolved:
            # all-accept on a fully-live batch (the overwhelmingly common
            # reply): one unmasked vector add, no boolean temporaries
            fb.acc += fb.weights[:, src]
        else:
            mask = np.zeros(B, dtype=bool)
            for i in range(B):
                if (bits >> i) & 1:
                    mask[i] = True
            live = ~fb.resolved
            accept = live & mask
            fb.acc[accept] += fb.weights[accept, src]
            conflicted = live & ~mask
        # the co-sign is the replier's own leadership claim (explicit
        # "lead" flag), not the coordinator's possibly-stale view of who
        # leads: behind a partition the coordinator's believed leader is
        # just another cut-off replica whose ordinary vote must not
        # unlock commits (see current_leader's majority lease)
        if msg.payload.get("lead"):
            fb.leader_voted = True
            for i, dep in msg.payload.get("deps", {}).items():
                fb.deps[fb.ops[i].op_id] = [dep]
            linfo = msg.payload.get("leases")
            if linfo is not None and self.lease_mgr is not None:
                self.lease_mgr.merge_info(fb.ops, linfo)
        # latency observations feed the dynamic weight rule (§3.1);
        # fb.observe pre-selects the repeat-access objects worth tracking
        lat = now - fb.propose_time
        self.observe_node(src, lat)
        if fb.observe:
            observe = self.obj_weights.observe
            for op in fb.observe:
                observe(op.obj, src, lat)
        # first CONFLICT for an op -> slow path (Alg. 1 lines 14-15)
        if conflicted is not None and conflicted.any():
            self._divert(fb, conflicted, now)
        self._fast_check_commit(fb, now)

    def _fast_check_commit(self, fb: FastBatch, now: float) -> None:
        if not fb.leader_voted:          # leader co-sign is mandatory
            return
        ready = fb.acc > fb.threshold                      # strict crossing
        if fb.n_resolved:
            ready &= ~fb.resolved
        if not ready.any():
            return
        if not fb.n_resolved and ready.all():
            committed = fb.ops                 # whole batch commits at once
            fb.resolved[:] = True
        else:
            committed = [fb.ops[i] for i in np.flatnonzero(ready)]
            fb.resolved |= ready
        fb.n_resolved += len(committed)
        tr = self.sim.tracer
        if tr is not None:
            sampled = tr.sampled
            for op in committed:
                if sampled(op.op_id):
                    tr.ev("fast_commit", now, self.node_id,
                          fb.batch_id, op.op_id)
        if fb.deps:
            deps = {op.op_id: fb.deps.get(op.op_id, []) for op in committed}
        else:
            deps = {}
        cm = self.coding_mgr
        if cm is not None:
            key = cm.gate_commit(
                committed, now,
                lambda t, ops=committed, d=deps, b=fb:
                    self._fast_coding_gated(b, ops, d, t),
                fb.replied)
            if key is not None:
                # a striped write crossed its weighted threshold before
                # its reconstructable set is durable: the decision
                # stands but the stamp waits for enough distinct shard
                # acks (late round acks / stripe_push acks feed it)
                fb.coding_waits.append(key)
                return
        self._fast_lease_gated(fb, committed, deps, now)

    def _fast_lease_gated(self, fb: FastBatch, committed: List[Op],
                          deps: dict, now: float) -> None:
        lm = self.lease_mgr
        if lm is not None:
            key = lm.gate_commit(
                committed, now,
                lambda t, ops=committed, d=deps, b=fb:
                    self._fast_finalize_gated(b, ops, d, t),
                set(self._others) - fb.replied)
            if key is not None:
                # a write hit a live read lease: the decision stands
                # (resolved above) but the stamp/apply/broadcast waits for
                # the remaining round acks — or the lease expiry
                fb.lease_waits.append(key)
                return
        self._fast_finalize(committed, deps, now)
        self._fast_gc(fb)

    def _fast_finalize(self, committed: List[Op], deps: dict,
                       now: float) -> None:
        for op in committed:
            op.path = op.path or "fast"
        cm = self.coding_mgr
        mk = cm.commit_marker(committed) if cm is not None else None
        if mk:
            # marker before apply: the local apply below GC's the plan
            cm.note_striped_commit(committed, mk, now)
        self.apply_commit_batch(committed, deps, now, "fast")
        payload = {"ops": committed, "deps": deps}
        if mk:
            payload["striped"] = mk
        self.broadcast(self._others, "fast_commit", payload,
                       size_ops=len(committed))
        self.flush_credits()

    def _fast_finalize_gated(self, fb: FastBatch, committed: List[Op],
                             deps: dict, now: float) -> None:
        self._fast_finalize(committed, deps, now)
        self._fast_gc(fb)

    def _fast_coding_gated(self, fb: FastBatch, committed: List[Op],
                           deps: dict, now: float) -> None:
        # reconstructable set durable: continue through the lease gate
        self._fast_lease_gated(fb, committed, deps, now)

    def _divert(self, fb: FastBatch, which: np.ndarray, now: float,
                reason: str = "conflict") -> None:
        which &= ~fb.resolved
        n = int(which.sum())
        if not n:
            return
        fb.resolved |= which
        fb.n_resolved += n
        ops = [fb.ops[i] for i in np.flatnonzero(which)]
        tr = self.sim.tracer
        if tr is not None:
            sampled = tr.sampled
            for op in ops:
                if sampled(op.op_id):
                    tr.ev("divert", now, self.node_id, fb.batch_id,
                          op.op_id, reason)
        self.forward_slow(ops, now)
        self._fast_gc(fb)

    def _fast_gc(self, fb: FastBatch) -> None:
        if fb.n_resolved < len(fb.ops):
            return
        if fb.coding_waits:
            cmgr = self.coding_mgr
            fb.coding_waits = [k for k in fb.coding_waits
                               if cmgr is not None and k in cmgr.waits]
            if fb.coding_waits:
                return        # batch lives on to feed late acks to the wait
        if fb.lease_waits:
            lm = self.lease_mgr
            fb.lease_waits = [k for k in fb.lease_waits
                              if lm is not None and k in lm.waits]
            if fb.lease_waits:
                return        # batch lives on to feed late acks to the wait
        self.fast_batches.pop(fb.batch_id, None)
        if fb.timer is not None:
            fb.timer.cancel()

    def on_fast_timeout(self, payload: dict, now: float) -> None:
        fb = self.fast_batches.get(payload["fb"])
        if fb is None:
            return
        pending = ~fb.resolved
        if pending.any():                             # Alg. 1 line 16
            self._divert(fb, pending, now, "timeout")

    # -- replica side -----------------------------------------------------------

    def on_fast_propose(self, msg: Msg, now: float) -> None:
        """Reply with an accept BITMASK (bit i = FAST_ACCEPT for op i):
        ints are free to build and let the coordinator detect the
        all-accept reply with one compare. The conflict check + in-flight
        registration (has_conflict/register_inflight semantics, incl.
        lazy expiry of stale entries) is inlined — it runs B x (n-1)
        times per client batch."""
        ops: List[Op] = msg.payload["ops"]
        cm = self.coding_mgr
        if cm is not None:
            st = msg.payload.get("stripes")
            if st:
                # shards were physically delivered with this propose —
                # record them even if we refuse to vote below
                cm.recv_stripes(ops, st, msg.src, now)
        if self._isolated:
            return        # no votes from behind a partition (the round
                          # times out at the coordinator and diverts)
        bits = 0
        deps: Dict[int, int] = {}
        am_leader = self.is_leader(now)
        slow_count = self._slow_obj_count
        last_applied = self.last_applied
        in_flight = self.in_flight
        lm = self.lease_mgr
        cutoff = now - self.gc_timeout
        for i, op in enumerate(ops):
            obj = op.obj
            op_id = op.op_id
            if lm is not None and op.kind == "w":
                # regardless of the vote below: a write this replica has
                # SEEN might still commit elsewhere, so local serving on
                # its object must pause until it applies (or the round
                # provably dies and the entry ages out of grant votes)
                lm.note_write(obj, op_id, now)
            d = in_flight.get(obj)
            conflict = False
            if d is not None:
                expired = None
                for k, t0 in d.items():
                    if t0 < cutoff:
                        if expired is None:
                            expired = [k]
                        else:
                            expired.append(k)
                    elif k != op_id:
                        conflict = True
                if expired:
                    for k in expired:
                        del d[k]
                    if not d:
                        del in_flight[obj]
                        d = None
            if am_leader and not conflict and slow_count \
                    and slow_count.get(obj):
                conflict = True        # a slow op is queued for this object
            if not conflict:
                bits |= 1 << i
                if d is None:
                    in_flight[obj] = {op_id: now}
                else:
                    d[op_id] = now
                # accepted-op record: a fast round can cross T^O with this
                # vote and lose its coordinator (and commit broadcast) in
                # the same breath — the accepters are then the only place
                # the decided op survives (protocol_base._accept_sweep)
                self._note_accepted(op, msg.src, now)
                if am_leader:
                    dep = last_applied.get(obj)
                    if dep is not None:
                        deps[i] = dep
        payload = {"fb": msg.payload["fb"], "mask": bits}
        if am_leader:
            payload["lead"] = True
            payload["deps"] = deps
            if self.lease_mgr is not None:
                # piggyback the leader's live-lease excerpt on the co-sign:
                # a committer whose own lease table missed a grant round
                # (e.g. votes raced its proposal) still gates the commit —
                # the leader provably saw either the write (votes no on
                # the lease) or the lease (this excerpt)
                linfo = self.lease_mgr.lease_info(ops, now)
                if linfo is not None:
                    payload["leases"] = linfo
        self.send(msg.src, "fast_accept", payload)

    def on_fast_commit(self, msg: Msg, now: float) -> None:
        cm = self.coding_mgr
        if cm is not None:
            mk = msg.payload.get("striped")
            if mk:
                cm.note_striped_commit(msg.payload["ops"], mk, now)
        self.apply_commit_batch(msg.payload["ops"],
                                msg.payload.get("deps") or {}, now, "fast")
        self.flush_credits()
