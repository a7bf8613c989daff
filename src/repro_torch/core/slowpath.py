"""Slow path: leader-coordinated node-weighted consensus (paper §4.4, Alg. 2).

  SLOWPATH(op, O):
    1. non-leaders forward to the leader            (lines 2-3)
    2. leader takes the mutex, reads priorities     (lines 4-6)
    3. SLOW_PROPOSE broadcast                       (lines 7-8)
    4. accumulate priority-weighted SLOW_ACCEPTs    (lines 9-12)
    5. commit at pSum > T^N, SLOW_COMMIT broadcast,
       updatePriorities(responders), release mutex  (lines 13-17)

The mutex serializes slow-path instances (one in flight at a time) exactly
as written in Algorithm 2 — this is what makes the leader the bottleneck
the paper measures, and it is shared by the Cabinet baseline (Cabinet *is*
the slow path applied to every operation). Queued forwards are merged into
one instance up to ``group_cap`` ops (the paper's "dynamic reordering of
non-conflicting operations within the same batch").

Cross-path ordering: each slow op's SLOW_COMMIT carries the op_ids of fast
ops that were live at the leader when the instance formed; replicas apply
per-object in dependency order (BaseReplica.apply_commit). Followers only
accept proposals from their current leader; RSM apply is op_id-idempotent
so leader hand-off and retransmission are duplicate-safe.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Dict, List, Optional

from repro_torch.core.simulator import Msg, Op


@dataclasses.dataclass(eq=False, slots=True)
class SlowInstance:
    inst_id: int
    ops: List[Op]
    psum: float
    acked: set
    propose_time: float
    deps: Dict[int, List[int]]
    committed: bool = False
    timer: object = None      # slow_inst_timeout handle (cancelled on commit)
    lease_wait: object = None # pending revocation-wait key (leases on)
    coding_wait: object = None # pending reconstructable-set key (coding on)


class SlowPathMixin:
    """Leader queue + Algorithm 2. Requires BaseReplica machinery and the
    host class to implement ``finalize_op(op, now, path)``."""

    def _init_slowpath(self):
        self.slow_queue: deque = deque()
        self.slow_mutex = False                    # Alg. 2 lock(mutex)
        self.slow_inst: Optional[SlowInstance] = None
        self._inst_seq = itertools.count()
        self._forwarded: Dict[int, Op] = {}        # op_id -> op (retransmit)
        self._slow_pending: set = set()            # op_ids queued or proposed

    # -- leader-side pending bookkeeping (also feeds fast-path conflicts) -----

    def _slow_pending_add(self, op: Op) -> None:
        if op.op_id not in self._slow_pending:
            self._slow_pending.add(op.op_id)
            self._slow_obj_count[op.obj] = \
                self._slow_obj_count.get(op.obj, 0) + 1

    def _slow_pending_remove(self, op: Op) -> None:
        if op.op_id in self._slow_pending:
            self._slow_pending.discard(op.op_id)
            k = self._slow_obj_count.get(op.obj, 0) - 1
            if k <= 0:
                self._slow_obj_count.pop(op.obj, None)
            else:
                self._slow_obj_count[op.obj] = k

    # -- batch post-apply tail (shared by WocReplica / CabinetReplica) ---------

    def _finalize_batch(self, ops: List[Op], now: float, path: str) -> None:
        """Hoisted per-op tail of ``on_applied`` for batch applies:
        retransmit/pending cleanup plus client batch accounting and credit
        buffering. Requires the host class's ``op2batch``/``pending``
        bookkeeping (WocReplica, CabinetReplica). This runs
        committed_ops x n_replicas times per experiment — one shared copy,
        locals hoisted."""
        forwarded = self._forwarded
        slow_pending = self._slow_pending
        op2batch = self.op2batch
        pending = self.pending
        credit_buf = self._credit_buf
        commit_log = self.sim.commit_log
        stamp = (now, path)
        tr = self.sim.tracer
        node_id = self.node_id
        for op in ops:
            op_id = op.op_id
            if forwarded:
                forwarded.pop(op_id, None)
            if slow_pending and op_id in slow_pending:
                self._slow_pending_remove(op)
            bid = op2batch.pop(op_id, None)
            if bid is None:
                continue
            if op.commit_time < 0:
                op.commit_time = now
                op.path = path
                if op_id not in commit_log:
                    commit_log[op_id] = stamp
                    if tr is not None:
                        tr.ev("commit", now, node_id, op_id, path)
            rec = pending.get(bid)
            if rec is None:
                continue
            rec["remaining"].discard(op_id)
            key = (rec["client"], bid)
            buf = credit_buf.get(key)
            if buf is None:
                credit_buf[key] = [op_id]
            else:
                buf.append(op_id)
            if not rec["remaining"]:
                pending.pop(bid, None)

    # -- any replica: forward to leader (lines 2-3) ----------------------------

    def forward_slow(self, ops: List[Op], now: float) -> None:
        if not ops:
            return
        leader = self.current_leader(now)
        for op in ops:
            self._forwarded[op.op_id] = op
        tr = self.sim.tracer
        if tr is not None:
            sampled = tr.sampled
            for op in ops:
                if sampled(op.op_id):
                    tr.ev("slow_forward", now, self.node_id,
                          op.op_id, leader)
        if leader == self.node_id:
            self._enqueue_slow(ops, now)
        else:
            self.send(leader, "slow_forward", {"ops": ops},
                      size_ops=len(ops),
                      size_bytes=sum(op.size for op in ops))
        # retransmission guards against leader failure, not queueing delay:
        # exponential backoff, generous initial timeout (the leader dedupes
        # anyway, but duplicate forwards are wasted messages)
        self.set_timer(self.sim.costs.timeout * 4, "slow_retransmit",
                       {"op_ids": [op.op_id for op in ops], "backoff": 1})

    def on_slow_forward(self, msg: Msg, now: float) -> None:
        if self._isolated:
            # cut off from the majority: we can neither commit this nor
            # know the real leader — drop; the sender's retransmit
            # backoff (or the client's retry) re-drives it elsewhere
            return
        if not self.is_leader(now):                # stale leader view: bounce
            leader = self.current_leader(now)
            if leader == msg.src:
                # mutual disagreement: the sender believes WE lead, we
                # believe THEY do (a partition whose sides can each see
                # the other's heartbeats but neither can claim the lease
                # leaves exactly this pairwise view). Bouncing would
                # ping-pong the batch at network rate until the heal —
                # drop instead; the sender's retransmit backoff (or the
                # client's retry) re-drives it once views converge.
                return
            self.send(leader, "slow_forward", msg.payload,
                      size_ops=len(msg.payload["ops"]),
                      size_bytes=sum(op.size
                                     for op in msg.payload["ops"]))
            return
        self._enqueue_slow(msg.payload["ops"], now)

    # -- leader: serialized instances (lines 4-17) ------------------------------

    def _enqueue_slow(self, ops: List[Op], now: float) -> None:
        ops = [op for op in ops if op.op_id not in self.rsm.applied_ops
               and op.op_id not in self._slow_pending]
        if ops:
            tr = self.sim.tracer
            if tr is not None:
                sampled = tr.sampled
                for op in ops:
                    if sampled(op.op_id):
                        tr.ev("slow_enqueue", now, self.node_id, op.op_id)
            lm = self.lease_mgr
            for op in ops:
                self._slow_pending_add(op)
                if lm is not None and op.kind == "w":
                    # leader-side write visibility for lease votes: queued
                    # slow writes block grants until applied
                    lm.note_write(op.obj, op.op_id, now)
            self.slow_queue.append(ops)
        self._slow_kick(now)

    def _slow_kick(self, now: float) -> None:
        if self.slow_mutex or not self.slow_queue:
            return
        if not self.is_leader(now):
            # lost leadership with work queued: hand everything to the
            # current leader (clear pending so the forward isn't deduped)
            leader = self.current_leader(now)
            while self.slow_queue:
                ops = self.slow_queue.popleft()
                for op in ops:
                    self._slow_pending_remove(op)
                    self._forwarded[op.op_id] = op
                self.send(leader, "slow_forward", {"ops": ops},
                          size_ops=len(ops),
                          size_bytes=sum(op.size for op in ops))
            return
        self.slow_mutex = True                      # lock(mutex)
        # group commit: merge queued forwards into one instance, up to the
        # configured cap (always take the head group)
        ops = list(self.slow_queue.popleft())
        while (self.slow_queue
               and len(ops) + len(self.slow_queue[0]) <= self.group_cap):
            ops.extend(self.slow_queue.popleft())
        self.sim.busy(self.node_id, self._coord_cost * len(ops))
        # cross-path deps: fast ops live at the leader for these objects
        # must apply first, everywhere (leader in_flight holds fast entries
        # only — slow ops are tracked in _slow_pending)
        deps: Dict[int, List[int]] = {}
        for op in ops:
            live = [x for x in self.in_flight.get(op.obj, {})
                    if x != op.op_id and x not in self._slow_pending
                    and x not in self.rsm.applied_ops]
            if live:
                deps[op.op_id] = live
        w = self.node_weights()                     # getPriorities()
        inst = SlowInstance(inst_id=next(self._inst_seq)
                            | (self.node_id << 48),
                            ops=ops, psum=float(w[self.node_id]),
                            acked={self.node_id}, propose_time=now,
                            deps=deps)
        self.slow_inst = inst
        tr = self.sim.tracer
        if tr is not None:
            sampled = tr.sampled
            for op in ops:
                if sampled(op.op_id):
                    tr.ev("slow_propose", now, self.node_id,
                          inst.inst_id, op.op_id)
        payload = {"inst": inst.inst_id, "ops": ops}
        if self.reassign_mgr is not None:
            # epoch-stamped proposal: followers on a newer weight view
            # nack it (repro_torch.core.reassign) — the key only appears once
            # an epoch exists, so fault-free payloads are unchanged
            self.reassign_mgr.stamp(payload)
        cm = self.coding_mgr
        if cm is not None and cm.plan_batch(ops, now):
            # striped instance: per-destination proposes, one distinct
            # shard per assignee (the leader is the origin here)
            for dst in self._others:
                stripes, nb = cm.stripe_payload_for(ops, dst)
                p2 = dict(payload)
                if stripes:
                    p2["stripes"] = stripes
                self.send(dst, "slow_propose", p2, size_ops=len(ops),
                          size_bytes=nb)
        else:
            self.broadcast(self._others, "slow_propose", payload,
                           size_ops=len(ops),
                           size_bytes=sum(op.size for op in ops))
        inst.timer = self.set_timer(self.sim.costs.timeout,
                                    "slow_inst_timeout",
                                    {"inst": inst.inst_id})
        self._slow_check_commit(inst, now)

    def on_slow_accept(self, msg: Msg, now: float) -> None:
        inst = self.slow_inst
        if (inst is None or msg.payload["inst"] != inst.inst_id
                or msg.src in inst.acked):
            return
        if not self.is_leader(now):
            # lost leadership mid-round: abandon rather than commit a
            # round that would race the new leader's instances
            self.on_slow_nack(Msg("slow_nack", msg.src, self.node_id,
                                  {"inst": inst.inst_id}), now)
            return
        inst.acked.add(msg.src)
        if inst.coding_wait is not None:
            # decided striped instance awaiting its reconstructable set:
            # this accept proves the follower holds its assigned shards
            self.coding_mgr.wait_ack(inst.coding_wait, msg.src, now)
            return
        if inst.lease_wait is not None:
            # decided instance gated on a lease: this accept doubles as
            # the follower's revocation ack
            self.lease_mgr.wait_vote(inst.lease_wait, msg.src, now)
            return
        inst.psum += float(self.node_weights()[msg.src])
        tr = self.sim.tracer
        if tr is not None:   # instance-level: always recorded (no sampling)
            tr.ev("slow_accept", now, self.node_id, inst.inst_id,
                  msg.src, inst.psum)
        # updatePriorities(responders): latency EMA feeds the next ranking
        self.observe_node(msg.src, now - inst.propose_time)
        self._slow_check_commit(inst, now)

    def _slow_check_commit(self, inst: SlowInstance, now: float) -> None:
        if inst.committed or inst.psum <= self.node_threshold():  # strict
            return
        inst.committed = True
        if inst.timer is not None:
            inst.timer.cancel()
        tr = self.sim.tracer
        if tr is not None:
            sampled = tr.sampled
            for op in inst.ops:
                if sampled(op.op_id):
                    tr.ev("slow_commit", now, self.node_id,
                          inst.inst_id, op.op_id)
        cm = self.coding_mgr
        if cm is not None:
            key = cm.gate_commit(
                inst.ops, now,
                lambda t, i=inst: self._slow_coding_gated(i, t),
                inst.acked)
            if key is not None:
                # a striped instance crossed its weighted threshold
                # before its reconstructable set is durable: hold the
                # mutex and wait for enough distinct shard acks
                inst.coding_wait = key
                return
        self._slow_lease_gated(inst, now)

    def _slow_coding_gated(self, inst: SlowInstance, now: float) -> None:
        inst.coding_wait = None
        self._slow_lease_gated(inst, now)

    def _slow_lease_gated(self, inst: SlowInstance, now: float) -> None:
        lm = self.lease_mgr
        if lm is not None:
            key = lm.gate_commit(
                inst.ops, now, lambda t, i=inst: self._slow_finalize(i, t),
                set(self._others) - inst.acked)
            if key is not None:
                # a write hit a live read lease: the decision stands but
                # the stamp/broadcast waits for the remaining accept acks
                # (or lease expiry). The mutex stays held — that residual
                # quorum-to-all gap IS the leased-write cost the churn
                # bench measures.
                inst.lease_wait = key
                return
        self._slow_finalize(inst, now)

    def _slow_finalize(self, inst: SlowInstance, now: float) -> None:
        cm = self.coding_mgr
        mk = cm.commit_marker(inst.ops) if cm is not None else None
        payload = {"ops": inst.ops, "deps": inst.deps}
        if mk:
            payload["striped"] = mk
            # marker before apply: the local apply GC's the plan recs
            cm.note_striped_commit(inst.ops, mk, now)
        self.broadcast(self._others, "slow_commit", payload,
                       size_ops=len(inst.ops))
        self._apply_slow_commit(inst.ops, inst.deps, now)
        self.slow_inst = None
        self.slow_mutex = False                     # unlock(mutex)
        self._slow_kick(now)

    def on_slow_nack(self, msg: Msg, now: float) -> None:
        inst = self.slow_inst
        if inst is None or msg.payload["inst"] != inst.inst_id \
                or inst.committed:
            # committed means DECIDED: with leases on, a decided instance
            # can sit in slow_inst awaiting revocation acks — a late nack
            # must not re-drive (and double-commit) it
            return
        # lost leadership: hand the instance to the current leader
        if inst.timer is not None:
            inst.timer.cancel()
        self.slow_inst = None
        self.slow_mutex = False
        for op in inst.ops:
            self._slow_pending_remove(op)
        self.forward_slow(inst.ops, now)
        self._slow_kick(now)

    # -- follower side -----------------------------------------------------------

    def on_slow_propose(self, msg: Msg, now: float) -> None:
        cm = self.coding_mgr
        if cm is not None:
            st = msg.payload.get("stripes")
            if st:
                # shards were physically delivered with this propose —
                # record them even if we refuse to vote below
                cm.recv_stripes(msg.payload["ops"], st, msg.src, now)
        if self._isolated:
            return        # no votes from behind a partition (split-brain
                          # guard; the proposer's instance times out)
        if now < self._promise_until:
            # fresh leader-lease promise (repro_torch.core.leases): accept only
            # from the promised leader, whatever the heartbeat view says —
            # the promise is what lets that leader serve reads locally
            if msg.src != self._promise_to:
                self.send(msg.src, "slow_nack",
                          {"inst": msg.payload["inst"]})
                return
        elif msg.src != self.current_leader(now):
            self.send(msg.src, "slow_nack", {"inst": msg.payload["inst"]})
            return
        if self.reassign_mgr is not None \
                and self.reassign_mgr.reject_stale(msg, now):
            # proposal stamped with a pre-reassignment weight epoch: its
            # quorum math predates the installed view — bounce it back so
            # the (demoted) proposer hands the ops to the current leader
            self.send(msg.src, "slow_nack", {"inst": msg.payload["inst"]})
            return
        lm = self.lease_mgr
        for op in msg.payload["ops"]:
            # cross-path guard (Thm 2): fast attempts now see a conflict
            self.register_inflight(op.obj, op.op_id, now)
            if lm is not None and op.kind == "w":
                lm.note_write(op.obj, op.op_id, now)
            # accepted-op record: if the leader is lost right after this
            # instance crosses its threshold, the decision survives here
            self._note_accepted(op, msg.src, now)
        self.send(msg.src, "slow_accept", {"inst": msg.payload["inst"]})

    def on_slow_commit(self, msg: Msg, now: float) -> None:
        cm = self.coding_mgr
        if cm is not None:
            mk = msg.payload.get("striped")
            if mk:
                cm.note_striped_commit(msg.payload["ops"], mk, now)
        self._apply_slow_commit(msg.payload["ops"],
                                msg.payload.get("deps", {}), now)

    def _apply_slow_commit(self, ops: List[Op],
                           deps: Dict[int, List[int]], now: float) -> None:
        for op in ops:
            op.path = op.path or "slow"
        self.apply_commit_batch(ops, deps, now, "slow")
        self.flush_credits()

    # -- timers --------------------------------------------------------------------

    def on_protocol_timer(self, name: str, payload: dict, now: float) -> None:
        if name == "slow_retransmit":
            stale = [self._forwarded[i] for i in payload["op_ids"]
                     if i in self._forwarded]
            if stale:
                backoff = min(payload.get("backoff", 1) * 2, 16)
                leader = self.current_leader(now)
                if leader != self.node_id:
                    self.send(leader, "slow_forward", {"ops": stale},
                              size_ops=len(stale),
                              size_bytes=sum(op.size for op in stale))
                else:
                    self._enqueue_slow(stale, now)
                self.set_timer(self.sim.costs.timeout * 4 * backoff,
                               "slow_retransmit",
                               {"op_ids": [op.op_id for op in stale],
                                "backoff": backoff})
        elif name == "slow_inst_timeout":
            inst = self.slow_inst
            if inst is not None and inst.inst_id == payload["inst"] \
                    and not inst.committed:
                missing = [r for r in range(self.sim.n)
                           if r not in inst.acked]
                payload = {"inst": inst.inst_id, "ops": inst.ops}
                if self.reassign_mgr is not None:
                    self.reassign_mgr.stamp(payload)
                cm = self.coding_mgr
                if cm is not None and cm.has_stripes(inst.ops):
                    # the gate counts an assignee's accept as "holds its
                    # shard", so re-proposes MUST re-carry the shards
                    for dst in missing:
                        st, nb = cm.stripe_payload_for(inst.ops, dst)
                        p2 = dict(payload)
                        if st:
                            p2["stripes"] = st
                        self.send(dst, "slow_propose", p2,
                                  size_ops=len(inst.ops), size_bytes=nb)
                else:
                    self.broadcast(missing, "slow_propose", payload,
                                   size_ops=len(inst.ops),
                                   size_bytes=sum(op.size
                                                  for op in inst.ops))
                inst.timer = self.set_timer(self.sim.costs.timeout,
                                            "slow_inst_timeout",
                                            {"inst": inst.inst_id})
        elif name == "fast_timeout":
            self.on_fast_timeout(payload, now)
