"""WOC replica: Object Manager + fast path + slow path (paper §4).

A WocReplica is a full consensus-layer node (Fig. 1): it ingests client
batches as a coordinator, routes each operation through the Object Manager
(fast path for conflict-free independent objects, slow path otherwise),
participates in other coordinators' fast rounds, and serves as slow-path
leader when it is the highest-weighted live replica.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.core.fastpath import FastPathMixin
from repro_torch.core.object_manager import ObjectManager, Route
from repro_torch.core.protocol_base import BaseReplica
from repro_torch.core.simulator import Msg, Op, Simulation
from repro_torch.core.slowpath import SlowPathMixin


class WocReplica(FastPathMixin, SlowPathMixin, BaseReplica):

    def __init__(self, node_id: int, sim: Simulation, *, t_fail: int = 1,
                 steepness: float | None = None, **kw):
        super().__init__(node_id, sim, t_fail=t_fail, steepness=steepness,
                         **kw)
        self.om = ObjectManager()
        if self.lease_mgr is not None:
            # ownership epoch bumps (shard stealing) void local leases
            self.om.lease_invalidate = self.lease_mgr.invalidate_obj
        self._init_fastpath()
        self._init_slowpath()
        # client batch bookkeeping: batch_id -> {client, remaining op_ids}
        self.pending: Dict[int, dict] = {}
        self.op2batch: Dict[int, int] = {}

    # -- ingress (client layer -> consensus layer) ------------------------------

    def on_client_req(self, msg: Msg, now: float) -> None:
        ops: List[Op] = msg.payload["ops"]
        bid = msg.payload["batch_id"]
        remaining = set()
        rec = {"client": msg.src, "remaining": remaining}
        self.pending[bid] = rec
        fast_ops, slow_ops = [], []
        applied_ops = self.rsm.applied_ops
        op2batch = self.op2batch
        om_route = self.om.route
        slow_count = self._slow_obj_count
        node_id = self.node_id
        tr = self.sim.tracer
        lm = self.lease_mgr
        for op in ops:
            op_id = op.op_id
            if op_id in applied_ops:                   # client retry of a
                if op.commit_time < 0:                 # committed op whose
                    op.commit_time = now               # coordinator died
                    op.path = op.path or "slow"        # before stamping it
                    commit_log = self.sim.commit_log
                    if op_id not in commit_log:
                        commit_log[op_id] = (now, op.path)
                        if tr is not None:
                            tr.ev("commit", now, node_id, op_id, op.path)
                self.credit_op(msg.src, bid, op_id)
                continue
            # lease-held reads commit here, in zero network round-trips
            # (serve_read also absorbs retries of reads lease-stamped at
            # another replica, so consensus never re-executes them)
            if lm is not None and op.kind == "r" and lm.serve_read(op, now):
                if tr is not None and tr.sampled(op_id):
                    # lease-served reads skip the routing block below, so
                    # give the critical-path analyzer their ingress span
                    tr.ev("ingress", now, node_id, op_id, op.obj,
                          op.submit_time, op.client)
                self.credit_op(msg.src, bid, op_id)
                continue
            remaining.add(op_id)
            op2batch[op_id] = bid
            # routing evidence is consumed by om_route (in-flight map,
            # post-migration window) — capture it before the call so the
            # trace can explain the decision
            samp = tr is not None and tr.sampled(op_id)
            if samp:
                tr.ev("ingress", now, node_id, op_id, op.obj,
                      op.submit_time, op.client)
                pre_conflict = bool(self.om.in_flight.get(op.obj))
                pre_fresh = op.obj in self.om._fresh
            route = om_route(op.obj, op_id, op.client, node_id, now)
            if route is Route.FAST:
                if slow_count and slow_count.get(op.obj):
                    # slow op queued here (we are leader)
                    if samp:
                        tr.ev("route", now, node_id, op_id, op.obj,
                              "slow", "slow_queued")
                    slow_ops.append(op)
                    continue
                if samp:
                    tr.ev("route", now, node_id, op_id, op.obj,
                          "fast", "independent")
                # coordinator's own in-flight registration (self-vote side)
                self.register_inflight(op.obj, op_id, now)
                if lm is not None and op.kind == "w":
                    lm.note_write(op.obj, op_id, now)
                fast_ops.append(op)
            else:
                if samp:
                    tr.ev("route", now, node_id, op_id, op.obj, "slow",
                          "post_migration" if pre_fresh
                          else "conflict_inflight" if pre_conflict
                          else "hot_or_common")
                slow_ops.append(op)
        if not remaining:
            self.pending.pop(bid, None)
        self.start_fast(fast_ops, now)
        self.forward_slow(slow_ops, now)
        self.flush_credits()

    # -- commit bookkeeping -------------------------------------------------------

    def on_applied(self, op: Op, now: float, path: str) -> None:
        op_id = op.op_id
        # om tracking exists only where this replica coordinated the op —
        # at the other n-1 replicas the lookup misses and the call is skipped
        d = self.om.in_flight.get(op.obj)
        if d and op_id in d:
            self.om.complete(op.obj, op_id, now)
        if self._forwarded:
            self._forwarded.pop(op_id, None)
        if op_id in self._slow_pending:
            self._slow_pending_remove(op)
        self.finalize_op(op, now, path)

    def on_applied_batch(self, ops, now: float, path: str) -> None:
        """Hot path: om completion for coordinated ops, then the shared
        finalize tail (SlowPathMixin._finalize_batch)."""
        om = self.om
        om_in_flight = om.in_flight
        for op in ops:
            d = om_in_flight.get(op.obj)
            if d and op.op_id in d:
                om.complete(op.obj, op.op_id, now)
        self._finalize_batch(ops, now, path)

    def finalize_op(self, op: Op, now: float, path: str) -> None:
        op_id = op.op_id
        bid = self.op2batch.pop(op_id, None)
        if bid is None:
            return
        if op.commit_time < 0:
            op.commit_time = now
            op.path = path
            commit_log = self.sim.commit_log
            if op_id not in commit_log:
                commit_log[op_id] = (now, path)
                tr = self.sim.tracer
                if tr is not None:
                    tr.ev("commit", now, self.node_id, op_id, path)
        rec = self.pending.get(bid)
        if rec is None:
            return
        rec["remaining"].discard(op_id)
        self.credit_op(rec["client"], bid, op_id)
        if not rec["remaining"]:
            self.pending.pop(bid, None)
