"""Cabinet baseline (Zhang et al., 2025 [24]): the paper's main comparison.

Cabinet is node-weighted consensus with a single global leader: *every*
operation — independent or not — is serialized through one leader running
dynamically weighted quorums. Structurally this is exactly WOC's slow path
applied to 100% of the workload, so the implementation reuses
:class:`SlowPathMixin` verbatim; clients contact the leader directly.

``steepness=1.0`` degenerates every weight to 1 and the threshold to n/2,
which is classic majority-quorum MultiPaxos — exported as PaxosReplica.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.core.protocol_base import BaseReplica
from repro_torch.core.simulator import Msg, Op, Simulation
from repro_torch.core.slowpath import SlowPathMixin


class CabinetReplica(SlowPathMixin, BaseReplica):

    def __init__(self, node_id: int, sim: Simulation, *, t_fail: int = 1,
                 steepness: float | None = None, **kw):
        super().__init__(node_id, sim, t_fail=t_fail, steepness=steepness,
                         **kw)
        self._init_slowpath()
        self.pending: Dict[int, dict] = {}
        self.op2batch: Dict[int, int] = {}

    def on_client_req(self, msg: Msg, now: float) -> None:
        ops: List[Op] = msg.payload["ops"]
        bid = msg.payload["batch_id"]
        rec = {"client": msg.src, "remaining": set()}
        self.pending[bid] = rec
        todo = []
        tr = self.sim.tracer
        lm = self.lease_mgr
        for op in ops:
            if op.op_id in self.rsm.applied_ops:       # client retry
                if op.commit_time < 0:
                    op.commit_time = now
                    op.path = op.path or "slow"
                    commit_log = self.sim.commit_log
                    if op.op_id not in commit_log:
                        commit_log[op.op_id] = (now, op.path)
                        if tr is not None:
                            tr.ev("commit", now, self.node_id,
                                  op.op_id, op.path)
                self.credit_op(msg.src, bid, op.op_id)
                continue
            # Cabinet-style leader reads: under a fresh promise-based
            # leader lease the leader answers reads from its own RSM —
            # no instance, no quorum round (repro_torch.core.leases)
            if lm is not None and op.kind == "r" \
                    and lm.leader_serve(op, now):
                if tr is not None and tr.sampled(op.op_id):
                    # served without an instance: emit the ingress span
                    # the critical-path analyzer keys local reads on
                    tr.ev("ingress", now, self.node_id, op.op_id, op.obj,
                          op.submit_time, op.client)
                self.credit_op(msg.src, bid, op.op_id)
                continue
            rec["remaining"].add(op.op_id)
            self.op2batch[op.op_id] = bid
            if tr is not None and tr.sampled(op.op_id):
                tr.ev("ingress", now, self.node_id, op.op_id, op.obj,
                      op.submit_time, op.client)
                tr.ev("route", now, self.node_id, op.op_id, op.obj,
                      "slow", "single_leader")
            todo.append(op)
        if not rec["remaining"]:
            self.pending.pop(bid, None)
        self.forward_slow(todo, now)   # leader-or-forward, then Algorithm 2
        self.flush_credits()

    def on_applied(self, op: Op, now: float, path: str) -> None:
        self._forwarded.pop(op.op_id, None)
        self._slow_pending_remove(op)
        self.finalize_op(op, now, path)

    def on_applied_batch(self, ops, now: float, path: str) -> None:
        self._finalize_batch(ops, now, path)

    def finalize_op(self, op: Op, now: float, path: str) -> None:
        bid = self.op2batch.pop(op.op_id, None)
        if bid is None:
            return
        if op.commit_time < 0:
            op.commit_time = now
            op.path = path
            commit_log = self.sim.commit_log
            if op.op_id not in commit_log:
                commit_log[op.op_id] = (now, path)
                tr = self.sim.tracer
                if tr is not None:
                    tr.ev("commit", now, self.node_id, op.op_id, path)
        rec = self.pending.get(bid)
        if rec is None:
            return
        rec["remaining"].discard(op.op_id)
        self.credit_op(rec["client"], bid, op.op_id)
        if not rec["remaining"]:
            self.pending.pop(bid, None)


class PaxosReplica(CabinetReplica):
    """Uniform majority-quorum MultiPaxos: Cabinet with flat weights."""

    def __init__(self, node_id: int, sim: Simulation, *, t_fail: int = 1,
                 steepness: float | None = None, **kw):
        super().__init__(node_id, sim, t_fail=t_fail, steepness=1.0, **kw)
