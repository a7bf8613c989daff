"""EPaxos-style baseline (Moraru et al., 2013 [13]): the other design axis.

Leaderless, *uniform* quorums with dependency tracking: any replica
coordinates; a command commits in one round-trip if a quorum reports
identical (empty) dependency sets, otherwise it pays a second ACCEPT round.

This is a calibrated performance baseline for §2.2's comparison (object
independence *without* node weights): the coordinator must always wait for
the ⌈(n+1)/2⌉-th fastest reply regardless of replica heterogeneity, whereas
WOC's steep object weights commit on the top-weighted (fastest) replicas.
Dependency-graph execution is simplified to conflict-triggered second
rounds; we do not run linearizability checks against this baseline (WOC and
Cabinet are the verified implementations).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List

import numpy as np

from repro_torch.core.protocol_base import BaseReplica
from repro_torch.core.simulator import Msg, Op, Simulation


@dataclasses.dataclass
class EpaxosBatch:
    batch_id: int
    client: int
    client_bid: int
    ops: List[Op]
    replies: int = 0
    dep_any: np.ndarray = None          # (B,) op saw a dependency anywhere
    accept_acks: int = 0
    phase: str = "preaccept"            # -> "accept" -> done
    deferred: List[Op] = dataclasses.field(default_factory=list)


class EPaxosReplica(BaseReplica):

    def __init__(self, node_id: int, sim: Simulation, *, t_fail: int = 1,
                 steepness: float | None = None, **kw):
        super().__init__(node_id, sim, t_fail=t_fail, steepness=1.0, **kw)
        self.batches: Dict[int, EpaxosBatch] = {}
        self._seq = itertools.count()
        self.majority = sim.n // 2 + 1

    # -- coordinator -------------------------------------------------------------

    def on_client_req(self, msg: Msg, now: float) -> None:
        ops: List[Op] = msg.payload["ops"]
        done = [op for op in ops if op.op_id in self.rsm.applied_ops]
        tr = self.sim.tracer
        if done:                                     # client retry
            for op in done:
                if op.commit_time < 0:
                    op.commit_time = now
                    op.path = op.path or "fast"
                    commit_log = self.sim.commit_log
                    if op.op_id not in commit_log:
                        commit_log[op.op_id] = (now, op.path)
                        if tr is not None:
                            tr.ev("commit", now, self.node_id,
                                  op.op_id, op.path)
                self.credit_op(msg.src, msg.payload["batch_id"], op.op_id)
            self.flush_credits()
            ops = [op for op in ops if op.op_id not in self.rsm.applied_ops]
            if not ops:
                return
        c = self.sim.costs
        self.sim.busy(self.node_id,
                      c.c_coord * len(ops) * c.speed(self.node_id))
        eb = EpaxosBatch(batch_id=next(self._seq) | (self.node_id << 48),
                         client=msg.src, client_bid=msg.payload["batch_id"],
                         ops=ops, dep_any=np.zeros(len(ops), dtype=bool))
        self.batches[eb.batch_id] = eb
        if tr is not None:
            sampled = tr.sampled
            for op in ops:
                if sampled(op.op_id):
                    tr.ev("ingress", now, self.node_id, op.op_id, op.obj,
                          op.submit_time, op.client)
        # self pre-accept
        for i, op in enumerate(ops):
            if self.has_conflict(op.obj, op.op_id, now):
                eb.dep_any[i] = True
            self.register_inflight(op.obj, op.op_id, now)
        eb.replies = 1
        others = [r for r in range(self.sim.n) if r != self.node_id]
        self.broadcast(others, "preaccept",
                       {"eb": eb.batch_id, "ops": ops}, size_ops=len(ops))

    def on_preaccept_ok(self, msg: Msg, now: float) -> None:
        eb = self.batches.get(msg.payload["eb"])
        if eb is None or eb.phase != "preaccept":
            return
        tr = self.sim.tracer
        if tr is not None:
            tr.ev("epx_reply", now, self.node_id, eb.batch_id, "pre",
                  msg.src)
        eb.replies += 1
        eb.dep_any |= msg.payload["deps"]
        if eb.replies >= self.majority:
            clean = ~eb.dep_any
            committed = [eb.ops[i] for i in np.flatnonzero(clean)]
            self._commit(committed, now)                  # 1-RTT fast path
            eb.deferred = [eb.ops[i] for i in np.flatnonzero(eb.dep_any)]
            if eb.deferred:                                # 2nd round
                eb.phase = "accept"
                eb.accept_acks = 1
                others = [r for r in range(self.sim.n) if r != self.node_id]
                self.broadcast(others, "epx_accept",
                               {"eb": eb.batch_id, "ops": eb.deferred},
                               size_ops=len(eb.deferred))
            else:
                self._finish(eb, now)

    def on_epx_accept_ok(self, msg: Msg, now: float) -> None:
        eb = self.batches.get(msg.payload["eb"])
        if eb is None or eb.phase != "accept":
            return
        tr = self.sim.tracer
        if tr is not None:
            tr.ev("epx_reply", now, self.node_id, eb.batch_id, "acc",
                  msg.src)
        eb.accept_acks += 1
        if eb.accept_acks >= self.majority:
            self._commit(eb.deferred, now)
            self._finish(eb, now)

    def _commit(self, ops: List[Op], now: float) -> None:
        if not ops:
            return
        c = self.sim.costs
        self.sim.busy(self.node_id,
                      c.c_apply * len(ops) * c.speed(self.node_id))
        commit_log = self.sim.commit_log
        tr = self.sim.tracer
        for op in ops:
            self.rsm.apply(op)
            self.clear_inflight(op.obj, op.op_id)
            if op.commit_time < 0:
                op.commit_time = now
                op.path = "fast" if not op.path else op.path
                if op.op_id not in commit_log:
                    commit_log[op.op_id] = (now, op.path)
                    if tr is not None:
                        tr.ev("commit", now, self.node_id,
                              op.op_id, op.path)
        others = [r for r in range(self.sim.n) if r != self.node_id]
        self.broadcast(others, "epx_commit", {"ops": ops},
                       size_ops=len(ops))

    def _finish(self, eb: EpaxosBatch, now: float) -> None:
        eb.phase = "done"
        self.send(eb.client, "client_reply",
                  {"batch_id": eb.client_bid,
                   "op_ids": [op.op_id for op in eb.ops]})
        self.batches.pop(eb.batch_id, None)

    # -- replica side ---------------------------------------------------------------

    def on_preaccept(self, msg: Msg, now: float) -> None:
        ops: List[Op] = msg.payload["ops"]
        deps = np.zeros(len(ops), dtype=bool)
        for i, op in enumerate(ops):
            if self.has_conflict(op.obj, op.op_id, now):
                deps[i] = True
            self.register_inflight(op.obj, op.op_id, now)
        self.send(msg.src, "preaccept_ok",
                  {"eb": msg.payload["eb"], "deps": deps})

    def on_epx_accept(self, msg: Msg, now: float) -> None:
        self.send(msg.src, "epx_accept_ok", {"eb": msg.payload["eb"]})

    def on_epx_commit(self, msg: Msg, now: float) -> None:
        ops: List[Op] = msg.payload["ops"]
        if self.recovering:
            # mid-state-transfer: applying now would be overwritten by the
            # incoming snapshot (and the ops lost) — route through the
            # recovery buffer like the other protocols' commit paths
            for op in ops:
                self._recovery_buf.append((op, None, op.path or "fast"))
            return
        c = self.sim.costs
        self.sim.busy(self.node_id,
                      c.c_apply * len(ops) * c.speed(self.node_id))
        for op in ops:
            self.rsm.apply(op)
            self.clear_inflight(op.obj, op.op_id)
