"""Shard gate: ownership checks, NOT_OWNER redirects, object stealing.

``make_sharded_replica(cls)`` wraps any protocol replica class (WOC,
Cabinet, EPaxos, MultiPaxos) with a gate that intercepts ``client_req``
at the consensus-layer boundary:

  * ops on objects this group owns are admitted and passed to the
    protocol unmodified;
  * ops on objects owned elsewhere are bounced back to the client with a
    ``shard_redirect`` (NOT_OWNER) carrying the owner hint + epoch;
  * ops on objects mid-migration are *fenced* (buffered) and, once the
    transfer completes, redirected to the new owner for replay — op-id
    idempotent RSM apply plus the migrated per-object applied-op-id set
    make the replay exactly-once.

Object stealing (WPaxos-style ownership transfer) runs between the two
groups' *gate replicas* (local id 0 — also each group's initial leader):

  stealer                          owner
    shard_steal_req  ───────────▶  fence object; wait until every op
                                   ever admitted for it has applied at
                                   the gate replica's RSM (drain)
    shard_steal_grant ◀──────────  ship {value, applied values, applied
                                   op ids}, bump epoch, record custody,
                                   redirect the fenced ops
    install + shard_install to own group; serve the object

All bookkeeping lives in a per-group :class:`GroupGate` shared by that
group's replicas: intra-group agreement on the shard map is carried by
the group's own consensus in a real deployment and is abstracted to
shared control-plane state here (the same simplification
:class:`repro_torch.core.object_manager.ObjectManager` documents); the
*cross-group* transfer — the part whose latency and message cost matter —
uses real simulated messages. Cross-group messages address peers by
global id (``GroupView.post_global``) and carry explicit reply addresses
in payloads; ``msg.src`` is only meaningful intra-group.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Type

from repro_torch.core.protocol_base import BaseReplica
from repro_torch.core.simulator import Msg, Op
from repro_torch.shard.shard_map import ShardMap


class GroupGate:
    """Shared per-group shard control plane + migration bookkeeping."""

    def __init__(self, group: int, n_groups: int, size: int, seed: int = 0,
                 steal_cooldown: float = 0.25):
        self.group = group
        self.n_groups = n_groups
        self.size = size
        self.map = ShardMap(n_groups, seed=seed)
        self.steal_cooldown = steal_cooldown
        # every op id ever admitted into this group's protocol, per object
        # (drain condition for migration: all of them applied at the gate)
        self.admitted: Dict[int, set] = {}
        # obj -> [(client, batch_id, op)] buffered while mid-migration
        self.fence_buf: Dict[int, List[Tuple[int, int, Op]]] = {}
        # owner-side: obj -> grant destination, stealer-side: obj -> hinter
        self.pending_grant: Dict[int, dict] = {}
        self.stealing: Dict[int, int] = {}
        self.resteal_ok: Dict[int, float] = {}   # obj -> cooldown expiry
        # metrics
        self.ops_admitted = 0
        self.redirects = 0
        self.fenced_ops = 0
        self.fenced_replayed = 0
        self.steals_started = 0
        self.steal_nacks = 0
        self.migrations_in = 0
        self.migrations_out = 0
        self.migration_log: List[Tuple[int, int, int, int]] = []
        # (obj, from_group, to_group, epoch)
        # parallel runs set this to a list: counter bumps are journaled as
        # (event_time, field, delta) for the current time window so the
        # orchestrator can truncate the final window to the exact serial
        # stop time T* (see repro_torch.shard.parallel). None in serial runs.
        self.journal = None

    def truncate_after(self, t: float) -> None:
        """Undo journaled counter bumps from events after ``t`` (the
        serial engine never processes them: it stops at T* exactly)."""
        if not self.journal:
            return
        for tt, field, delta in self.journal:
            if tt > t:
                setattr(self, field, getattr(self, field) - delta)
        self.journal.clear()

    def admit(self, op: Op, now: float) -> None:
        s = self.admitted.setdefault(op.obj, set())
        if op.op_id not in s:
            s.add(op.op_id)
            self.ops_admitted += 1
            if self.journal is not None:
                self.journal.append((now, "ops_admitted", 1))

    def gate_replica_global(self) -> int:
        return self.group * self.size


_SHARDED_CLASSES: Dict[Type[BaseReplica], Type[BaseReplica]] = {}

_INSTALL_KEYS = ("obj", "epoch", "present", "value", "values", "op_ids")


def make_sharded_replica(base_cls: Type[BaseReplica]) -> Type[BaseReplica]:
    """Return (and cache) a gate-wrapped subclass of ``base_cls``."""
    cls = _SHARDED_CLASSES.get(base_cls)
    if cls is None:
        cls = type(f"Sharded{base_cls.__name__}", (_ShardGateMixin, base_cls),
                   {})
        _SHARDED_CLASSES[base_cls] = cls
    return cls


class _ShardGateMixin:
    """Ownership gate in front of any protocol replica's client ingress."""

    DRAIN_POLL = 1e-3   # owner-side fence-drain poll interval (sim seconds)

    def __init__(self, node_id, sim, *, gate: GroupGate, **kw):
        self.gate = gate
        self._install_epochs: Dict[int, int] = {}   # obj -> installed epoch
        super().__init__(node_id, sim, **kw)

    # -- addressing --------------------------------------------------------

    def _gid(self) -> int:
        """This replica's global id."""
        return self.sim.to_global(self.node_id)

    def _shard_send(self, dst_global: int, kind: str, payload: dict,
                    size_ops: int = 0) -> None:
        """Cross-group send in the global namespace (bypasses the group
        view's local-id translation)."""
        self.sim.post_global(Msg(kind, self._gid(), dst_global, payload,
                                 size_ops))

    # -- client ingress -----------------------------------------------------

    def on_client_req(self, msg: Msg, now: float) -> None:
        g = self.gate
        ops: List[Op] = msg.payload["ops"]
        bid = msg.payload["batch_id"]
        mine, redirects = [], []
        for op in ops:
            if op.op_id in self.rsm.applied_ops:
                mine.append(op)      # committed already: super() credits it
                continue
            grp, ep = g.map.owner(op.obj)
            if grp != g.group:
                redirects.append((op.op_id, op.obj, grp, ep))
            elif g.map.is_fenced(op.obj):
                buf = g.fence_buf.setdefault(op.obj, [])
                # client retries during a long drain re-send the sub-batch;
                # buffer each fenced op once or the grant-time flush emits
                # duplicate redirects (and inflates the fence counters)
                if not any(b[2].op_id == op.op_id for b in buf):
                    buf.append((msg.src, bid, op))
                    g.fenced_ops += 1
                    if g.journal is not None:
                        g.journal.append((now, "fenced_ops", 1))
            else:
                g.admit(op, now)
                mine.append(op)
        if redirects:
            g.redirects += len(redirects)
            if g.journal is not None:
                g.journal.append((now, "redirects", len(redirects)))
            tr = self.sim.tracer
            if tr is not None:
                for _, obj, grp, _ in redirects:
                    tr.ev("redirect", now, self.node_id, obj, grp)
            self.send(msg.src, "shard_redirect",
                      {"batch_id": bid, "redirects": redirects})
        if mine:
            msg.payload = dict(msg.payload, ops=mine)
            super().on_client_req(msg, now)

    # -- stealer side --------------------------------------------------------

    def on_shard_steal_hint(self, msg: Msg, now: float) -> None:
        """A client homed here keeps hitting a remote object: try to steal
        it. Only the gate replica (local 0) receives hints."""
        g = self.gate
        obj = msg.payload["obj"]
        grp, ep = g.map.owner(obj)
        if grp == g.group or obj in g.stealing:
            return
        g.stealing[obj] = msg.payload.get("client", -1)
        g.steals_started += 1
        if g.journal is not None:
            g.journal.append((now, "steals_started", 1))
        tr = self.sim.tracer
        if tr is not None:
            tr.ev("steal_hint", now, self.node_id, obj)
        self._shard_send(grp * g.size, "shard_steal_req",
                         {"obj": obj, "group": g.group, "epoch_seen": ep,
                          "from": self._gid()})

    def on_shard_steal_grant(self, msg: Msg, now: float) -> None:
        g = self.gate
        p = msg.payload
        obj = p["obj"]
        hinter = g.stealing.pop(obj, None)
        self._shard_install(p, now)
        others = [r for r in range(self.sim.n) if r != self.node_id]
        self.broadcast(others, "shard_install",
                       {k: p[k] for k in _INSTALL_KEYS},
                       size_ops=len(p["op_ids"]))
        g.map.record(obj, g.group, p["epoch"])
        g.migrations_in += 1
        if g.journal is not None:
            g.journal.append((now, "migrations_in", 1))
        if hinter is not None and hinter >= 0:
            self.send(hinter, "shard_owner_update",
                      {"updates": [(obj, g.group, p["epoch"])]})

    def on_shard_steal_nack(self, msg: Msg, now: float) -> None:
        g = self.gate
        p = msg.payload
        g.stealing.pop(p["obj"], None)
        g.steal_nacks += 1
        if g.journal is not None:
            g.journal.append((now, "steal_nacks", 1))
        g.map.record(p["obj"], p["group"], p["epoch"])

    def on_shard_install(self, msg: Msg, now: float) -> None:
        self._shard_install(msg.payload, now)

    def _shard_install(self, p: dict, now: float) -> None:
        """Install a migrated object's state as the new *prefix* of the
        local history. The shipped applied-op-id list covers everything
        committed under previous custodies (prefix property along the
        chain), so replayed duplicates dedupe against it. The merge keeps
        any ops this replica already applied under the NEW custody — a
        redirected replay can reach a non-gate replica and commit before
        its shard_install arrives — rather than clobbering them: those are
        strictly newer than anything shipped, so they stay as the suffix.
        Stale/duplicate installs (epoch at or below one already installed)
        are ignored."""
        obj = p["obj"]
        if p["epoch"] <= self._install_epochs.get(obj, 0):
            return
        self._install_epochs[obj] = p["epoch"]
        tr = self.sim.tracer
        if tr is not None:
            tr.ev("steal_install", now, self.node_id, obj, p["epoch"])
        c = self.sim.costs
        self.sim.busy(self.node_id, c.c_parse * max(1, len(p["op_ids"]))
                      * c.speed(self.node_id))
        rsm = self.rsm
        shipped_ids = list(p["op_ids"])
        shipped_vals = list(p["values"])
        id_set, val_set = set(shipped_ids), set(shipped_vals)
        extra_ids = [i for i in rsm.obj_ops.get(obj, ())
                     if i not in id_set]
        extra_vals = [v for v in rsm.applied.get(obj, ())
                      if v not in val_set]     # write values are unique
        rsm.applied[obj] = shipped_vals + extra_vals
        rsm.obj_ops[obj] = shipped_ids + extra_ids
        rsm.applied_ops.update(shipped_ids)
        if not extra_vals:                     # no post-custody write yet
            rsm.store.pop(obj, None)
            if p["present"]:
                rsm.store[obj] = p["value"]
        if self.coding_mgr is not None:
            # the installed value is a decoded full copy strictly newer
            # than anything striped here under an older custody: drop any
            # stale stripe record (and stamp reads parked on it)
            self.coding_mgr.invalidate_obj(obj)
        if rsm.obj_ops.get(obj):
            # join the dependency machinery: post-install fast commits are
            # leader-stamped to order after this (and a commit racing ahead
            # of the install buffers on the dep until it lands here)
            self.last_applied[obj] = rsm.obj_ops[obj][-1]
        om = getattr(self, "om", None)
        if om is not None:
            om.note_ownership(obj, p["epoch"])
        self._drain_obj(obj, now)
        self.flush_credits()

    # -- owner side -----------------------------------------------------------

    def on_shard_steal_req(self, msg: Msg, now: float) -> None:
        g = self.gate
        p = msg.payload
        obj = p["obj"]
        grp, ep = g.map.owner(obj)
        if (grp != g.group or g.map.is_fenced(obj)
                or now < g.resteal_ok.get(obj, 0.0)):
            # not ours / mid-migration / cooling down: point at our best
            # known owner so the stealer's map converges anyway
            self._shard_send(p["from"], "shard_steal_nack",
                             {"obj": obj, "group": grp, "epoch": ep})
            return
        g.map.fence(obj)
        tr = self.sim.tracer
        if tr is not None:
            tr.ev("steal_fence", now, self.node_id, obj)
        g.pending_grant[obj] = {"to": p["from"], "group": p["group"]}
        self._shard_drain_check(obj, now)

    def _shard_drain_check(self, obj: int, now: float) -> None:
        """Grant once every op ever admitted for ``obj`` has applied at
        this (gate) replica's RSM — the in-flight fence+drain that makes
        the transfer linearizable."""
        need = self.gate.admitted.get(obj, ())
        lm = self.lease_mgr
        cm = self.coding_mgr
        if all(oid in self.rsm.applied_ops for oid in need) \
                and (lm is None or lm.fence_obj(obj, now)) \
                and (cm is None or cm.fence_obj(obj, now)):
            # read leases and stripe state fence alongside the write
            # drain: no replica may keep serving local reads past the
            # custody change, and the grant ships the decoded full value
            # (rsm.store), so the stripe record must not outlive custody
            self._shard_grant(obj, now)
        else:
            self.set_timer(self.DRAIN_POLL, "shard_drain", {"obj": obj})

    def _shard_grant(self, obj: int, now: float) -> None:
        g = self.gate
        rec = g.pending_grant.pop(obj, None)
        if rec is None:
            return
        epoch = g.map.epoch(obj) + 1
        op_ids = list(self.rsm.obj_ops.get(obj, ()))
        self._shard_send(rec["to"], "shard_steal_grant",
                         {"obj": obj, "epoch": epoch, "group": rec["group"],
                          "present": obj in self.rsm.store,
                          "value": self.rsm.store.get(obj),
                          "values": list(self.rsm.applied.get(obj, ())),
                          "op_ids": op_ids, "from": self._gid()},
                         size_ops=max(1, len(op_ids)))
        g.map.record(obj, rec["group"], epoch)
        g.map.unfence(obj)
        g.resteal_ok[obj] = now + g.steal_cooldown
        g.migrations_out += 1
        if g.journal is not None:
            g.journal.append((now, "migrations_out", 1))
        g.migration_log.append((obj, g.group, rec["group"], epoch))
        tr = self.sim.tracer
        if tr is not None:
            tr.ev("steal_grant", now, self.node_id, obj, epoch)
        om = getattr(self, "om", None)
        if om is not None:
            om.note_ownership(obj, epoch)
        buf = g.fence_buf.pop(obj, None)
        if buf:
            by_batch: Dict[Tuple[int, int], list] = {}
            for client, bid, op in buf:
                by_batch.setdefault((client, bid), []).append(
                    (op.op_id, op.obj, rec["group"], epoch))
            for (client, bid), rds in by_batch.items():
                g.fenced_replayed += len(rds)
                if g.journal is not None:
                    g.journal.append((now, "fenced_replayed", len(rds)))
                self.send(client, "shard_redirect",
                          {"batch_id": bid, "redirects": rds})

    # -- timers ---------------------------------------------------------------

    def on_protocol_timer(self, name: str, payload: dict, now: float) -> None:
        if name == "shard_drain":
            if payload["obj"] in self.gate.pending_grant:
                self._shard_drain_check(payload["obj"], now)
            return
        super().on_protocol_timer(name, payload, now)
