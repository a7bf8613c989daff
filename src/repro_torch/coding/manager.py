"""Per-replica payload-striping state machine (Crossword, PAPERS.md).

Constructed only when the Scenario enables coding; every hook in the
protocol code is guarded by ``self.coding_mgr is not None`` so the
disabled cost is one attribute read and knob-off runs stay bit-identical.

Stripe record lifecycle (one dict per striped write, shared across
stages so shards accumulate in place):

  ``announced``        propose received (followers, with this replica's
                       shard) or planned (coordinator, full copy)
  ``pending_striped``  the commit's inert-when-absent ``"striped"``
                       marker arrived; awaiting dependency-ordered apply
  ``stripes[obj]``     applied — this IS the object's current value; a
                       later non-striped write on the object pops it

Commit gating: a striped write decides only when the acked replicas
hold a *weighted reconstructable set* — ``need`` DISTINCT assigned
shards, not just enough weight. The invariant every retransmission path
must preserve: an ack from an assigned replica implies it physically
holds (at least) its assigned shard, so the initial per-destination
proposes AND every retransmit (``stripe_push``, slow-instance timeout
re-proposes) carry real shard bytes.

Reads: the RSM's ``resolver`` hook calls :meth:`resolve_read` at each
replica's apply point. A replica that cannot decode the object's
current value (fewer than ``k`` local shards, origin crashed) parks the
read with the store value captured at its linearization point — the
per-object apply prefix is identical at every replica, so the captured
answer is too — and kicks a repair (``stripe_fetch``/``stripe_fill``)
that re-assembles ``k`` shards from peers, decodes for real, and stamps
the parked reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.coding import rs
from repro_torch.coding.policy import choose_plan


@dataclasses.dataclass(frozen=True)
class CodingConfig:
    """Lowered coding knob (see ``repro_torch.scenario.spec.Coding``)."""
    stripe_min_bytes: int = 4096   # op.size floor for striping
    parity: int = 1                # m: parity shards per stripe


def _serialize(value) -> bytes:
    """The value's compact byte serialization — what the RS codec
    actually encodes. ``op.size`` models the (much larger) simulated
    wire footprint; ``blen`` below is this real length."""
    return repr(value).encode()


class CodingManager:
    def __init__(self, rep, cfg: CodingConfig):
        self.rep = rep
        self.cfg = cfg
        # coordinator-side plans: op_id -> rec (holds assign/need + all
        # shards for retransmission); GC'd at local apply
        self.sent: Dict[int, dict] = {}
        # pre-commit shard holdings: op_id -> rec
        self.announced: Dict[int, dict] = {}
        # committed-but-unapplied: op_id -> rec
        self.pending_striped: Dict[int, dict] = {}
        # applied striped values: obj -> rec (the object's CURRENT value)
        self.stripes: Dict[int, dict] = {}
        # reads parked at their linearization point: obj -> [(op, value)]
        self.pending_reads: Dict[int, list] = {}
        # commit-gate waits: key -> {ops, acked, fin, timer}
        self.waits: Dict[int, dict] = {}
        self._wait_seq = 0
        # repair state: obj -> op_id being re-assembled
        self.repairing: Dict[int, int] = {}
        self.repair_cooldown: Dict[int, float] = {}
        self._repair_armed: set = set()
        # metrics (host-side)
        self.striped = 0
        self.reconstructs = 0
        self.repairs = 0

    # -- coordinator: planning + wire payloads -----------------------------

    def plan_batch(self, ops: List, now: float) -> bool:
        """Decide striping per op (coordinator side, at propose time).
        Returns True when any op striped — the caller then switches to
        per-destination sends so each assignee gets its distinct shard."""
        any_striped = False
        for op in ops:
            if op.op_id in self.sent:
                any_striped = True
                continue                     # re-proposed batch
            plan = choose_plan(self.rep, self.cfg, op, now)
            if plan is None:
                continue
            data = _serialize(op.value)
            shards = rs.encode(data, plan.k, plan.m)
            self.sent[op.op_id] = self.announced[op.op_id] = {
                "op_id": op.op_id, "obj": op.obj, "k": plan.k,
                "m": plan.m, "blen": len(data), "size": op.size,
                "origin": self.rep.node_id, "full": True,
                "shards": dict(enumerate(shards)),
                "assign": plan.assign, "need": plan.need,
            }
            self.striped += 1
            self.rep.sim.striped_ops += 1
            tr = self.rep.sim.tracer
            if tr is not None and tr.sampled(op.op_id):
                tr.ev("stripe", now, self.rep.node_id, op.op_id, op.obj,
                      plan.k, plan.m)
            any_striped = True
        return any_striped

    def stripe_payload_for(self, ops: List, dst: int):
        """Per-destination propose decoration: ``(stripes, size_bytes)``
        where ``stripes`` maps op index -> (k, m, idx, blen, size,
        shard) for ops whose plan assigns ``dst`` a shard, and
        ``size_bytes`` is the message's total modeled payload (shard
        wire size for striped ops, full size for unstriped ones)."""
        st = None
        nb = 0
        for i, op in enumerate(ops):
            rec = self.sent.get(op.op_id)
            if rec is None:
                nb += op.size
                continue
            idx = rec["assign"].get(dst)
            if idx is None:
                continue                     # unhealthy at plan time:
            if st is None:                   # metadata only, no bytes
                st = {}
            st[i] = (rec["k"], rec["m"], idx, rec["blen"], rec["size"],
                     rec["shards"][idx])
            nb += rs.shard_len(rec["size"], rec["k"])
        return st, nb

    def has_stripes(self, ops: List) -> bool:
        return any(op.op_id in self.sent for op in ops)

    def commit_marker(self, ops: List) -> Optional[dict]:
        """The commit message's inert-when-absent ``"striped"`` key:
        op index -> (k, m, blen, origin, size)."""
        mk = None
        for i, op in enumerate(ops):
            rec = self.sent.get(op.op_id)
            if rec is not None:
                if mk is None:
                    mk = {}
                mk[i] = (rec["k"], rec["m"], rec["blen"], rec["origin"],
                         rec["size"])
        return mk

    # -- follower: shard receipt + commit/apply transitions ----------------

    def recv_stripes(self, ops: List, stripes: dict, src: int,
                     now: float) -> None:
        """A propose (or re-propose) carried this replica's shards.
        A re-driven op can arrive re-striped under a DIFFERENT plan
        (the retry coordinator saw a different healthy set, so k/m/
        origin changed): shards of distinct geometries never mix — the
        latest propose resets the record."""
        for i, (k, m, idx, blen, size, shard) in stripes.items():
            op = ops[i]
            rec = self.announced.get(op.op_id)
            if rec is None:
                rec = self.pending_striped.get(op.op_id)
            if rec is not None and (rec["k"], rec["m"], rec["origin"]) \
                    != (k, m, src):
                # never mutate the stale record in place: at the origin
                # of the losing plan ``announced`` aliases ``sent``,
                # whose full shard set must stay intact for its own
                # (idempotent) commit attempt
                self.pending_striped.pop(op.op_id, None)
                rec = None
            if rec is None:
                rec = self.announced[op.op_id] = {
                    "op_id": op.op_id, "obj": op.obj, "k": k, "m": m,
                    "blen": blen, "size": size, "origin": src,
                    "full": False, "shards": {}}
            rec["shards"][idx] = shard

    def note_striped_commit(self, ops: List, marker: dict,
                            now: float) -> None:
        """The commit's ``"striped"`` marker arrived: stage recs for
        apply (creating empty-shard recs for replicas that missed the
        propose — they can still repair later)."""
        applied = self.rep.rsm.applied_ops
        for i, (k, m, blen, origin, size) in marker.items():
            op = ops[i]
            if op.op_id in applied or op.op_id in self.pending_striped:
                continue                     # duplicate commit delivery
            rec = self.announced.pop(op.op_id, None)
            if rec is None or (rec["k"], rec["m"], rec["origin"]) \
                    != (k, m, origin):
                # no propose seen — or only one from a losing plan of a
                # re-driven op: the committed marker's geometry is the
                # authoritative one (stale shards would be undecodable).
                # At the committing plan's origin, a LATER plan's propose
                # wave may have displaced the announced rec — the sent
                # rec still holds this plan's full shard set, and losing
                # it would commit a stripe with no shards anywhere.
                rec = self.sent.get(op.op_id)
                if rec is not None and (rec["k"], rec["m"],
                                        rec["origin"]) != (k, m, origin):
                    rec = None
            if rec is None:
                rec = {"op_id": op.op_id, "obj": op.obj, "k": k, "m": m,
                       "blen": blen, "size": size, "origin": origin,
                       "full": False, "shards": {}}
            self.pending_striped[op.op_id] = rec

    def note_write_applied(self, obj: int, op_id: int) -> None:
        """Apply-time hook for EVERY write while coding is on: a striped
        write becomes the object's current value; any write supersedes
        the previous value — reads parked on it are stamped with their
        captured (linearization-point) answers, since the repair they
        were waiting on can no longer matter to the outcome."""
        self.sent.pop(op_id, None)
        self.announced.pop(op_id, None)
        rec = self.pending_striped.pop(op_id, None)
        if rec is not None:
            self.stripes[obj] = rec
        else:
            self.stripes.pop(obj, None)
        self.repairing.pop(obj, None)
        self._stamp_pending(obj)

    # -- read resolution (RSM resolver hook) -------------------------------

    def resolve_read(self, op) -> bool:
        """Called at this replica's apply point for every non-local
        read. True = stamp ``read_result`` now; False = parked (the op
        object is shared in-process, so the origin's own apply — or a
        completed repair, or a superseding write — stamps it later)."""
        rec = self.stripes.get(op.obj)
        if rec is None or rec["full"]:
            return True
        if len(rec["shards"]) >= rec["k"]:
            self._decode_full(rec, self.rep.sim.now)
            return True
        rep = self.rep
        now = rep.sim.now
        self.pending_reads.setdefault(op.obj, []).append(
            (op, rep.rsm.store.get(op.obj)))
        tr = rep.sim.tracer
        if tr is not None and tr.sampled(op.op_id):
            tr.ev("coding_wait", now, rep.node_id, op.op_id, op.obj)
        self.maybe_repair(op.obj, now)
        return False

    def _stamp_pending(self, obj: int) -> None:
        pend = self.pending_reads.pop(obj, None)
        if pend:
            for op, val in pend:
                if op.read_result is None and op.path != "local":
                    op.read_result = val

    def _decode_full(self, rec: dict, now: float) -> None:
        """>= k shards present: reconstruct the real bytes (decode
        failure here would be a codec bug — let it raise)."""
        data = rs.decode(rec["shards"], rec["k"], rec["m"], rec["blen"])
        assert len(data) == rec["blen"]
        rec["full"] = True
        if any(i not in rec["shards"] for i in range(rec["k"])):
            # decode may have leaned on parity indices; a full holder must
            # be able to serve every data shard (on_fetch invariant)
            regen = rs.encode(data, rec["k"], rec["m"])
            for i in range(rec["k"]):
                rec["shards"].setdefault(i, regen[i])
        self.reconstructs += 1
        rep = self.rep
        rep.sim.busy(rep.node_id, rep._apply_cost)
        tr = rep.sim.tracer
        if tr is not None:
            tr.ev("reconstruct", now, rep.node_id, rec["op_id"],
                  rec["obj"])

    # -- repair (reconstruction-on-read / recovery sweep) ------------------

    def maybe_repair(self, obj: int, now: float,
                     force: bool = False) -> None:
        rec = self.stripes.get(obj)
        if rec is None or rec["full"] or len(rec["shards"]) >= rec["k"]:
            return
        rep = self.rep
        if obj in self.repairing:
            return
        if not force:
            origin = rec["origin"]
            if origin != rep.node_id \
                    and now - rep.last_hb[origin] <= rep.HB_TIMEOUT:
                # origin looks alive: it holds the full value and its
                # own apply stamps the shared op — just re-check later
                # in case it dies with the read still parked
                self._arm_repair_timer(obj)
                return
        if now < self.repair_cooldown.get(obj, 0.0):
            self._arm_repair_timer(obj)
            return
        self.repairs += 1
        self.repair_cooldown[obj] = now + rep.sim.costs.timeout
        self.repairing[obj] = rec["op_id"]
        rep.broadcast(rep._others, "stripe_fetch",
                      {"obj": obj, "op": rec["op_id"]})
        self._arm_repair_timer(obj)

    def _arm_repair_timer(self, obj: int) -> None:
        if obj not in self._repair_armed:
            self._repair_armed.add(obj)
            self.rep.set_timer(self.rep.sim.costs.timeout, "coding_t",
                               {"k": "repair", "obj": obj})

    def on_fetch(self, msg, now: float) -> None:
        obj = msg.payload["obj"]
        rec = self.stripes.get(obj)
        if rec is None or rec["op_id"] != msg.payload["op"]:
            # our current value is a different generation: if newer, the
            # fetcher is about to be superseded by a commit it has yet
            # to apply — stay quiet either way
            return
        rep = self.rep
        if rec["full"] or len(rec["shards"]) >= rec["k"]:
            # answer with the data shards (what decode needs first);
            # modeled wire cost = k shard payloads
            if not rec["full"]:
                self._decode_full(rec, now)
            sl = rs.shard_len(rec["size"], rec["k"])
            shards = {i: rec["shards"][i] for i in range(rec["k"])}
            rep.send(msg.src, "stripe_fill",
                     {"obj": obj, "op": rec["op_id"], "shards": shards},
                     size_bytes=sl * rec["k"])
        elif rec["shards"]:
            sl = rs.shard_len(rec["size"], rec["k"])
            rep.send(msg.src, "stripe_fill",
                     {"obj": obj, "op": rec["op_id"],
                      "shards": dict(rec["shards"])},
                     size_bytes=sl * len(rec["shards"]))

    def on_fill(self, msg, now: float) -> None:
        p = msg.payload
        obj = p["obj"]
        rec = self.stripes.get(obj)
        if rec is None or rec["op_id"] != p["op"] or rec["full"]:
            return
        sl = rs.shard_len(rec["blen"], rec["k"])
        rec["shards"].update(
            (i, s) for i, s in p["shards"].items()
            if len(s) == sl and 0 <= i < rec["k"] + rec["m"])
        if len(rec["shards"]) < rec["k"]:
            return
        self._decode_full(rec, now)
        self.repairing.pop(obj, None)
        self._stamp_pending(obj)

    # -- commit gate (weighted reconstructable set) ------------------------

    def _rec_satisfied(self, rec: dict, acked) -> bool:
        got = 0
        for dst, idx in rec["assign"].items():
            if dst in acked:
                got += 1                     # distinct by construction
        return got >= rec["need"]

    def gate_commit(self, ops: List, now: float, finalize,
                    acked) -> Optional[int]:
        """Decide-time hook for both commit paths: every striped op in
        ``ops`` must have ``need`` distinct assigned shards durable at
        acked replicas. None = reconstructable already; otherwise a wait
        key — the caller withholds the commit and feeds late round acks
        (and stripe_push acks) to :meth:`wait_ack`."""
        gated = None
        for op in ops:
            rec = self.sent.get(op.op_id)
            if rec is not None and not self._rec_satisfied(rec, acked):
                if gated is None:
                    gated = []
                gated.append(op)
        if gated is None:
            return None
        rep = self.rep
        tr = rep.sim.tracer
        if tr is not None:
            sampled = tr.sampled
            for op in gated:
                if sampled(op.op_id):
                    tr.ev("coding_wait", now, rep.node_id, op.op_id,
                          op.obj)
        key = self._wait_seq
        self._wait_seq += 1
        w = {"ops": gated, "acked": set(acked), "fin": finalize,
             "timer": None}
        self.waits[key] = w
        w["timer"] = rep.set_timer(rep.sim.costs.timeout, "coding_t",
                                   {"k": "wait", "key": key})
        return key

    def wait_ack(self, key: int, src: int, now: float) -> None:
        """An ack from ``src`` (round ack or stripe_push ack — either
        implies it durably holds its assigned shards for every op it
        was pushed)."""
        w = self.waits.get(key)
        if w is None:
            return
        w["acked"].add(src)
        for op in w["ops"]:
            rec = self.sent.get(op.op_id)
            if rec is not None and not self._rec_satisfied(rec,
                                                           w["acked"]):
                return
        del self.waits[key]
        if w["timer"] is not None:
            w["timer"].cancel()
        w["fin"](now)

    def _wait_retransmit(self, key: int, now: float) -> None:
        w = self.waits.get(key)
        if w is None:
            return
        rep = self.rep
        per_dst: Dict[int, list] = {}
        nb: Dict[int, int] = {}
        for op in w["ops"]:
            rec = self.sent.get(op.op_id)
            if rec is None or self._rec_satisfied(rec, w["acked"]):
                continue
            for dst, idx in rec["assign"].items():
                if dst in w["acked"]:
                    continue
                per_dst.setdefault(dst, []).append(
                    (op.op_id, rec["obj"], rec["k"], rec["m"], idx,
                     rec["blen"], rec["size"], rec["origin"],
                     rec["shards"][idx]))
                nb[dst] = nb.get(dst, 0) \
                    + rs.shard_len(rec["size"], rec["k"])
        for dst, entries in per_dst.items():
            rep.send(dst, "stripe_push",
                     {"key": key, "entries": entries},
                     size_bytes=nb[dst])
        w["timer"] = rep.set_timer(rep.sim.costs.timeout, "coding_t",
                                   {"k": "wait", "key": key})

    def on_push(self, msg, now: float) -> None:
        """Shard retransmission: store the shards, ack the whole batch
        (the ack is what lets the gate count this replica — it MUST
        cover every pushed entry)."""
        applied = self.rep.rsm.applied_ops
        for (op_id, obj, k, m, idx, blen, size, origin, shard) \
                in msg.payload["entries"]:
            rec = self.announced.get(op_id)
            if rec is None:
                rec = self.pending_striped.get(op_id)
            if rec is None:
                r2 = self.stripes.get(obj)
                if r2 is not None and r2["op_id"] == op_id:
                    rec = r2
            if rec is None:
                if op_id in applied:
                    continue                 # superseded generation
                rec = self.announced[op_id] = {
                    "op_id": op_id, "obj": obj, "k": k, "m": m,
                    "blen": blen, "size": size, "origin": origin,
                    "full": False, "shards": {}}
            if (rec["k"], rec["m"], rec["origin"]) != (k, m, origin):
                continue                     # a losing plan's retransmit:
                                             # never mix stripe geometries
            rec["shards"][idx] = shard
        self.rep.send(msg.src, "stripe_ack",
                      {"key": msg.payload["key"]})

    def on_push_ack(self, msg, now: float) -> None:
        self.wait_ack(msg.payload["key"], msg.src, now)

    # -- timers / faults / state transfer / shard fencing ------------------

    def on_timer(self, payload: dict, now: float) -> None:
        k = payload["k"]
        if k == "wait":
            self._wait_retransmit(payload["key"], now)
        elif k == "repair":
            obj = payload["obj"]
            self._repair_armed.discard(obj)
            self.repairing.pop(obj, None)
            if obj in self.pending_reads:
                self.maybe_repair(obj, now)

    def on_recover(self, now: float, lost_memory: bool = True) -> None:
        """Recovery entry. ``lost_memory=True`` (crash restart): all
        shard holdings are volatile and gone — the sync snapshot
        re-installs stripe METADATA and the post-install sweep (see
        install_state) re-fetches the shards themselves.
        ``lost_memory=False`` (isolation rejoin): the process never
        died, so committed shard holdings — durability the commit gate
        already certified — are KEPT and merged by install_state; only
        in-flight coordination state is discarded.

        Parked reads are stamped with their captured answers either
        way: capture happens at the read's linearization point, so the
        answer is already decided — recovery merely delivers it."""
        for obj in list(self.pending_reads):
            self._stamp_pending(obj)
        self.sent.clear()
        self.announced.clear()
        self.pending_striped.clear()
        if lost_memory:
            self.stripes.clear()
        for w in self.waits.values():
            if w["timer"] is not None:
                w["timer"].cancel()
        self.waits.clear()
        self.repairing.clear()
        self.repair_cooldown.clear()
        self._repair_armed.clear()

    @staticmethod
    def _meta(rec: dict) -> tuple:
        return (rec["op_id"], rec["obj"], rec["k"], rec["m"],
                rec["blen"], rec["size"], rec["origin"])

    def export_state(self) -> dict:
        """Stripe metadata for the sync snapshot. Shards are NOT
        exported: the recovering node does not physically hold them —
        it re-fetches via the recovery sweep."""
        return {
            "stripes": {obj: self._meta(rec)
                        for obj, rec in self.stripes.items()},
            "pending": {op_id: self._meta(rec)
                        for op_id, rec in self.pending_striped.items()},
        }

    def install_state(self, p: dict, now: float) -> None:
        def _rec(meta):
            op_id, obj, k, m, blen, size, origin = meta
            return {"op_id": op_id, "obj": obj, "k": k, "m": m,
                    "blen": blen, "size": size, "origin": origin,
                    "full": False, "shards": {}}
        kept = self.stripes            # non-empty only on isolation rejoin
        self.stripes = {}
        for obj, meta in p["stripes"].items():
            rec = _rec(meta)
            prev = kept.get(obj)
            if prev is not None and prev["op_id"] == rec["op_id"]:
                # same generation survived the rejoin locally: our
                # holdings are still that value's bytes — keep them
                rec["full"] = prev["full"]
                rec["shards"] = prev["shards"]
            self.stripes[obj] = rec
        self.pending_striped = {op_id: _rec(meta)
                                for op_id, meta in p["pending"].items()}
        # recovery sweep: re-fetch missing shards up front (force: the
        # origin being alive is no help — we serve reads against our
        # own holdings). maybe_repair no-ops on recs kept full.
        for obj in list(self.stripes):
            self.maybe_repair(obj, now, force=True)

    def fence_obj(self, obj: int, now: float) -> bool:
        """Shard-steal fence: stripe state is group-local (the steal
        installs the object's full value in the new group), so fencing
        is immediate — park-stamped reads keep their captured answers."""
        self.invalidate_obj(obj)
        return True

    def invalidate_obj(self, obj: int) -> None:
        self.repairing.pop(obj, None)
        self.repair_cooldown.pop(obj, None)
        self._stamp_pending(obj)
        self.stripes.pop(obj, None)


def drain_pending_reads(replicas) -> int:
    """End-of-run flush for reads still parked when the engine stops.

    A read of a striped object parks at its coordinator's apply point
    (its linearization point — the answer is captured there) and is
    stamped later by whichever arrives first: the origin applying the
    same shared op, a completed repair, or a superseding write. The
    engine, however, halts the moment every client has its acks, so a
    read committed in the final instants can lose ALL of its stamp
    sources to the shutdown — a scheduling artifact, not data loss.

    The flush distinguishes the two by asking the question a drain-time
    repair would: is the stripe still reconstructable *cluster-wide*
    (any full holder, or >= k distinct shards of the same generation)?
    If yes, the cut-off repair would have succeeded — stamp the parked
    reads with their captured answers. If no, the value is genuinely
    gone and ``read_result`` stays ``None``: that is the data-loss
    signal the linearizability checker (and the commit-gate mutation
    twin in tests/test_coding.py) must keep seeing.

    Returns the number of reads stamped.
    """
    mgrs = [rep.coding_mgr for rep in replicas
            if getattr(rep, "coding_mgr", None) is not None]
    stamped = 0
    for mgr in mgrs:
        for obj in list(mgr.pending_reads):
            rec = mgr.stripes.get(obj)
            if rec is None:
                # superseded while parked; _stamp_pending normally fired
                # at that write's apply, so this is belt-and-braces
                recoverable = True
            else:
                want = (rec["op_id"], rec["k"], rec["m"], rec["origin"])
                have: set = set()
                recoverable = False
                for other in mgrs:
                    orec = other.stripes.get(obj)
                    if orec is None or (orec["op_id"], orec["k"],
                                        orec["m"],
                                        orec["origin"]) != want:
                        continue
                    if orec["full"]:
                        recoverable = True
                        break
                    have.update(orec["shards"])
                recoverable = recoverable or len(have) >= rec["k"]
            if recoverable:
                stamped += len(mgr.pending_reads.get(obj, ()))
                mgr._stamp_pending(obj)
    return stamped
