"""Weighted object read leases: linearizable local reads.

Reads normally ride full consensus at write cost (the read-fraction
sweep in BENCH_workloads pins the flat line). This module adds a
default-off lease subsystem so replicas can serve reads for leased
objects locally, in zero network round-trips, without giving up
linearizability.

Object leases (WOC dual path)
-----------------------------
A lease on object ``o`` is granted by the *same weighted quorum rule*
that commits fast-path writes on ``o``:

  * **grant round** — a replica whose read missed broadcasts
    ``lease_req(o, epoch, expiry)``. Every replica records the proposed
    expiry pessimistically (it gates writers even before the grant
    lands — closing the partition-during-activation race) and votes
    with its weight in ``W^o`` iff it holds no live in-flight op on
    ``o``; the current slow-path leader's vote is **mandatory** (the
    same Theorem-2 lynchpin the fast path uses) and carries the
    object's last applied op id as the lease *dependency*.
  * **activation** — weighted yes-votes strictly crossing ``T^o`` plus
    the leader's co-sign let the requester broadcast ``lease_install``.
    Leases are **multi-holder**: after install, *every* replica may
    serve reads on ``o`` locally while ``now < expiry``, the dependency
    is applied, and no revocation barrier is pending. (Clients rotate
    coordinators per batch, so a single-holder lease would be hit on
    ~1/n of reads.)
  * **revocation = pause-until-applied, piggybacked on the write's own
    round** (the quorum-leases trick) — every replica records a proposed
    write in ``write_inflight`` the moment the propose/accept message
    arrives and refuses to serve local reads on that object until the
    write applies. A committer that *decides* a write on a leased object
    therefore already holds implicit revocation acks from every replica
    that answered the round; it withholds the commit stamp only until
    the *remaining* replicas answer **or** the lease expiry passes (a
    partitioned holder stops serving at expiry by its own clock;
    simulated clocks do not drift). No extra message is sent: revocation
    costs the gap between a quorum and an all-replicas round — which is
    exactly the write-hotness crossover the churn bench sweeps.

Why the leader co-sign makes revocation sound: a fast-path commit on
``o`` needs the leader's vote, and the leader refuses lease votes while
it holds any live in-flight or queued slow op on ``o`` — so either the
lease round saw the write (leader votes no, round fails) or the write's
co-sign reply carries the leader's lease table (the committer learns of
the lease before stamping). Slow-path committers *are* the leader.

Leader lease (Cabinet / MultiPaxos slow path)
---------------------------------------------
Leader-serialized protocols get a promise-based leader lease instead:
followers promise (``llease_grant``) not to accept proposals from
anyone else until ``until``; the leader serves all reads locally while
it holds fresh promises from at least ``n - 1 - k_max`` peers, where
``k_max`` is the largest k whose top-k base weights cannot strictly
cross ``T^N`` — so no usurper can form a node-weighted quorum from the
unpromised remainder. Promise expiry *is* expiry-before-takeover: a new
leader cannot commit (or serve) until outstanding promises lapse.

Fault-free inertness
--------------------
With ``Scenario.leases`` unset (the default) no ``LeaseManager`` is
constructed: no messages, timers, rng draws, or payload keys change, so
all golden traces and the fault-free timing contract stay bit-identical.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Set


@dataclasses.dataclass(frozen=True)
class LeaseConfig:
    """Lowered lease knob (see ``repro_torch.scenario.spec.Leases``)."""
    duration_s: float = 0.05
    renew_margin: float = 0.5      # renew when remaining < margin*duration
    grant_after_reads: int = 2     # read misses per replica before a round


@dataclasses.dataclass(eq=False)
class LeaseRecord:
    """Per-object lease state at one replica.

    ``active_until`` bounds local serving (installed grants only);
    ``gate_until`` bounds writers (it also covers rounds this replica
    voted on that may have activated elsewhere — pessimism that a
    failed round retracts via ``lease_abort``).
    """
    __slots__ = ("epoch", "active_until", "gate_until", "dep", "installed")

    def __init__(self, epoch=0, active_until=-1.0, gate_until=-1.0,
                 dep=None, installed=0):
        self.epoch = epoch
        self.active_until = active_until
        self.gate_until = gate_until
        self.dep = dep
        self.installed = installed


class _GrantRound:
    __slots__ = ("obj", "epoch", "expiry", "acc", "leader_voted", "dep",
                 "renewal", "timer")

    def __init__(self, obj, epoch, expiry, renewal):
        self.obj = obj
        self.epoch = epoch
        self.expiry = expiry
        self.acc = 0.0
        self.leader_voted = False
        self.dep = None
        self.renewal = renewal
        self.timer = None


MAX_ROUNDS = 64        # concurrent grant rounds per replica

# adaptive per-object lease policy (Crossword-style per-object strategy
# switching): grant/renew only while estimated total reads exceed this
# multiple of observed writes in the sliding window. A write on a leased
# object pays a full revocation round-trip while a local read saves one
# consensus round, and batch acknowledgment is gated by its slowest op —
# measured on the uniform-mix bench the win only clears the tax past
# roughly 6 reads per write, so write-hotter objects stay unleased
WRITE_PRESSURE = 2.5


class LeaseManager:
    """Per-replica lease state machine (object leases + leader lease).

    Constructed only when the Scenario enables leases; every hook in the
    protocol code is guarded by ``self.lease_mgr is not None`` so the
    disabled cost is one attribute read.
    """

    def __init__(self, rep, cfg: LeaseConfig):
        self.rep = rep
        self.cfg = cfg
        self.records: Dict[int, LeaseRecord] = {}
        self.barrier: Dict[int, Set[int]] = {}   # obj -> unapplied revoked ops
        # write-only in-flight view: the replica's in_flight map tracks
        # reads too (they vote/conflict on the fast path), but only an
        # unapplied WRITE makes a lease vote unsafe — read-heavy traffic
        # must not starve grant rounds. Maintained by the vote/ingress
        # paths only while leases are on; entries expire lazily against
        # applied_ops (no apply-path hook needed).
        self.write_inflight: Dict[int, Dict[int, float]] = {}
        self.rounds: Dict[int, _GrantRound] = {}
        self.read_seen: Dict[int, int] = {}      # obj -> local read misses
        # sliding read/write pressure window: obj -> [reads_here, writes,
        # window_start]. Reads are counted at this replica only (~1/n of
        # the object's reads under coordinator rotation); writes are
        # counted once per write (every replica votes on / enqueues every
        # write), so the grant predicate compares reads*n against
        # WRITE_PRESSURE*writes.
        self.rw: Dict[int, list] = {}
        self.cooldown: Dict[int, float] = {}     # obj -> no new round before
        # committer-side revocation waits: key -> {pending, fin, timer}
        self.waits: Dict[int, dict] = {}
        self._wait_seq = 0
        self._fences: Dict[int, dict] = {}       # shard fencing (gate.py)
        # leader lease (promise-based, leader-serialized protocols)
        self.promises: Dict[int, float] = {}     # peer -> promised until
        self._ll_last_req = -1.0
        self._ll_renew_at = -1.0
        # k_max: the largest k whose top-k base weights can NOT strictly
        # cross T^N — promises from the other n-1-k_max peers make a
        # usurper quorum impossible (the leader itself nacks usurpers)
        base = rep.obj_weights.base
        half = rep.obj_weights.half_sum
        k, s = 0, 0.0
        for w in base:                           # descending by rank
            if s + float(w) > half:
                break
            s += float(w)
            k += 1
        self._ll_need = max(0, rep.sim.n - 1 - k)
        # metrics (host-side)
        self.local_reads = 0
        self.grants = 0
        self.revokes = 0

    # -- local read serving (object leases) --------------------------------

    def serve_read(self, op, now: float) -> bool:
        """Serve a read at ingress under an installed object lease.
        Returns True when the op was stamped (or already stamped by a
        lease hit elsewhere — client retries must not re-execute it
        through consensus, which would overwrite ``read_result`` after
        the linearization point)."""
        rep = self.rep
        if op.commit_time >= 0:
            return True
        obj = op.obj
        rec = self.records.get(obj)
        if rec is None:
            self._note_miss(obj, now)
            return False
        if rep.recovering or now >= rec.active_until:
            self._note_miss(obj, now)
            return False
        applied = rep.rsm.applied_ops
        if rec.dep is not None and rec.dep not in applied:
            return False
        b = self.barrier.get(obj)
        if b:
            for i in [i for i in b if i in applied]:   # lazy barrier GC
                b.discard(i)
            if b:
                return False
            del self.barrier[obj]
        if self._scan_writes(obj) is not None:
            return False       # implicit revocation: a proposed write on
                               # this object pauses serving until it applies
        self._stamp_local(op, now)
        e = self._rw(obj, now)
        e[0] += 1.0
        if (rec.active_until - now < self.cfg.renew_margin
                * self.cfg.duration_s) \
                and self._worth_leasing(e, now, renewal=True):
            # write-hot objects are not renewed: the lease lapses and
            # writes stop paying the revocation round-trip
            self.request(obj, now, renewal=True)
        return True

    def _stamp_local(self, op, now: float) -> None:
        rep = self.rep
        op.commit_time = now
        op.path = "local"
        op.read_result = rep.rsm.store.get(op.obj)
        if op.op_id not in rep.sim.commit_log:
            rep.sim.commit_log[op.op_id] = (now, "local")
            tr = rep.sim.tracer
            if tr is not None:
                tr.ev("commit", now, rep.node_id, op.op_id, "local")
                if tr.sampled(op.op_id):
                    tr.ev("lease_local", now, rep.node_id, op.op_id, op.obj)
        rep.sim.busy(rep.node_id, rep._apply_cost)
        self.local_reads += 1

    def _note_miss(self, obj: int, now: float) -> None:
        c = self.read_seen.get(obj, 0) + 1
        self.read_seen[obj] = c
        e = self._rw(obj, now)
        e[0] += 1.0
        if c >= self.cfg.grant_after_reads and self._worth_leasing(e, now):
            self.request(obj, now)

    # -- grant rounds ------------------------------------------------------

    def request(self, obj: int, now: float, renewal: bool = False) -> None:
        rep = self.rep
        if (obj in self.rounds or len(self.rounds) >= MAX_ROUNDS
                or now < self.cooldown.get(obj, 0.0) or rep.recovering
                or rep._isolated):
            return
        rec = self.records.get(obj)
        if rec is not None and not renewal and now < rec.active_until:
            return                               # already serving
        epoch = (rec.epoch if rec is not None else 0) + 1
        rnd = _GrantRound(obj, epoch, now + self.cfg.duration_s, renewal)
        self.rounds[obj] = rnd
        self._note_epoch(obj, epoch, rnd.expiry)
        # self-vote under the same rule any voter applies
        if self._vote_ok(obj, now):
            rnd.acc = float(rep.obj_weights.weights_for(obj)[rep.node_id])
            if rep.is_leader(now):
                rnd.leader_voted = True
                rnd.dep = rep.last_applied.get(obj)
        tr = rep.sim.tracer
        if tr is not None:
            tr.ev("lease_renew" if renewal else "lease_req", now,
                  rep.node_id, obj, epoch)
        rep.broadcast(rep._others, "lease_req",
                      {"obj": obj, "epoch": epoch, "expiry": rnd.expiry})
        rnd.timer = rep.set_timer(rep.sim.costs.timeout, "lease_t",
                                  {"k": "round", "obj": obj, "epoch": epoch})
        self._round_check(rnd, now)

    def note_write(self, obj: int, op_id: int, now: float) -> None:
        """Record an in-progress write (called from the fast-path vote /
        ingress / slow-accept paths while leases are on)."""
        d = self.write_inflight.get(obj)
        if d is None:
            self.write_inflight[obj] = {op_id: now}
        else:
            if op_id in d:
                d[op_id] = now               # retransmit: refresh, count once
                return
            d[op_id] = now
        self._rw(obj, now)[1] += 1.0

    def _rw(self, obj: int, now: float) -> list:
        e = self.rw.get(obj)
        if e is None:
            e = self.rw[obj] = [0.0, 0.0, now, now]   # [..., birth]
        elif now - e[2] > 2.0 * self.cfg.duration_s:
            e[0] *= 0.95                     # gentle exponential decay
            e[1] *= 0.95                     # (~40 durations of memory):
            e[2] = now                       # reads are a 1/n coordinator
        return e                             # sample, so short windows are
                                             # too noisy to compare against
                                             # the write count

    def _worth_leasing(self, e: list, now: float, renewal: bool = False) \
            -> bool:
        # cold window: no grant until the object has been observed for a
        # full lease duration — reads are counted at ingress but a write
        # is only visible one forward hop later, so a younger window
        # systematically looks read-only (and startup grants on objects
        # that turn out write-hot cost a revocation round-trip per write)
        if not renewal and now - e[3] < 4.0 * self.cfg.duration_s:
            return False
        if not renewal and e[0] < 3.0:
            return False                     # too few reads to trust the
                                             # sampled ratio for a grant
        return e[0] * self.rep.sim.n > WRITE_PRESSURE * e[1]

    def _scan_writes(self, obj: int) -> Optional[dict]:
        """Prune applied entries; return the remaining unapplied writes
        (or None). Serving blocks while this is non-empty — that IS the
        revocation pause, held from propose receipt to local apply. Only
        application clears an entry here: an aged-out entry must not
        unblock serving, because its write may still stamp elsewhere."""
        d = self.write_inflight.get(obj)
        if not d:
            return None
        applied = self.rep.rsm.applied_ops
        dead = [k for k in d if k in applied]
        for k in dead:
            del d[k]
        if not d:
            del self.write_inflight[obj]
            return None
        return d

    def _write_live(self, obj: int, now: float) -> bool:
        """Grant-vote view: like :meth:`_scan_writes` but entries older
        than ``gc_timeout`` do not count (an op abandoned by its
        coordinator must not wedge grants forever — it still blocks
        *serving* above, which is the conservative side)."""
        d = self._scan_writes(obj)
        if d is None:
            return False
        cutoff = now - self.rep.gc_timeout
        return any(t0 >= cutoff for t0 in d.values())

    def _vote_ok(self, obj: int, now: float) -> bool:
        """A yes-vote promises the object has no in-progress WRITE this
        replica knows of — at the leader this covers every co-signed
        fast write (propose until local apply) and every queued or
        deciding slow write (note_write at enqueue/accept). In-flight
        reads and queued slow reads do not block a grant."""
        rep = self.rep
        if rep.recovering or rep._isolated:
            return False
        return not self._write_live(obj, now)

    def _note_epoch(self, obj: int, epoch: int, expiry: float) -> LeaseRecord:
        rec = self.records.get(obj)
        if rec is None:
            rec = self.records[obj] = LeaseRecord()
        if epoch > rec.epoch:
            rec.epoch = epoch
        if expiry > rec.gate_until:
            rec.gate_until = expiry
        return rec

    def on_req(self, msg, now: float) -> None:
        p = msg.payload
        obj, epoch = p["obj"], p["epoch"]
        rep = self.rep
        rec = self.records.get(obj)
        if rec is not None and epoch <= rec.epoch:
            rep.send(msg.src, "lease_vote",
                     {"obj": obj, "epoch": epoch, "ok": False})
            return
        self._note_epoch(obj, epoch, p["expiry"])
        ok = self._vote_ok(obj, now)
        reply = {"obj": obj, "epoch": epoch, "ok": ok}
        if rep.is_leader(now):
            reply["lead"] = True                 # a leader no kills the round
            if ok:
                dep = rep.last_applied.get(obj)
                if dep is not None:
                    reply["dep"] = dep
        rep.send(msg.src, "lease_vote", reply)

    def on_vote(self, msg, now: float) -> None:
        p = msg.payload
        rnd = self.rounds.get(p["obj"])
        if rnd is None or rnd.epoch != p["epoch"]:
            return
        if not p["ok"]:
            if p.get("lead"):
                self._fail_round(rnd, now)       # mandatory co-sign refused
            return
        rnd.acc += float(self.rep.obj_weights.weights_for(p["obj"])[msg.src])
        if p.get("lead"):
            rnd.leader_voted = True
            rnd.dep = p.get("dep")
        self._round_check(rnd, now)

    def _round_check(self, rnd: _GrantRound, now: float) -> None:
        rep = self.rep
        if not rnd.leader_voted or rnd.acc <= rep.obj_weights.half_sum:
            return
        obj = rnd.obj
        self._finish_round(rnd)
        rec = self._note_epoch(obj, rnd.epoch, rnd.expiry)
        rec.installed = rnd.epoch
        rec.active_until = max(rec.active_until, rnd.expiry)
        rec.dep = rnd.dep
        # NOTE: the barrier is NOT cleared — the grant dep only subsumes
        # writes the leader applied before voting; a write that committed
        # during the round is barriered here and must stay until applied
        self.read_seen.pop(obj, None)
        self.grants += 1
        tr = rep.sim.tracer
        if tr is not None:
            tr.ev("lease_grant", now, rep.node_id, obj, rnd.epoch,
                  1 if rnd.renewal else 0)
        rep.broadcast(rep._others, "lease_install",
                      {"obj": obj, "epoch": rnd.epoch, "expiry": rnd.expiry,
                       "dep": rnd.dep})

    def _finish_round(self, rnd: _GrantRound) -> None:
        self.rounds.pop(rnd.obj, None)
        if rnd.timer is not None:
            rnd.timer.cancel()
            rnd.timer = None

    def _fail_round(self, rnd: _GrantRound, now: float) -> None:
        self._finish_round(rnd)
        obj = rnd.obj
        self.cooldown[obj] = now + self.rep.sim.costs.timeout * 2
        rec = self.records.get(obj)
        if (rec is not None and rec.epoch == rnd.epoch
                and rec.installed < rnd.epoch):
            rec.gate_until = rec.active_until    # retract own pessimism
        self.rep.broadcast(self.rep._others, "lease_abort",
                           {"obj": obj, "epoch": rnd.epoch})

    def on_install(self, msg, now: float) -> None:
        if self.rep.recovering:
            return                               # sync snapshot supersedes
        p = msg.payload
        rec = self._note_epoch(p["obj"], p["epoch"], p["expiry"])
        if p["epoch"] > rec.installed:
            rec.installed = p["epoch"]
            rec.active_until = max(rec.active_until, p["expiry"])
            rec.dep = p["dep"]
            self.read_seen.pop(p["obj"], None)

    def on_abort(self, msg, now: float) -> None:
        p = msg.payload
        rec = self.records.get(p["obj"])
        if (rec is not None and rec.epoch == p["epoch"]
                and rec.installed < p["epoch"]):
            # nobody can activate this epoch (the leader refused or the
            # requester timed out before installing): writers need not
            # wait it out
            rec.gate_until = rec.active_until

    # -- committer-side write gating (revocation) --------------------------

    def lease_info(self, ops, now: float) -> Optional[dict]:
        """Leader-side lease table excerpt for a fast-path co-sign reply:
        op index -> (epoch, until) for proposed writes on leased objects.
        The coordinator merges it so its commit gate sees every lease the
        leader saw at co-sign time."""
        info = None
        for i, op in enumerate(ops):
            if op.kind != "w":
                continue
            rec = self.records.get(op.obj)
            if rec is None:
                continue
            until = max(rec.active_until, rec.gate_until)
            if until > now:
                if info is None:
                    info = {}
                info[i] = (rec.epoch, until)
        return info

    def merge_info(self, ops, info: dict) -> None:
        """Merge a leader co-sign's lease excerpt (gate pessimism only —
        serving rights always come via ``lease_install``)."""
        for i, (epoch, until) in info.items():
            self._note_epoch(ops[i].obj, epoch, until)

    def gate_commit(self, ops, now: float,
                    finalize: Callable[[float], None],
                    pending) -> Optional[int]:
        """Decide-time hook for both commit paths. ``pending`` is the
        set of replicas whose ack for the committing round has not yet
        arrived: every replica that DID answer registered each proposed
        write (``note_write``) and refuses to serve local reads on it
        until it applies, so its round ack doubles as a revocation ack.
        If a write in ``ops`` hits a live lease and ``pending`` is
        non-empty, schedule ``finalize`` for remaining-acks-or-expiry
        and return a wait key (the caller must withhold the commit stamp
        and feed late round acks to :meth:`wait_vote`). None = stamp
        immediately — either no lease, or every holder already paused."""
        rep = self.rep
        gated: Optional[Dict[int, list]] = None
        until = now
        for op in ops:
            if op.kind != "w":
                continue
            rec = self.records.get(op.obj)
            if rec is None:
                continue
            u = max(rec.active_until, rec.gate_until)
            if u > now:
                if gated is None:
                    gated = {}
                gated.setdefault(op.obj, []).append(op.op_id)
                if u > until:
                    until = u
        if gated is None:
            return None
        tr = rep.sim.tracer
        if tr is not None:
            for obj, ids in gated.items():
                tr.ev("lease_revoke", now, rep.node_id, obj,
                      self.records[obj].epoch, len(ids))
            for op in ops:
                if op.obj in gated and tr.sampled(op.op_id):
                    tr.ev("lease_wait", now, rep.node_id, op.op_id, op.obj)
        self.revokes += 1
        if not pending:
            return None        # all holders answered the round already
        key = self._wait_seq
        self._wait_seq += 1
        w = {"pending": set(pending), "fin": finalize, "timer": None}
        self.waits[key] = w
        w["timer"] = rep.set_timer(max(until - now, 0.0), "lease_t",
                                   {"k": "wait", "key": key})
        return key

    def wait_vote(self, key: int, src: int, now: float) -> None:
        """A late round ack arrived at the committer: count it against
        the revocation wait (no-op for completed waits)."""
        w = self.waits.get(key)
        if w is None:
            return
        w["pending"].discard(src)
        if not w["pending"]:
            del self.waits[key]
            if w["timer"] is not None:
                w["timer"].cancel()
            fin = w["fin"]
            if fin is not None:
                fin(now)

    def on_revoke(self, msg, now: float) -> None:
        p = msg.payload
        applied = self.rep.rsm.applied_ops
        kill = p.get("kill")
        for obj, op_ids in p["objs"].items():
            pend = [i for i in op_ids if i not in applied]
            if pend:
                b = self.barrier.get(obj)
                if b is None:
                    self.barrier[obj] = set(pend)
                else:
                    b.update(pend)
            if kill:
                self.records.pop(obj, None)
                self.barrier.pop(obj, None)
        self.rep.send(msg.src, "lease_revoke_ack", {"key": p["key"]})

    def on_revoke_ack(self, msg, now: float) -> None:
        self.wait_vote(msg.payload["key"], msg.src, now)

    # -- shard fencing / ownership invalidation ----------------------------

    def fence_obj(self, obj: int, now: float) -> bool:
        """Shard-steal fence: stop this group serving ``obj``. Serving
        stops locally at once; returns True when every peer dropped its
        record (kill-revoke acked) or the lease window lapsed — polled
        by the gate's drain loop."""
        rec = self.records.get(obj)
        if rec is None and obj not in self._fences:
            return True
        if rec is not None:
            rec.active_until = -1.0
            if now >= rec.gate_until:
                self.records.pop(obj, None)
                self._fences.pop(obj, None)
                return True
        f = self._fences.get(obj)
        if f is None:
            key = self._wait_seq
            self._wait_seq += 1
            pending = set(self.rep._others)
            f = self._fences[obj] = {"key": key, "pending": pending,
                                     "until": rec.gate_until}
            self.waits[key] = {"pending": pending, "fin": None,
                               "timer": None}
            self.rep.broadcast(self.rep._others, "lease_revoke",
                               {"key": key, "objs": {obj: []},
                                "kill": True})
        if not f["pending"] or now >= f["until"]:
            self._fences.pop(obj, None)
            self.waits.pop(f["key"], None)
            self.records.pop(obj, None)
            return True
        return False

    def invalidate_obj(self, obj: int) -> None:
        """Ownership epoch bump (ObjectManager / shard install): any
        local lease on the object is void."""
        self.records.pop(obj, None)
        self.barrier.pop(obj, None)
        self.write_inflight.pop(obj, None)
        self.read_seen.pop(obj, None)
        self.rw.pop(obj, None)
        self.cooldown.pop(obj, None)
        rnd = self.rounds.pop(obj, None)
        if rnd is not None and rnd.timer is not None:
            rnd.timer.cancel()

    # -- leader lease (promise-based, leader-serialized protocols) ---------

    def leader_lease_active(self, now: float) -> bool:
        if self._ll_need == 0:
            return True            # n=1: no usurper quorum exists
        cnt = 0
        for u in self.promises.values():
            if u > now:
                cnt += 1
        return cnt >= self._ll_need

    def leader_serve(self, op, now: float) -> bool:
        """Serve a read locally at the leader under a fresh leader lease
        (Cabinet-style leader reads without a consensus round)."""
        rep = self.rep
        if op.commit_time >= 0:
            return True
        if rep.recovering or not rep.is_leader(now):
            return False
        if not self.leader_lease_active(now):
            self._ll_request(now)
            return False
        self._stamp_local(op, now)
        if now >= self._ll_renew_at:
            self._ll_request(now)
        return True

    def _ll_request(self, now: float) -> None:
        rep = self.rep
        if now < self._ll_last_req + 0.25 * self.cfg.duration_s:
            return
        self._ll_last_req = now
        self._ll_renew_at = now + (1.0 - self.cfg.renew_margin) \
            * self.cfg.duration_s
        until = now + self.cfg.duration_s
        tr = rep.sim.tracer
        if tr is not None:
            tr.ev("lease_leader", now, rep.node_id, until)
        rep.broadcast(rep._others, "llease_req", {"until": until})

    def on_ll_req(self, msg, now: float) -> None:
        """Follower side: promise not to accept proposals from anyone
        else until ``until``. Never granted against a fresh foreign
        promise — promise expiry is expiry-before-takeover."""
        rep = self.rep
        if rep.recovering or rep._isolated:
            return
        if msg.src != rep.current_leader(now):
            return
        if now < rep._promise_until and rep._promise_to != msg.src:
            return
        rep._promise_to = msg.src
        if msg.payload["until"] > rep._promise_until:
            rep._promise_until = msg.payload["until"]
        rep.send(msg.src, "llease_grant", {"until": rep._promise_until})

    def on_ll_grant(self, msg, now: float) -> None:
        u = msg.payload["until"]
        if u > self.promises.get(msg.src, -1.0):
            self.promises[msg.src] = u

    # -- timers / faults / state transfer ----------------------------------

    def on_timer(self, payload: dict, now: float) -> None:
        k = payload["k"]
        if k == "round":
            rnd = self.rounds.get(payload["obj"])
            if rnd is not None and rnd.epoch == payload["epoch"]:
                self._fail_round(rnd, now)
        elif k == "wait":
            w = self.waits.pop(payload["key"], None)
            if w is not None and w["fin"] is not None:
                w["fin"](now)    # lease window lapsed: holders stopped

    def on_recover(self, now: float) -> None:
        """Crash recovery wipes all lease state (a rebooted node never
        resumes serving on pre-crash grants) and conservatively
        re-promises to nobody for one full lease duration: any promise
        or vote this node gave before crashing has surely expired by
        then, so it cannot help a usurper break a live lease."""
        self.records.clear()
        self.barrier.clear()
        self.write_inflight.clear()
        for rnd in self.rounds.values():
            if rnd.timer is not None:
                rnd.timer.cancel()
        self.rounds.clear()
        self.read_seen.clear()
        self.rw.clear()
        self.cooldown.clear()
        for w in self.waits.values():
            if w["timer"] is not None:
                w["timer"].cancel()
        self.waits.clear()
        self._fences.clear()
        self.promises.clear()
        self.rep._promise_to = -1
        self.rep._promise_until = now + self.cfg.duration_s
        self._ll_last_req = now
        self._ll_renew_at = -1.0

    def on_weight_epoch(self, now: float) -> None:
        """Weight-view install (repro_torch.core.reassign): every lease is a
        quorum promise made under the *old* weights, so local serving
        stops here and now. Writer-side gates (``gate_until``, barriers,
        revocation waits) stay intact — they are the conservative side,
        and must keep covering holders that have not adopted the new
        epoch yet (or never will, behind a partition). Grant rounds in
        flight accumulated old-view weight and are aborted; the leader
        lease drops its promise set and re-establishes under the new
        ranking."""
        for rec in self.records.values():
            rec.active_until = -1.0
        for rnd in self.rounds.values():
            if rnd.timer is not None:
                rnd.timer.cancel()
        self.rounds.clear()
        self.read_seen.clear()
        self.promises.clear()
        self._ll_renew_at = -1.0

    def export_state(self) -> dict:
        """Lease table for the sync snapshot (state transfer)."""
        return {
            "records": {o: (r.epoch, r.active_until, r.gate_until, r.dep,
                            r.installed)
                        for o, r in self.records.items()},
            "barrier": {o: sorted(b) for o, b in self.barrier.items()},
        }

    def install_state(self, p: dict, now: float) -> None:
        """Restore the lease table from a peer snapshot — *gating only*.
        ``active_until`` is dropped: the snapshot may predate a
        revocation whose barrier this node then never sees, so a healed
        replica regains serving rights only from a fresh
        ``lease_install`` (whose grant dependency provably covers every
        write the leader applied, including any it missed while down).
        Writer-side pessimism (epochs, ``gate_until``, barriers) is kept
        so a healed replica that commits writes still waits leases out."""
        self.records = {
            o: LeaseRecord(epoch=e, active_until=-1.0,
                           gate_until=max(a, g), dep=d, installed=i)
            for o, (e, a, g, d, i) in p["records"].items()}
        applied = self.rep.rsm.applied_ops
        self.barrier = {}
        for o, ids in p["barrier"].items():
            pend = set(ids) - applied
            if pend:
                self.barrier[o] = pend
