"""Online weight reassignment: self-healing weighted quorums under churn.

Static-plus-EMA weights have a failure mode the fault bench measures
directly: when the top-weight node degrades, every quorum keeps waiting
on the one replica the protocol can *observe* is slow, and throughput
sags for as long as the fault lasts. This module closes the loop. Each
replica folds the telemetry it already collects — heartbeat staleness
and the per-node latency EMA — into a per-peer suspicion score; when
confirmed evidence reaches the leader from a count-majority of the
deployment, the leader installs an **epoch-stamped weight view** that
re-ranks the geometric weights so suspected nodes drop to the tail
instead of anchoring every quorum.

Safety model (why a consensus-free install is enough here):

  * Weighted quorums from different views need not intersect, so view
    agreement cannot come from quorum intersection — the blueprint
    papers (consensus-free weight reassignment; asynchronous weight
    reassignment hardness) both reach the same conclusion. In this
    codebase cross-quorum safety is anchored elsewhere: every fast
    quorum carries a mandatory leader co-sign and every slow instance
    is leader-serialized, while *leadership itself* is guarded by the
    count-majority heartbeat lease (``current_leader``), which no
    weight view can forge. A weight view therefore only needs to move
    *performance* (who anchors quorums), never *safety*.
  * The installer is the slow-path leader, and the install is fenced on
    that anchor: installing a view that demotes the installer makes it
    abandon its uncommitted slow instance and hand the ops to the new
    leader **before** any node acts on the new ranking (in-flight fast
    batches drain under their propose-time weight snapshot; new
    instances bind to the new epoch). ``epoch_fence=False`` disables
    exactly this hand-off — the mutation twin in the test suite shows
    the resulting dual-leader window is a real linearizability hole.
  * Leases are quorum promises made under the old view, so lease state
    is invalidated on every weight-epoch bump
    (:meth:`repro_torch.core.leases.LeaseManager.on_weight_epoch`).

Liveness under partitioned evidence: a replica whose *view-weighted*
heartbeat-fresh set cannot strictly cross ``half_sum`` falls back to
flat weights locally (``ObjectWeightTable.flat``) — a count-majority
island keeps committing even when the geometric mass is stranded on
the far side and no installer is reachable to re-rank it. Flat quorums
are count-majorities and leadership still requires the heartbeat
lease, so the fallback cannot enable a minority side.

Inertness (ROADMAP standing constraint): with the knob on but no fault
evidence, this subsystem sends **no messages and arms no timers** —
the monitor piggybacks on the existing heartbeat timer, heartbeat
payloads gain an epoch key only once an epoch exists, and suspicion
needs multi-tick confirmed evidence. Fault-free runs with the knob on
are bit-identical to knob-off runs (pinned in tests/test_reassign.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ReassignConfig:
    """Picklable knob carrier (lowered from ``scenario.spec.Reassign``).

    ``ema_ratio``/``stale_after_s`` set the evidence thresholds,
    ``confirm_ticks`` the hysteresis depth (heartbeat ticks of
    consecutive evidence before a peer is confirmed suspect; twice that
    many clean ticks to un-confirm), ``min_reports`` the reporter count
    the leader needs before installing (0 = count-majority of the
    deployment, leader included). ``backoff_s`` is the install-churn
    floor: demote installs are gated by it flat, restore installs (the
    speculative re-probes of a demoted node) by an exponential backoff
    starting there and capped at ``backoff_max_s`` — that asymmetry is
    what bounds view churn under flapping without delaying confirmed
    demotions.
    ``epoch_fence=False`` is the mutation-twin switch: installs still
    happen but the slow-path anchor is not fenced.
    """
    ema_ratio: float = 2.5
    stale_after_s: float = 0.045
    confirm_ticks: int = 3
    min_reports: int = 0
    report_interval_s: float = 0.02
    report_ttl_s: float = 0.12
    backoff_s: float = 0.05
    backoff_max_s: float = 0.4
    epoch_fence: bool = True


class ReassignManager:
    """Per-replica monitor + view state. Constructed only when the
    Scenario knob is on; every hook in the protocol stack is guarded by
    an ``is not None`` test, mirroring the lease subsystem."""

    # measured-EMA evidence needs this many real samples of a peer before
    # the ratio test applies to it: ``BaseReplica.node_ema`` starts from a
    # bootstrap prior that never converges for peers outside the quorum
    # hot set (their late replies find the batch GC'd), so the manager
    # keeps its own prior-free EMA and trusts it only once seeded
    MIN_SAMPLES = 5

    def __init__(self, rep, cfg: ReassignConfig):
        self.rep = rep
        self.cfg = cfg
        n = rep.sim.n
        self._identity = list(range(n))
        # prior-free measured latency per peer (fed by observe_node): the
        # protocol's node_ema blends in its bootstrap prior, which reads
        # as "slow" for rarely-sampled low-weight peers — suspicion must
        # come from actual measurements only
        self._ema = [0.0] * n
        self._cnt = [0] * n
        self._last_sample = [-1.0] * n
        # installed view: epoch 0 = seed view (identity ranking). ranking
        # is None while identity so the election hot path stays on the
        # pre-reassignment code.
        self.epoch = 0
        self.ranking: Optional[List[int]] = None
        self._rank_of: Optional[List[int]] = None
        # local evidence: per-peer streak counter with hysteresis band
        self._streak: Dict[int, int] = {}
        self.confirmed: set = set()
        # follower-side report rate limiting
        self._sent_set: Tuple[int, ...] = ()
        self._sent_t = -1.0
        # leader-side aggregation: reporter -> (suspect set, seen time)
        self.reports: Dict[int, Tuple[Tuple[int, ...], float]] = {}
        # install backoff
        self._backoff = cfg.backoff_s
        self._last_install_t = -1.0
        # epoch catch-up: highest epoch we have asked a peer for
        self._pulled_epoch = 0
        # mutation twin: while now < _pin_until the (unfenced) installer
        # keeps its stale leader belief — see adopt()
        self._pin_until = -1.0
        self.installs = 0
        self.suspect_reports = 0

    # -- view accessors ------------------------------------------------------

    def rank_of(self, node: int) -> int:
        ro = self._rank_of
        return node if ro is None else ro[node]

    def note_sample(self, replica: int, latency: float) -> None:
        """One real latency observation (hooked from ``observe_node``).
        Host-side state only — never a message or timer."""
        c = self._cnt[replica]
        self._ema[replica] = latency if c == 0 \
            else 0.85 * self._ema[replica] + 0.15 * latency
        self._cnt[replica] = c + 1
        self._last_sample[replica] = self.rep.sim.now

    def hb_payload(self) -> dict:
        """Heartbeat piggyback: epoch gossip only once an epoch exists,
        so fault-free heartbeats stay byte-identical to knob-off runs."""
        if self.epoch == 0:
            return {}
        return {"we": self.epoch}

    # -- heartbeat-path hooks ------------------------------------------------

    def on_heartbeat(self, msg, now: float) -> bool:
        """Epoch gossip + view-ranked leader-memo invalidation. Returns
        True when the memo check was handled here (an installed view is
        active), False to fall through to the id-order check."""
        we = msg.payload.get("we", 0)
        if we > self.epoch and we > self._pulled_epoch:
            # a peer runs a newer view: pull it (once per epoch)
            self._pulled_epoch = we
            self.rep.send(msg.src, "weight_pull", {"e": self.epoch})
        if self.ranking is None:
            return False
        rep = self.rep
        memo = rep._leader_memo
        if memo >= 0 and now >= self._pin_until:
            ro = self._rank_of
            if ro[msg.src] < ro[memo]:
                rep._leader_until = -1.0   # a better-ranked leader is back
        return True

    def tick(self, now: float) -> None:
        """Health monitor, run on the existing heartbeat cadence. Pure
        host-side computation unless confirmed fault evidence exists —
        the inertness contract hangs on that property."""
        rep = self.rep
        cfg = self.cfg
        n = rep.sim.n
        me = rep.node_id
        last_hb = rep.last_hb
        ema = self._ema
        cnt = self._cnt
        last_s = self._last_sample
        stale_after = cfg.stale_after_s
        peers = [r for r in range(n) if r != me]
        # reference latency: median of the *seeded* peer EMAs — a single
        # degraded peer cannot drag it up, and a peer the quorum hot set
        # never samples cannot poison it. With fewer than two seeded
        # peers there is no reference and the latency term stays off.
        meas = sorted(ema[r] for r in peers if cnt[r] >= self.MIN_SAMPLES)
        lat_cut = cfg.ema_ratio * meas[len(meas) // 2] \
            if len(meas) >= 2 else None
        # latency evidence also needs a *recent* sample: a demoted (or
        # merely unweighted) peer stops being sampled, so its frozen EMA
        # is not ongoing evidence — the streak decays, the restore
        # install re-probes it, and install backoff bounds the churn.
        # Crashed/partitioned peers stay demoted via heartbeat staleness.
        fresh_cut = now - 2.0 * stale_after
        band = cfg.confirm_ticks * 3
        confirmed = self.confirmed
        streak = self._streak
        for r in peers:
            hb_r = last_hb[r]
            evid = (((hb_r > 0.0 or now > 2.0 * stale_after)
                     and now - hb_r > stale_after)
                    or (lat_cut is not None
                        and cnt[r] >= self.MIN_SAMPLES
                        and last_s[r] >= fresh_cut
                        and ema[r] > lat_cut))
            if evid:
                c = streak.get(r, 0) + 1
                if c > band:
                    c = band
                streak[r] = c
                if c >= cfg.confirm_ticks:
                    confirmed.add(r)
            else:
                c = streak.get(r, 0) - 1
                if c <= 0:
                    streak.pop(r, None)
                    confirmed.discard(r)
                else:
                    streak[r] = c
        # flat fallback: can the view-weighted hb-fresh set still cross
        # the threshold strictly? If not, health evidence itself is
        # partitioned away from us — degrade to count-majority quorums.
        table = rep.obj_weights
        if now > 2.0 * stale_after:
            vw = table.view_weights()
            hb_to = rep.HB_TIMEOUT
            fresh_w = float(vw[me])
            for r in peers:
                if now - last_hb[r] <= hb_to:
                    fresh_w += float(vw[r])
            table.flat = fresh_w <= table.half_sum
        if rep.recovering or rep._isolated:
            return
        leader = rep.current_leader(now)
        if leader != me:
            self._report(leader, now)
        else:
            self._evaluate_install(now)

    # -- follower: suspicion reports ----------------------------------------

    def _report(self, leader: int, now: float) -> None:
        cur = tuple(sorted(self.confirmed))
        # repeat while anything is suspected OR a demoted view is
        # installed: restores need standing all-clear reports at whoever
        # currently leads (leadership may have moved since the install).
        # Identity view + empty set -> never send: the inert state.
        repeat = bool(cur) or self.ranking is not None
        if cur == self._sent_set and (
                not repeat or now - self._sent_t < self.cfg.report_interval_s):
            return
        if not cur and not self._sent_set and self.ranking is None:
            return
        self._sent_set = cur
        self._sent_t = now
        self.suspect_reports += 1
        self.rep.send(leader, "weight_suspect", {"s": list(cur),
                                                 "e": self.epoch})
        tr = self.rep.sim.tracer
        if tr is not None:
            tr.ev("weight_suspect", now, self.rep.node_id,
                  ",".join(map(str, cur)), leader)

    def on_suspect(self, msg, now: float) -> None:
        self.reports[msg.src] = (tuple(msg.payload["s"]), now)

    # -- leader: aggregate evidence, install views ---------------------------

    def _evaluate_install(self, now: float) -> None:
        rep = self.rep
        cfg = self.cfg
        n = rep.sim.n
        me = rep.node_id
        self.reports[me] = (tuple(sorted(self.confirmed)), now)
        cutoff = now - cfg.report_ttl_s
        votes: Dict[int, int] = {}
        for reporter, (sus, t) in list(self.reports.items()):
            if t < cutoff:
                del self.reports[reporter]
                continue
            for r in sus:
                votes[r] = votes.get(r, 0) + 1
        need = cfg.min_reports or (n // 2 + 1)
        sus = sorted(r for r, v in votes.items() if v >= need and r < n)
        target = ([r for r in range(n) if r not in sus] + sus) if sus \
            else self._identity
        current = self.ranking if self.ranking is not None \
            else self._identity
        if target == current:
            return
        if len(self.reports) < need:
            # not enough live reporters to conclude anything — in
            # particular a freshly-elected leader with an empty ledger
            # must not read "no data yet" as "no suspects" and flap the
            # view back to identity (demotes are unaffected: votes >=
            # need already implies need distinct live reporters)
            return
        if self._last_install_t >= 0.0:
            since = now - self._last_install_t
            if since > 8.0 * cfg.backoff_max_s:
                self._backoff = cfg.backoff_s   # long quiet spell: reset
            # Asymmetric churn gate. A restore is a speculative re-probe
            # (a demoted node is never quorum-sampled, so "all clear" is
            # absence of evidence, not evidence of health) — restores pay
            # the doubling backoff so a flapping node cannot thrash the
            # view. A demote after a failed probe is confirmed evidence
            # and should land fast — every gated tick is a tick spent
            # anchoring quorums on a known-slow node — so demotes pay
            # only the fixed floor.
            if since < (self._backoff if not sus else cfg.backoff_s):
                return
        self._install(target, now)

    def _install(self, ranking: List[int], now: float) -> None:
        rep = self.rep
        epoch = self.epoch + 1
        self.installs += 1
        rep.sim.note_weight_install(now, epoch, list(ranking), rep.node_id)
        rep.broadcast(rep._others, "weight_install",
                      {"e": epoch, "rk": list(ranking)})
        self.adopt(epoch, ranking, now)

    # -- view adoption (every replica) ---------------------------------------

    def adopt(self, epoch: int, ranking: List[int], now: float) -> None:
        if epoch <= self.epoch:
            return
        rep = self.rep
        self.epoch = epoch
        if self._pulled_epoch < epoch:
            self._pulled_epoch = epoch
        ident = list(ranking) == self._identity
        # churn bookkeeping is view-global, kept on EVERY replica at
        # adopt time: a leader elected right after an install inherits
        # the install clock and backoff instead of restarting them (the
        # fresh-leader flap: a demote moves leadership to a node that
        # never installed anything, which would otherwise restore the
        # view one tick later, unthrottled). Restores double the
        # backoff; demotes only stamp the clock.
        self._last_install_t = now
        if ident:
            self._backoff = min(self._backoff * 2.0, self.cfg.backoff_max_s)
        self.ranking = None if ident else list(ranking)
        if ident:
            self._rank_of = None
        else:
            ro = [0] * len(ranking)
            for pos, r in enumerate(ranking):
                ro[r] = pos
            self._rank_of = ro
        rep.obj_weights.set_rank_override(self.ranking)
        tr = rep.sim.tracer
        if tr is not None:
            tr.ev("weight_adopt", now, rep.node_id, epoch,
                  ",".join(map(str, ranking)))
        if not self.cfg.epoch_fence:
            # mutation twin: no fence. The installer keeps believing it
            # leads until its failure detector would have told it
            # otherwise — the dual-leader window the fenced path closes.
            if rep._leader_memo == rep.node_id \
                    and now <= rep._leader_until:
                rep._leader_until = now + rep.HB_TIMEOUT
                self._pin_until = now + rep.HB_TIMEOUT
            return
        # epoch fence: leadership re-derives under the new ranking NOW,
        # promises/leases made under the old view die with it, and an
        # uncommitted slow instance held by a demoted installer is handed
        # to the new leader before anyone acts on the new weights.
        rep._leader_invalidate()
        if rep.lease_mgr is not None:
            rep.lease_mgr.on_weight_epoch(now)
        inst = getattr(rep, "slow_inst", None)
        if inst is not None and not inst.committed \
                and not rep.is_leader(now):
            from repro_torch.core.simulator import Msg
            rep.on_slow_nack(Msg("slow_nack", rep.node_id, rep.node_id,
                                 {"inst": inst.inst_id}), now)

    # -- message handlers (wired through BaseReplica.on_weight_*) ------------

    def on_install(self, msg, now: float) -> None:
        self.adopt(msg.payload["e"], msg.payload["rk"], now)

    def on_pull(self, msg, now: float) -> None:
        if msg.payload.get("e", 0) < self.epoch:
            self.rep.send(msg.src, "weight_view",
                          {"e": self.epoch,
                           "rk": list(self.ranking) if self.ranking
                           is not None else list(self._identity)})

    def on_view(self, msg, now: float) -> None:
        self.adopt(msg.payload["e"], msg.payload["rk"], now)

    # -- slow-path epoch stamps ----------------------------------------------

    def stamp(self, payload: dict) -> dict:
        """Epoch-stamp a slow proposal (key added only once an epoch
        exists — fault-free payloads stay byte-identical)."""
        if self.epoch:
            payload["we"] = self.epoch
        return payload

    def reject_stale(self, msg, now: float) -> bool:
        """Follower-side epoch fence: nack slow proposals stamped with an
        epoch older than our installed view (their quorum math predates
        the current ranking). Newer stamps trigger a catch-up pull but
        are not rejected — the proposer's view is ahead, not behind."""
        we = msg.payload.get("we", 0)
        if we > self.epoch and we > self._pulled_epoch:
            self._pulled_epoch = we
            self.rep.send(msg.src, "weight_pull", {"e": self.epoch})
        return self.cfg.epoch_fence and we < self.epoch

    # -- state transfer / recovery -------------------------------------------

    def export_state(self) -> tuple:
        return (self.epoch, list(self.ranking) if self.ranking is not None
                else list(self._identity))

    def install_state(self, state: tuple, now: float) -> None:
        self.adopt(state[0], state[1], now)

    def on_recover(self, now: float) -> None:
        # evidence is volatile (pre-crash observations are garbage); the
        # installed view persists and the sync snapshot may advance it
        n = len(self._ema)
        self._ema = [0.0] * n
        self._cnt = [0] * n
        self._last_sample = [-1.0] * n
        self._streak.clear()
        self.confirmed.clear()
        self.reports.clear()
        self._sent_set = ()
        self._sent_t = -1.0
        self._pin_until = -1.0
