"""Critical-path analysis: attribute each committed op's latency.

The analyzer walks the canonical trace and decomposes every committed
op's end-to-end latency (client submit -> authoritative commit stamp)
into additive components:

  ``ingress``      client link + coordinator ingest queueing
                   (submit -> coordinator handler),
  ``coord``        coordinator-side work before the quorum round starts
                   (route/forward handling; slow path includes the
                   forward hop to the leader),
  ``queue``        slow path only: leader mutex / group-commit queue
                   wait (enqueue -> instance propose),
  ``quorum_link``  propose broadcast -> first accept arrival (pure
                   network + responder service floor),
  ``straggler``    first accept -> the decisive accept that formed the
                   quorum — the cost of waiting for the slowest counted
                   responder, attributed per responder node in
                   ``straggler_by_node``,
  ``dep_stall``    quorum decision -> commit stamp (dependency-ordered
                   apply buffering and force-apply timeouts),
  ``lease``        leases on: quorum decision -> commit stamp time a
                   decided write spent waiting out a read lease
                   (remaining round acks or expiry — the revocation
                   pause, keyed off the sampled ``lease_wait`` span),
  ``reassign``     reassignment on: the decision -> commit gap of ops
                   whose stamp landed across a weight-view install
                   (``weight_install`` engine events) — the epoch-fence
                   drain/handoff pause, split out of ``dep_stall`` so
                   reassignment cost is visible per path,
  ``coding``       payload striping on: quorum decision -> commit stamp
                   time a striped write spent waiting for a weighted
                   *reconstructable* shard set (enough distinct assigned
                   shards to decode, not just enough ack weight — the
                   ``coding_wait`` span the commit gate records),
  ``other``        the (near-zero) remainder, including ops whose span
                   is incomplete (sampled out or committed via the
                   recovery/retry path with no quorum round of their
                   own).

Reads served locally under a lease (path ``"local"``) get their own
breakdown bucket — they never run a quorum round, so their latency is
ingress plus coordinator service.

Path mix (``fast_frac``) is computed from the *always-recorded* commit
stamp events, so it equals ``collect_metrics``/``assemble_result`` path
fractions exactly even when per-op span sampling is enabled — the obs
test suite pins that equality across the θ sweep.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

_COMPONENTS = ("ingress_s", "coord_s", "queue_s", "quorum_link_s",
               "straggler_s", "dep_stall_s", "lease_s", "reassign_s",
               "coding_s", "other_s")


@dataclasses.dataclass
class PathBreakdown:
    """Additive latency attribution for one protocol path."""
    count: int = 0
    total_s: float = 0.0
    ingress_s: float = 0.0
    coord_s: float = 0.0
    queue_s: float = 0.0
    quorum_link_s: float = 0.0
    straggler_s: float = 0.0
    dep_stall_s: float = 0.0
    lease_s: float = 0.0
    reassign_s: float = 0.0
    coding_s: float = 0.0
    other_s: float = 0.0

    def add(self, total: float, **parts: float) -> None:
        self.count += 1
        self.total_s += total
        acc = 0.0
        for name in _COMPONENTS[:-1]:
            v = max(0.0, parts.get(name, 0.0))
            setattr(self, name, getattr(self, name) + v)
            acc += v
        self.other_s += total - acc

    def to_dict(self) -> dict:
        d = {"count": self.count, "total_s": self.total_s}
        for name in _COMPONENTS:
            v = getattr(self, name)
            d[name] = v
            d[name.replace("_s", "_frac")] = (
                v / self.total_s if self.total_s > 0 else 0.0)
        return d


@dataclasses.dataclass
class CriticalPathReport:
    committed: int
    fast_committed: int
    slow_committed: int
    local_committed: int                # lease-served local reads
    fast_frac: float
    fast: PathBreakdown
    slow: PathBreakdown
    local: PathBreakdown
    # straggler seconds charged to the responder whose (decisive) accept
    # closed each quorum — the node everyone was waiting for
    straggler_by_node: Dict[int, float]
    analyzed: int                       # ops with a complete span

    def top_straggler(self) -> Optional[int]:
        """The node charged the most quorum-straggler time."""
        if not self.straggler_by_node:
            return None
        return max(sorted(self.straggler_by_node),
                   key=lambda n: self.straggler_by_node[n])

    def to_dict(self) -> dict:
        return {
            "committed": self.committed,
            "fast_committed": self.fast_committed,
            "slow_committed": self.slow_committed,
            "local_committed": self.local_committed,
            "fast_frac": self.fast_frac,
            "analyzed": self.analyzed,
            "fast": self.fast.to_dict(),
            "slow": self.slow.to_dict(),
            "local": self.local.to_dict(),
            "straggler_by_node": {str(k): v for k, v in
                                  sorted(self.straggler_by_node.items())},
        }


def analyze_events(events: List[tuple],
                   window: Optional[Tuple[float, float]] = None
                   ) -> CriticalPathReport:
    """Walk a canonical trace and build the per-path latency breakdown.

    ``window=(t0, t1)`` restricts the analysis to ops whose commit stamp
    falls in ``[t0, t1)`` — used by the fault-recovery bench to compare
    attribution inside vs outside a degradation window.
    """
    commits: Dict[int, Tuple[float, int, str]] = {}
    ingress: Dict[int, Tuple[float, float]] = {}       # op -> (t, submit)
    fb_of_op: Dict[int, int] = {}
    fb_propose: Dict[int, float] = {}
    fb_decide: Dict[Tuple[int, int], float] = {}       # (fb, op) -> t
    inst_of_op: Dict[int, int] = {}
    inst_propose: Dict[int, float] = {}
    inst_decide: Dict[Tuple[int, int], float] = {}
    enqueue: Dict[int, float] = {}
    accepts: Dict[Tuple[str, int], List[Tuple[float, int]]] = {}
    stall_t: Dict[Tuple[int, int], float] = {}         # (node, op) -> t
    lease_wait_t: Dict[Tuple[int, int], float] = {}    # (node, op) -> t
    coding_wait_t: Dict[Tuple[int, int], float] = {}   # (node, op) -> t
    installs: List[float] = []                         # weight-view installs

    for e in events:
        t, kind, node = e[0], e[1], e[2]
        if kind == "commit":
            commits.setdefault(e[3], (t, node, e[4]))
        elif kind == "ingress":
            ingress.setdefault(e[3], (t, e[5]))
        elif kind == "fast_propose":
            fb_of_op.setdefault(e[4], e[3])
            fb_propose.setdefault(e[3], t)
        elif kind == "fast_accept":
            accepts.setdefault(("f", e[3]), []).append((t, e[4]))
        elif kind == "fast_commit":
            fb_decide.setdefault((e[3], e[4]), t)
        elif kind == "slow_enqueue":
            enqueue.setdefault(e[3], t)
        elif kind == "slow_propose":
            inst_of_op.setdefault(e[4], e[3])
            inst_propose.setdefault(e[3], t)
        elif kind == "slow_accept":
            accepts.setdefault(("s", e[3]), []).append((t, e[4]))
        elif kind == "slow_commit":
            inst_decide.setdefault((e[3], e[4]), t)
        elif kind == "dep_stall":
            stall_t.setdefault((node, e[3]), t)
        elif kind == "lease_wait":
            lease_wait_t.setdefault((node, e[3]), t)
        elif kind == "coding_wait":
            coding_wait_t.setdefault((node, e[3]), t)
        elif kind == "weight_install":
            installs.append(t)
    installs.sort()

    fast_bd, slow_bd, local_bd = (PathBreakdown(), PathBreakdown(),
                                  PathBreakdown())
    straggler_by_node: Dict[int, float] = {}
    n_fast = n_slow = n_local = analyzed = 0

    for op_id, (commit_t, commit_node, path) in sorted(commits.items()):
        if window is not None and not (window[0] <= commit_t < window[1]):
            continue
        if path == "fast":
            n_fast += 1
        elif path == "local":
            n_local += 1
        else:
            n_slow += 1
        ing = ingress.get(op_id)
        if ing is None:
            continue                    # sampled out: mix only
        ingress_t, submit = ing
        total = commit_t - submit
        bd = (fast_bd if path == "fast"
              else local_bd if path == "local" else slow_bd)
        wait_t = lease_wait_t.get((commit_node, op_id))
        cw_t = coding_wait_t.get((commit_node, op_id))

        if path == "fast" and op_id in fb_of_op:
            fb = fb_of_op[op_id]
            propose_t = fb_propose.get(fb, ingress_t)
            decide_t = fb_decide.get((fb, op_id), commit_t)
            arr = [a for a in accepts.get(("f", fb), ())
                   if a[0] <= decide_t]
            parts, decisive = _quorum_parts(propose_t, decide_t, arr)
            stall = stall_t.get((commit_node, op_id))
            if cw_t is not None:
                # shard-durability pause: the weighted-reconstructable
                # gate engaged at decide time; the lease gate (if any)
                # runs after it, so the coding span ends where the lease
                # span begins
                end = (wait_t if wait_t is not None and wait_t >= cw_t
                       else commit_t)
                coding_s = max(0.0, end - cw_t)
                lease_s = (max(0.0, commit_t - wait_t)
                           if wait_t is not None else 0.0)
                dep_stall_s = max(0.0, cw_t - decide_t)
            elif wait_t is not None:
                # revocation pause: the gate engaged at decide time and
                # the stamp waited for the remaining round acks / expiry
                coding_s = 0.0
                lease_s = max(0.0, commit_t - wait_t)
                dep_stall_s = max(0.0, wait_t - decide_t)
            else:
                coding_s = lease_s = 0.0
                dep_stall_s = (commit_t - decide_t
                               if stall is not None or commit_t > decide_t
                               else 0.0)
            reassign_s = 0.0
            if dep_stall_s > 0.0 and _install_in(installs, decide_t,
                                                 commit_t):
                reassign_s, dep_stall_s = dep_stall_s, 0.0
            bd.add(total,
                   ingress_s=ingress_t - submit,
                   coord_s=propose_t - ingress_t,
                   dep_stall_s=dep_stall_s, lease_s=lease_s,
                   reassign_s=reassign_s, coding_s=coding_s,
                   **parts)
        elif path not in ("fast", "local") and op_id in inst_of_op:
            inst = inst_of_op[op_id]
            propose_t = inst_propose.get(inst, ingress_t)
            decide_t = inst_decide.get((inst, op_id), commit_t)
            enq_t = enqueue.get(op_id, propose_t)
            arr = [a for a in accepts.get(("s", inst), ())
                   if a[0] <= decide_t]
            parts, decisive = _quorum_parts(propose_t, decide_t, arr)
            if cw_t is not None:
                end = (wait_t if wait_t is not None and wait_t >= cw_t
                       else commit_t)
                coding_s = max(0.0, end - cw_t)
                lease_s = (max(0.0, commit_t - wait_t)
                           if wait_t is not None else 0.0)
                dep_stall_s = max(0.0, cw_t - decide_t)
            elif wait_t is not None:
                coding_s = 0.0
                lease_s = max(0.0, commit_t - wait_t)
                dep_stall_s = max(0.0, wait_t - decide_t)
            else:
                coding_s = lease_s = 0.0
                dep_stall_s = commit_t - decide_t
            reassign_s = 0.0
            if dep_stall_s > 0.0 and _install_in(installs, decide_t,
                                                 commit_t):
                reassign_s, dep_stall_s = dep_stall_s, 0.0
            bd.add(total,
                   ingress_s=ingress_t - submit,
                   coord_s=enq_t - ingress_t,
                   queue_s=propose_t - enq_t,
                   dep_stall_s=dep_stall_s, lease_s=lease_s,
                   reassign_s=reassign_s, coding_s=coding_s,
                   **parts)
        else:
            # committed without a quorum round of its own (retry hit on
            # an already-applied op, recovery path): everything lands in
            # ingress + other
            bd.add(total, ingress_s=ingress_t - submit)
            decisive = None
        analyzed += 1
        if decisive is not None:
            src, amount = decisive
            if amount > 0.0:
                straggler_by_node[src] = \
                    straggler_by_node.get(src, 0.0) + amount

    committed = n_fast + n_slow + n_local
    return CriticalPathReport(
        committed=committed, fast_committed=n_fast, slow_committed=n_slow,
        local_committed=n_local,
        fast_frac=n_fast / committed if committed else 0.0,
        fast=fast_bd, slow=slow_bd, local=local_bd,
        straggler_by_node=straggler_by_node, analyzed=analyzed)


def _install_in(installs: List[float], lo: float, hi: float) -> bool:
    """Any weight-view install in ``(lo, hi]``? (``installs`` sorted.)"""
    i = bisect.bisect_right(installs, lo)
    return i < len(installs) and installs[i] <= hi


def _quorum_parts(propose_t: float, decide_t: float,
                  arrivals: List[Tuple[float, int]]):
    """Split propose -> decision into link floor + straggler wait; the
    straggler share is charged to the decisive responder (the last
    counted accept at or before the decision)."""
    if not arrivals:
        return ({"quorum_link_s": decide_t - propose_t,
                 "straggler_s": 0.0}, None)
    arrivals = sorted(arrivals)
    first_t = arrivals[0][0]
    last_t, last_src = arrivals[-1]
    straggler = max(0.0, decide_t - first_t)
    return ({"quorum_link_s": max(0.0, first_t - propose_t),
             "straggler_s": straggler}, (last_src, straggler))
