"""Verification of simulated runs: history capture, linearizability,
recovery telemetry.

Three independent checks compose into :func:`verify_artifacts`:

  1. **History linearizability** (client's-eye Wing & Gong search,
     :mod:`repro_torch.verify.linearizability`) — needs nothing but the
     invoke/response history, so it applies to every protocol including
     ones whose replicas legitimately diverge (EPaxos simplification).
  2. **State-machine safety** across live replicas (prefix rule,
     :func:`repro_torch.core.rsm.check_state_machine_safety`).
  3. **Apply-order linearizability** — the cheap order-aware check
     against the most advanced replica's per-object apply order
     (:func:`repro_torch.core.rsm.check_linearizability`).

Replicas that are mid-state-transfer (``recovering``) or currently
isolated by a partition (``_isolated`` — their logs may have holes that
the heal-triggered sync has not yet filled) are excluded from the
replica-state checks; the history check covers them regardless.
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.core.rsm import (check_linearizability,  # noqa: F401
                            check_state_machine_safety, HistoryEntry)
from repro_torch.verify.history import by_object, capture_history  # noqa: F401
from repro_torch.verify.linearizability import (  # noqa: F401
    DEFAULT_MAX_STATES, SearchBudget, check_history_linearizable,
    check_object_linearizable)
from repro_torch.verify.recovery import (RecoveryReport,  # noqa: F401
                                   downtime_by_phase, effective_downtime,
                                   recovery_report, throughput_timeline)

__all__ = [
    "capture_history", "by_object", "HistoryEntry",
    "check_history_linearizable", "check_object_linearizable",
    "SearchBudget", "DEFAULT_MAX_STATES",
    "recovery_report", "throughput_timeline", "RecoveryReport",
    "effective_downtime", "downtime_by_phase",
    "check_state_machine_safety", "check_linearizability",
    "verify_artifacts",
]


def _checkable(replica, sim) -> bool:
    return (replica.node_id not in sim.crashed
            and not getattr(replica, "recovering", False)
            and not getattr(replica, "_isolated", False))


def verify_artifacts(art, *, check_rsm: bool = True,
                     check_history: bool = True,
                     max_states: int = DEFAULT_MAX_STATES
                     ) -> Tuple[bool, str]:
    """Run every applicable safety check on a finished run's artifacts.

    ``check_rsm=False`` restricts to the history-only check — use it for
    EPaxos, whose simplified commit broadcast applies in arrival order
    and may legitimately diverge across replicas (documented baseline
    simplification), and for artifacts without live replica state.
    ``check_history=False`` skips the (comparatively expensive) Wing &
    Gong search — for callers that already ran it on the same history,
    like the scenario verification gate.
    """
    history = getattr(art.result, "history", None) or \
        capture_history(art.clients)
    if check_history:
        ok, why = check_history_linearizable(history, max_states)
        if not ok:
            return False, f"history: {why}"
    if check_rsm:
        rsms = [r.rsm for r in art.replicas if _checkable(r, art.sim)]
        if rsms:
            ok, why = check_state_machine_safety(rsms)
            if not ok:
                return False, f"state-machine safety: {why}"
            best = max(rsms, key=lambda r: r.apply_count)
            ok, why = check_linearizability(history, best.applied)
            if not ok:
                return False, f"apply-order: {why}"
    return True, f"ok ({len(history)} committed ops verified)"
