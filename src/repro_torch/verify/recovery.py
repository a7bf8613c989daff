"""Recovery telemetry: what a fault cost and how fast the system healed.

Works on the committed history alone (response = commit stamp), in
simulated time, so every number here is deterministic given seed +
schedule — recovery claims can be exact ``check``s, not noisy wall-clock
notes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.core.rsm import HistoryEntry


@dataclasses.dataclass(frozen=True)
class RecoveryReport:
    fault_at: float
    baseline_tx_s: float       # windowed throughput just before the fault
    dip_tx_s: float            # worst window after the fault
    dip_frac: float            # dip / baseline (0 = full outage)
    time_to_recover_s: float   # fault onset -> first window back above
                               # settle_frac * baseline (inf = never)
    recovered: bool
    # weight-view installs (t, epoch) observed from the fault onset to the
    # analysis horizon — empty unless the run's weight_epochs were passed
    weight_installs: tuple = ()


def throughput_timeline(history: Sequence[HistoryEntry],
                        window: float = 0.05,
                        t0: float = 0.0,
                        t1: float | None = None) -> List[tuple]:
    """Commit throughput per fixed window: [(window_start, tx_s)]."""
    resp = np.sort(np.array([h.response for h in history]))
    if t1 is None:
        t1 = float(resp[-1]) if len(resp) else t0 + window
    out = []
    t = t0
    while t < t1:
        n = np.searchsorted(resp, t + window) - np.searchsorted(resp, t)
        out.append((t, float(n) / window))
        t += window
    return out


def _baseline_rate(resp: np.ndarray, fault_at: float,
                   baseline_s: float) -> float:
    """Commit rate over the ``baseline_s`` seconds before the fault —
    the single definition both dip_frac and downtime report against."""
    b0 = max(0.0, fault_at - baseline_s)
    n = np.searchsorted(resp, fault_at) - np.searchsorted(resp, b0)
    return float(n) / max(fault_at - b0, 1e-9)


def effective_downtime(history: Sequence[HistoryEntry], fault_at: float, *,
                       horizon: float = 0.5,
                       baseline_s: float = 0.25) -> float:
    """Throughput deficit around a fault, as equivalent seconds of full
    outage: (baseline-expected ops - actual ops) / baseline over
    ``[fault_at, min(fault_at + horizon, end of history)]``. Integrates
    the whole disruption, so a long shallow slump and a short hard
    outage are comparable on one axis."""
    resp = np.sort(np.array([h.response for h in history]))
    if not len(resp):
        return float(horizon)
    baseline = _baseline_rate(resp, fault_at, baseline_s)
    if baseline <= 0:
        return 0.0
    end = min(fault_at + horizon, float(resp[-1]))
    span = max(end - fault_at, 0.0)
    actual = float(np.searchsorted(resp, end) - np.searchsorted(resp, fault_at))
    return max(0.0, (baseline * span - actual) / baseline)


def recovery_report(history: Sequence[HistoryEntry], fault_at: float, *,
                    window: float = 0.05, baseline_s: float = 0.25,
                    settle_frac: float = 0.7,
                    horizon: float | None = None,
                    weight_epochs: Sequence = ()) -> RecoveryReport:
    """Measure the throughput dip and time-to-recover around one fault.

    Baseline is the commit rate over ``[fault_at - baseline_s, fault_at)``;
    post-fault windows of ``window`` seconds are scanned up to ``horizon``
    (default: end of history). Recovery = first post-fault window whose
    rate is at least ``settle_frac * baseline``; the dip is the worst
    window at or before that point (after recovery the workload may
    legitimately drain and fall to zero, which is not a dip).

    ``weight_epochs`` is the run's ``RunResult.weight_epochs`` record;
    the installs inside the analysis span land on the report so a
    recovery claim can tie the heal to the reassignment that caused it.
    """
    resp = np.sort(np.array([h.response for h in history]))
    if not len(resp):
        return RecoveryReport(fault_at, 0.0, 0.0, 0.0, float("inf"), False)
    if horizon is None:
        horizon = float(resp[-1])
    installs = tuple((rec[0], rec[1]) for rec in weight_epochs
                     if fault_at <= rec[0] <= horizon)
    baseline = _baseline_rate(resp, fault_at, baseline_s)
    dip = float("inf")
    t_rec = float("inf")
    t = fault_at
    while t < horizon:
        n = np.searchsorted(resp, t + window) - np.searchsorted(resp, t)
        rate = float(n) / window
        if rate < dip:
            dip = rate
        if baseline > 0 and rate >= settle_frac * baseline:
            t_rec = t + window - fault_at
            break
        t += window
    recovered = t_rec != float("inf")
    if dip == float("inf"):
        dip = 0.0
    return RecoveryReport(
        fault_at=fault_at, baseline_tx_s=baseline, dip_tx_s=dip,
        dip_frac=dip / baseline if baseline > 0 else 0.0,
        time_to_recover_s=t_rec, recovered=recovered,
        weight_installs=installs)


def downtime_by_phase(history: Sequence[HistoryEntry], fault_at: float,
                      weight_epochs: Sequence, *,
                      horizon: float = 0.5,
                      baseline_s: float = 0.25) -> tuple:
    """Split :func:`effective_downtime` at the first weight-view install
    after the fault: ``(detect_s, residual_s)`` — deficit paid while the
    fault ran on the old weight view (detection + confirmation latency)
    vs deficit remaining after the reassignment landed. With no install
    in the span, the whole deficit is detection."""
    resp = np.sort(np.array([h.response for h in history]))
    if not len(resp):
        return (float(horizon), 0.0)
    baseline = _baseline_rate(resp, fault_at, baseline_s)
    if baseline <= 0:
        return (0.0, 0.0)
    end = min(fault_at + horizon, float(resp[-1]))
    first = next((rec[0] for rec in weight_epochs
                  if rec[0] >= fault_at), None)
    split = end if first is None else min(first, end)

    def deficit(a: float, b: float) -> float:
        span = max(b - a, 0.0)
        actual = float(np.searchsorted(resp, b) - np.searchsorted(resp, a))
        return max(0.0, (baseline * span - actual) / baseline)

    return (deficit(fault_at, split), deficit(split, end))
