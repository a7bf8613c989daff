"""Deterministic metrics registry: counters, gauges, sim-time histograms.

Design
------
``collect_metrics`` / ``assemble_result`` keep their pinned summary
fields (throughput, latency percentiles, path mix) — those are the
bit-identity contract. The registry is the *extensible* layer on top:
labelled counters, gauges and fixed-bucket histograms built **post-run
from the canonical trace** (plus the commit log), so serial and
parallel sharded runs aggregate through one code path — a worker never
ships partial counters that would need truncation bookkeeping; the
trace events it ships are already truncated to T* by the parallel
runner, exactly like every other journaled side effect.

Histogram buckets are fixed geometric bounds (1 µs .. ~2 s, doubling),
so bucket assignment is a pure function of the observed value and the
serialized form is stable across runs and machines.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

# fixed sim-time bounds (seconds): 1e-6 * 2**k for k in 0..20
BUCKET_BOUNDS: Tuple[float, ...] = tuple(1e-6 * (1 << k) for k in range(21))


@dataclasses.dataclass
class Counter:
    value: float = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


@dataclasses.dataclass
class Gauge:
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-bound sim-time histogram (cumulative counts on export)."""

    __slots__ = ("bounds", "counts", "total", "count")

    def __init__(self, bounds: Tuple[float, ...] = BUCKET_BOUNDS):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)     # +1: +Inf bucket
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += v
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def to_dict(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "buckets": list(self.counts)}


def _key(name: str, labels: dict) -> Tuple:
    return (name,) + tuple(sorted(labels.items()))


class MetricsRegistry:
    """Name+label keyed metric store with canonical serialization."""

    def __init__(self):
        self._counters: Dict[Tuple, Counter] = {}
        self._gauges: Dict[Tuple, Gauge] = {}
        self._hists: Dict[Tuple, Histogram] = {}

    def counter(self, name: str, **labels) -> Counter:
        return self._counters.setdefault(_key(name, labels), Counter())

    def gauge(self, name: str, **labels) -> Gauge:
        return self._gauges.setdefault(_key(name, labels), Gauge())

    def histogram(self, name: str, **labels) -> Histogram:
        return self._hists.setdefault(_key(name, labels), Histogram())

    @staticmethod
    def _label_str(key: Tuple) -> str:
        name, labels = key[0], key[1:]
        if not labels:
            return name
        inner = ",".join(f"{k}={v}" for k, v in labels)
        return f"{name}{{{inner}}}"

    def to_dict(self) -> dict:
        """Canonical (sorted-key) nested dict — deterministic to
        serialize, diff-friendly in bench artifacts."""
        return {
            "counters": {self._label_str(k): c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {self._label_str(k): g.value
                       for k, g in sorted(self._gauges.items())},
            "histograms": {self._label_str(k): h.to_dict()
                           for k, h in sorted(self._hists.items())},
        }


def metrics_from_trace(events: List[tuple],
                       commit_log_residual: int = 0,
                       reg: Optional[MetricsRegistry] = None
                       ) -> MetricsRegistry:
    """Build the standard metric set from a canonical trace.

    Populates: path mix (``ops_committed_total{path=..}``), route
    decisions and reasons, fast-path abort reasons
    (``fast_divert_total{reason=..}``), quorum-wait histograms for both
    paths (propose -> decision), slow queue wait (enqueue -> propose),
    steal fence->grant (drain) and grant->install durations, per-node
    EMA weight gauges (last sample wins), redirect/steal counters, fault
    annotations, and the commit-log residual satellite metric.
    """
    reg = reg or MetricsRegistry()
    reg.counter("commit_log_residual").inc(commit_log_residual)

    fast_propose_t: Dict[int, float] = {}     # batch -> propose time
    slow_propose_t: Dict[int, float] = {}     # inst  -> propose time
    slow_enqueue_t: Dict[int, float] = {}     # op_id -> enqueue time
    fence_t: Dict[Tuple[int, int], float] = {}   # (node, obj) -> fence t
    grant_t: Dict[Tuple[int, int], float] = {}   # (obj, epoch) -> grant t
    fast_done = set()
    slow_done = set()

    for e in events:
        t, kind, node = e[0], e[1], e[2]
        if kind == "commit":
            reg.counter("ops_committed_total", path=e[4]).inc()
        elif kind == "route":
            reg.counter("route_decisions_total",
                        decision=e[5], reason=e[6]).inc()
        elif kind == "divert":
            reg.counter("fast_divert_total", reason=e[5]).inc()
        elif kind == "fast_propose":
            fast_propose_t.setdefault(e[3], t)
        elif kind == "fast_commit":
            b = e[3]
            if b in fast_propose_t and b not in fast_done:
                fast_done.add(b)
                reg.histogram("quorum_wait_s", path="fast").observe(
                    t - fast_propose_t[b])
        elif kind == "slow_enqueue":
            slow_enqueue_t.setdefault(e[3], t)
        elif kind == "slow_propose":
            if e[3] not in slow_propose_t:
                slow_propose_t[e[3]] = t
            qt = slow_enqueue_t.pop(e[4], None)
            if qt is not None:
                reg.histogram("slow_queue_wait_s").observe(t - qt)
        elif kind == "slow_commit":
            i = e[3]
            if i in slow_propose_t and i not in slow_done:
                slow_done.add(i)
                reg.histogram("quorum_wait_s", path="slow").observe(
                    t - slow_propose_t[i])
        elif kind == "dep_stall":
            reg.counter("dep_stalls_total").inc()
        elif kind == "ema":
            reg.gauge("ema_weight", node=node, peer=e[3]).set(e[4])
        elif kind == "steal_hint":
            reg.counter("steal_hints_total").inc()
        elif kind == "steal_fence":
            fence_t[(node, e[3])] = t
        elif kind == "steal_grant":
            ft = fence_t.pop((node, e[3]), None)
            if ft is not None:
                reg.histogram("steal_drain_s").observe(t - ft)
            grant_t[(e[3], e[4])] = t
            reg.counter("steals_granted_total").inc()
        elif kind == "steal_install":
            gt = grant_t.pop((e[3], e[4]), None)
            if gt is not None:
                reg.histogram("steal_install_s").observe(t - gt)
        elif kind == "redirect":
            reg.counter("redirects_total").inc()
        elif kind == "fault":
            reg.counter("fault_events_total", action=e[3]).inc()
    return reg
