"""Deterministic observability: span tracing, metrics, critical path.

Host-side only — enabling tracing never changes simulated timing (the
recorder posts no messages and charges no CPU cost), and same-seed runs
export byte-identical traces. See the observability test suite
(tests/test_obs.py) for the pinned contracts.
"""

from repro_torch.obs.critical_path import (CriticalPathReport, PathBreakdown,
                                     analyze_events)
from repro_torch.obs.export import (ARG_NAMES, EXPORT_FORMATS, chrome_trace_json,
                              export_trace, to_chrome_trace, to_jsonl,
                              validate_chrome_trace, write_trace)
from repro_torch.obs.metrics import (BUCKET_BOUNDS, Counter, Gauge, Histogram,
                               MetricsRegistry, metrics_from_trace)
from repro_torch.obs.spans import MappedTracer, Tracer, canonical_events

__all__ = [
    "ARG_NAMES", "BUCKET_BOUNDS", "Counter", "CriticalPathReport",
    "EXPORT_FORMATS", "Gauge", "Histogram", "MappedTracer",
    "MetricsRegistry", "PathBreakdown", "Tracer", "analyze_events",
    "canonical_events", "chrome_trace_json", "export_trace",
    "metrics_from_trace", "to_chrome_trace", "to_jsonl",
    "validate_chrome_trace", "write_trace",
]
