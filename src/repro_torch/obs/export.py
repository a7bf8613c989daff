"""Trace exporters: Chrome ``trace_event`` JSON (Perfetto-loadable) and
compact JSONL.

Byte determinism
----------------
Both exporters serialize the canonical event order (see
:func:`repro_torch.obs.spans.canonical_events`) with ``sort_keys=True`` and
fixed separators, and sim-time floats are emitted through ``repr`` (via
``json``), which is deterministic in CPython — so the same seed and
schedule produce a byte-identical file, which the obs test suite pins.

Chrome format
-------------
Two layers of events are emitted:

  * one ``ph: "X"`` (complete) event per committed op — name
    ``op/<path>``, lane (``tid``) = committing node, ``ts`` = client
    submit, ``dur`` = commit latency — so Perfetto renders the per-node
    commit timeline directly;
  * one ``ph: "i"`` (instant) event per raw span event — protocol phase
    markers, quorum arrivals, steal lifecycle, fault annotations — with
    the kind-specific arguments in ``args``.

Load a file via https://ui.perfetto.dev ("Open trace file"). Timestamps
are microseconds of *simulated* time.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

# kind -> names of the args after (t, kind, node); used for Chrome args
# dicts and for human-readable JSONL. Extra positions fall back to a0...
ARG_NAMES: Dict[str, Sequence[str]] = {
    "ingress":     ("op_id", "obj", "submit_t", "client"),
    "route":       ("op_id", "obj", "decision", "reason"),
    "fast_propose": ("batch", "op_id"),
    "fast_accept": ("batch", "src", "lead"),
    "fast_commit": ("batch", "op_id"),
    "divert":      ("batch", "op_id", "reason"),
    "slow_forward": ("op_id", "leader"),
    "slow_enqueue": ("op_id",),
    "slow_propose": ("inst", "op_id"),
    "slow_accept": ("inst", "src", "psum"),
    "slow_commit": ("inst", "op_id"),
    "epx_reply":   ("batch", "phase", "src"),
    "commit":      ("op_id", "path"),
    "dep_stall":   ("op_id", "obj", "n_deps"),
    "ema":         ("peer", "weight"),
    "lease_req":   ("obj", "epoch"),
    "lease_renew": ("obj", "epoch"),
    "lease_grant": ("obj", "epoch", "renewal"),
    "lease_revoke": ("obj", "epoch", "n_ops"),
    "lease_wait":  ("op_id", "obj"),
    "lease_local": ("op_id", "obj"),
    "lease_leader": ("until",),
    "steal_hint":  ("obj",),
    "steal_fence": ("obj",),
    "steal_grant": ("obj", "epoch"),
    "steal_install": ("obj", "epoch"),
    "redirect":    ("obj", "to_group"),
    "fault":       ("action", "detail"),
    "weight_suspect": ("suspects", "leader"),
    "weight_install": ("epoch", "ranking"),
    "weight_adopt": ("epoch", "ranking"),
}

_COMPACT = {"sort_keys": True, "separators": (",", ":")}


def _args_of(kind: str, rest: tuple) -> dict:
    names = ARG_NAMES.get(kind, ())
    return {(names[i] if i < len(names) else f"a{i}"): v
            for i, v in enumerate(rest)}


def to_chrome_trace(events: List[tuple]) -> dict:
    """Build a Chrome ``trace_event`` object from canonical events."""
    ingress = {}                       # op_id -> submit time
    trace_events = []
    for e in events:
        t, kind, node, rest = e[0], e[1], e[2], e[3:]
        if kind == "ingress":
            ingress[rest[0]] = rest[2]
        trace_events.append({
            "name": kind, "ph": "i", "s": "g",
            "ts": t * 1e6, "pid": 0, "tid": node,
            "cat": "span", "args": _args_of(kind, rest),
        })
    for e in events:
        if e[1] != "commit":
            continue
        t, node, op_id, path = e[0], e[2], e[3], e[4]
        submit = ingress.get(op_id)
        if submit is None:
            continue                   # unsampled op: no span to draw
        trace_events.append({
            "name": f"op/{path}", "ph": "X",
            "ts": submit * 1e6, "dur": (t - submit) * 1e6,
            "pid": 0, "tid": node, "cat": "op",
            "args": {"op_id": op_id},
        })
    return {
        "displayTimeUnit": "ms",
        "otherData": {"generator": "repro_torch.obs", "clock": "sim"},
        "traceEvents": trace_events,
    }


def chrome_trace_json(events: List[tuple]) -> str:
    """Byte-deterministic Chrome-trace serialization."""
    return json.dumps(to_chrome_trace(events), **_COMPACT)


def to_jsonl(events: List[tuple]) -> str:
    """One compact JSON object per line: ``{"t":..,"kind":..,"node":..,
    <kind args>}`` — grep-friendly and byte-deterministic."""
    lines = []
    for e in events:
        row = {"t": e[0], "kind": e[1], "node": e[2]}
        row.update(_args_of(e[1], e[3:]))
        lines.append(json.dumps(row, **_COMPACT))
    return "\n".join(lines) + ("\n" if lines else "")


EXPORT_FORMATS = ("chrome", "jsonl")


def export_trace(events: List[tuple], fmt: str = "chrome") -> str:
    if fmt == "chrome":
        return chrome_trace_json(events)
    if fmt == "jsonl":
        return to_jsonl(events)
    raise ValueError(f"unknown trace export format {fmt!r}; "
                     f"expected one of {EXPORT_FORMATS}")


def write_trace(path: str, events: List[tuple],
                fmt: str = "chrome") -> str:
    """Export ``events`` to ``path`` and return the path."""
    data = export_trace(events, fmt)
    with open(path, "w") as f:
        f.write(data)
    return path


def validate_chrome_trace(obj: dict) -> bool:
    """Structural schema check for the Chrome ``trace_event`` JSON object
    format (the subset Perfetto's legacy importer requires). Raises
    ``ValueError`` on the first violation; returns True when valid.
    Shared by the obs tests and the CI smoke step."""
    if not isinstance(obj, dict):
        raise ValueError("trace must be a JSON object")
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        raise ValueError("trace.traceEvents must be a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"traceEvents[{i}].name missing/not a string")
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "i", "I", "M", "C"):
            raise ValueError(f"traceEvents[{i}].ph invalid: {ph!r}")
        for key in ("ts", "pid", "tid"):
            if not isinstance(ev.get(key), (int, float)):
                raise ValueError(f"traceEvents[{i}].{key} missing/not "
                                 "a number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"traceEvents[{i}].dur missing/negative")
        args = ev.get("args")
        if args is not None and not isinstance(args, dict):
            raise ValueError(f"traceEvents[{i}].args not an object")
    return True
