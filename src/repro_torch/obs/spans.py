"""Deterministic, zero-overhead-when-off span recorder.

The tracer is a host-side append-only log of flat tuples — it never
posts messages, charges CPU cost, or touches the event heap, so a run
with tracing enabled is *bit-identical in simulated time* to the same
run with tracing off. Every instrumentation site in the engine and the
protocols is guarded by::

    tr = self.sim.tracer
    if tr is not None:
        tr.ev(...)

so the disabled cost is one attribute read and a ``None`` test.

Event schema
------------
Each event is a tuple ``(t, kind, node, *args)``:

  * ``t``     — simulated time of the recording handler (seconds),
  * ``kind``  — short string tag (see ``ARG_NAMES`` in
    :mod:`repro_torch.obs.export` for the per-kind argument names),
  * ``node``  — the *global* replica id of the recording node (GroupView
    installs a :class:`MappedTracer` so shard-group-local protocol code
    records global ids), or ``-1`` for engine-level annotations,
  * ``args``  — kind-specific primitives (ints / floats / strings only).

Tuples start with ``t`` so a plain ``sorted()`` gives the canonical
order used for byte-identical export and for the serial <-> parallel
span-set contract; within one ``(t, kind, node)`` the argument tuples of
a single kind are homogeneous, so mixed-type comparisons never happen.

Per-op span events (ingress / route / proposals / per-op commits on the
protocol paths) honour the deterministic sampling filter
:meth:`Tracer.sampled`; authoritative ``commit`` stamp events and cheap
batch-level events (quorum arrivals, EMA samples, steals, faults) are
always recorded so path-mix metrics stay exact under sampling.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

Event = Tuple  # (t, kind, node, *args)

_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """The same finalizer family the engine's jitter hash uses: a cheap,
    high-quality deterministic scramble of an op id."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return (x ^ (x >> 31)) & _MASK


class Tracer:
    """Append-only deterministic span recorder (see module docstring)."""

    __slots__ = ("events", "sample_every")

    def __init__(self, sample_every: int = 1):
        self.events: List[Event] = []
        self.sample_every = max(1, int(sample_every))

    def sampled(self, op_id: int) -> bool:
        """Deterministic per-op sampling decision: a pure hash of the op
        id, so every engine (serial or parallel worker) keeps exactly the
        same op population."""
        if self.sample_every <= 1:
            return True
        return _splitmix64(op_id) % self.sample_every == 0

    def ev(self, kind: str, t: float, node: int, *args) -> None:
        self.events.append((t, kind, node) + args)


# event kinds whose args (after the node position) carry a replica id at
# this index — translated alongside ``node`` so every id in a sharded
# trace lives in the global namespace
_NODE_ARG_IDX = {
    "fast_accept": 1,    # src (responder)
    "slow_accept": 1,    # src (responder)
    "epx_reply": 2,      # src (responder)
    "ema": 0,            # peer
    "slow_forward": 1,   # leader
    "weight_suspect": 1,  # leader (report target)
}

# event kinds carrying a comma-joined replica-id list at this arg index
# (rankings / suspect sets) — every id in the list is translated
_CSV_ARG_IDX = {
    "weight_suspect": 0,  # suspect set
    "weight_adopt": 1,    # installed ranking
}


class MappedTracer:
    """A view over a :class:`Tracer` that translates node ids on record.

    Shard-group protocol code runs in a group-local id namespace (see
    :class:`repro_torch.shard.groupview.GroupView`); the view maps local
    replica ids to global ones so merged traces from all groups share
    one namespace. Ids already outside the group-local range (clients,
    explicit global addressing) pass through untouched, matching
    ``GroupView.to_global``.
    """

    __slots__ = ("_tr", "_map")

    def __init__(self, tracer: Tracer, node_map: Callable[[int], int]):
        self._tr = tracer
        self._map = node_map

    @property
    def events(self) -> List[Event]:
        return self._tr.events

    @property
    def sample_every(self) -> int:
        return self._tr.sample_every

    def sampled(self, op_id: int) -> bool:
        return self._tr.sampled(op_id)

    def ev(self, kind: str, t: float, node: int, *args) -> None:
        idx = _NODE_ARG_IDX.get(kind)
        if idx is not None and idx < len(args):
            args = args[:idx] + (self._map(args[idx]),) + args[idx + 1:]
        idx = _CSV_ARG_IDX.get(kind)
        if idx is not None and idx < len(args) and args[idx]:
            mapped = ",".join(str(self._map(int(p)))
                              for p in args[idx].split(","))
            args = args[:idx] + (mapped,) + args[idx + 1:]
        self._tr.ev(kind, t, self._map(node), *args)


def canonical_events(events: List[Event]) -> List[Event]:
    """Canonicalize a raw event log: sort into the total (t, kind, node,
    args) order and keep only the **earliest** ``commit`` event per op.

    The dedup mirrors the engine's commit-stamp guard: on the serial
    engine a shared ``commit_log`` suppresses later stamps of the same
    op, while parallel per-group engines each stamp their own pickled Op
    copy — merging their traces would otherwise show one commit per
    engine. Keeping the earliest matches the parallel runner's
    earliest-stamp-first commit_log merge, so serial and parallel runs
    canonicalize to the same span set.
    """
    out = sorted(events)
    seen_commit = set()
    deduped: List[Event] = []
    for e in out:
        if e[1] == "commit":
            op_id = e[3]
            if op_id in seen_commit:
                continue
            seen_commit.add(op_id)
        deduped.append(e)
    return deduped
