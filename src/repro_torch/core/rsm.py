"""Replicated state machine + safety checkers (paper §4.5 validation).

Each replica owns an :class:`RSM` that applies committed operations to a
key-value store and records the per-object apply sequence. Tests use:

  * :func:`check_state_machine_safety` — every pair of replicas applied the
    same value-sequence per object (prefix-closed: a replica may lag).
  * :func:`check_linearizability` — for each object, the committed history
    (invocation/response intervals + unique write values) admits a legal
    linearization consistent with (a) real time and (b) the agreed apply
    order. With unique write values this reduces to: the apply order must
    not invert any pair of non-overlapping operations, and every read must
    return the latest write ordered before it.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.simulator import Op


class RSM:
    """Key-value replicated state machine for one replica.

    Hot-path layout (the engine's hot-path overhaul): ``apply`` maintains the value
    ``store`` and the ``applied_ops`` idempotence set eagerly, but records
    the per-object history as one flat, append-only ``_log`` — sequential
    writes instead of two dict-of-list insertions per op. The per-object
    views ``applied`` (value sequences, the safety-checker artifact) and
    ``obj_ops`` (op ids incl. reads, the shard-migration unit) are
    properties that fold the log up to a watermark on access; protocol
    code that never inspects them (the benchmark hot path) never pays for
    the indexing, while mid-run readers (shard gate drains/installs,
    recovery snapshots) see an always-consistent live dict.
    """

    __slots__ = ("store", "applied_ops", "apply_count",
                 "_log", "_applied", "_obj_ops", "_mark", "resolver")

    def __init__(self):
        self.store: Dict[int, int] = {}
        self.applied_ops: set[int] = set()
        self.apply_count = 0
        # read-resolution hook (repro_torch.coding): when set, a non-local
        # read is stamped only if resolver(op) is True — a replica that
        # cannot decode the object's striped value parks the read and
        # stamps it after repair. None (the default) = always stamp.
        self.resolver = None
        self._log: List[Tuple[int, int, object]] = []  # (obj, op_id, value|None=read)
        self._applied: Dict[int, List[int]] = defaultdict(list)
        self._obj_ops: Dict[int, List[int]] = defaultdict(list)
        self._mark = 0                   # log entries folded into the views

    def _fold(self) -> None:
        log = self._log
        mark = self._mark
        if mark == len(log):
            return
        applied = self._applied
        obj_ops = self._obj_ops
        for i in range(mark, len(log)):
            obj, op_id, val = log[i]
            obj_ops[obj].append(op_id)
            if val is not None:
                applied[obj].append(val)
        self._mark = len(log)

    @property
    def applied(self) -> Dict[int, List[int]]:
        """obj -> applied write values, in apply order (live dict)."""
        self._fold()
        return self._applied

    @property
    def obj_ops(self) -> Dict[int, List[int]]:
        """obj -> applied op ids incl. reads, in apply order (live dict).
        This is the unit of state a shard migration ships so the new
        owner group can dedupe replayed ops committed under the old
        owner."""
        self._fold()
        return self._obj_ops

    def install_snapshot(self, *, store, applied, applied_ops, obj_ops,
                         apply_count) -> None:
        """Replace the whole state (crash-recovery state transfer)."""
        self.store = dict(store)
        self.applied_ops = set(applied_ops)
        self.apply_count = apply_count
        self._log = []
        self._mark = 0
        self._applied = defaultdict(list)
        for k, v in applied.items():
            self._applied[k] = list(v)
        self._obj_ops = defaultdict(list)
        for k, v in obj_ops.items():
            self._obj_ops[k] = list(v)

    def apply(self, op: Op) -> int | None:
        """Apply a committed op; idempotent on op_id (re-delivery safe)."""
        op_id = op.op_id
        obj = op.obj
        applied_ops = self.applied_ops
        if op_id in applied_ops:
            return self.store.get(obj)
        applied_ops.add(op_id)
        self.apply_count += 1
        if op.kind == "w":
            value = op.value
            self.store[obj] = value
            self._log.append((obj, op_id, value))
            return value
        self._log.append((obj, op_id, None))
        # A read already answered from a lease holder keeps that answer:
        # the op may still ride an older consensus instance to commit
        # (client retried into the lease path while the instance was
        # stuck behind a partition), and re-sampling the store here
        # would overwrite the result after its linearization point.
        if op.path != "local":
            r = self.resolver
            if r is None or r(op):
                op.read_result = self.store.get(obj)
        return op.read_result


def check_state_machine_safety(rsms: Sequence[RSM]) -> Tuple[bool, str]:
    """All replicas agree on the per-object value sequence (prefix rule)."""
    objects = set()
    for r in rsms:
        objects |= set(r.applied)
    for obj in objects:
        seqs = [r.applied[obj] for r in rsms if obj in r.applied]
        longest = max(seqs, key=len)
        for s in seqs:
            if s != longest[: len(s)]:
                return False, (f"divergent apply order on object {obj}: "
                               f"{s[:8]} vs {longest[:8]}")
    return True, "ok"


@dataclasses.dataclass(frozen=True)
class HistoryEntry:
    op_id: int
    obj: int
    kind: str
    value: object          # write payload, or the value a read RETURNED
    invoke: float
    response: float


def history_from_ops(ops: Sequence[Op]) -> List[HistoryEntry]:
    return [HistoryEntry(o.op_id, o.obj, o.kind,
                         o.value if o.kind == "w" else o.read_result,
                         o.submit_time, o.commit_time)
            for o in ops if o.commit_time >= 0]


def check_linearizability(history: Sequence[HistoryEntry],
                          apply_order: Dict[int, List[int]]
                          ) -> Tuple[bool, str]:
    """Check per-object linearizability against the agreed apply order.

    ``apply_order``: obj -> list of written values in the order the RSM
    applied them (from any up-to-date replica). Write values are unique, so
    the apply order induces a total order on writes; linearizability then
    requires that order to respect real time.
    """
    by_obj: Dict[int, List[HistoryEntry]] = defaultdict(list)
    for h in history:
        by_obj[h.obj].append(h)

    for obj, entries in by_obj.items():
        writes = [h for h in entries if h.kind == "w"]
        order = apply_order.get(obj, [])
        pos = {v: i for i, v in enumerate(order)}
        # every committed write must have been applied
        for w in writes:
            if w.value not in pos:
                return False, f"committed write {w.op_id} never applied"
        # real-time order must be preserved by the apply order
        ws = sorted(writes, key=lambda h: h.response)
        for i, a in enumerate(ws):
            for b in ws[i + 1:]:
                if a.response < b.invoke and pos[a.value] > pos[b.value]:
                    return False, (f"real-time inversion on obj {obj}: "
                                   f"{a.op_id} -> {b.op_id}")
        # reads: the read's serialization point is pinned by the value it
        # returned (position in the write order; -1 = initial state). Every
        # write that finished before the read began must be ordered at or
        # before that point; every write that began after the read finished
        # must be ordered after it.
        for r in (h for h in entries if h.kind == "r"):
            if r.value is not None and r.value not in pos:
                return False, f"read {r.op_id} returned unapplied {r.value}"
            rv = pos[r.value] if r.value is not None else -1
            for w in writes:
                if w.response < r.invoke and pos[w.value] > rv:
                    return False, (f"stale read on obj {obj}: read {r.op_id} "
                                   f"missed write {w.op_id}")
                if r.response < w.invoke and pos[w.value] <= rv:
                    return False, (f"future read on obj {obj}: read "
                                   f"{r.op_id} saw write {w.op_id}")
    return True, "ok"
