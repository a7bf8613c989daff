"""Per-object linearizability checking (Wing & Gong + register fast path).

Operations are single-object, so a run's history decomposes per object
and each piece is checked independently against a register model (state
= last written value, ``None`` initial; a write always applies, a read
applies iff the state equals the value it returned). The checker is the
client's-eye view — it uses ONLY invoke/response intervals and observed
values, no replica state — which is what makes it trustworthy against
protocol-level ordering bugs: a bug has to fool every client to fool it.

Two exact engines, picked per object:

**Wing & Gong search** (:func:`_search`) — the general model-based
checker: linearize one eligible operation at a time (eligible = no
still-pending op responded before it invoked), depth-first with an
explicit stack, memoizing visited (linearized-set, state) pairs (Lowe's
P-compositionality / porcupine's cache), first complete linearization
wins. Exponential in per-object concurrency in the worst case, so it is
used for small histories and for histories with duplicate write values,
under a ``max_states`` budget that raises :class:`SearchBudget`
(an *undecided* verdict, never a pass) instead of hanging.

**Reign decomposition** (:func:`_check_unique_writes`) — when every
write value is unique (true for every harness-generated workload: the
value is derived from the unique op id), the read mapping is known and
linearizability is polynomial (Gibbons & Korach's read-mapped register
case). In any legal sequence, the reads of write ``w`` must sit between
``w`` and the next write — each write's "reign" is a contiguous block,
with reads of the initial ``None`` state in a virtual reign before all
writes. A valid block order exists iff

  * no read completes before its own write was invoked, and no write or
    later-value read completes before a ``None``-read invokes (the
    initial reign cannot be preceded), and
  * no two reigns mutually wholly-precede each other: with
    ``mr(G) = min response`` and ``Mi(G) = max invoke`` over a reign's
    ops, reign G1 must precede G2 whenever ``mr(G1) < Mi(G2)``, and a
    mutual pair is an order cycle. (Any longer cycle in this threshold
    relation collapses to such a 2-cycle, so the pairwise test is
    complete; the pair scan is one numpy broadcast.)

Fault-induced commit pile-ups — hundreds of ops stalled behind a
partition all committing in one overlapping burst — are exactly the
histories that blow up a pure search, and exactly where the
decomposition stays O(ops + reigns^2). Write-only objects (the entire
default 90/5/5 mix) short-circuit: ordering writes by invocation time
always witnesses linearizability. tests/test_linearizability.py
cross-checks the two engines on random small histories.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.rsm import HistoryEntry
from repro_torch.verify.history import by_object

DEFAULT_MAX_STATES = 200_000
# above this many ops, unique-write objects use the reign decomposition
# (the W&G memo set alone would dwarf the history); below it, W&G is
# exact, fast, and exercises the general engine
SEARCH_MAX_OPS = 48


class SearchBudget(Exception):
    """Raised when the linearization search exceeds its state budget —
    the verdict is *undecided*, never treated as a pass."""


def _quick_reject(obj: int, entries: Sequence[HistoryEntry]
                  ) -> Tuple[bool, str]:
    """Cheap necessary conditions with sharp diagnostics (any search
    would also fail these, slowly and vaguely). With duplicate write
    values any of the writes may have served a read, so the future-read
    check compares against the EARLIEST invoke among them."""
    writes: dict = {}
    for h in entries:
        if h.kind == "w":
            w = writes.get(h.value)
            if w is None or h.invoke < w.invoke:
                writes[h.value] = h
    for r in entries:
        if r.kind != "r" or r.value is None:
            continue
        w = writes.get(r.value)
        if w is None:
            return False, (f"object {obj:#x}: read {r.op_id} returned "
                           f"{r.value}, which no committed write wrote")
        if r.response < w.invoke:
            return False, (f"object {obj:#x}: read {r.op_id} returned the "
                           f"value of write {w.op_id}, which was invoked "
                           f"only after the read completed")
    return True, "ok"


# ---------------------------------------------------------------------------
# Reign decomposition (unique write values)
# ---------------------------------------------------------------------------

def _check_unique_writes(obj: int, entries: Sequence[HistoryEntry]
                         ) -> Tuple[bool, str]:
    """Polynomial check when the read mapping is known (unique writes).
    ``_quick_reject`` must have passed already (reads map to real writes
    and never complete before their write invokes)."""
    # reigns: write value -> [ops]; None key = the virtual initial reign
    reigns: Dict[object, List[HistoryEntry]] = {}
    for h in entries:
        key = h.value if (h.kind == "w" or h.value is not None) else None
        reigns.setdefault(key, []).append(h)
    initial = reigns.pop(None, [])
    if initial:
        mi0 = max(h.invoke for h in initial)
        for key, ops in reigns.items():
            mr = min(h.response for h in ops)
            if mr < mi0:
                return False, (
                    f"object {obj:#x}: a read of the initial state invoked "
                    f"after ops of value {key} completed (stale None read)")
    if len(reigns) > 1:
        keys = list(reigns)
        mr = np.array([min(h.response for h in reigns[k]) for k in keys])
        mi = np.array([max(h.invoke for h in reigns[k]) for k in keys])
        # 2-cycle scan: reign i must precede j iff mr[i] < mi[j]; a
        # mutual pair admits no block order (longer cycles collapse to
        # this case — see module docstring)
        bad = (mr[:, None] < mi[None, :]) & (mr[None, :] < mi[:, None])
        np.fill_diagonal(bad, False)
        if bad.any():
            i, j = map(int, np.argwhere(bad)[0])
            return False, (
                f"object {obj:#x}: values {keys[i]} and {keys[j]} must "
                f"each precede the other (real-time order cycle across "
                f"their reads)")
    return True, "ok"


# ---------------------------------------------------------------------------
# Wing & Gong search (general: duplicate write values, arbitrary reads)
# ---------------------------------------------------------------------------

def _search(obj: int, seg: List[HistoryEntry], budget: List[int],
            max_states: int) -> bool:
    """Find-first Wing & Gong DFS over one object's history (sorted by
    invoke). Candidate order: matching reads before writes, earliest
    response first — reads never hurt (they free a slot without moving
    the state), so they are consumed greedily."""
    n = len(seg)
    full = (1 << n) - 1
    invoke = [h.invoke for h in seg]
    resp = [h.response for h in seg]
    is_write = [h.kind == "w" for h in seg]
    value = [h.value for h in seg]
    by_resp = sorted(range(n), key=lambda i: resp[i], reverse=True)
    seen: Set[Tuple[int, object]] = set()
    stack: List[Tuple[int, object]] = [(0, None)]
    while stack:
        mask, state = stack.pop()
        if mask == full:
            return True
        key = (mask, state)
        if key in seen:
            continue
        seen.add(key)
        budget[0] += 1
        if budget[0] > max_states:
            raise SearchBudget(
                f"object {obj:#x}: linearization search exceeded "
                f"{max_states} states ({n} ops)")
        mr = min(resp[i] for i in range(n) if not (mask >> i) & 1)
        reads = []
        # pushed latest-response first => popped earliest-response first
        for i in by_resp:
            if (mask >> i) & 1 or invoke[i] > mr:
                continue
            if is_write[i]:
                stack.append((mask | (1 << i), value[i]))
            elif value[i] == state:
                reads.append((mask | (1 << i), state))
        stack.extend(reads)
    return False


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def check_object_linearizable(obj: int, entries: Sequence[HistoryEntry],
                              max_states: int = DEFAULT_MAX_STATES
                              ) -> Tuple[bool, str]:
    """Check one object's committed history against the register model."""
    ordered = sorted(entries, key=lambda h: (h.invoke, h.response, h.op_id))
    if all(h.kind == "w" for h in ordered):
        return True, "ok (write-only: invoke order is a witness)"
    ok, why = _quick_reject(obj, ordered)
    if not ok:
        return False, why
    writes = [h.value for h in ordered if h.kind == "w"]
    # the reign decomposition needs an unambiguous read mapping: all
    # write values distinct AND none equal to the initial-state marker
    # (a None-valued write would alias the virtual initial reign)
    if (len(ordered) > SEARCH_MAX_OPS
            and len(set(writes)) == len(writes) and None not in writes):
        return _check_unique_writes(obj, ordered)
    budget = [0]
    if not _search(obj, ordered, budget, max_states):
        ids = [h.op_id for h in ordered[:6]]
        return False, (f"object {obj:#x}: ops {ids}... admit no "
                       f"linearization (register model, {len(ordered)} ops)")
    return True, "ok"


def check_history_linearizable(history: Sequence[HistoryEntry],
                               max_states: int = DEFAULT_MAX_STATES
                               ) -> Tuple[bool, str]:
    """Check a whole run history: every per-object piece must linearize.

    Returns ``(ok, reason)``; raises :class:`SearchBudget` if an object
    blows the search budget (undecided — never a silent pass).
    """
    n_ops = 0
    for obj, entries in by_object(history).items():
        ok, why = check_object_linearizable(obj, entries, max_states)
        if not ok:
            return False, why
        n_ops += len(entries)
    return True, f"ok ({n_ops} ops linearizable per object)"
