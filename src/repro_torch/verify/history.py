"""Client invoke/response history capture.

A history is the client-observable record of a run: one
:class:`~repro_torch.core.rsm.HistoryEntry` per committed operation with its
invocation time (client submit), response time (commit stamp — the
earliest point the operation's effect is decided, which is *earlier*
than the client's ack and therefore strictly harder on the checker:
shrinking intervals can only forbid linearizations, never admit new
ones), the written value, and for reads the value returned at the
serialization point.

Capture is deterministic given seed + fault schedule, so the captured
history participates in the determinism contract (unlike wall-clock
telemetry).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Sequence

from repro_torch.core.rsm import HistoryEntry, history_from_ops
from repro_torch.core.simulator import Op


def capture_history(clients: Iterable) -> List[HistoryEntry]:
    """Build the run history from client-side op records, in a canonical
    order (invoke time, then op id) so equal runs give equal lists."""
    ops: List[Op] = [op for c in clients for op in c.ops]
    hist = history_from_ops(ops)
    hist.sort(key=lambda h: (h.invoke, h.op_id))
    return hist


def by_object(history: Sequence[HistoryEntry]
              ) -> Dict[int, List[HistoryEntry]]:
    """Decompose a history per object (ops are single-object, so the
    full history is linearizable iff every per-object one is)."""
    out: Dict[int, List[HistoryEntry]] = defaultdict(list)
    for h in history:
        out[h.obj].append(h)
    return out
