"""Declarative fault schedules (the nemesis vocabulary).

A fault schedule is a sequence of timed, declarative events — crash a
replica, partition a set of replicas away from the rest, inflate a
replica's network delays — that :func:`compile_schedule` lowers onto the
deterministic event engine (``EventEngine.crash/recover/cut_links/
restore_links/set_degrade``). Because the lowered faults are ordinary
heap events, a schedule is part of the simulation's deterministic event
stream: same seed + same schedule gives bit-identical runs.

Node references are either explicit global replica ids or symbolic
selectors. Symbolic selectors are *live*: they are lowered as deferred
events (``EventEngine.schedule_dynamic``) and resolve when the fault
fires, against the weight view installed at that moment
(``engine.weight_view`` — updated by the reassignment subsystem's
epoch installs). With no installed view the ranking is the static seed
ordering (the simulator's ``speed()`` is non-decreasing in id, so id 0
is the fastest — and top-weighted — replica, and the initial leader of
the leader-based protocols), and the deferred event applies the exact
same effects at the exact same heap position as the old eager
lowering:

  * ``"leader"`` / ``"top_weight"`` — head of the current ranking
  * ``"low_weight"``                — tail of the current ranking
  * ``"median"``                    — middle of the current ranking

In sharded runs symbolic selectors resolve inside group 0's id block
(group g's replicas occupy ``[g*group_size, (g+1)*group_size)``); use
explicit ids to target other groups.

Partition semantics: links are cut between the ``side`` set and every
*other replica* — clients stay connected to everyone (paper-style
clients fail over by retrying elsewhere; a partition models a backbone
cut, not client loss). ``symmetric=False`` cuts only the inbound
direction: the side can still send (its heartbeats keep arriving, so
peers do not suspect it) but receives nothing from the rest — the
adversarial "deaf coordinator" regime for heartbeat-rank election.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

NodeRef = Union[int, str]

_SYMBOLIC = ("leader", "top_weight", "low_weight", "median")


def resolve_node(ref: NodeRef, n_replicas: int) -> int:
    """Resolve a node reference to a replica id in ``[0, n_replicas)``
    (sharded runs resolve symbolic refs against the group size — see
    ``compile_schedule``'s ``symbolic_n``)."""
    if isinstance(ref, str):
        if ref in ("leader", "top_weight"):
            return 0
        if ref == "low_weight":
            return n_replicas - 1
        if ref == "median":
            return n_replicas // 2
        raise ValueError(f"unknown node selector {ref!r} "
                         f"(expected one of {_SYMBOLIC} or an int)")
    node = int(ref)
    if not 0 <= node < n_replicas:
        raise ValueError(f"node id {node} out of range [0, {n_replicas})")
    return node


@dataclasses.dataclass(frozen=True)
class Crash:
    """Fail-stop ``node`` at time ``at`` (messages to/from it vanish,
    its timers stop). Pair with :class:`Recover` for crash-recovery."""
    at: float
    node: NodeRef = "leader"


@dataclasses.dataclass(frozen=True)
class Recover:
    """Restart ``node`` at ``at``: volatile state is wiped and the
    replica pulls a state-transfer snapshot before rejoining
    (``BaseReplica.on_recover``)."""
    at: float
    node: NodeRef = "leader"


@dataclasses.dataclass(frozen=True)
class Partition:
    """Cut replica links between ``side`` and the remaining replicas at
    ``at``. ``symmetric=False`` cuts only links INTO the side (deaf but
    still heard). Heal with :class:`Heal`."""
    at: float
    side: Tuple[NodeRef, ...] = ("leader",)
    symmetric: bool = True


@dataclasses.dataclass(frozen=True)
class Heal:
    """Restore every cut link at ``at`` (partitions only; crashed nodes
    need :class:`Recover`, degraded nodes a ``factor=1`` Degrade)."""
    at: float


@dataclasses.dataclass(frozen=True)
class Degrade:
    """Multiply one-way network delays to/from ``node`` by ``factor``
    from ``at`` on (``factor=1.0`` heals). Degrading the top-weight
    replica is the regime where dynamic re-ranking must shift quorum
    weight away from it."""
    at: float
    node: NodeRef = "top_weight"
    factor: float = 8.0


FaultEvent = Union[Crash, Recover, Partition, Heal, Degrade]


def _live_resolve(engine, ref: NodeRef, sn: int) -> int:
    """Resolve a symbolic selector against the weight view in force when
    a deferred fault fires. No installed view (epoch 0, or none covering
    the symbolic block) falls back to the static seed ranking."""
    epoch, ranking = getattr(engine, "weight_view", (0, None))
    if ranking is not None:
        block = [r for r in ranking if r < sn]
        if block:
            if ref in ("leader", "top_weight"):
                return block[0]
            if ref == "low_weight":
                return block[-1]
            if ref == "median":
                return block[len(block) // 2]
    return resolve_node(ref, sn)


def _dyn_crash(ref: NodeRef, sn: int):
    # effects mirror the engine's _CRASH branch exactly (same trace
    # annotation), so a deferred crash at an unchanged seed ranking is
    # bit-identical to the old eager lowering
    def apply(engine, t):
        node = _live_resolve(engine, ref, sn)
        engine.crashed.add(node)
        tr = engine.tracer
        if tr is not None:
            tr.ev("fault", t, node, "crash", 0.0)
    return apply


def _dyn_recover(ref: NodeRef, sn: int):
    def apply(engine, t):
        node = _live_resolve(engine, ref, sn)
        engine.crashed.discard(node)
        engine._busy[node] = t
        tr = engine.tracer
        if tr is not None:
            tr.ev("fault", t, node, "recover", 0.0)
        hook = getattr(engine.nodes.get(node), "on_recover", None)
        if hook is not None:
            hook(t)
    return apply


def _dyn_partition(side_refs: Tuple[NodeRef, ...], symmetric: bool,
                   n: int, sn: int):
    def apply(engine, t):
        side = {(_live_resolve(engine, r, sn) if isinstance(r, str)
                 else resolve_node(r, n)) for r in side_refs}
        if not side or len(side) >= n:
            raise ValueError(f"partition side {side_refs!r} must be a "
                             f"proper non-empty subset of {n} replicas")
        rest = [r for r in range(n) if r not in side]
        pairs = [(o, s) for o in rest for s in side]
        if symmetric:
            pairs += [(s, o) for s in side for o in rest]
        keys = frozenset((s << 24) | d for s, d in pairs)
        engine._apply_fault("cut", keys)
        tr = engine.tracer
        if tr is not None:
            tr.ev("fault", t, -1, "cut", float(len(keys)))
    return apply


def _dyn_degrade(ref: NodeRef, factor: float, sn: int):
    def apply(engine, t):
        # heal/degrade pairing: a factor=1.0 heal must target the node
        # this selector previously degraded, not re-resolve against the
        # live view — a reassignment install between onset and heal
        # re-ranks "top_weight" onto a healthy node, and healing that
        # one would leave the degraded replica degraded forever
        ledger = getattr(engine, "_dyn_degraded", None)
        if ledger is None:
            ledger = engine._dyn_degraded = {}
        if factor == 1.0 and (ref, sn) in ledger:
            node = ledger.pop((ref, sn))
        else:
            node = _live_resolve(engine, ref, sn)
            if factor != 1.0:
                ledger[(ref, sn)] = node
        engine._apply_fault("degrade", (node, factor))
        tr = engine.tracer
        if tr is not None:
            tr.ev("fault", t, node, "degrade",
                  float(factor if factor is not None else 1.0))
    return apply


def compile_schedule(engine, events: Sequence[FaultEvent],
                     n_replicas: int | None = None,
                     symbolic_n: int | None = None) -> None:
    """Lower a declarative schedule onto an event engine. ``n_replicas``
    bounds the replica id space (defaults to ``engine.n``);
    ``symbolic_n`` is the id block symbolic selectors resolve inside
    (sharded runs pass the group size so ``"leader"`` means group 0's
    leader; defaults to ``n_replicas``).

    Events naming symbolic selectors are lowered as deferred thunks that
    re-resolve against the live weight view when they fire; events with
    explicit ids (and :class:`Heal`) are lowered eagerly. Both take the
    same heap slot (seq is allocated here either way), so schedules are
    bit-identical to the old eager lowering whenever no weight view is
    installed by fire time."""
    n = n_replicas if n_replicas is not None else engine.n
    sn = symbolic_n if symbolic_n is not None else n

    def res(ref: NodeRef) -> int:
        return resolve_node(ref, sn if isinstance(ref, str) else n)

    for ev in events:
        if isinstance(ev, Crash):
            if isinstance(ev.node, str):
                res(ev.node)                # validate the selector now
                engine.schedule_dynamic(ev.at, _dyn_crash(ev.node, sn))
            else:
                engine.crash(res(ev.node), ev.at)
        elif isinstance(ev, Recover):
            if isinstance(ev.node, str):
                res(ev.node)
                engine.schedule_dynamic(ev.at, _dyn_recover(ev.node, sn))
            else:
                engine.recover(res(ev.node), ev.at)
        elif isinstance(ev, Partition):
            if any(isinstance(r, str) for r in ev.side):
                for r in ev.side:
                    res(r)
                engine.schedule_dynamic(
                    ev.at, _dyn_partition(tuple(ev.side), ev.symmetric,
                                          n, sn))
                continue
            side = {res(r) for r in ev.side}
            if not side or len(side) >= n:
                raise ValueError(f"partition side {ev.side!r} must be a "
                                 f"proper non-empty subset of {n} replicas")
            rest = [r for r in range(n) if r not in side]
            pairs = [(o, s) for o in rest for s in side]
            if ev.symmetric:
                pairs += [(s, o) for s in side for o in rest]
            engine.cut_links(pairs, ev.at)
        elif isinstance(ev, Heal):
            engine.restore_links(None, ev.at)
        elif isinstance(ev, Degrade):
            if isinstance(ev.node, str):
                res(ev.node)
                engine.schedule_dynamic(
                    ev.at, _dyn_degrade(ev.node, ev.factor, sn))
            else:
                engine.set_degrade(res(ev.node), ev.factor, ev.at)
        else:
            raise TypeError(f"not a fault event: {ev!r}")


# ---------------------------------------------------------------------------
# Preset schedules (the scenarios the paper's heterogeneity story cares about)
# ---------------------------------------------------------------------------

def leader_crash(at: float = 0.1,
                 recover_at: float | None = None) -> Tuple[FaultEvent, ...]:
    """Crash the initial leader / top-weight replica (optionally recover)."""
    events: Tuple[FaultEvent, ...] = (Crash(at, "leader"),)
    if recover_at is not None:
        events += (Recover(recover_at, "leader"),)
    return events


def rolling_crashes(start: float = 0.1, gap: float = 0.2,
                    down: float = 0.15,
                    nodes: Sequence[NodeRef] = (1, 2)) -> Tuple[FaultEvent, ...]:
    """Crash ``nodes`` one at a time, each recovering before the next
    falls — the rolling-restart regime (never two down at once when
    ``gap >= down``)."""
    events: list[FaultEvent] = []
    t = start
    for node in nodes:
        events.append(Crash(t, node))
        events.append(Recover(t + down, node))
        t += gap
    return tuple(events)


def asym_partition(at: float = 0.1, heal_at: float = 0.3,
                   side: Tuple[NodeRef, ...] = ("leader",)
                   ) -> Tuple[FaultEvent, ...]:
    """Deaf-side partition: ``side`` keeps sending (peers still see its
    heartbeats) but receives nothing from other replicas until heal."""
    return (Partition(at, side, symmetric=False), Heal(heal_at))


def sym_partition(at: float = 0.1, heal_at: float = 0.3,
                  side: Tuple[NodeRef, ...] = ("leader",)
                  ) -> Tuple[FaultEvent, ...]:
    """Full bidirectional partition of ``side`` until heal."""
    return (Partition(at, side, symmetric=True), Heal(heal_at))


def degrade_top(at: float = 0.1, heal_at: float = 0.4,
                factor: float = 8.0) -> Tuple[FaultEvent, ...]:
    """Degrade the top-weight replica's network by ``factor``, then heal
    — the weight-reassignment stress: quorum weight must migrate off the
    degraded node and back."""
    return (Degrade(at, "top_weight", factor),
            Degrade(heal_at, "top_weight", 1.0))


def flap(node: NodeRef = 0, at: float = 0.1, period: float = 0.1,
         count: int = 3, factor: float = 8.0) -> Tuple[FaultEvent, ...]:
    """Degrade/heal oscillation: ``count`` cycles of a half-period
    degraded, half-period healed ``node`` — the reassignment-churn
    stress where the exponential install backoff must keep the weight
    view from thrashing. The default targets explicit replica 0 (the
    seed top-weight node) rather than the live ``"top_weight"``
    selector, so the flapping node keeps flapping even after a view
    install demotes it."""
    events: list[FaultEvent] = []
    t = at
    for _ in range(max(1, count)):
        events.append(Degrade(t, node, factor))
        events.append(Degrade(t + period / 2.0, node, 1.0))
        t += period
    return tuple(events)
