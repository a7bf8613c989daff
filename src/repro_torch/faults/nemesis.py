"""Seeded nemesis: a deterministic adversary that draws fault schedules.

``Nemesis(seed)`` generates random-but-reproducible declarative
schedules for the property sweep (random small workloads x random fault
schedules must stay linearizable). Episodes are sequential — each fault
is healed/recovered before the next begins — and every episode keeps a
replica majority alive and mutually connected, so liveness (all ops
eventually commit once the schedule drains) is preserved by
construction; the *safety* of what happened during the disruption is
what the linearizability checker then verifies.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repro_torch.faults.schedule import (Crash, Degrade, FaultEvent, Heal,
                                   Partition, Recover)

KINDS = ("crash", "partition", "asym_partition", "degrade")


class Nemesis:
    """Deterministic fault-schedule generator (numpy PCG64 stream)."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = np.random.default_rng(0xFA_0175 ^ (seed << 1))

    def random_schedule(self, n_replicas: int, *,
                        episodes: int | None = None,
                        start: float = 0.05,
                        duration: Tuple[float, float] = (0.08, 0.2),
                        gap: Tuple[float, float] = (0.05, 0.15),
                        kinds: Sequence[str] = KINDS
                        ) -> Tuple[FaultEvent, ...]:
        """Draw a schedule of 1-3 sequential fault episodes.

        Each episode picks a kind from ``kinds`` and a victim replica,
        holds the fault for a duration drawn from ``duration``, heals
        it, then idles for a ``gap`` before the next episode. Victims of
        crash/partition episodes are single replicas (minority by
        construction for n >= 3).
        """
        if n_replicas < 3:
            raise ValueError("nemesis schedules need n_replicas >= 3")
        rng = self.rng
        k = int(episodes) if episodes is not None \
            else int(rng.integers(1, 4))
        events: list[FaultEvent] = []
        t = start
        for _ in range(k):
            kind = kinds[int(rng.integers(0, len(kinds)))]
            node = int(rng.integers(0, n_replicas))
            dur = float(rng.uniform(*duration))
            if kind == "crash":
                events += [Crash(t, node), Recover(t + dur, node)]
            elif kind == "partition":
                events += [Partition(t, (node,), symmetric=True),
                           Heal(t + dur)]
            elif kind == "asym_partition":
                events += [Partition(t, (node,), symmetric=False),
                           Heal(t + dur)]
            elif kind == "degrade":
                factor = float(rng.uniform(3.0, 12.0))
                events += [Degrade(t, node, factor),
                           Degrade(t + dur, node, 1.0)]
            else:
                raise ValueError(f"unknown fault kind {kind!r}")
            t += dur + float(rng.uniform(*gap))
        return tuple(events)


def schedule_end(events: Sequence[FaultEvent]) -> float:
    """Time at which the last fault event lands (fault-free from then on,
    aside from whatever damage is still being repaired)."""
    return max((ev.at for ev in events), default=0.0)


def fault_times(events: Sequence[FaultEvent]) -> list[float]:
    """Onset times of disruptive events (crash/partition/degrade != 1),
    the anchors recovery telemetry measures dips against."""
    out = []
    for ev in events:
        if isinstance(ev, (Crash, Partition)):
            out.append(ev.at)
        elif isinstance(ev, Degrade) and ev.factor != 1.0:
            out.append(ev.at)
    return sorted(out)
