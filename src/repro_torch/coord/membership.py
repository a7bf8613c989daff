"""Cluster membership for the training runtime: heartbeat failure
detection, rank-order leader election, elastic resize proposals (a Python
copy of ``repro.coord.membership``).

The same failure-detector design as the protocol core (BaseReplica), run
at host granularity with an injectable clock so tests drive it
deterministically. A membership change produces a new *epoch*: the
launcher reacts by rebuilding the mesh (mesh shape is a config, not a
constant) and restoring from the last committed checkpoint — elastic
scaling is checkpoint-restart with a different (dp, tp) factorization,
which the logical-name checkpoint layer supports across topologies.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class MemberView:
    epoch: int
    alive: List[int]
    leader: int
    mesh_proposal: Dict[str, int]


class Membership:
    def __init__(self, n_hosts: int, *, hb_timeout: float = 30.0,
                 clock: Optional[Callable[[], float]] = None,
                 tp_size: int = 16):
        self.n = n_hosts
        self.hb_timeout = hb_timeout
        self.clock = clock or (lambda: 0.0)
        self.tp = tp_size
        self.last_hb = {i: self.clock() for i in range(n_hosts)}
        self.epoch = 0
        self._last_alive = list(range(n_hosts))

    def heartbeat(self, host: int) -> None:
        self.last_hb[host] = self.clock()

    def alive(self) -> List[int]:
        now = self.clock()
        return [h for h in range(self.n)
                if now - self.last_hb[h] <= self.hb_timeout]

    def leader(self) -> int:
        a = self.alive()
        return a[0] if a else 0

    def view(self) -> MemberView:
        a = self.alive()
        if a != self._last_alive:
            self.epoch += 1
            self._last_alive = a
        # elastic proposal: biggest dp that the surviving hosts support
        # (tp stays fixed: it is wired by ICI within a host/pod slice)
        dp = max(1, len(a))
        return MemberView(epoch=self.epoch, alive=a, leader=self.leader(),
                          mesh_proposal={"data": dp, "model": self.tp})
