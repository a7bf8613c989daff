"""ShardMap: object-space partitioning with ownership epochs.

Every object has a *default* group given by a stable hash partition of the
object id. Ownership can move (WPaxos-style object stealing): a transfer
bumps the object's ownership epoch and is recorded as an override on top
of the hash partition. Each consensus group keeps its own ShardMap view
(intra-group agreement on the map rides on the group's own consensus and
is abstracted as shared state here — see :mod:`repro_torch.shard.gate`), and
each client router keeps a cached view updated by NOT_OWNER redirects.

The custody chain is navigable without global state: the default-hash
group of an object always learns where it granted the object, so a stale
client contacting any past owner is redirected one hop closer to the
current owner.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Ownership:
    group: int
    epoch: int = 0


class ShardMap:
    """One view of the object -> consensus-group ownership mapping."""

    def __init__(self, n_groups: int, seed: int = 0):
        self.n_groups = n_groups
        self.seed = seed
        self._overrides: Dict[int, Ownership] = {}
        self._fenced: set[int] = set()   # objects mid-migration (owner view)
        self._hash_cache: Dict[int, int] = {}

    # -- default partition ---------------------------------------------------

    def default_group(self, obj: int) -> int:
        """Stable hash partition of the object space across groups."""
        g = self._hash_cache.get(obj)
        if g is None:
            h = hashlib.blake2b(
                np.array([self.seed, obj], dtype=np.int64).tobytes(),
                digest_size=8).digest()
            g = int.from_bytes(h, "little") % self.n_groups
            self._hash_cache[obj] = g
        return g

    # -- ownership -------------------------------------------------------------

    def owner(self, obj: int) -> Tuple[int, int]:
        """(owning group, ownership epoch) under this view."""
        rec = self._overrides.get(obj)
        if rec is not None:
            return rec.group, rec.epoch
        return self.default_group(obj), 0

    def epoch(self, obj: int) -> int:
        rec = self._overrides.get(obj)
        return rec.epoch if rec is not None else 0

    def record(self, obj: int, group: int, epoch: int) -> bool:
        """Learn that ``group`` owns ``obj`` at ``epoch``; stale news (an
        epoch at or below what this view already knows) is ignored."""
        cur = self._overrides.get(obj)
        if cur is not None and epoch <= cur.epoch:
            return False
        if cur is None and epoch <= 0:
            return False
        self._overrides[obj] = Ownership(group, epoch)
        return True

    # -- migration fencing (owner-side) ----------------------------------------

    def fence(self, obj: int) -> None:
        self._fenced.add(obj)

    def unfence(self, obj: int) -> None:
        self._fenced.discard(obj)

    def is_fenced(self, obj: int) -> bool:
        return obj in self._fenced

    # -- introspection ----------------------------------------------------------

    def overrides(self) -> Dict[int, Ownership]:
        return dict(self._overrides)


def resolve_owner(maps: Dict[int, ShardMap], obj: int,
                  max_hops: Optional[int] = None) -> Tuple[int, int]:
    """Follow the custody chain across per-group map views to the current
    owner of ``obj`` (used by tests/metrics; clients converge to the same
    answer one redirect at a time)."""
    if max_hops is None:
        max_hops = len(maps) + 2
    # start from the default-hash group's own view
    g0 = next(iter(maps.values())).default_group(obj)
    g, ep = maps[g0].owner(obj)
    for _ in range(max_hops):
        ng, nep = maps[g].owner(obj)
        if ng == g:
            return g, max(ep, nep)
        g, ep = ng, nep
    return g, ep
