"""Protocol registry: replica classes + capability metadata.

Replaces the hand-maintained ``PROTOCOLS`` dict and ``LEADER_BASED``
string set that used to live in :mod:`repro_torch.core.runner`. Every consumer
that needs to know *something about a protocol* — which replica a client
should contact (``client_target_fn``), whether a protocol can sit behind
the shard gate, whether its read path is verified linearizable — asks
the registry for a :class:`ProtocolInfo` instead of testing the name
against a string set. Adding a protocol is one :func:`register_protocol`
call carrying its metadata; nothing else in the tree needs editing.

The built-in entries are registered at import time. ``paxos`` is
Cabinet with flat (uniform) weights — the same replica class under a
different registry name (the old ``repro_torch.core.paxos`` re-export stub is
gone; the registry entry IS the indirection now).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Type


@dataclasses.dataclass(frozen=True)
class ProtocolInfo:
    """A consensus protocol and what the harness may assume about it.

    * ``leader_based`` — clients must contact the group's single
      (initial) leader; False means any replica can coordinate and
      clients round-robin (this is what ``client_target_fn`` consults).
    * ``supports_sharding`` — the replica class works behind the shard
      gate (``make_sharded_replica``); scenario validation fails fast on
      ``n_groups > 1`` with a protocol that does not.
    * ``reads`` — status of the read path: ``"linearizable"`` (reads go
      through consensus and verify), or ``"unverified"`` (write-path
      only is verified; benches/verification restrict such protocols to
      write-only workloads — EPaxos's arrival-order commit
      simplification).
    * ``lease_reads`` — the replica class honors ``Scenario.leases``
      (repro_torch.core.leases): linearizable local reads under weighted
      object leases (or a promise-based leader lease for leader-based
      protocols). Scenario validation rejects ``leases`` on protocols
      without it.
    * ``reassign`` — the replica class honors ``Scenario.reassign``
      (repro_torch.core.reassign): online weight reassignment under churn.
      Meaningful only for geometric-weight protocols anchored on the
      shared slow-path leader; validation rejects the knob elsewhere
      (paxos runs flat weights by definition, epaxos has no leader
      anchor to fence an install on).
    * ``coding`` — the replica class honors ``Scenario.coding``
      (repro_torch.coding): adaptive Crossword-style payload striping with
      the weighted-reconstructable commit gate. Requires the dual-path
      batch commit machinery (fastpath/slowpath hooks), so only WOC
      carries it; validation rejects the knob elsewhere.
    """

    name: str
    factory: Type
    leader_based: bool = False
    supports_sharding: bool = True
    reads: str = "linearizable"
    lease_reads: bool = False
    reassign: bool = False
    coding: bool = False
    description: str = ""


_REGISTRY: Dict[str, ProtocolInfo] = {}


def register_protocol(info: ProtocolInfo) -> ProtocolInfo:
    """Register (or replace) a protocol. Returns ``info`` so plugin
    modules can ``INFO = register_protocol(ProtocolInfo(...))``."""
    _REGISTRY[info.name] = info
    return info


def protocol_info(name: str) -> ProtocolInfo:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown protocol {name!r} (registered: "
            f"{sorted(_REGISTRY)}); add one with "
            f"repro_torch.scenario.register_protocol") from None


def protocol_class(name: str) -> Type:
    return protocol_info(name).factory


def protocol_names() -> list:
    return sorted(_REGISTRY)


def protocols_with(**caps) -> list:
    """Names of registered protocols whose metadata matches every given
    capability (e.g. ``protocols_with(leader_based=False)``). Benches use
    this instead of hard-coding protocol lists."""
    out = []
    for name in sorted(_REGISTRY):
        info = _REGISTRY[name]
        if all(getattr(info, k) == v for k, v in caps.items()):
            out.append(name)
    return out


def _register_builtins() -> None:
    from repro_torch.core.cabinet import CabinetReplica, PaxosReplica
    from repro_torch.core.epaxos import EPaxosReplica
    from repro_torch.core.woc import WocReplica

    register_protocol(ProtocolInfo(
        "woc", WocReplica, leader_based=False, supports_sharding=True,
        reads="linearizable", lease_reads=True, reassign=True,
        coding=True,
        description="dual-path weighted object consensus (the paper)"))
    register_protocol(ProtocolInfo(
        "cabinet", CabinetReplica, leader_based=True, supports_sharding=True,
        reads="linearizable", lease_reads=True, reassign=True,
        description="weighted single-leader consensus (paper baseline)"))
    register_protocol(ProtocolInfo(
        "paxos", PaxosReplica, leader_based=True, supports_sharding=True,
        reads="linearizable", lease_reads=True,
        description="classic majority MultiPaxos (Cabinet with flat "
                    "weights)"))
    register_protocol(ProtocolInfo(
        "epaxos", EPaxosReplica, leader_based=False, supports_sharding=True,
        reads="unverified",
        description="leaderless dependency-tracking consensus "
                    "(write path verified; reads unverified)"))


_register_builtins()
