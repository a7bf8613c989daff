"""Legacy experiment surface: ``RunConfig`` + ``run()``.

Since the Scenario API landed, this module is a thin compatibility
layer: ``run(cfg)`` lowers the config onto a declarative
:class:`repro_torch.scenario.Scenario` and hands it to ``run_scenario`` — the
single construction path shared with the sharded runner. New code
should build Scenarios directly (see repro_torch.scenario); this surface stays
because a decade of tests, benches and muscle memory spell 5-replica
experiments as ``run(RunConfig(...))``.

Protocol lookup lives in :mod:`repro_torch.scenario.registry` (capability
metadata instead of string sets). ``PROTOCOLS`` and ``LEADER_BASED``
below are import-compatible *live views* over the registry for old call
sites (late-registered protocols appear; every access warns); consult
the registry in anything new.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections.abc import Mapping, Set
from typing import List, Optional, Sequence

from repro_torch.core.protocol_base import BaseReplica
from repro_torch.core.simulator import (Client, CostModel, RunResult, Simulation,
                                  Workload)
from repro_torch.scenario.registry import (protocol_class, protocol_info,
                                     protocol_names, protocols_with)


def _deprecated(name: str) -> None:
    warnings.warn(
        f"repro_torch.core.runner.{name} is deprecated; consult "
        f"repro_torch.scenario.registry (protocol_class / protocol_info / "
        f"protocols_with) instead", DeprecationWarning, stacklevel=4)


class _LiveProtocols(Mapping):
    """Deprecated compatibility surface for the old ``PROTOCOLS`` dict.

    A live view over :mod:`repro_torch.scenario.registry` — unlike the
    import-time snapshot it replaces, protocols registered after this
    module imports DO appear. Every access emits a DeprecationWarning."""

    def __getitem__(self, name):
        _deprecated("PROTOCOLS")
        return protocol_class(name)

    def __iter__(self):
        _deprecated("PROTOCOLS")
        return iter(protocol_names())

    def __len__(self):
        return len(protocol_names())

    def __repr__(self):
        return (f"<deprecated live view of the protocol registry: "
                f"{protocol_names()}>")


class _LiveLeaderBased(Set):
    """Deprecated compatibility surface for the old ``LEADER_BASED``
    string set — a live registry view (see :class:`_LiveProtocols`)."""

    def _members(self):
        return protocols_with(leader_based=True)

    def __contains__(self, name):
        _deprecated("LEADER_BASED")
        return name in self._members()

    def __iter__(self):
        _deprecated("LEADER_BASED")
        return iter(self._members())

    def __len__(self):
        return len(self._members())

    def __repr__(self):
        return (f"<deprecated live view of leader-based protocols: "
                f"{self._members()}>")


PROTOCOLS = _LiveProtocols()
LEADER_BASED = _LiveLeaderBased()


def client_target_fn(protocol: str, ci: int, n: int, offset: int = 0):
    """Replica-choice policy for client ``ci`` over a group of ``n``
    replicas whose ids start at ``offset``. Protocols whose registry
    capability says ``leader_based`` pin the group's initial leader; the
    rest round-robin. Shared with the sharded runner (src/repro_torch/shard),
    where ``offset`` selects the owning group's id block."""
    if protocol_info(protocol).leader_based:
        return lambda k: offset                       # initial leader
    return lambda k, ci=ci: offset + (ci + k) % n     # round-robin


@dataclasses.dataclass
class RunConfig:
    protocol: str = "woc"
    n_replicas: int = 5
    n_clients: int = 2
    batch_size: int = 10
    max_inflight: int = 5               # paper §5.1
    total_ops: int = 40_000             # across all clients
    t_fail: int = 1
    workload: Workload = dataclasses.field(default_factory=Workload)
    costs: CostModel = dataclasses.field(default_factory=CostModel)
    seed: int = 0
    # deprecated: folded into the declarative fault schedule by the
    # Scenario converter (Crash/Recover events targeting replica 0)
    crash_at: Optional[float] = None
    recover_at: Optional[float] = None
    sim_time_cap: float = 300.0
    # declarative fault schedule (repro_torch.faults events), compiled onto the
    # engine before the run; implies history capture so the run can be
    # verified (repro_torch.verify)
    faults: Sequence = ()
    capture_history: bool = False


@dataclasses.dataclass
class RunArtifacts:
    result: RunResult
    sim: Simulation
    replicas: List[BaseReplica]
    clients: List[Client]


def run(cfg: RunConfig) -> RunArtifacts:
    # lazy: repro_torch.scenario.build imports this module's names
    from repro_torch.scenario.build import run_scenario
    from repro_torch.scenario.spec import Scenario
    return run_scenario(Scenario.from_run_config(cfg))
