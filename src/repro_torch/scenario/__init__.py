"""Unified Scenario API: one declarative spec for cluster, workload,
faults, sharding, and verification.

  * spec      — :class:`Scenario` (+ ``Sharding``/``Verification``):
                validated construction, dict/JSON round-trip, legacy
                RunConfig/ShardedRunConfig conversion
  * registry  — protocol registry with capability metadata
                (leader-based?, supports-sharding?, read path) replacing
                the old PROTOCOLS dict + LEADER_BASED string set
  * workloads — workload generator registry (paper mix, zipf,
                hotspot-drift, bursty) behind the
                sample_object/sample_kind contract
  * build     — :func:`run_scenario`, the single entrypoint subsuming
                ``run(RunConfig)`` and ``run_sharded(ShardedRunConfig)``

``build`` is imported lazily (module ``__getattr__``): the legacy
runner modules import the registry at load time, and an eager import
here would cycle back into them.
"""

from repro_torch.scenario.registry import (ProtocolInfo, protocol_class,
                                     protocol_info, protocol_names,
                                     protocols_with, register_protocol)
from repro_torch.scenario.spec import (Coding, Leases, Observability, Reassign,
                                 Scenario, Sharding, Verification,
                                 fault_from_dict, fault_to_dict)
from repro_torch.scenario.workloads import (BurstyWorkload, HotspotDriftWorkload,
                                      ValueSizesWorkload, ZipfWorkload,
                                      make_workload, register_workload,
                                      workload_kinds, workload_ref)

__all__ = ["Scenario", "Sharding", "Verification", "Observability",
           "Leases", "Reassign", "Coding",
           "run_scenario",
           "ProtocolInfo", "register_protocol", "protocol_info",
           "protocol_class", "protocol_names", "protocols_with",
           "register_workload", "make_workload", "workload_ref",
           "workload_kinds", "ZipfWorkload", "HotspotDriftWorkload",
           "BurstyWorkload", "ValueSizesWorkload",
           "fault_to_dict", "fault_from_dict"]


def __getattr__(name):
    if name in ("run_scenario", "lower_sharded"):
        from repro_torch.scenario import build
        return getattr(build, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
