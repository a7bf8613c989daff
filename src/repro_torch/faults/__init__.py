"""Deterministic fault injection (nemesis) for the cluster simulator.

Declarative schedules (:mod:`repro_torch.faults.schedule`) lower onto engine
events via :func:`compile_schedule`; :class:`Nemesis` draws seeded
random schedules for property sweeps. Verification of the histories
these runs produce lives in :mod:`repro_torch.verify`.
"""

from repro_torch.faults.nemesis import (Nemesis, fault_times,  # noqa: F401
                                  schedule_end)
from repro_torch.faults.schedule import (Crash, Degrade, FaultEvent,  # noqa: F401
                                   Heal, Partition, Recover,
                                   asym_partition, compile_schedule,
                                   degrade_top, flap, leader_crash,
                                   resolve_node, rolling_crashes,
                                   sym_partition)

__all__ = [
    "Crash", "Recover", "Partition", "Heal", "Degrade", "FaultEvent",
    "compile_schedule", "resolve_node", "leader_crash", "rolling_crashes",
    "asym_partition", "sym_partition", "degrade_top", "flap",
    "Nemesis", "schedule_end", "fault_times",
]
