"""Sharded multi-group WOC: object-space partitioning + object stealing.

Scales the reproduction past a single consensus group: G independent WOC
(or Cabinet/EPaxos/Paxos) groups own a hash-partitioned object space,
clients route per-object to the owning group, and locality-driven
WPaxos-style object stealing migrates objects toward the groups that
access them (Ailijiang et al.; placement adaptivity per Crossword).

Public surface:
  * shard_map  — ShardMap: hash partition + ownership epochs + fencing
  * groupview  — GroupView/GroupNodeProxy: per-group id namespacing
  * gate       — GroupGate + make_sharded_replica: NOT_OWNER redirects,
                 fenced ownership transfer, state install
  * router     — ShardClient + ShardWorkload: owner-aware batch routing,
                 redirect handling, steal hints, locality modes
  * runner     — ShardedRunConfig / run_sharded / ShardedRunResult
  * parallel   — per-group EventEngines over worker processes with
                 conservative time-window sync (workers>=2; bit-identical
                 metrics to the workers=1 serial oracle)
"""

from repro_torch.shard.gate import GroupGate, make_sharded_replica
from repro_torch.shard.groupview import GroupNodeProxy, GroupView
from repro_torch.shard.router import ShardClient, ShardWorkload
from repro_torch.shard.runner import (TELEMETRY_FIELDS, EngineStats,
                                ShardedRunArtifacts, ShardedRunConfig,
                                ShardedRunResult, lookahead_of,
                                non_telemetry_metrics, run_sharded)
from repro_torch.shard.shard_map import ShardMap, resolve_owner

__all__ = ["GroupGate", "make_sharded_replica", "GroupNodeProxy",
           "GroupView", "ShardClient", "ShardWorkload",
           "ShardedRunArtifacts", "ShardedRunConfig", "ShardedRunResult",
           "run_sharded", "ShardMap", "resolve_owner", "EngineStats",
           "TELEMETRY_FIELDS", "lookahead_of", "non_telemetry_metrics"]
