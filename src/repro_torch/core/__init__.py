"""WOC protocol core, ported: the paper's primary contribution.

Public surface:
  * weights         — geometric weight assignment + invariants (§3.1-3.2)
  * quorum          — vectorized weighted-quorum commit math
  * object_manager  — classification + routing (§3.3)
  * woc / cabinet / epaxos — protocol node implementations (§4); the
    protocol registry (repro_torch.scenario.registry) maps names incl.
    "paxos" (Cabinet with flat weights) to classes + capability metadata
  * simulator / runner — deterministic cluster simulation (§5 substrate);
    runner is the legacy RunConfig shim over repro_torch.scenario
  * rsm             — replicated state machine + linearizability checking

The protocol stack (simulator, rsm, the protocols, runner) and the packages
it runs on (scenario, faults, shard, obs, verify, coding) are copies of the
JAX package's numpy and plain-Python modules, with every module path renamed;
tests/test_torch_protocol_copies.py holds each copy to its reference.
"""

from repro_torch.core import weights
from repro_torch.core.quorum import QuorumResult, quorum_commit
from repro_torch.core.object_manager import ObjectClass, ObjectManager, Route
from repro_torch.core.runner import PROTOCOLS, RunConfig, run

__all__ = ["weights", "QuorumResult", "quorum_commit", "ObjectClass",
           "ObjectManager", "Route", "PROTOCOLS", "RunConfig", "run"]
