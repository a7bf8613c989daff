"""WOC as a first-class feature of the training runtime (port of
``repro.coord``):

  * grad_quorum    — weighted-quorum gradient commit (straggler cut)
  * membership     — heartbeat view, leader, elastic resize epochs
  * ckpt_consensus — slow-path checkpoint commit certificates
"""

from repro_torch.coord.ckpt_consensus import CheckpointConsensus
from repro_torch.coord.grad_quorum import GradQuorum, quorum_allreduce
from repro_torch.coord.membership import Membership

__all__ = ["CheckpointConsensus", "GradQuorum", "quorum_allreduce",
           "Membership"]
