"""WOC protocol core, ported: geometric weights and the weighted quorum.

Public surface:
  * weights  — geometric weight assignment + invariants (§3.1-3.2)
  * quorum   — vectorized weighted-quorum commit math
"""

from repro_torch.core import weights
from repro_torch.core.quorum import QuorumResult, quorum_commit

__all__ = ["weights", "QuorumResult", "quorum_commit"]
