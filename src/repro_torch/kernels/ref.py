"""Plain PyTorch versions of the port's kernels, which the tests and the
on-card checks hold each kernel against (port of ``repro.kernels.ref``)."""

from __future__ import annotations

from repro_torch.kernels.quorum_commit import quorum_commit_plain


def quorum_commit_ref(arrivals, weights):
    """(commit_time, quorum_size, committed, weight_sum), as the JAX
    ``quorum_commit_ref`` returns them."""
    return quorum_commit_plain(arrivals, weights)[:4]
