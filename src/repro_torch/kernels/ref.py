"""Plain PyTorch versions of the port's kernels, which the tests and the
on-card checks hold each kernel against (port of ``repro.kernels.ref``)."""

from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.quorum_commit import quorum_commit_plain
from repro_torch.kernels.ssd_scan import ssd_chunked_plain


def quorum_commit_ref(arrivals, weights):
    """(commit_time, quorum_size, committed, weight_sum), as the JAX
    ``quorum_commit_ref`` returns them."""
    return quorum_commit_plain(arrivals, weights)[:4]


def flash_attention_ref(q, k, v, *, causal: bool = True):
    return flash_attention_plain(q, k, v, causal=causal)


def ssd_ref(x, dt, A, Bm, Cm, D, chunk, initial_state=None):
    return ssd_chunked_plain(x, dt, A, Bm, Cm, D, chunk,
                             initial_state=initial_state)
