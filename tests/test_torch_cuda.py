"""K1's CUDA kernel against its plain version, on a GPU.

The kernel has no CPU mode, so every test here takes the ``cuda`` fixture
and skips where ``torch.cuda.is_available()`` is false. The file imports no
JAX, so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Exact on ``committed``, ``commit_time``, ``quorum_size`` and ``members``;
``weight_sum`` at rtol 1e-6 (the plain version's prefix sum is a float32
scan in another order). Inputs have tied arrivals, non-votes and rows with
no vote; weights are drawn so that no prefix sum lies near the threshold.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import quorum_commit  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quorum_commit as qc  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def tie_inputs(rng, ops_, n, device):
    a = rng.integers(0, 4, (ops_, n)).astype(np.float32)
    a[rng.random((ops_, n)) < 0.3] = np.inf
    a[::17] = np.inf
    # integer weights: every prefix sum and threshold is exact in float32
    w = rng.integers(1, 9, (ops_, n)).astype(np.float32)
    w[:, 0] += 0.5          # odd half-units: no prefix sum equals T exactly
    thr = (np.floor(w.sum(-1) * rng.uniform(0.3, 0.7, ops_)) + 0.25).astype(np.float32)
    return (torch.from_numpy(x).to(device) for x in (a, w, thr))


def assert_equal_results(got, want):
    for i, (g, e) in enumerate(zip(got, want)):
        if i == 3:
            torch.testing.assert_close(g, e, rtol=1e-6, atol=0)
        else:
            assert torch.equal(g, e), i


@pytest.mark.parametrize("n", [1, 2, 3, 9, 33, 128, 1024])
@pytest.mark.parametrize("with_threshold", [False, True])
def test_kernel_matches_plain(cuda, n, with_threshold):
    rng = np.random.default_rng(n)
    a, w, thr = tie_inputs(rng, 300, n, cuda)
    th = thr if with_threshold else None
    before = qc.launches
    got = qc.quorum_commit_cuda(a, w, th, members=True)
    torch.cuda.synchronize()
    assert qc.launches == before + 1
    assert_equal_results(got, qc.quorum_commit_plain(a, w, th, members=True))


def test_entry_points_launch_the_kernel(cuda):
    a, w, _ = tie_inputs(np.random.default_rng(0), 129, 9, cuda)
    before = qc.launches
    res = quorum_commit(a, w)
    got = ops.quorum_commit(a, w)
    torch.cuda.synchronize()
    assert qc.launches == before + 2
    want = qc.quorum_commit_plain(a, w, members=True)
    assert_equal_results((res.commit_time, res.quorum_size, res.committed,
                          res.weight_sum, res.members), want)
    assert_equal_results(got, want[:4])
    empty = qc.quorum_commit_cuda(a[:0], w[:0], members=True)
    assert empty[4].shape == (0, 9) and qc.launches == before + 2


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    a = torch.zeros(4, 3, device=cuda)
    with pytest.raises(TypeError):
        qc.quorum_commit_cuda(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        qc.quorum_commit_cuda(a.t().contiguous().t(), a)
    with pytest.raises(ValueError, match="one CUDA device"):
        qc.quorum_commit_cuda(a, a.cpu())
    big = torch.zeros(2, qc.MAX_REPLICAS + 1, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        qc.quorum_commit_cuda(big, big)
