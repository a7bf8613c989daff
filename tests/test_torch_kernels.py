"""K1 in the port: its plain version against the Pallas kernel, its routing,
its launch wrapper's checks and its build.

Plain K1 runs against ``quorum_commit_pallas(..., interpret=True)`` as
``tests/test_kernels.py`` runs the Pallas kernel against its reference:
``committed`` and ``commit_time`` exactly; ``quorum_size`` and ``weight_sum``
only on tie-free inputs, because the Pallas bitonic network is unstable and
orders tied votes differently. ``weight_sum`` at rtol 1e-6 (prefix sums taken
in another order). K1 has no backward kernel: its CUDA wrapper raises where a
gradient is wanted, and the plain version keeps its gradient. The build is
keyed by the hash of each source and of every shared header. The CUDA kernel
itself is tested on a GPU by ``tests/test_torch_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.quorum_commit import quorum_commit_pallas  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import quorum_commit as qc  # noqa: E402


def random_inputs(rng, ops_, n, ties):
    if ties:
        a = rng.integers(0, 4, (ops_, n)).astype(np.float32)
    else:   # distinct arrivals within each row
        a = np.stack([rng.permutation(n) for _ in range(ops_)]).astype(np.float32)
        a = a + rng.uniform(0.0, 0.5, (ops_, n)).astype(np.float32)
    a[rng.random((ops_, n)) < 0.3] = np.inf
    w = rng.uniform(0.1, 9.0, (ops_, n)).astype(np.float32)
    return a, w


@pytest.mark.parametrize("ops_,n,ties", [(1, 2, False), (37, 5, False),
                                         (200, 9, False), (130, 33, False),
                                         (64, 5, True), (150, 16, True)])
def test_plain_matches_pallas_interpret(ops_, n, ties):
    rng = np.random.default_rng(ops_ * 100 + n)
    a, w = random_inputs(rng, ops_, n, ties)
    ct, qs, cm, ws = (np.asarray(x) for x in quorum_commit_pallas(
        jnp.asarray(a), jnp.asarray(w), interpret=True))
    pct, pqs, pcm, pws = (x.numpy() for x in ref.quorum_commit_ref(
        torch.from_numpy(a), torch.from_numpy(w)))
    np.testing.assert_array_equal(pcm, cm)
    np.testing.assert_array_equal(pct, ct)
    if not ties:
        np.testing.assert_array_equal(pqs, qs)
        np.testing.assert_allclose(pws, ws, rtol=1e-6, atol=0)


def test_plain_top2_with_geometric_weights():
    from repro_torch.core import weights as W
    w = W.geometric_weights(7, 1.9, device="cpu").expand(4, 7).contiguous()
    arr = torch.arange(1.0, 8.0).expand(4, 7).contiguous()
    ct, qs, cm, _ = ops.quorum_commit(arr, w)
    assert bool(cm.all())
    assert torch.equal(qs, torch.full((4,), 2, dtype=torch.int32))
    assert torch.equal(ct, torch.full((4,), 2.0))


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    rng = np.random.default_rng(5)
    a, w = (torch.from_numpy(x) for x in random_inputs(rng, 50, 7, True))
    before = qc.launches
    got = ops.quorum_commit(a, w)
    want = qc.quorum_commit_plain(a, w)[:4]
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    assert qc.launches == before
    assert qc.quorum_commit(a, w)[4] is None
    assert qc.quorum_commit(a, w, members=True)[4].shape == (50, 7)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        qc.quorum_commit_cuda(a, a)
    with pytest.raises(ValueError, match="no implementation"):
        qc.quorum_commit(a.to("meta"), a.to("meta"))
    with pytest.raises(ValueError, match="ops, n"):
        qc.quorum_commit(a, torch.zeros(4, 2))
    with pytest.raises(ValueError, match="at least one replica"):
        qc.quorum_commit(torch.zeros(4, 0), torch.zeros(4, 0))
    with pytest.raises(ValueError, match="threshold"):
        qc.quorum_commit(a, a, torch.zeros(3))


def test_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    assert _build.sources() == ["flash_attention", "flash_attention_bwd", "quorum_commit",
                                "ssd_scan", "ssd_scan_bwd"]
    path = _build.library_path("quorum_commit")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "quorum_commit.cu").write_text("// another source\n")
    assert _build.library_path("quorum_commit").name != path.name


def test_build_key_covers_every_header(tmp_path, monkeypatch):
    """Editing a shared header (csrc/*.cuh) changes the key of every library,
    so no library built against the old header is loaded."""
    assert (_build.CSRC / "hopper.cuh").is_file()
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = _build.sources()
    before = {name: _build.library_path(name).name for name in names}
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = {name: _build.library_path(name).name for name in names}
    assert all(before[name] != after[name] for name in names), (before, after)
    # a new header counts too
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert all(_build.library_path(name).name != after[name] for name in names)


# K1 has no backward kernel: its CUDA wrapper raises where a gradient is
# wanted, before it looks at the device; the plain version keeps its gradient.

@pytest.mark.parametrize("which", ["arrivals", "weights", "threshold"])
def test_k1_wrapper_raises_where_a_gradient_is_wanted(which):
    a, w = (torch.from_numpy(x) for x in random_inputs(np.random.default_rng(3), 20, 5, False))
    args = {"arrivals": a, "weights": w, "threshold": w.sum(-1) / 2}
    args[which] = args[which].clone().requires_grad_()
    before = qc.launches
    with pytest.raises(NotImplementedError, match="no backward"):
        qc.quorum_commit_cuda(args["arrivals"], args["weights"], args["threshold"])
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        qc.quorum_commit_cuda(args["arrivals"], args["weights"], args["threshold"])
    assert qc.launches == before


def test_plain_k1_keeps_the_weight_sums_gradient():
    """On the CPU weight_sum is differentiable in the weights: its gradient is
    1 for each member of the quorum and 0 elsewhere."""
    a, w = (torch.from_numpy(x) for x in random_inputs(np.random.default_rng(4), 64, 9, False))
    w.requires_grad_()
    _, _, committed, weight_sum, members = qc.quorum_commit(a, w, members=True)
    assert committed.any() and not committed.all()
    weight_sum.sum().backward()
    assert torch.equal(w.grad, members.float())


def test_build_raises_without_nvcc_or_on_a_failed_compile(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["quorum_commit"])
    failing = tmp_path / "nvcc"
    failing.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 2\n")
    failing.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(failing))
    with pytest.raises(RuntimeError, match="refused"):
        _build.build(["quorum_commit"])
    assert not any((tmp_path / "build").iterdir())
