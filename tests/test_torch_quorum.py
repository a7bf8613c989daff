"""repro_torch.core.quorum against repro.core.quorum (the JAX reference).

The same numpy inputs, with tied arrivals and ``inf`` non-votes, go through
both packages; the port runs on the CPU through the plain version of K1.
``committed``, ``commit_time``, ``quorum_size`` and ``members`` must be equal:
both packages order ties by replica index (stable sorts). ``weight_sum`` is
compared at rtol 1e-6 because the two frameworks take the prefix sum in
another order (the largest gap seen is 2.3e-7 relative).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402
from _signed_rows import signed_rows  # noqa: E402

from repro.core import quorum as JQ  # noqa: E402
from repro.core import weights as JW  # noqa: E402
from repro_torch.core import weights as W  # noqa: E402
from repro_torch.core.quorum import (QuorumResult, min_quorum_latency,  # noqa: E402
                                     quorum_commit, quorums_intersect)

EXACT = ("committed", "commit_time", "quorum_size", "members")
DTYPES = {"committed": torch.bool, "commit_time": torch.float32,
          "quorum_size": torch.int32, "weight_sum": torch.float32,
          "members": torch.bool}


def tie_inputs(rng, ops, n):
    """Integer arrivals (heavy ties), 30% non-votes, a few rows with no vote."""
    a = rng.integers(0, 5, (ops, n)).astype(np.float32)
    a[rng.random((ops, n)) < 0.3] = np.inf
    a[rng.random(ops) < 0.05] = np.inf
    w = rng.uniform(0.1, 8.0, (ops, n)).astype(np.float32)
    thr = (w.sum(-1) * rng.uniform(0.3, 0.7, ops)).astype(np.float32)
    return a, w, thr


def assert_matches_jax(res, ref):
    assert isinstance(res, QuorumResult)
    for field in QuorumResult._fields:
        got, want = getattr(res, field), np.asarray(getattr(ref, field))
        assert got.dtype == DTYPES[field], field
        assert got.shape == want.shape, field
        if field in EXACT:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=field)
    np.testing.assert_allclose(res.weight_sum.numpy(), np.asarray(ref.weight_sum),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 9, 16, 33, 128])
@pytest.mark.parametrize("with_threshold", [False, True])
def test_quorum_commit_matches_jax_with_ties(n, with_threshold):
    rng = np.random.default_rng(1000 * n + with_threshold)
    a, w, thr = tie_inputs(rng, 512, n)
    th_t = torch.from_numpy(thr) if with_threshold else None
    th_j = jnp.asarray(thr) if with_threshold else None
    res = quorum_commit(torch.from_numpy(a), torch.from_numpy(w), th_t)
    assert_matches_jax(res, JQ.quorum_commit(jnp.asarray(a), jnp.asarray(w), th_j))


@pytest.mark.parametrize("n", [1, 3, 9, 33, 200])
def test_quorum_commit_orders_signed_zeros_and_nan_as_jax(n):
    """-0.0 beside +0.0, NaN and -NaN arrivals: the plain version sorts
    canonical keys, so ±0 tie in replica order and NaN (no vote) comes last,
    as jnp.argsort orders them; commit_time keeps the sign of the arrival
    that crossed, so its bits show which replica that was."""
    rng = np.random.default_rng(n)
    a = signed_rows(rng, 400, n, high=3, inf=False)
    # integer weights with one odd half: prefix sums are exact, none equals T
    w = rng.integers(1, 9, (400, n)).astype(np.float32)
    w[:, 0] += 0.5
    res = quorum_commit(torch.from_numpy(a), torch.from_numpy(w))
    ref = JQ.quorum_commit(jnp.asarray(a), jnp.asarray(w))
    assert_matches_jax(res, ref)
    np.testing.assert_array_equal(res.commit_time.numpy().view(np.int32),
                                  np.asarray(ref.commit_time).view(np.int32))
    # a pinned row: +0.0 at replica 0 ties with -0.0 at replica 1, so replica
    # 0 comes first (1 is not > T = 3), then replica 1 crosses (4) at -0.0
    row = torch.tensor([[0.0, -0.0, float("nan"), 1.0]])
    got = quorum_commit(row, torch.tensor([[1.0, 3.0, 1.0, 1.0]]))
    ref = JQ.quorum_commit(jnp.asarray(row.numpy()), jnp.asarray([[1.0, 3.0, 1.0, 1.0]]))
    assert int(got.quorum_size[0]) == 2 and np.signbit(got.commit_time.numpy()[0])
    assert_matches_jax(got, ref)
    assert np.signbit(np.asarray(ref.commit_time)[0])


def test_quorum_commit_casts_float64_and_1d_like_jax():
    """float64 numpy inputs are cast to float32, as JAX with x64 off does; a
    1-D input is one op row."""
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 10, (64, 6))
    a[rng.random((64, 6)) < 0.2] = np.inf
    w = rng.uniform(0.1, 8.0, (64, 6))
    assert_matches_jax(quorum_commit(torch.from_numpy(a), torch.from_numpy(w)),
                       JQ.quorum_commit(jnp.asarray(a), jnp.asarray(w)))
    assert_matches_jax(quorum_commit(torch.from_numpy(a[3]), torch.from_numpy(w[3])),
                       JQ.quorum_commit(jnp.asarray(a[3]), jnp.asarray(w[3])))


def test_min_quorum_latency_and_intersection_match_jax():
    rng = np.random.default_rng(11)
    a, w, _ = tie_inputs(rng, 128, 7)
    np.testing.assert_array_equal(
        min_quorum_latency(torch.from_numpy(a), torch.from_numpy(w)).numpy(),
        np.asarray(JQ.min_quorum_latency(jnp.asarray(a), jnp.asarray(w))))
    m1 = rng.random((128, 7)) < 0.4
    m2 = rng.random((128, 7)) < 0.4
    np.testing.assert_array_equal(
        quorums_intersect(torch.from_numpy(m1), torch.from_numpy(m2)).numpy(),
        np.asarray(JQ.quorums_intersect(jnp.asarray(m1), jnp.asarray(m2))))


def test_quorum_commit_empty_batch():
    res = quorum_commit(torch.empty(0, 5), torch.empty(0, 5))
    assert res.members.shape == (0, 5) and res.committed.shape == (0,)


# ---------------------------------------------------------------------------
# the cases of tests/test_quorum.py, replayed on the port
# ---------------------------------------------------------------------------

def brute_force_commit(arrivals, weights, threshold):
    """O(n^2) reference: walk votes in time order, accumulate weight."""
    order = np.argsort(arrivals)
    acc = 0.0
    for k, i in enumerate(order):
        if not np.isfinite(arrivals[i]):
            break
        acc += weights[i]
        if acc > threshold:
            return True, arrivals[i], k + 1, acc
    return False, np.inf, 0, 0.0


@given(st.data())
@settings(max_examples=100, deadline=None)
def test_quorum_commit_matches_brute_force(data):
    n = data.draw(st.integers(2, 12))
    ops = data.draw(st.integers(1, 6))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
    arrivals = rng.uniform(0, 10, size=(ops, n))
    arrivals = np.where(rng.random((ops, n)) < 0.3, np.inf, arrivals)
    weights = rng.uniform(0.1, 8.0, size=(ops, n))

    res = quorum_commit(torch.from_numpy(arrivals), torch.from_numpy(weights))
    thresh = weights.sum(-1) / 2.0
    for i in range(ops):
        ok, t, k, acc = brute_force_commit(arrivals[i], weights[i], thresh[i])
        assert bool(res.committed[i]) == ok
        if ok:
            assert abs(float(res.commit_time[i]) - t) < 1e-5
            assert int(res.quorum_size[i]) == k
            assert abs(float(res.weight_sum[i]) - acc) < 1e-4
            members = res.members[i].numpy()
            assert members.sum() == k
            assert weights[i][members].sum() >= thresh[i] - 1e-5


@given(st.integers(0, 2**31))
@settings(max_examples=60, deadline=None)
def test_theorem1_fast_path_quorums_intersect(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 12))
    r = float(rng.uniform(1.0, 2.0))
    w = W.geometric_weights(n, r, device="cpu")
    a1 = rng.permutation(np.arange(1.0, n + 1))
    a2 = rng.permutation(np.arange(1.0, n + 1))
    res = quorum_commit(torch.from_numpy(np.stack([a1, a2])), torch.stack([w, w]))
    assert bool(res.committed[0]) and bool(res.committed[1])
    assert bool(quorums_intersect(res.members[0], res.members[1]))


def test_no_commit_when_too_many_failures():
    w = W.geometric_weights(5, 1.4, device="cpu")
    arrivals = torch.tensor([float("inf")] * 3 + [1.0, 2.0])
    res = quorum_commit(arrivals, w)
    assert not bool(res.committed[0])
    assert not torch.isfinite(res.commit_time[0])


def test_commit_with_top_heavy_quorum():
    w = W.geometric_weights(5, 1.9, device="cpu")
    arrivals = torch.tensor([0.5, 1.0] + [float("inf")] * 3)
    res = quorum_commit(arrivals, w)
    assert bool(res.committed[0])
    assert int(res.quorum_size[0]) == 2
    assert float(res.commit_time[0]) == 1.0


def test_theorem1_geometric_weights_match_jax():
    """Solved-steepness geometric weights (the protocol's own) on permuted
    arrivals give the JAX package's quorums."""
    rng = np.random.default_rng(3)
    for n in (3, 5, 7, 9):
        w = np.tile(JW.geometric_weights_np(n, W.solve_steepness(n, 1)), (64, 1))
        a = np.stack([rng.permutation(n) for _ in range(64)]).astype(np.float32)
        assert_matches_jax(quorum_commit(torch.from_numpy(a), torch.from_numpy(w)),
                           JQ.quorum_commit(jnp.asarray(a), jnp.asarray(w)))
