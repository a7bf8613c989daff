"""repro_torch.core.weights against repro.core.weights (the JAX reference).

The same numpy inputs go through both packages; the port runs on the CPU.
Tolerances: float32 ``torch.pow`` differs from JAX's float32 power by at most
1.2e-7 relative, so weights compare at rtol 1e-6. Below float32's smallest
normal number (1.18e-38, reached by long steep fleets such as n=128 at r=2)
XLA flushes results to zero where torch keeps subnormals, so weights also
take that number as absolute tolerance. The numpy twins and the steepness
solver are copies and compare bit for bit; ranks and integer results compare
exactly.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.core import weights as JW  # noqa: E402
from repro_torch.core import weights as W  # noqa: E402

CPU = "cpu"
TINY = float(np.finfo(np.float32).tiny)   # XLA flushes subnormals to zero
R_GRID = [1.0, 1.001, 1.05, 1.08, 1.1, 1.19, 1.25, 1.3757961, 1.38, 1.4,
          1.5, 1.75, 1.9, 1.999, 2.0]


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 9, 16, 33, 64, 100, 128, 1024])
def test_geometric_weights_match_jax(n):
    for r in R_GRID:
        got = W.geometric_weights(n, r, device=CPU)
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_allclose(got.numpy(), np.asarray(JW.geometric_weights(n, r)),
                                   rtol=1e-6, atol=TINY, err_msg=f"n={n} r={r}")


def test_geometric_weights_np_and_solve_steepness_bit_equal():
    for n in range(1, 70):
        for r in R_GRID:
            for dtype in (np.float32, np.float64):
                got = W.geometric_weights_np(n, r, dtype)
                want = JW.geometric_weights_np(n, r, dtype)
                assert got.dtype == want.dtype
                assert np.array_equal(got, want), (n, r, dtype)
        for t in range(1, (n - 1) // 2 + 1):
            assert W.solve_steepness(n, t) == JW.solve_steepness(n, t), (n, t)


@pytest.mark.parametrize("table", ["paper_table1", "paper_table2"])
def test_paper_tables_match_jax(table):
    rs, w, thresh = getattr(W, table)()
    jrs, jw, jthresh = getattr(JW, table)()
    np.testing.assert_array_equal(rs, jrs)
    np.testing.assert_allclose(w, jw, rtol=1e-6, atol=0)
    np.testing.assert_allclose(thresh, jthresh, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [3, 5, 9, 16])
def test_invariants_match_jax(n):
    rng = np.random.default_rng(n)
    w = rng.uniform(0.1, 8.0, (256, n)).astype(np.float32)
    wt, wj = torch.from_numpy(w), jnp.asarray(w)
    desc = -np.sort(-w, axis=-1)
    np.testing.assert_array_equal(
        W.cabinet_size(torch.from_numpy(desc)).numpy(),
        np.asarray(JW.cabinet_size(jnp.asarray(desc))))
    got = W.max_safe_t(wt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(JW.max_safe_t(wj)))
    for t in range(0, n):
        np.testing.assert_array_equal(
            W.check_invariant_progress(wt, t).numpy(),
            np.asarray(JW.check_invariant_progress(wj, t)))
        np.testing.assert_array_equal(
            W.check_invariant_safety(wt, t).numpy(),
            np.asarray(JW.check_invariant_safety(wj, t)))
    np.testing.assert_allclose(W.consensus_threshold(wt).numpy(),
                               np.asarray(JW.consensus_threshold(wj)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [1, 5, 9])
def test_weight_tracker_matches_jax(n):
    """Ranks from tied EMAs, weights and observe on unique ids."""
    rng = np.random.default_rng(100 + n)
    objects = 48
    ema = rng.integers(1, 4, (objects, n)).astype(np.float32)   # many ties
    jt = JW.WeightTracker(latency_ema=jnp.asarray(ema), decay=0.8)
    pt = W.WeightTracker(latency_ema=torch.from_numpy(ema.copy()), decay=0.8)
    for step in range(3):
        np.testing.assert_array_equal(pt.ranks().numpy(), np.asarray(jt.ranks()))
        np.testing.assert_allclose(pt.weights(1.4).numpy(),
                                   np.asarray(jt.weights(1.4)), rtol=1e-6, atol=0)
        ids = rng.choice(objects, 16, replace=False).astype(np.int32)
        lat = rng.uniform(0.5, 20.0, (16, n))                      # float64 in
        jt = jt.observe(jnp.asarray(ids), jnp.asarray(lat))
        assert pt.observe(torch.from_numpy(ids), torch.from_numpy(lat)) is pt
        np.testing.assert_allclose(pt.latency_ema.numpy(),
                                   np.asarray(jt.latency_ema), rtol=1e-6, atol=0)


def test_weight_tracker_init_and_node_weights_match_jax():
    pt = W.WeightTracker.init(7, 5, device=CPU)
    jt = JW.WeightTracker.init(7, 5)
    assert pt.latency_ema.dtype == torch.float32 and pt.decay == jt.decay
    np.testing.assert_array_equal(pt.latency_ema.numpy(), np.asarray(jt.latency_ema))
    np.testing.assert_allclose(pt.weights(1.38).numpy(), np.asarray(jt.weights(1.38)),
                               rtol=1e-6, atol=0)
    lat = np.array([5.0, 1.0, 9.0, 1.0, 3.0, 9.0], np.float32)   # with ties
    np.testing.assert_allclose(
        W.node_weights_from_latency(torch.from_numpy(lat), 1.4).numpy(),
        np.asarray(JW.node_weights_from_latency(jnp.asarray(lat), 1.4)),
        rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the order of -0.0 and NaN: the port sorts canonical keys (kernels.
# quorum_commit.sort_keys), which keep the CPU's order equal to jnp.argsort's
# (±0 tie in replica order, every NaN last in replica order); the card's
# sort gets the same keys (tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

from _signed_rows import signed_rows  # noqa: E402
from repro_torch.kernels.quorum_commit import sort_keys  # noqa: E402

NAN = np.float32("nan")


def test_sort_keys_order_the_roadmap_row_as_jnp_argsort():
    row = np.array([0, -0.0, NAN, 1, -NAN, -0.0, 0, 2], np.float32)
    assert np.signbit(row[4]) and np.isnan(row[4])
    want = [0, 1, 5, 6, 3, 7, 2, 4]
    np.testing.assert_array_equal(np.asarray(jnp.argsort(jnp.asarray(row))), want)
    t = torch.from_numpy(row)
    np.testing.assert_array_equal(torch.sort(sort_keys(t), stable=True).indices.numpy(), want)
    keys = sort_keys(t).numpy()
    assert not np.signbit(keys[[0, 1, 5, 6]]).any()          # -0.0 is now +0.0
    assert np.isnan(keys[[2, 4]]).all() and not np.signbit(keys[[2, 4]]).any()
    np.testing.assert_array_equal(keys[[3, 7]], row[[3, 7]])


@pytest.mark.parametrize("n", [1, 2, 5, 9, 33, 200])
def test_ranks_of_signed_zeros_and_nan_match_jax(n):
    ema = signed_rows(np.random.default_rng(n), 64, n)
    t = torch.from_numpy(ema)
    order = np.asarray(jnp.argsort(jnp.asarray(ema), axis=-1))
    np.testing.assert_array_equal(torch.sort(sort_keys(t), dim=-1, stable=True).indices.numpy(),
                                  order)
    jt = JW.WeightTracker(latency_ema=jnp.asarray(ema))
    pt = W.WeightTracker(latency_ema=t.clone())
    want = np.asarray(jt.ranks())
    np.testing.assert_array_equal(W._ranks(t).numpy(), want)
    np.testing.assert_array_equal(pt.ranks().numpy(), want)
    r = 1.4 if n < 64 else 1.05
    np.testing.assert_allclose(pt.weights(r).numpy(), np.asarray(jt.weights(r)),
                               rtol=1e-6, atol=TINY)
    for row in ema[:8]:
        np.testing.assert_allclose(
            W.node_weights_from_latency(torch.from_numpy(row), r).numpy(),
            np.asarray(JW.node_weights_from_latency(jnp.asarray(row), r)),
            rtol=1e-6, atol=TINY)


# ---------------------------------------------------------------------------
# the cases of tests/test_weights.py, replayed on the port
# ---------------------------------------------------------------------------

def test_geometric_weights_table1_obja():
    w = W.geometric_weights(7, 1.40, device=CPU).numpy()
    np.testing.assert_allclose(w, [7.53, 5.38, 3.84, 2.74, 1.96, 1.40, 1.00],
                               atol=0.005)
    t = float(W.consensus_threshold(torch.from_numpy(w)))
    assert abs(t - 11.93) < 0.01


def test_geometric_weights_table2_rows():
    rows = {1: (1.40, [7.5, 5.4, 3.8, 2.7, 2.0, 1.4, 1.0]),
            2: (1.38, [6.9, 5.0, 3.6, 2.6, 1.9, 1.4, 1.0]),
            3: (1.19, [2.8, 2.4, 2.0, 1.7, 1.4, 1.2, 1.0]),
            4: (1.08, [1.6, 1.5, 1.4, 1.3, 1.2, 1.1, 1.0])}
    for t, (r, exp) in rows.items():
        np.testing.assert_allclose(W.geometric_weights(7, r, device=CPU).numpy(),
                                   exp, atol=0.06)


def test_paper_tables_regenerate():
    rs, w, thresh = W.paper_table1()
    assert w.shape == (4, 7)
    assert np.all(np.diff(w, axis=-1) <= 0)
    np.testing.assert_allclose(w[:, -1], 1.0)
    np.testing.assert_allclose(thresh, w.sum(-1) / 2)


@given(n=st.integers(3, 15), r=st.floats(1.0, 2.0))
@settings(max_examples=60, deadline=None)
def test_invariant_progress_always_holds_for_max_safe_t(n, r):
    w = W.geometric_weights(n, r, device=CPU)
    t = int(W.max_safe_t(w))
    assert bool(W.check_invariant_progress(w, t))
    if t >= 1:
        assert bool(W.check_invariant_safety(w, t))


@given(n=st.integers(3, 15))
@settings(max_examples=30, deadline=None)
def test_solve_steepness_satisfies_both_invariants(n):
    for t in range(1, (n - 1) // 2 + 1):
        r = W.solve_steepness(n, t)
        w = W.geometric_weights(n, r, device=CPU)
        assert bool(W.check_invariant_safety(w, t)), (n, t, r)
        assert bool(W.check_invariant_progress(w, t)), (n, t, r)
        assert int(W.cabinet_size(w)) == t + 1


def test_solve_steepness_matches_paper_scale():
    assert W.solve_steepness(7, 1) >= 1.40
    assert 1.0 < W.solve_steepness(7, 3) < 1.30


def test_steepness_tradeoff_quorum_size():
    flat = int(W.cabinet_size(W.geometric_weights(7, 1.05, device=CPU)))
    steep = int(W.cabinet_size(W.geometric_weights(7, 1.9, device=CPU)))
    assert steep < flat
    assert steep == 2 and flat >= 4


def test_weight_tracker_dynamic_assignment():
    tr = W.WeightTracker.init(num_objects=3, n=5, device=CPU)
    lat = torch.tensor([[20.0, 15.0, 12.0, 1.0, 18.0]])
    for _ in range(10):
        tr = tr.observe(torch.tensor([0]), lat)
    w = tr.weights(1.4)
    assert int(torch.argmax(w[0])) == 3
    assert w.shape == (3, 5)


def test_node_weights_from_latency():
    lat = torch.tensor([5.0, 1.0, 9.0, 3.0])
    w = W.node_weights_from_latency(lat, 1.4).numpy()
    np.testing.assert_array_equal(np.argsort(-w), [1, 3, 0, 2])


def test_geometric_weights_validation():
    with pytest.raises(ValueError):
        W.geometric_weights(0, 1.4, device=CPU)
    with pytest.raises(ValueError):
        W.geometric_weights(5, 2.5, device=CPU)
    with pytest.raises(ValueError):
        W.geometric_weights_np(5, 2.5)
    with pytest.raises(ValueError):
        W.solve_steepness(5, 3)
