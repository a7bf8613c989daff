"""The port's data-plane slice end to end against the JAX package.

64 objects, n=5 replicas, five steps of 16 unique object ids. Each step takes
``WeightTracker.weights(r)[ids]``, then ``quorum_commit``, then ``observe``,
in both packages on the same numpy inputs (the port on the CPU). Results must
be equal, except ``weight_sum`` at rtol 1e-6 (prefix sums in another order);
the latency EMA and the weights at rtol 1e-6 (float32 power and EMA
arithmetic in another framework). State crosses between the packages as
numpy arrays through ``repro_torch.convert``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from repro.core import quorum as JQ  # noqa: E402
from repro.core import weights as JW  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import quorum_commit  # noqa: E402
from repro_torch.core import weights as W  # noqa: E402

OBJECTS, N, STEPS, BATCH = 64, 5, 5, 16


def make_steps(seed):
    rng = np.random.default_rng(seed)
    base = rng.lognormal(np.log(2.0), 0.5, N)
    steps = []
    for _ in range(STEPS):
        ids = rng.choice(OBJECTS, BATCH, replace=False).astype(np.int32)
        lat = (base * rng.lognormal(0.0, 0.3, (BATCH, N))).astype(np.float32)
        vote = rng.random((BATCH, N)) >= 0.1
        steps.append((ids, np.where(vote, lat, np.inf).astype(np.float32),
                      np.where(vote, lat, 50.0).astype(np.float32)))
    return steps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slice_matches_jax(seed):
    r = W.solve_steepness(N, 2)
    jt = JW.WeightTracker.init(OBJECTS, N)
    pt = convert.weight_tracker(np.asarray(jt.latency_ema), jt.decay, device="cpu")
    for step, (ids, arrivals, observed) in enumerate(make_steps(seed)):
        jw = jt.weights(r)[jnp.asarray(ids)]
        pw = pt.weights(r)[torch.from_numpy(ids)]
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-6, atol=0)

        jres = JQ.quorum_commit(jnp.asarray(arrivals), jw)
        pres = quorum_commit(torch.from_numpy(arrivals), pw)
        got = convert.quorum_result_arrays(pres)
        for name, g, e in zip(pres._fields, got, jres):
            e = np.asarray(e)
            assert g.dtype == e.dtype, name
            if name == "weight_sum":
                np.testing.assert_allclose(g, e, rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(g, e, err_msg=f"step {step}: {name}")

        jt = jt.observe(jnp.asarray(ids), jnp.asarray(observed))
        pt.observe(torch.from_numpy(ids), torch.from_numpy(observed))
        ema, decay = convert.weight_tracker_arrays(pt)
        assert decay == jt.decay
        np.testing.assert_allclose(ema, np.asarray(jt.latency_ema), rtol=1e-6, atol=0)


def test_convert_round_trips():
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 5, (8, 3)).astype(np.float32)
    w = rng.uniform(0.1, 8, (8, 3)).astype(np.float32)
    jres = JQ.quorum_commit(jnp.asarray(a), jnp.asarray(w))
    fields = [np.asarray(x) for x in jres]
    pres = convert.quorum_result(fields, device="cpu")
    assert [x.dtype for x in pres] == [torch.bool, torch.float32, torch.int32,
                                        torch.float32, torch.bool]
    for g, e in zip(convert.quorum_result_arrays(pres), fields):
        np.testing.assert_array_equal(g, e)
    with pytest.raises(ValueError):
        convert.quorum_result(fields[:4], device="cpu")
    ema = rng.uniform(1, 9, (6, 3)).astype(np.float32)
    tracker = convert.weight_tracker(ema, 0.7, device="cpu")
    tracker.observe(torch.tensor([0]), torch.ones(1, 3))
    assert ema[0, 0] != tracker.latency_ema[0, 0]          # the input is not aliased
    np.testing.assert_array_equal(convert.to_numpy(convert.to_tensor(w, device="cpu")), w)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.default_device()
    with pytest.raises(RuntimeError):
        repro_torch.default_device("cuda")
    with pytest.raises(RuntimeError):
        W.WeightTracker.init(4, 3)
    with pytest.raises(RuntimeError):
        W.geometric_weights(3, 1.4)
    assert repro_torch.default_device("cpu") == torch.device("cpu")


def test_default_device_picks_cuda_when_present(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert repro_torch.default_device() == torch.device("cuda")
