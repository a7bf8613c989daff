"""Training the moe family (granite-moe-3b-a800m, qwen3-moe-235b-a22b) in the
port against the JAX package on the CPU, in float32, at the smoke configs
(``tests/_torch_train_parity.py`` holds what the encdec and vlm tests
share):

* ``loss_fn`` and every leaf of its gradient against ``jax.value_and_grad``
  of the reference's ``loss_fn``, remat off and on;
* two train steps (``launch.train.make_train_step`` against
  ``jax.jit(repro.launch.train.make_train_step(cfg, None, ...))``), one
  microbatch without remat and two with it: loss, grad_norm and lr, the
  parameters and both moments;
* without remat at the configurations' capacity factor (1.25), and with
  remat at 0.3, where the test asserts that pairs drop (some drop at 1.25
  too: 104 and 129 pairs in two steps of one microbatch).

All at 1e-4 of each leaf's largest magnitude plus 1e-4 relative (the
parameters after the steps as ``_torch_train_parity`` says). Every call of
the port's router is recorded, in every layer, microbatch and step (the
recompute under remat included), and its tokens' k-th and (k+1)-th
probabilities must lie ``NEAR_TIE`` = 1e-5 apart or more: JAX's
probabilities lie within float32 rounding (~1e-7) of the port's, so both
sides route every token alike, and a near-tie would fail as one, never as a
gradient mismatch.

The seeds are 5 and 6. They were first 0 and 1, where the train steps of
one microbatch read 0.54 of the tolerance: one element of layer 0's ``wk``
had a first-step gradient of 4e-9, in float32's noise and under AdamW's eps
of 1e-8, where AdamW's division turns a last-bits difference into 0.14 lr
of the parameter. They were moved once, after that reading, and are not to
be moved again to make a failure pass. At 5 and 6 the smallest gap is
7.07e-5 (qwen3-moe, 0.3, two microbatches), and the worst error 0.067 of
the tolerance (qwen3-moe, the train steps of one microbatch; the gradients
read at most 0.023 of theirs). Run the file as a script to print every
case's readings.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import _torch_train_parity as P  # noqa: E402
from repro.models import family as jax_family  # noqa: E402

ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
LOW_CAPACITY = 0.3
PARAM_SEED, BATCH_SEED = 5, 6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test with one torch thread (``P.one_torch_thread``)."""
    with P.one_torch_thread():
        yield


def capacity_kw(low):
    return {"capacity_factor": LOW_CAPACITY} if low else {}


def check_drops(margins, low):
    if low:
        assert sum(margins.dropped) > 0, "a capacity factor of 0.3 drops pairs"


LOSS_CASES = [(False, False), (True, True)]           # remat, low
STEP_CASES = [(1, False, False), (2, True, True)]     # microbatches, remat, low


@pytest.mark.parametrize("remat,low", LOSS_CASES, ids=["plain", "remat-drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(monkeypatch, arch, remat, low):
    jcfg, cfg = P.f32_pair(arch, remat=remat, **capacity_kw(low))
    params = jax_family(jcfg).init_params(jcfg, jax.random.PRNGKey(PARAM_SEED))
    margins = P.RouterMargins(monkeypatch, cfg)
    (jloss, jgrads), (tloss, tgrads) = P.loss_and_grads(jcfg, cfg, params,
                                                        P.loss_batch(cfg, BATCH_SEED))
    margins.smallest_gap()
    check_drops(margins, low)
    np.testing.assert_allclose(tloss, jloss, rtol=P.TOL)
    assert P.share_of_tol(tgrads, jgrads) <= 1


@pytest.mark.parametrize("microbatches,remat,low", STEP_CASES, ids=["m1", "m2-remat-drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(monkeypatch, arch, microbatches, remat, low):
    jcfg, cfg = P.f32_pair(arch, microbatches=microbatches, remat=remat, **capacity_kw(low))
    params = jax_family(jcfg).init_params(jcfg, jax.random.PRNGKey(PARAM_SEED))
    margins = P.RouterMargins(monkeypatch, cfg)
    assert P.train_steps_share(jcfg, cfg, params, P.step_batches(cfg, BATCH_SEED)) <= 1
    margins.smallest_gap()
    check_drops(margins, low)


if __name__ == "__main__":
    # the readings the module docstring states, for every case
    for arch in ARCHS:
        for case in LOSS_CASES + STEP_CASES:
            names = ("remat", "low") if len(case) == 2 else ("microbatches", "remat", "low")
            kw = dict(zip(names, case))
            low = kw.pop("low")
            jcfg, cfg = P.f32_pair(arch, **kw, **capacity_kw(low))
            params = jax_family(jcfg).init_params(jcfg, jax.random.PRNGKey(PARAM_SEED))
            with pytest.MonkeyPatch.context() as mp:
                m = P.RouterMargins(mp, cfg)
                if len(case) == 2:
                    (jl, jg), (tl, tg) = P.loss_and_grads(jcfg, cfg, params,
                                                          P.loss_batch(cfg, BATCH_SEED))
                    share = max(abs(tl - jl) / (P.TOL * abs(jl)), P.share_of_tol(tg, jg))
                else:
                    share = P.train_steps_share(jcfg, cfg, params,
                                                P.step_batches(cfg, BATCH_SEED))
            print(arch, case, "smallest gap", min(m.gaps), "dropped", sum(m.dropped),
                  "worst share of the tolerance", share)
