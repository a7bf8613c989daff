"""Training the encdec (seamless-m4t-medium) and vlm (internvl2-26b) families
in the port against the JAX package on the CPU, in float32, at the smoke
configs (``tests/_torch_train_parity.py`` holds what the moe tests share):

* ``loss_fn`` and every leaf of its gradient against ``jax.value_and_grad``
  of the reference's ``loss_fn``, remat off and on: seamless with frames at
  S / 4 (the encoder's gradient arrives through every decoder layer's
  cross K/V), internvl2 with its image prefix ahead of the tokens and the
  loss over the text tail;
* two train steps (``launch.train.make_train_step`` against
  ``jax.jit(repro.launch.train.make_train_step(cfg, None, ...))``), one
  microbatch without remat and two with it, the frames or image embeddings
  split with their tokens: loss, grad_norm and lr, the parameters and both
  moments (``tests/test_torch_train.py`` runs the training CLI for both);

All at 1e-4 of each leaf's largest magnitude plus 1e-4 relative (the
parameters after the steps as ``_torch_train_parity`` says). The seeds were
chosen once; the worst error at them is 0.149 of the tolerance (seamless,
two microbatches; the gradients read at most 0.013 of theirs). Run the file
as a script to print every case's readings.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import _torch_train_parity as P  # noqa: E402
from repro.models import family as jax_family  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ARCHS = ("seamless-m4t-medium", "internvl2-26b")
PARAM_SEED, BATCH_SEED = 0, 1


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test with one torch thread (``P.one_torch_thread``)."""
    with P.one_torch_thread():
        yield


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    jcfg, cfg = P.f32_pair(arch, remat=remat)
    params = jax_family(jcfg).init_params(jcfg, jax.random.PRNGKey(PARAM_SEED))
    batch = P.loss_batch(cfg, BATCH_SEED)
    assert {"encdec": "frames", "vlm": "image_embeds"}[cfg.family] in batch
    (jloss, jgrads), (tloss, tgrads) = P.loss_and_grads(jcfg, cfg, params, batch)
    np.testing.assert_allclose(tloss, jloss, rtol=P.TOL)
    assert P.share_of_tol(tgrads, jgrads) <= 1
    if cfg.family == "encdec":      # the encoder learns through the cross-attention
        assert all(np.abs(g).max() > 0 for g in jax.tree.leaves(tgrads["enc"]))


@pytest.mark.parametrize("microbatches,remat", [(1, False), (2, True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch, microbatches, remat):
    jcfg, cfg = P.f32_pair(arch, microbatches=microbatches, remat=remat)
    params = jax_family(jcfg).init_params(jcfg, jax.random.PRNGKey(PARAM_SEED))
    assert P.train_steps_share(jcfg, cfg, params, P.step_batches(cfg, BATCH_SEED)) <= 1


def test_train_batch_carries_the_stub_inputs():
    """``launch.train.train_batch``: the data pipeline's tokens with frames
    at S / 4 (encdec) or the image prefix (vlm), the same for a step and
    seed wherever it is drawn, other for another step."""
    for arch, key, length in (("seamless-m4t-medium", "frames", 8),
                              ("internvl2-26b", "image_embeds", 8)):
        cfg = configs.smoke(arch)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=3)
        batch = train.train_batch(cfg, dcfg, 5, "cpu")
        assert sorted(batch) == sorted(["tokens", "targets", "mask", key])
        assert batch[key].shape == (4, length, cfg.d_model) and batch[key].dtype == cfg.dtype()
        assert torch.equal(batch[key], train.train_batch(cfg, dcfg, 5, "cpu")[key])
        assert not torch.equal(batch[key], train.train_batch(cfg, dcfg, 6, "cpu")[key])


if __name__ == "__main__":
    # the readings the module docstring states
    for arch in ARCHS:
        for remat in (False, True):
            jcfg, cfg = P.f32_pair(arch, remat=remat)
            params = jax_family(jcfg).init_params(jcfg, jax.random.PRNGKey(PARAM_SEED))
            (jl, jg), (tl, tg) = P.loss_and_grads(jcfg, cfg, params,
                                                  P.loss_batch(cfg, BATCH_SEED))
            print(arch, "remat" if remat else "-", "loss share",
                  abs(tl - jl) / (P.TOL * abs(jl)), "grad share", P.share_of_tol(tg, jg))
        for M, remat in ((1, False), (2, True)):
            jcfg, cfg = P.f32_pair(arch, microbatches=M, remat=remat)
            params = jax_family(jcfg).init_params(jcfg, jax.random.PRNGKey(PARAM_SEED))
            print(arch, f"M{M}", "steps share",
                  P.train_steps_share(jcfg, cfg, params, P.step_batches(cfg, BATCH_SEED)))
