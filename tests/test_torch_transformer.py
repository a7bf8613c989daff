"""The dense family in the port (``repro_torch.models.transformer``) against
the JAX package on the CPU, in float32.

The smoke configs of qwen3-1.7b (qk-norm, SwiGLU), phi4-mini (no qk-norm)
and nemotron-4-340b (squared ReLU) run with the JAX package's parameters,
carried across by ``repro_torch.convert``, on the same numpy tokens:

* prefill plus 3 greedy decode steps: logits and caches at atol/rtol 1e-4
  (the same float32 arithmetic in another order through 2-3 layers) and
  equal greedy tokens;
* the port's decode against its own teacher forcing, at the limits of
  ``tests/test_models.py:50`` and at 1e-4;
* ``loss_fn`` and its gradient against ``jax.value_and_grad`` at 1e-4,
  with remat on and off.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import family as jax_family  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.train import value_and_grad  # noqa: E402
from repro_torch.models import family, transformer  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ARCHS = ("qwen3-1.7b", "phi4-mini-3.8b", "nemotron-4-340b")
B, S, STEPS = 2, 32, 3
TOL = 1e-4


def pair(arch, **kw):
    kw = dict(param_dtype="float32", compute_dtype="float32", **kw)
    return (dataclasses.replace(jax_configs.smoke(arch), **kw),
            dataclasses.replace(configs.smoke(arch), **kw))


def jax_params(jcfg, seed=0):
    params = jax_family(jcfg).init_params(jcfg, jax.random.PRNGKey(seed))
    return params, convert.params_from_jax(jax.tree.map(np.asarray, params),
                                           device="cpu")


def tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(2, cfg.vocab, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_jax(arch):
    jcfg, cfg = pair(arch)
    jp, tp = jax_params(jcfg)
    toks = tokens(cfg, 1, (B, S))
    jfam = jax_family(jcfg)
    jl, jc = jfam.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, cache_len=S + 4)
    tl, tc = serve.make_prefill_step(cfg, cache_len=S + 4)(
        tp, {"tokens": torch.from_numpy(toks)})
    decode = serve.make_decode_step(cfg)
    for step in range(STEPS + 1):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL,
                                   err_msg=f"{arch} step {step}")
        for name in ("k", "v"):
            assert tc[name].shape == jc[name].shape
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                       atol=TOL, rtol=TOL)
        if step == STEPS:
            break
        jtok = np.asarray(jl)[:, -1].argmax(-1)[:, None]
        ttok = tl[:, -1].argmax(-1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), jtok)       # greedy tokens
        jl, jc = jfam.decode_step(jcfg, jp, jc, jnp.asarray(jtok, jnp.int32),
                                  jnp.full((B,), S + step, jnp.int32))
        tl, tc = decode(tp, tc, ttok, torch.full((B,), S + step, dtype=torch.int64))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """prefill(x[:t]) + decode(x[t]) == prefill(x[:t+1]) at the last position,
    as ``tests/test_models.py:50`` holds the JAX package (its limits, atol
    0.15 and rtol 0.05, in the smoke config's bf16) and, in float32, at 1e-4."""
    for dtype, atol, rtol in (("bfloat16", 0.15, 0.05), ("float32", TOL, TOL)):
        cfg = dataclasses.replace(configs.smoke(arch), param_dtype=dtype,
                                  compute_dtype=dtype)
        fam = family(cfg)
        params = fam.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
        toks = torch.from_numpy(tokens(cfg, 2, (1, S + 1)))
        _, cache = fam.prefill(cfg, params, {"tokens": toks[:, :S]}, cache_len=S + 4)
        dec, _ = fam.decode_step(cfg, params, cache, toks[:, S:S + 1],
                                 torch.full((1,), S, dtype=torch.int64))
        full, _ = fam.prefill(cfg, params, {"tokens": toks}, cache_len=S + 4)
        np.testing.assert_allclose(dec[:, -1].float().numpy(), full[:, -1].float().numpy(),
                                   atol=atol, rtol=rtol, err_msg=dtype)


def train_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = tokens(cfg, seed, (B, S + 1))
    mask = (rng.random((B, S)) < 0.9).astype(np.float32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    jcfg, cfg = pair(arch, remat=remat)
    jp, tp = jax_params(jcfg, seed=3)
    batch = train_batch(cfg, 4)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_family(jcfg).loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch)))(jp)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert float(transformer.loss_fn(cfg, tp, tbatch)) == pytest.approx(
        float(jloss), rel=TOL)
    tloss, tgrads = value_and_grad(lambda p, b: family(cfg).loss_fn(cfg, p, b), tp, tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    want = jax.tree.map(np.asarray, jgrads)
    got = convert.params_to_numpy(tgrads)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=TOL * np.abs(w).max(), rtol=TOL)


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32) * 4
    targets = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = JL.softmax_xent(jnp.asarray(logits), jnp.asarray(targets),
                               None if m is None else jnp.asarray(m))
        got = L.softmax_xent(torch.from_numpy(logits), torch.from_numpy(targets),
                             None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    # bf16 logits: the log-sum-exp runs in float32 in both
    lb = jnp.asarray(logits, jnp.bfloat16)
    got = L.softmax_xent(convert.to_tensor(np.asarray(lb), torch.bfloat16, device="cpu"),
                         torch.from_numpy(targets))
    np.testing.assert_allclose(float(got), float(JL.softmax_xent(lb, jnp.asarray(targets))),
                               rtol=1e-6)


def test_dense_configs_match_jax():
    for arch in ARCHS + ("qwen3-8b",):
        assert dataclasses.asdict(configs.get(arch)) == dataclasses.asdict(
            jax_configs.get(arch))
        assert dataclasses.asdict(configs.smoke(arch)) == dataclasses.asdict(
            jax_configs.smoke(arch))
        jcfg, cfg = pair(arch)
        want = jax_family(jcfg).init_cache(jcfg, 2, 10)
        got = family(cfg).init_cache(cfg, 2, 10, device="cpu")
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert tuple(got[name].shape) == w.shape and not got[name].any()
    cfg = configs.get("qwen3-1.7b")
    assert cfg.param_count() == 1_720_567_808
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab, cfg.qk_norm, cfg.rope_theta) == (
        28, 2048, 16, 8, 128, 6144, 151_936, True, 1e6)
    smoke = configs.smoke("qwen3-1.7b")
    params = transformer.init_params(smoke, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.eval_shape(lambda: jax_family(jax_configs.smoke("qwen3-1.7b")).init_params(
        jax_configs.smoke("qwen3-1.7b"), jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jshapes) == L.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype)[6:]), params)
