"""The two families with a stub frontend in the port, the encoder-decoder
(``repro_torch.models.encdec``, seamless-m4t-medium) and the VLM
(``repro_torch.models.vlm``, internvl2-26b), against the JAX package on the
CPU, in float32.

Parameters come from the JAX initialiser, carried across with
``repro_torch.convert.params_from_jax``; tokens, frames and image
embeddings from numpy seeds. Everything is held at atol/rtol 1e-4 (the same
float32 arithmetic in another order), as ``tests/test_torch_transformer.py``
holds the dense family:

* seamless: ``encode``, ``cross_attend`` (q of length 1 and of the
  decoder's length against the encoder's keys), ``dec_block``, and prefill
  (cross keys at S / 4) plus 3 greedy decode steps through ``launch.serve``,
  logits and every cache tensor, ``mk``/``mv`` included, and equal greedy
  tokens;
* internvl2: prefill plus 3 decode steps with the image prefix, the cache
  counting the prefix and decode positions starting after it;
* the configs' fields and caches against the reference's, and the serving
  CLI's request batches for both.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models import family as jax_family  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import encdec, family, transformer, vlm  # noqa: E402

ENCDEC, VLM = "seamless-m4t-medium", "internvl2-26b"
B, S, STEPS = 2, 32, 3
TOL = 1e-4


def pair(arch):
    kw = dict(param_dtype="float32", compute_dtype="float32")
    return (dataclasses.replace(jax_configs.smoke(arch), **kw),
            dataclasses.replace(configs.smoke(arch), **kw))


def params_pair(jcfg, seed=0):
    jp = jax_family(jcfg).init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def close(got, want, what=""):
    assert tuple(got.shape) == tuple(np.shape(want)), what
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL,
                               err_msg=what)


def first_layer(tree):
    return jax.tree.map(lambda a: a[0], tree)


def test_encode_and_cross_attend_match_jax():
    jcfg, cfg = pair(ENCDEC)
    jp, tp = params_pair(jcfg, seed=1)
    frames = normal(2, (B, S // cfg.enc_len_ratio, cfg.d_model))
    jenc = jax_encdec.encode(jcfg, jp, jnp.asarray(frames))
    enc = encdec.encode(cfg, tp, torch.from_numpy(frames))
    close(enc, jenc, "encode")
    jcross = first_layer(jp["dec"])["cross"]
    cross = convert.params_from_jax(jax.tree.map(np.asarray, jcross), device="cpu")
    jmk, jmv = jax_encdec.cross_kv(jcross, jcfg, jenc)
    mk, mv = encdec.cross_kv(cross, cfg, enc)
    close(mk, jmk, "mk")
    close(mv, jmv, "mv")
    for sq in (1, S):                      # decode, and the decoder's length
        x = normal(3 + sq, (B, sq, cfg.d_model))
        close(encdec.cross_attend(cross, cfg, torch.from_numpy(x), mk, mv),
              jax_encdec.cross_attend(jcross, jcfg, jnp.asarray(x), jmk, jmv),
              f"cross_attend, {sq} queries")


def test_dec_block_matches_jax():
    jcfg, cfg = pair(ENCDEC)
    jp, _ = params_pair(jcfg, seed=4)
    jlayer = first_layer(jp["dec"])
    layer = convert.params_from_jax(jax.tree.map(np.asarray, jlayer), device="cpu")
    x = normal(5, (B, S, cfg.d_model))
    enc = normal(6, (B, S // cfg.enc_len_ratio, cfg.d_model))
    positions = np.broadcast_to(np.arange(S), (B, S))
    want = jax_encdec.dec_block(jcfg, jlayer, jnp.asarray(x), jnp.asarray(enc),
                                jnp.asarray(positions), None)
    got = encdec.dec_block(cfg, layer, torch.from_numpy(x), torch.from_numpy(enc),
                           torch.from_numpy(positions.copy()))
    close(got, want, "dec_block")


def serve_both(arch, batch, pos0, cache_len):
    """Prefill then STEPS greedy decode steps in both packages; holds the
    logits and every cache tensor at each step and the greedy tokens.
    Returns the port's last cache."""
    jcfg, cfg = pair(arch)
    jp, tp = params_pair(jcfg)
    jfam = jax_family(jcfg)
    jl, jc = jfam.prefill(jcfg, jp, jax.tree.map(jnp.asarray, batch), cache_len=cache_len)
    tl, tc = serve.make_prefill_step(cfg, cache_len=cache_len)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    decode = serve.make_decode_step(cfg)
    for step in range(STEPS + 1):
        close(tl, jl, f"{arch} logits, step {step}")
        assert sorted(tc) == sorted(jc)
        for name in jc:
            close(tc[name], jc[name], f"{arch} cache {name}, step {step}")
        if step == STEPS:
            return tc
        jtok = np.asarray(jl)[:, -1].argmax(-1)[:, None]
        ttok = tl[:, -1].argmax(-1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        jl, jc = jfam.decode_step(jcfg, jp, jc, jnp.asarray(jtok, jnp.int32),
                                  jnp.full((B,), pos0 + step, jnp.int32))
        tl, tc = decode(tp, tc, ttok, torch.full((B,), pos0 + step, dtype=torch.int64))


def test_encdec_serving_matches_jax():
    cfg = configs.smoke(ENCDEC)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(2, cfg.vocab, (B, S)).astype(np.int32),
             "frames": normal(8, (B, S // cfg.enc_len_ratio, cfg.d_model))}
    cache = serve_both(ENCDEC, batch, S, S + 4)
    assert cache["mk"].shape == (cfg.n_layers, B, S // 4, cfg.n_kv_heads, cfg.head_dim)
    # decode wrote positions S .. S + STEPS - 1 of the self cache, in place
    assert cache["k"][:, :, S:S + STEPS].abs().amax(dim=(1, 3, 4)).min() > 0
    assert not cache["k"][:, :, S + STEPS:].any()


def test_vlm_serving_with_the_image_prefix_matches_jax():
    cfg = configs.smoke(VLM)
    n_img = cfg.n_image_tokens
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(2, cfg.vocab, (B, S)).astype(np.int32),
             "image_embeds": normal(10, (B, n_img, cfg.d_model))}
    pos0 = n_img + S
    cache = serve_both(VLM, batch, pos0, pos0 + 4)
    assert cache["k"].shape[2] == pos0 + 4
    assert cache["k"][:, :, :pos0 + STEPS].abs().amax(dim=(1, 3, 4)).min() > 0
    assert not cache["k"][:, :, pos0 + STEPS:].any()
    assert vlm.prefill is transformer.prefill and vlm.decode_step is transformer.decode_step


def test_stub_configs_match_jax_and_serve_from_the_cli():
    for arch, module in ((ENCDEC, encdec), (VLM, vlm)):
        assert dataclasses.asdict(configs.get(arch)) == dataclasses.asdict(
            jax_configs.get(arch))
        assert dataclasses.asdict(configs.smoke(arch)) == dataclasses.asdict(
            jax_configs.smoke(arch))
        assert configs.get(arch).param_count() == jax_configs.get(arch).param_count()
        jcfg, cfg = pair(arch)
        assert family(cfg) is module
        want = jax_family(jcfg).init_cache(jcfg, 2, 16)
        got = family(cfg).init_cache(cfg, 2, 16, device="cpu")
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert tuple(got[name].shape) == w.shape and not got[name].any()
        params = module.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        jshapes = jax.eval_shape(lambda: jax_family(jcfg).init_params(
            jcfg, jax.random.PRNGKey(0)))
        assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jshapes) == \
            jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), params)
        batch = serve.make_batch(cfg, torch.Generator().manual_seed(0), 3, 16)
        stub = {"encdec": ("frames", 4), "vlm": ("image_embeds", cfg.n_image_tokens)}
        name, length = stub[cfg.family]
        assert sorted(batch) == sorted(["tokens", name])
        assert batch[name].shape == (3, length, cfg.d_model)
        assert serve.prefix_len(cfg) == (cfg.n_image_tokens if arch == VLM else 0)
        toks = serve.main(["--arch", arch, "--device", "cpu", "--gen", "5"])
        assert toks.shape == (2, 5)
    cfg = configs.get(ENCDEC)
    assert (cfg.encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.vocab, cfg.enc_len_ratio) == (12, 12, 1024, 16, 16, 64,
                                                            256_206, 4)
