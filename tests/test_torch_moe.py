"""The moe family in the port (``repro_torch.models.moe``) against the JAX
package on the CPU, in float32.

Parameters come from the JAX initialiser, carried across with
``repro_torch.convert.params_from_jax``; inputs from numpy seeds. Both sides
run in float32, and everything is held at atol/rtol 1e-4 (the same float32
arithmetic in another order), as ``tests/test_torch_transformer.py`` holds
the dense family:

* ``moe_mlp`` at the smoke configs, at a capacity factor low enough that
  pairs drop (the test asserts that some do), and on zero input (zero
  output, as ``tests/test_models.py:83`` holds the reference);
* ``block``, one layer's training forward;
* the smoke granite-moe and qwen3-moe served: prefill plus 3 greedy decode
  steps through ``launch.serve``, logits and KV caches, equal greedy tokens.
  At decode the capacity is 1 to 2, so tokens drop there, and the test
  asserts that some did.

The router's choice sets: ``torch.topk`` must pick the set that
``jax.lax.top_k`` picks from the same probabilities. A token whose k-th and
(k+1)-th probabilities lie within ``NEAR_TIE`` of each other may pick
otherwise on another backend; such tokens are counted and reported, never
avoided by another seed.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import family as jax_family  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import family, moe  # noqa: E402

ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
B, S, STEPS = 4, 32, 3
TOL = 1e-4
NEAR_TIE = 1e-5      # a gap between the k-th and (k+1)-th probability this small


def pair(arch, **kw):
    kw = dict(param_dtype="float32", compute_dtype="float32", **kw)
    return (dataclasses.replace(jax_configs.smoke(arch), **kw),
            dataclasses.replace(configs.smoke(arch), **kw))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


class Routes:
    """Records every call of ``moe.route``: its inputs' token count, the
    capacity, the chosen experts and the probabilities."""

    def __init__(self, monkeypatch, cfg):
        self.calls = []
        route = moe.route

        def recording(params, cfg_, xf):
            top_p, top_e, probs = route(params, cfg_, xf)
            self.calls.append((moe.capacity(cfg_, xf.shape[0]), top_e, probs))
            return top_p, top_e, probs
        monkeypatch.setattr(moe, "route", recording)
        self.cfg = cfg

    def dropped(self):
        """Pairs past capacity in each recorded call."""
        out = []
        for C, top_e, _ in self.calls:
            counts = torch.bincount(top_e.reshape(-1), minlength=self.cfg.n_experts)
            out.append(int(torch.clamp_min(counts - C, 0).sum()))
        return out

    def check_choice_sets(self):
        """The sets torch.topk chose equal jax.lax.top_k's on the same
        probabilities, wherever no near-tie is reported. Returns the count of
        near-tied tokens."""
        K, near = self.cfg.top_k, 0
        for _, top_e, probs in self.calls:
            _, jtop = jax.lax.top_k(jnp.asarray(probs.numpy()), K)
            ranked = torch.sort(probs, dim=-1, descending=True).values
            tied = (ranked[:, K - 1] - ranked[:, K]) < NEAR_TIE
            near += int(tied.sum())
            got = np.sort(top_e.numpy(), -1)[~tied.numpy()]
            want = np.sort(np.asarray(jtop), -1)[~tied.numpy()]
            np.testing.assert_array_equal(got, want)
        return near


@pytest.mark.parametrize("arch,capacity_factor", [
    ("granite-moe-3b-a800m", None), ("qwen3-moe-235b-a22b", None),
    ("granite-moe-3b-a800m", 0.3), ("qwen3-moe-235b-a22b", 0.3)])
def test_moe_mlp_matches_jax(monkeypatch, arch, capacity_factor):
    kw = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    jcfg, cfg = pair(arch, **kw)
    jp = jax_moe.init_moe_mlp(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = convert.params_from_jax(to_numpy(jp), device="cpu")
    x = np.random.default_rng(2).normal(size=(3, 40, cfg.d_model)).astype(np.float32)
    routes = Routes(monkeypatch, cfg)
    got = moe.moe_mlp(tp, cfg, torch.from_numpy(x))
    want = np.asarray(jax_moe.moe_mlp(jp, jcfg, jnp.asarray(x)))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    routes.check_choice_sets()
    dropped = routes.dropped()[0]
    if capacity_factor is not None:
        assert dropped > 0, "a capacity factor of 0.3 drops pairs"
        assert moe.capacity(cfg, 120) == int(max(1, round(0.3 * 120 * cfg.top_k
                                                           / cfg.n_experts)))


def test_moe_mlp_of_zero_is_zero():
    jcfg, cfg = pair("granite-moe-3b-a800m")
    jp = jax_moe.init_moe_mlp(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = convert.params_from_jax(to_numpy(jp), device="cpu")
    y0 = moe.moe_mlp(tp, cfg, torch.zeros(2, 64, cfg.d_model))
    np.testing.assert_allclose(y0.numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(
        y0.numpy(), np.asarray(jax_moe.moe_mlp(jp, jcfg, jnp.zeros((2, 64, cfg.d_model)))),
        atol=TOL, rtol=TOL)


def test_capacity_rounds_halves_to_even():
    cfg = dataclasses.replace(configs.get("granite-moe-3b-a800m"))
    assert moe.capacity(cfg, 8) == 2                 # decode: 1.25 * 8 * 8 / 40
    assert moe.capacity(cfg, 8 * 2048) == 4096       # the full-size prefill
    half = dataclasses.replace(cfg, capacity_factor=1.0, top_k=1, n_experts=4)
    assert moe.capacity(half, 10) == 2               # round(2.5) is 2, not 3
    assert moe.capacity(half, 14) == 4               # round(3.5) is 4
    assert moe.capacity(half, 1) == 1                # at least 1


@pytest.mark.parametrize("arch", ARCHS)
def test_block_matches_jax(arch):
    jcfg, cfg = pair(arch)
    jparams = jax_family(jcfg).init_params(jcfg, jax.random.PRNGKey(3))
    jlayer = jax.tree.map(lambda a: a[0], jparams["layers"])
    layer = convert.params_from_jax(to_numpy(jlayer), device="cpu")
    x = np.random.default_rng(4).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(24), (2, 24))
    want = jax_moe.block(jcfg, jlayer, jnp.asarray(x), jnp.asarray(positions), None)
    got = moe.block(cfg, layer, torch.from_numpy(x), torch.from_numpy(positions.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_jax(monkeypatch, arch):
    jcfg, cfg = pair(arch)
    jp = jax_family(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(to_numpy(jp), device="cpu")
    toks = np.random.default_rng(1).integers(2, cfg.vocab, (B, S)).astype(np.int32)
    routes = Routes(monkeypatch, cfg)
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
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        jl, jc = jfam.decode_step(jcfg, jp, jc, jnp.asarray(jtok, jnp.int32),
                                  jnp.full((B,), S + step, jnp.int32))
        tl, tc = decode(tp, tc, ttok, torch.full((B,), S + step, dtype=torch.int64))
    near = routes.check_choice_sets()
    dropped = routes.dropped()
    assert len(dropped) == cfg.n_layers * (STEPS + 1)
    assert sum(dropped[cfg.n_layers:]) > 0, "decode at capacity 1-2 drops pairs"
    print(f"{arch}: dropped pairs per call {dropped}; near-tied tokens {near}")


def test_moe_configs_match_jax():
    for arch in ARCHS:
        assert dataclasses.asdict(configs.get(arch)) == dataclasses.asdict(
            jax_configs.get(arch))
        assert dataclasses.asdict(configs.smoke(arch)) == dataclasses.asdict(
            jax_configs.smoke(arch))
        assert configs.get(arch).param_count() == jax_configs.get(arch).param_count()
        assert (configs.get(arch).active_param_count()
                == jax_configs.get(arch).active_param_count())
        jcfg, cfg = pair(arch)
        assert family(cfg) is moe
        want = jax_family(jcfg).init_cache(jcfg, 2, 10)
        got = family(cfg).init_cache(cfg, 2, 10, device="cpu")
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert tuple(got[name].shape) == w.shape and not got[name].any()
        params = moe.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        jshapes = jax.eval_shape(lambda: jax_family(jcfg).init_params(
            jcfg, jax.random.PRNGKey(0)))
        assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jshapes) == \
            jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), params)
    cfg = configs.get("granite-moe-3b-a800m")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab, cfg.n_experts, cfg.top_k) == (
        32, 1536, 24, 8, 64, 512, 49_155, 40, 8)


def test_every_architecture_has_a_config_and_a_family():
    assert configs.ALL_ARCHS == jax_configs.ARCHS
    for arch in configs.ALL_ARCHS:
        cfg = configs.get(arch)
        assert family(cfg).__name__.split(".")[-1] == jax_family(
            jax_configs.get(arch)).__name__.split(".")[-1]
