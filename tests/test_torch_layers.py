"""The port's layers against ``repro.models.layers`` on the CPU.

Inputs are made with numpy from a seed and parameters come from the JAX
initialisers, carried across with ``repro_torch.convert``. Tolerances:
float32 at atol/rtol 1e-5 (the same float32 arithmetic, summed in another
order); bfloat16 at 2e-2 (one bf16 rounding is 2^-8 = 3.9e-3 relative, and
a matrix product in the two frameworks rounds at other places: up to a few
ulps).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke as jax_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def cfgs(dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(jax_smoke("zamba2-1.2b"), **kw),
            dataclasses.replace(configs.smoke("zamba2-1.2b"), **kw))


def both(a, dtype):
    """The numpy array ``a`` as a JAX array and a CPU tensor of ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    j = jnp.asarray(a, jdt)
    return j, convert.to_tensor(np.asarray(j), tdt, device="cpu")


def close(got, want, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def jax_params(init, cfg, seed=0):
    jp = init(jax.random.PRNGKey(seed), cfg, cfg.pdtype())
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_norms_rope_and_gelu(dtype):
    rng = np.random.default_rng(0)
    jx, px = both(rng.normal(size=(2, 8, 4, 16)) * 3, dtype)
    js, ps = both(rng.uniform(0.5, 1.5, 16), dtype)
    jb, pb = both(rng.normal(size=16), dtype)
    close(L.rmsnorm(px, ps), JL.rmsnorm(jx, js), dtype)
    close(L.layernorm(px, ps, pb), JL.layernorm(jx, js, jb), dtype)
    pos = rng.integers(0, 4096, (2, 8))
    close(L.rope(px, torch.from_numpy(pos), 1e4),
          JL.rope(jx, jnp.asarray(pos, jnp.int32), 1e4), dtype)
    # jax.nn.gelu is the tanh approximation; torch's exact gelu is 4.7e-4 off
    close(L.ACTS["gelu"](px), JL.ACTS["gelu"](jx), dtype)
    close(L.ACTS["silu"](px), JL.ACTS["silu"](jx), dtype)
    close(L.ACTS["relu2"](px), JL.ACTS["relu2"](jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp(dtype):
    jcfg, pcfg = cfgs(dtype)
    jp, pp = jax_params(JL.init_mlp, jcfg)
    jx, px = both(np.random.default_rng(1).normal(size=(2, 16, 64)), dtype)
    close(L.mlp(pp, pcfg, px), JL.mlp(jp, jcfg, jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_train(dtype):
    jcfg, pcfg = cfgs(dtype)
    jp, pp = jax_params(JL.init_attention, jcfg)
    B, S = 2, 24
    jx, px = both(np.random.default_rng(2).normal(size=(B, S, 64)), dtype)
    pos = np.broadcast_to(np.arange(S), (B, S))
    got = L.attention_train(pp, pcfg, px, torch.from_numpy(pos.copy()))
    close(got, JL.attention_train(jp, jcfg, jx, jnp.asarray(pos)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_decode_writes_the_cache_in_place(dtype):
    jcfg, pcfg = cfgs(dtype)
    jp, pp = jax_params(JL.init_attention, jcfg)
    rng = np.random.default_rng(3)
    B, S, KV, hd = 2, 12, pcfg.n_kv_heads, pcfg.head_dim
    jx, px = both(rng.normal(size=(B, 1, 64)), dtype)
    jk, pk = both(rng.normal(size=(B, S, KV, hd)), dtype)
    jv, pv = both(rng.normal(size=(B, S, KV, hd)), dtype)
    pos = np.full((B,), 7, np.int32)
    ja, jk2, jv2 = JL.attention_decode(jp, jcfg, jx, jk, jv, jnp.asarray(pos))
    pa, pk2, pv2 = L.attention_decode(pp, pcfg, px, pk, pv, torch.from_numpy(pos).long())
    close(pa, ja, dtype)
    close(pk2, jk2, dtype)
    close(pv2, jv2, dtype)
    assert pk2 is pk and pv2 is pv


def test_attend_picks_full_or_chunked_as_jax_does():
    rng = np.random.default_rng(4)
    for S in (64, 512, 1024):
        jq, q = both(rng.normal(size=(1, S, 2, 32)), "float32")
        jk, k = both(rng.normal(size=(1, S, 1, 32)), "float32")
        jv, v = both(rng.normal(size=(1, S, 1, 32)), "float32")
        close(L.attend(q, k, v, causal=True), JL.attend(jq, jk, jv, causal=True),
              "float32")
    assert L.attend_full is fa.attend_full and L.ATTN_CHUNK == JL.ATTN_CHUNK


def test_embed_unembed_and_dense_init():
    jcfg, pcfg = cfgs("float32")
    jp, pp = jax_params(lambda r, c, d: JL.init_embed(r, c, d), jcfg)
    tokens = np.random.default_rng(5).integers(0, pcfg.vocab, (2, 9))
    jx = JL.embed(jp, jnp.asarray(tokens))
    px = L.embed(pp, torch.from_numpy(tokens))
    close(px, jx, "float32")
    close(L.unembed(pp, px), JL.unembed(jp, jx), "float32")
    g = torch.Generator("cpu").manual_seed(0)
    w = L.dense_init(g, (400, 300), torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.device.type == "cpu"
    assert abs(float(w.float().std()) - 400 ** -0.5) < 2e-3


def test_maybe_remat_checkpoints_only_where_autograd_records(monkeypatch):
    """A layer is checkpointed under ``cfg.remat`` when autograd records (a
    tensor of its arguments, here one inside a dict as a layer's parameters
    are, requires a gradient, in grad mode), and called as it is without
    remat, under ``no_grad``, or where nothing requires a gradient
    (serving), with the same result either way."""
    calls = []
    real = L.checkpoint

    def counting(f, *args, **kw):
        calls.append(f)
        return real(f, *args, **kw)
    monkeypatch.setattr(L, "checkpoint", counting)

    def scale(layer, x):
        return layer["w"] * x

    x = torch.arange(4.0)
    for remat, grad, wants, checkpointed in ((True, True, True, 1), (True, False, True, 0),
                                             (True, True, False, 0), (False, True, True, 0)):
        cfg = dataclasses.replace(configs.smoke("qwen3-1.7b"), remat=remat)
        layer = {"w": torch.tensor(3.0, requires_grad=wants)}
        with torch.set_grad_enabled(grad):
            y = L.maybe_remat(cfg, scale, layer, x)
        assert torch.equal(y, 3.0 * x) and (y.grad_fn is not None) == (grad and wants)
        assert len(calls) == checkpointed, (remat, grad, wants)
        calls.clear()
