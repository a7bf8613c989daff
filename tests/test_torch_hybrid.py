"""The serving slice end to end: the port's hybrid (zamba2) and ssm (mamba2)
families against the JAX package on the CPU, plus the port's configs,
``convert`` and the serving CLI.

Smoke configs, B = 2, S = 64, caches of S + 4, prefill then 3 greedy decode
steps through ``launch.serve.make_prefill_step`` / ``make_decode_step`` in
both packages, on parameters from the JAX initialiser carried across with
``convert.params_from_jax``.

* float32: prefill logits, every cache tensor and each decode step's logits
  at atol/rtol 1e-4 (float32 arithmetic in another order through 3-6
  layers), and equal greedy tokens.
* bfloat16: both packages decode JAX's greedy tokens. bf16 rounding happens
  at other places in the two frameworks (XLA fuses elementwise chains), and
  the smoke zamba2 amplifies it: JAX's own bf16 logits lie up to 11% of
  their largest magnitude from its float32 logits, so a limit on the largest
  logit cannot tell a sound port from one that rounds in the wrong place. The
  test holds instead where the port rounds: for the logits and every cache
  tensor at every step, the port's relative RMS distance to JAX's bf16 run
  over JAX's bf16 run's relative RMS distance to its float32 run, averaged,
  stays below ``BF16_RATIO``. A port that rounds where JAX does lands well
  inside bf16's own noise (0.65 and 0.70 here); one with a planted fault,
  ``rmsnorm`` without its float32 inside, lands near it (1.04 and 0.95), and
  the test checks that the fault fails. Run this file as a script to print
  the readings. Where JAX's bf16 error is within 2e-2 of the largest logit
  (the smoke mamba2), the port's bf16 logits are also within 2e-2 of JAX's.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import family as jax_family  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import family, hybrid, moe  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

B, S, STEPS = 2, 64, 3
ARCHS = ("zamba2-1.2b", "mamba2-780m")
BF16_RATIO = 0.8     # between the sound readings (<= 0.70) and the fault's (>= 0.95)


def smoke_pair(arch, dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(jax_configs.smoke(arch), **kw),
            dataclasses.replace(configs.smoke(arch), **kw))


def argmax_tokens(logits):
    return np.asarray(logits, np.float32)[:, -1].argmax(-1)[:, None]


def as_key(tokens):
    """Tokens fed per step as nested tuples of ints (hashable)."""
    return tuple(tuple(int(v) for v in np.ravel(t)) for t in tokens)


def as_step(key):
    return np.asarray(key, np.int64).reshape(B, 1)


@functools.cache
def run_jax(arch, dtype, forced=None):
    """Prefill + STEPS decode steps in JAX: logits per step, cache arrays per
    step, and the tokens fed (its own greedy tokens, or ``forced``)."""
    cfg, _ = smoke_pair(arch, dtype)
    params = jax_family(cfg).init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(2, cfg.vocab, (B, S)).astype(np.int32)
    logits, cache = jax_serve.make_prefill_step(cfg, None, cache_len=S + 4)(
        params, {"tokens": jnp.asarray(tokens)})
    decode = jax_serve.make_decode_step(cfg, None)
    out = [(np.asarray(logits, np.float32), jax.tree.map(np.asarray, cache))]
    fed = []
    for i in range(STEPS):
        tok = argmax_tokens(logits) if forced is None else as_step(forced[i])
        fed.append(tok)
        logits, cache = decode(params, cache, jnp.asarray(tok, jnp.int32),
                               jnp.full((B,), S + i, jnp.int32))
        out.append((np.asarray(logits, np.float32), jax.tree.map(np.asarray, cache)))
    return (jax.tree.map(np.asarray, params), tokens), out, as_key(fed)


def run_port(arch, dtype, jax_params, tokens, forced=None):
    _, cfg = smoke_pair(arch, dtype)
    params = convert.params_from_jax(jax_params, device="cpu")
    logits, cache = serve.make_prefill_step(cfg, cache_len=S + 4)(
        params, {"tokens": torch.from_numpy(tokens)})
    decode = serve.make_decode_step(cfg)
    out = [(logits.float().numpy(), convert.cache_to_numpy(cache))]
    fed = []
    for i in range(STEPS):
        tok = argmax_tokens(out[-1][0]) if forced is None else as_step(forced[i])
        fed.append(tok)
        logits, cache = decode(params, cache, torch.from_numpy(tok),
                               torch.full((B,), S + i, dtype=torch.int64))
        out.append((logits.float().numpy(), convert.cache_to_numpy(cache)))
    return out, as_key(fed)


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_serving_matches_jax(arch):
    (params, tokens), want, want_fed = run_jax(arch, "float32")
    got, got_fed = run_port(arch, "float32", params, tokens)
    assert got_fed == want_fed                        # equal greedy tokens
    for step, ((gl, gc), (wl, wc)) in enumerate(zip(got, want)):
        assert gl.shape == wl.shape == (B, 1, smoke_pair(arch, "float32")[1].vocab)
        np.testing.assert_allclose(gl, wl, atol=1e-4, rtol=1e-4, err_msg=f"step {step}")
        assert sorted(gc) == sorted(wc)
        for name in wc:
            assert gc[name].dtype == wc[name].dtype and gc[name].shape == wc[name].shape
            np.testing.assert_allclose(gc[name], wc[name], atol=1e-4, rtol=1e-4,
                                       err_msg=f"step {step} cache {name}")


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def bf16_ratio(got, want, ref32) -> float:
    """Mean over steps, and over the logits and every cache tensor, of the
    port's relative RMS distance to JAX's bf16 run (``want``) over that run's
    relative RMS distance to JAX's float32 run (``ref32``)."""
    ratios = []
    for (gl, gc), (wl, wc), (rl, rc) in zip(got, want, ref32):
        ratios.append(rel_rms(gl, wl) / rel_rms(wl, rl))
        ratios += [rel_rms(gc[n].astype(np.float32), wc[n].astype(np.float32))
                   / rel_rms(wc[n].astype(np.float32), rc[n]) for n in wc]
    return float(np.mean(ratios))


def rmsnorm_in_bf16(x, scale, eps=1e-6):
    """The planted fault: ``rmsnorm`` without its float32 inside."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def bf16_runs(arch):
    """JAX's bf16 run, JAX's float32 run and the port's bf16 run, all fed
    JAX's bf16 greedy tokens."""
    (params, tokens), want, fed = run_jax(arch, "bfloat16")
    _, ref32, _ = run_jax(arch, "float32", forced=fed)
    got, _ = run_port(arch, "bfloat16", params, tokens, forced=fed)
    return got, want, ref32


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_serving_tracks_jax(arch):
    got, want, ref32 = bf16_runs(arch)
    assert all(gc["ssm"].dtype.name == "bfloat16" for _, gc in got)
    assert bf16_ratio(got, want, ref32) < BF16_RATIO
    for step, ((gl, _), (wl, _), (rl, _)) in enumerate(zip(got, want, ref32)):
        if np.abs(wl - rl).max() <= 2e-2 * np.abs(rl).max():
            np.testing.assert_allclose(gl, wl, atol=2e-2 * np.abs(wl).max(), rtol=0,
                                       err_msg=f"step {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_limit_fails_a_planted_fault(arch, monkeypatch):
    monkeypatch.setattr(L, "rmsnorm", rmsnorm_in_bf16)
    assert bf16_ratio(*bf16_runs(arch)) > BF16_RATIO


def test_configs_match_jax_and_unported_archs_raise():
    for arch in ARCHS:
        assert configs.get(arch).param_count() == jax_configs.get(arch).param_count()
        assert (configs.get(arch).active_param_count()
                == jax_configs.get(arch).active_param_count())
        assert dataclasses.asdict(configs.smoke(arch)) == dataclasses.asdict(
            jax_configs.smoke(arch))
    for arch in ARCHS:
        jcfg, pcfg = smoke_pair(arch, "bfloat16")
        want = jax_family(jcfg).init_cache(jcfg, 2, 10)
        got = family(pcfg).init_cache(pcfg, 2, 10, device="cpu")
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert tuple(got[name].shape) == w.shape and got[name].dtype == torch.bfloat16
            assert not got[name].any()
    cfg = configs.get("zamba2_1p2b")
    assert (cfg.head_dim, cfg.d_inner, cfg.n_ssm_heads) == (64, 4096, 64)
    assert cfg.dtype() == torch.bfloat16 and hybrid.n_shared(cfg) == 6
    # the moe family is ported: its config and module, not a raise
    assert configs.get("granite-moe-3b-a800m") == configs.granite_moe_3b_a800m.CONFIG
    assert family(jax_configs.get("granite-moe-3b-a800m")) is moe
    with pytest.raises(ValueError, match="unknown architecture"):
        configs.smoke("no-such-model")


def test_bfloat16_arrays_cross_bit_for_bit():
    jp = jax_family(jax_configs.smoke("zamba2-1.2b")).init_params(
        jax_configs.smoke("zamba2-1.2b"), jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, jp)
    params = convert.params_from_jax(tree, device="cpu")
    assert params["layers"]["mixer"]["in_proj"].dtype == torch.bfloat16
    assert params["layers"]["mixer"]["A_log"].dtype == torch.float32
    back = convert.params_to_numpy(params)
    flat_a, flat_b = jax.tree.leaves(tree), jax.tree.leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_to_tensor_takes_bfloat16_arrays():
    a = np.asarray(jnp.arange(7, dtype=jnp.bfloat16) / 3)
    t = convert.to_tensor(a, torch.bfloat16, device="cpu")
    assert t.dtype == torch.bfloat16
    assert convert.to_numpy(t).tobytes() == a.tobytes()
    np.testing.assert_array_equal(convert.to_tensor(a, device="cpu").numpy(),
                                  a.astype(np.float32))


def test_serve_cli_on_the_cpu(capsys):
    toks = serve.main(["--device", "cpu", "--prompt-len", "16", "--gen", "4"])
    assert toks.shape == (2, 4) and toks.device.type == "cpu"
    assert "generated (2, 4)" in capsys.readouterr().out
    toks = serve.main(["--device", "cpu", "--arch", "zamba2-1.2b", "--prompt-len", "16",
                       "--gen", "4"])
    assert toks.shape == (2, 4)
    toks = serve.main(["--device", "cpu", "--arch", "mamba2-780m",
                       "--prompt-len", "8", "--gen", "2", "--batch", "1"])
    assert toks.shape == (1, 2)


def largest_logit_errors(got, want):
    return [round(float(np.abs(g - w).max() / np.abs(w).max()), 4)
            for (g, _), (w, _) in zip(got, want)]


if __name__ == "__main__":
    # the bf16 readings, per step: relative RMS distances to JAX's bf16 run,
    # and the largest logit error over the largest logit
    for arch in ARCHS:
        runs = {"sound": bf16_runs(arch)}
        L.rmsnorm, sound_rmsnorm = rmsnorm_in_bf16, L.rmsnorm
        runs["planted fault"] = bf16_runs(arch)
        L.rmsnorm = sound_rmsnorm
        for name, (got, want, ref32) in runs.items():
            steps = [{"logits": round(rel_rms(gl, wl), 4),
                      **{n: round(rel_rms(gc[n].astype(np.float32),
                                          wc[n].astype(np.float32)), 4) for n in wc}}
                     for (gl, gc), (wl, wc) in zip(got, want)]
            print(f"{arch} {name}: ratio {bf16_ratio(got, want, ref32):.4f}; "
                  f"distance to JAX bf16 {steps}; largest logit error against "
                  f"JAX float32 {largest_logit_errors(got, ref32)}, against JAX "
                  f"bf16 {largest_logit_errors(got, want)}")
        print(f"{arch} JAX bf16: largest logit error against JAX float32 "
              f"{largest_logit_errors(want, ref32)}")
