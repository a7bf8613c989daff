"""The port's train step (``repro_torch.launch.train.make_train_step``)
against the JAX package's (``jax.jit(repro.launch.train.make_train_step(cfg,
None, ...))``) on the CPU, from the same parameters and data.

float32, smoke qwen3-1.7b, two steps at steps 200 and 201 of a 300-step
schedule (full learning rate), microbatches M = 1 and 2, remat off and on:
loss, grad_norm and lr at rtol 1e-5, the parameters and both moments at
atol/rtol 1e-4 of each leaf's largest magnitude and 1e-4 relative (float32
gradients in another summation order; AdamW's first steps move each
parameter by about lr whatever the gradient's size, so a gradient that
differs in its last bits moves the parameter by the same amount).

bfloat16 (the configuration's own dtypes, M = 2 with remat): XLA and torch
round bf16 at other places, so the test holds where the port rounds, as
``tests/test_torch_hybrid.py`` does for serving: for the parameters' update,
each moment and the losses, the relative RMS distance of the port's steps to
JAX's bf16 steps, over the distance of JAX's bf16 steps to its float32
steps, stays below ``BF16_RATIO``. A sound port reads 0.15 (update), 0.67
(m), 0.63 (v) and 0.07 (loss); with ``rmsnorm`` computed in bf16, a planted
fault, m and v read 1.11 and 1.10, and a test checks that the fault fails.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import host_batch as jax_host_batch  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import family as jax_family  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import DataConfig, host_batch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import family  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "qwen3-1.7b"
B, S = 4, 32
STEPS = (200, 201)
TOTAL = 300
BF16_RATIO = 0.85    # between the sound readings (<= 0.67) and the fault's (>= 1.10)


def run_jax(cfg, params):
    opt_cfg = JaxAdamWConfig(moment_dtype=cfg.opt_state_dtype)
    step_fn = jax.jit(jax_train.make_train_step(cfg, None, opt_cfg, total_steps=TOTAL))
    opt = jax_adamw.init(params, opt_cfg)
    dcfg = JaxDataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    metrics = []
    for step in STEPS:
        batch = jax.tree.map(jnp.asarray, jax_host_batch(dcfg, step, 0, 1))
        params, opt, m = step_fn(params, opt, batch, jnp.int32(step))
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt), metrics


def run_port(cfg, jparams):
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
    step_fn = train.make_train_step(cfg, opt_cfg, total_steps=TOTAL)
    opt = adamw.init(params, opt_cfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    metrics = []
    for step in STEPS:
        batch = train.batch_to(host_batch(dcfg, step, 0, 1), "cpu")
        params, opt, m = step_fn(params, opt, batch, step)
        metrics.append({k: float(v) for k, v in m.items()})
    return convert.params_to_numpy(params), convert.params_to_numpy(opt), metrics


def pair(**kw):
    return (dataclasses.replace(jax_configs.smoke(ARCH), **kw),
            dataclasses.replace(configs.smoke(ARCH), **kw))


def leaves_close(got, want, tol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32),
                                   atol=tol * max(np.abs(w).max(), 1e-30), rtol=tol)


@pytest.mark.parametrize("microbatches,remat", [(1, False), (1, True), (2, False), (2, True)])
def test_train_steps_match_jax(microbatches, remat):
    jcfg, cfg = pair(param_dtype="float32", compute_dtype="float32",
                     microbatches=microbatches, remat=remat)
    params = jax_family(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    jp, jo, jm = run_jax(jcfg, params)
    tp, to, tm = run_port(cfg, params)
    for got, want in zip(tm, jm):
        assert sorted(got) == sorted(want) == ["grad_norm", "loss", "lr"]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    leaves_close(tp, jp, 1e-4)
    assert int(to["count"]) == int(jo["count"]) == len(STEPS)
    leaves_close(to["m"], jo["m"], 1e-4)
    leaves_close(to["v"], jo["v"], 1e-4)


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def state_vector(params, opt, metrics):
    """Every parameter and moment, and the losses, as one float64 vector per
    kind, for the relative RMS distances."""
    flat = lambda t: np.concatenate([x.astype(np.float64).ravel()  # noqa: E731
                                     for x in jax.tree.leaves(t)])
    return {"params": flat(params), "m": flat(opt["m"]), "v": flat(opt["v"]),
            "loss": np.array([m["loss"] for m in metrics])}


@functools.cache
def jax_bf16_runs():
    """JAX's bf16 step and its float32 step from the same bf16 parameters, as
    state vectors, and the parameters."""
    jcfg, _ = pair(microbatches=2, remat=True)
    assert jcfg.param_dtype == "bfloat16" and jcfg.opt_state_dtype == "float32"
    params = jax_family(jcfg).init_params(jcfg, jax.random.PRNGKey(1))
    jcfg32 = dataclasses.replace(jcfg, param_dtype="float32", compute_dtype="float32")
    return (params, state_vector(*run_jax(jcfg, params)),
            state_vector(*run_jax(jcfg32, jax.tree.map(lambda x: x.astype(jnp.float32),
                                                       params))))


def bf16_ratios() -> dict:
    """Per kind, the port's relative RMS distance to JAX's bf16 step over
    that step's distance to JAX's float32 step; for the parameters, of the
    update from the bf16 start."""
    params, want, ref = jax_bf16_runs()
    got_params, got_opt, got_metrics = run_port(pair(microbatches=2, remat=True)[1], params)
    assert got_params["layers"]["attn"]["wq"].dtype.name == "bfloat16"
    got = state_vector(got_params, got_opt, got_metrics)
    start = np.concatenate([np.asarray(x, np.float64).ravel()
                            for x in jax.tree.leaves(params)])
    ratios = {}
    for kind in ("params", "m", "v", "loss"):
        g, w, r = got[kind], want[kind], ref[kind]
        if kind == "params":
            g, w, r = g - start, w - start, r - start
        ratios[kind] = rel_rms(g, w) / rel_rms(w, r)
    return ratios


def test_bf16_train_steps_track_jax():
    ratios = bf16_ratios()
    assert max(ratios.values()) < BF16_RATIO, ratios


def rmsnorm_in_bf16(x, scale, eps=1e-6):
    """The planted fault: ``rmsnorm`` without its float32 inside."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def test_bf16_limit_fails_a_planted_fault(monkeypatch):
    monkeypatch.setattr(L, "rmsnorm", rmsnorm_in_bf16)
    assert max(bf16_ratios().values()) > BF16_RATIO


def test_train_cli_on_the_cpu(tmp_path, capsys):
    params, opt, metrics = train.main(["--smoke", "--arch", ARCH, "--device", "cpu",
                                       "--steps", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     1 loss" in out and out.strip().endswith("done")
    assert np.isfinite(float(metrics["loss"])) and int(opt["count"]) == 2
    assert all(t.device.type == "cpu" for t in tree_leaves(params))
    resumed, _, _ = train.main(["--smoke", "--arch", ARCH, "--device", "cpu",
                                "--steps", "2", "--resume", str(tmp_path)])
    assert "resumed from step 2" in capsys.readouterr().out
    for a, b in zip(tree_leaves(resumed), tree_leaves(params)):
        assert torch.equal(a, b)



@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "seamless-m4t-medium",
                                  "internvl2-26b"])
def test_families_that_only_serve_raise_for_a_train_step(arch, capsys):
    """moe, encdec and vlm once only served, and their train step raised;
    they train now: one train step of the smoke config on the CPU, with the
    stub frontend's inputs from ``train_batch``, and two steps of the CLI,
    each finite, the parameters left on the CPU
    (``tests/test_torch_moe_train.py`` and ``tests/test_torch_encdec_train.py``
    hold them against JAX)."""
    cfg = configs.smoke(arch)
    opt_cfg = AdamWConfig()
    params = family(cfg).init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = adamw.init(params, opt_cfg)
    batch = train.train_batch(cfg, DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2),
                              0, "cpu")
    params, opt, m = train.make_train_step(cfg, opt_cfg)(params, opt, batch, 0)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert int(opt["count"]) == 1 and all(torch.isfinite(t).all() for t in tree_leaves(params))
    params, opt, metrics = train.main(["--smoke", "--arch", arch, "--device", "cpu",
                                       "--steps", "2", "--seq", "32", "--batch", "2"])
    out = capsys.readouterr().out
    assert "step     1 loss" in out and out.strip().endswith("done")
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert int(opt["count"]) == 2
    assert all(t.device.type == "cpu" and torch.isfinite(t).all() for t in tree_leaves(params))
