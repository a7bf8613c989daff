"""What the training parity tests of the moe, encdec and vlm families
(``tests/test_torch_moe_train.py``, ``tests/test_torch_encdec_train.py``)
share: float32 config pairs, numpy batches with the stub frontends' inputs,
the loss and gradient and two train steps on both sides, the worst error as
a share of the tolerance, and a recorder of the MoE router's margins.

Both sides compute in float32 from the same parameters (the JAX
initialiser's, carried across with ``repro_torch.convert.params_from_jax``)
and the same numpy batches. Losses, gradients, train metrics and moments are
held at ``TOL`` = 1e-4 of each leaf's largest magnitude plus 1e-4 relative,
as ``tests/test_torch_train.py`` holds the dense family. The parameters
after the steps are held at that tolerance plus what the moments' tolerance
becomes through AdamW's m̂ / (√v̂ + eps) at each step, capped at ``SLACK_LR``
= 0.1 of the step's lr, on at most ``SLACK_SHARE`` = 1e-4 of the elements:
the rule that ``tests/test_torch_ssm_train.py`` holds its models to, with
the moments at 1e-4 (:func:`adamw_slack`, which it shares). Where a gradient changes sign between the two steps, m̂
nearly cancels, and AdamW's division turns a last-bits difference of the
gradients into one of a few hundredths of lr (the smoke granite-moe's
embedding, 2 microbatches: 1.2e-5 = 0.04 lr at one element, with every
moment within 0.12 of its tolerance).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jax_configs
from repro.data import DataConfig as JaxDataConfig
from repro.data import host_batch as jax_host_batch
from repro.launch import train as jax_train
from repro.models import family as jax_family
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw as jax_adamw
from repro_torch import configs, convert
from repro_torch.launch import train
from repro_torch.models import family, moe
from repro_torch.optim import AdamWConfig, adamw

TOL = 1e-4
B, S = 4, 32
STEPS = (200, 201)        # full learning rate in a 300-step schedule
TOTAL = 300
NEAR_TIE = 1e-5           # the least gap between the k-th and (k+1)-th probability
SLACK_LR = 0.1            # adamw_slack's cap, per step, as a share of its lr
SLACK_SHARE = 1e-4        # the share of the parameters that may need that slack


@contextlib.contextmanager
def one_torch_thread():
    """torch on one thread while inside. The smoke models are too small for
    its thread pool to pay: with the default threads the two parity files
    took 442 CPU seconds against 187 on one, load that the suite's socket
    tests share under xdist. Their results are the same at 1 and 3 threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def f32_pair(arch, **kw):
    kw = dict(param_dtype="float32", compute_dtype="float32", **kw)
    return (dataclasses.replace(jax_configs.smoke(arch), **kw),
            dataclasses.replace(configs.smoke(arch), **kw))


def stub_arrays(cfg, rng, batch: int) -> dict:
    """The stub frontend's inputs, standard normal float32 from ``rng``:
    frames at S / enc_len_ratio (encdec) or the image prefix (vlm)."""
    length = {"encdec": S // cfg.enc_len_ratio, "vlm": cfg.n_image_tokens}.get(cfg.family)
    if length is None:
        return {}
    name = "frames" if cfg.family == "encdec" else "image_embeds"
    return {name: rng.normal(size=(batch, length, cfg.d_model)).astype(np.float32)}


def loss_batch(cfg, seed: int) -> dict:
    """Two sequences of S tokens with a random mask and the stub inputs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab, (2, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "mask": (rng.random((2, S)) < 0.9).astype(np.float32),
            **stub_arrays(cfg, rng, 2)}


def step_batches(cfg, seed: int) -> list:
    """The data pipeline's batches of STEPS (B x S tokens), each with stub
    inputs from a numpy generator seeded by (seed, step)."""
    dcfg = JaxDataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed)
    return [{**jax_host_batch(dcfg, step, 0, 1),
             **stub_arrays(cfg, np.random.default_rng([seed, step]), B)} for step in STEPS]


def share_of_tol(got, want, tol=TOL) -> float:
    """The worst element's error over its tolerance (tol of the leaf's
    largest magnitude plus tol relative), over every leaf: 1 is the limit.
    Asserts equal tree structure, shapes and dtypes."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    worst = 0.0
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        limit = tol * (max(np.abs(w).max(), 1e-30) + np.abs(w))
        worst = max(worst, float((np.abs(g - w) / limit).max()))
    return worst


def loss_and_grads(jcfg, cfg, params, batch):
    """(loss, grads) of JAX's ``loss_fn`` and of the port's, from the JAX
    ``params``, as floats and numpy trees."""
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_family(jcfg).loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch))))(params)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, tgrads = train.value_and_grad(lambda p, b: family(cfg).loss_fn(cfg, p, b), tp,
                                         tbatch)
    return ((float(jloss), jax.tree.map(np.asarray, jgrads)),
            (float(tloss), convert.params_to_numpy(tgrads)))


def run_jax(cfg, params, batches):
    """JAX's train steps: parameters, optimizer state, metrics, and each
    step's moments (m, v) for :func:`adamw_slack`."""
    opt_cfg = JaxAdamWConfig(moment_dtype=cfg.opt_state_dtype)
    step_fn = jax.jit(jax_train.make_train_step(cfg, None, opt_cfg, total_steps=TOTAL))
    opt = jax_adamw.init(params, opt_cfg)
    metrics, moments = [], []
    for step, batch in zip(STEPS, batches):
        params, opt, m = step_fn(params, opt, jax.tree.map(jnp.asarray, batch),
                                 jnp.int32(step))
        metrics.append({k: float(v) for k, v in m.items()})
        moments.append(jax.tree.map(np.asarray, (opt["m"], opt["v"])))
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt), metrics,
            moments)


def run_port(cfg, jparams, batches):
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
    step_fn = train.make_train_step(cfg, opt_cfg, total_steps=TOTAL)
    opt = adamw.init(params, opt_cfg)
    metrics = []
    for step, batch in zip(STEPS, batches):
        params, opt, m = step_fn(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 step)
        metrics.append({k: float(v) for k, v in m.items()})
    return convert.params_to_numpy(params), convert.params_to_numpy(opt), metrics


def adamw_slack(moments, lrs, tol=TOL, cfg=JaxAdamWConfig()):
    """Per parameter leaf, how far two runs' parameters may drift apart when
    each step's moments differ by ``tol`` of the leaf's largest magnitude and
    ``tol`` relative: the sum over steps of lr times the first-order change
    of m̂ / (√v̂ + eps) under those differences, at most SLACK_LR times lr."""
    slack = None
    for t, ((ms, vs), lr) in enumerate(zip(moments, lrs), start=1):
        c1, c2 = 1 - cfg.b1 ** t, 1 - cfg.b2 ** t
        step = []
        for m, v in zip(jax.tree.leaves(ms), jax.tree.leaves(vs)):
            m, v = m.astype(np.float64), v.astype(np.float64)
            dm = tol * (np.abs(m).max() + np.abs(m)) / c1
            dv = tol * (np.abs(v).max() + np.abs(v)) / c2
            mh, root = np.abs(m) / c1, np.sqrt(v / c2)
            with np.errstate(divide="ignore", invalid="ignore"):
                dv_term = np.where(mh > 0, mh * dv / (2 * root * (root + cfg.eps) ** 2), 0.0)
            step.append(lr * np.minimum(dm / (root + cfg.eps) + dv_term, SLACK_LR))
        slack = step if slack is None else [a + b for a, b in zip(slack, step)]
    return slack


def train_steps_share(jcfg, cfg, params, batches) -> float:
    """Two train steps on both sides from the JAX ``params``: loss,
    grad_norm and lr and both moments held at TOL, the parameters at TOL
    plus :func:`adamw_slack` on at most SLACK_SHARE of them; returns the
    worst share of the tolerance."""
    jp, jo, jm, moments = run_jax(jcfg, params, batches)
    tp, to, tm = run_port(cfg, params, batches)
    worst = 0.0
    for got, want in zip(tm, jm):
        assert sorted(got) == sorted(want) == ["grad_norm", "loss", "lr"]
        for k in want:
            worst = max(worst, abs(got[k] - want[k]) / (TOL * abs(want[k])))
    assert int(to["count"]) == int(jo["count"]) == len(STEPS)
    assert jax.tree.structure(tp) == jax.tree.structure(jp)
    slack = adamw_slack(moments, [m["lr"] for m in jm])
    slacked = total = 0
    for g, w, extra in zip(jax.tree.leaves(tp), jax.tree.leaves(jp), slack):
        assert g.dtype == w.dtype and g.shape == w.shape
        diff, flat = np.abs(g.astype(np.float64) - w), TOL * (np.abs(w).max() + np.abs(w))
        worst = max(worst, float((diff / (flat + extra)).max()))
        slacked, total = slacked + int(np.sum(diff > flat)), total + diff.size
    assert slacked <= SLACK_SHARE * total, (slacked, total)
    return max(worst, share_of_tol(to["m"], jo["m"]), share_of_tol(to["v"], jo["v"]))


class RouterMargins:
    """Records every call of the port's ``moe.route`` while installed with
    ``monkeypatch``: each call's smallest gap between a token's k-th and
    (k+1)-th probability, and its dropped pairs (past the capacity)."""

    def __init__(self, monkeypatch, cfg):
        self.gaps, self.dropped = [], []
        route = moe.route

        def recording(params, cfg_, xf):
            top_p, top_e, probs = route(params, cfg_, xf)
            ranked = probs.detach().sort(-1, descending=True).values
            self.gaps.append(float((ranked[:, cfg_.top_k - 1] - ranked[:, cfg_.top_k]).min()))
            counts = torch.bincount(top_e.reshape(-1), minlength=cfg_.n_experts)
            C = moe.capacity(cfg_, xf.shape[0])
            self.dropped.append(int(torch.clamp_min(counts - C, 0).sum()))
            return top_p, top_e, probs
        monkeypatch.setattr(moe, "route", recording)

    def smallest_gap(self) -> float:
        """The smallest gap over every recorded call; asserts it is at least
        NEAR_TIE, so that a near-tie fails as one and never as a gradient
        mismatch."""
        assert self.gaps, "the router was never called"
        gap = min(self.gaps)
        assert gap >= NEAR_TIE, f"a token's k-th and (k+1)-th probabilities lie {gap} apart"
        return gap
