"""Training step builder + CLI driver (port of ``repro.launch.train``).

``make_train_step`` returns a (params, opt_state, batch, step) ->
(params, opt_state, metrics) function with:

  * microbatch gradient accumulation in ``cfg.grad_accum_dtype``, each add
    in float32,
  * remat around each layer (``cfg.remat``, inside the model),
  * AdamW with configurable moment dtype,
  * an optional ``quorum`` hook between the gradients and AdamW (WOC's
    weighted-quorum gradient commit, ``repro_torch.coord.grad_quorum``).

It updates the parameters and moments in place (the JAX package donates
them) and returns the same trees.

Sharded training: ``rules`` (``launch.shardings.make_rules`` of a torch
``DeviceMesh``) with parameters, optimizer state and batch laid out on the
mesh by :func:`distribute_tree` (placements from :func:`tree_shardings`,
the batch's from :func:`batch_spec_tree`). Each microbatch is the rows that
the unsharded step gives it, split over dp; each fresh gradient is
redistributed to its parameter's placements before the add (a partial sum
becomes a reduce-scatter where the parameter is sharded), and the
accumulator has the parameters' placements. :func:`abstract_params` and
:func:`abstract_opt_state` give the trees' shapes on the ``meta`` device.

Every family trains. A batch holds ``tokens``, ``targets`` and ``mask``
(B, S) and, for encdec and vlm, the stub frontend's ``frames`` or
``image_embeds`` (:func:`train_batch`); the microbatch split cuts every key
on its first dimension.

CLI (on CUDA unless ``--device cpu``; ``--arch`` any configuration, e.g.
qwen3-1.7b, zamba2-1.2b, granite-moe-3b-a800m or seamless-m4t-medium):
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --arch zamba2-1.2b
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from torch.distributed.tensor import distribute_tensor

from repro_torch import configs, default_device
from repro_torch.data import DataConfig, host_batch
from repro_torch.launch.shardings import P, placements, resolve_spec
from repro_torch.models import family, layers as L, stub_inputs
from repro_torch.optim import AdamWConfig, adamw, schedule
from repro_torch.tree import tree_leaves, tree_map


def _meta(build):
    """The tree ``build()`` makes, as ``meta`` tensors of its shapes and
    dtypes (nothing is allocated or drawn)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = build()
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def abstract_params(cfg):
    fam = family(cfg)
    return _meta(lambda: fam.init_params(cfg, torch.Generator(), device="cpu"))


def abstract_opt_state(cfg, opt_cfg: AdamWConfig):
    fam = family(cfg)
    return _meta(lambda: adamw.init(
        fam.init_params(cfg, torch.Generator(), device="cpu"), opt_cfg))


def tree_shardings(mesh, abstract, specs, rules):
    """DTensor placements per leaf, with role resolution + divisibility
    sanitizing."""
    return tree_map(lambda a, s: placements(mesh, resolve_spec(a.shape, s, rules)),
                    abstract, specs)


def batch_spec_tree(batch_abstract):
    return tree_map(lambda a: P("DP", *([None] * (a.ndim - 1))), batch_abstract)


def distribute_tree(tree, mesh, specs, rules):
    """``tree`` (the same full tensors on every rank) on ``mesh``: each rank
    keeps its shard of every leaf, laid out by ``specs``, with no
    communication; so parameters drawn from one generator on every rank
    equal the unsharded ones."""
    return tree_map(lambda t, pl: distribute_tensor(t, mesh, pl, src_data_rank=None),
                    tree, tree_shardings(mesh, tree, specs, rules))


def shardings_for_train(cfg, mesh, opt_cfg, rules):
    fam = family(cfg)
    ap = abstract_params(cfg)
    ao = abstract_opt_state(cfg, opt_cfg)
    pspecs = fam.param_specs(cfg, rules)
    p_sh = tree_shardings(mesh, ap, pspecs, rules)
    o_sh = tree_shardings(mesh, ao, adamw.state_specs(pspecs), rules)
    return ap, ao, p_sh, o_sh


def value_and_grad(loss_for, params, batch):
    """The loss and its gradient with respect to every leaf of ``params``,
    as a tree with the parameters' dtypes."""
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = loss_for(p, batch)
        grads = torch.autograd.grad(loss, tree_leaves(p))
    it = iter(grads)
    # tree_leaves visits keys sorted; rebuild the tree in that order
    return loss.detach(), _fill(params, it)


def _fill(tree, it):
    if isinstance(tree, dict):
        return {k: _fill(tree[k], it) for k in sorted(tree)}
    return next(it)


def make_train_step(cfg, opt_cfg: AdamWConfig, *, rules=None,
                    total_steps: int = 10_000, quorum=None):
    """The train step of ``cfg``; sharded under ``rules`` (see the module
    docstring)."""
    fam = family(cfg)

    def loss_for(p, mb):
        return fam.loss_fn(cfg, p, mb, rules)

    # gradients and the float32 accumulator carry the parameter sharding:
    # constrained BEFORE the add, a fresh microbatch gradient is
    # reduce-scattered instead of all-reduced and sliced
    specs = fam.param_specs(cfg, rules) if rules is not None else None

    def grad_shard(tree):
        if rules is None:
            return tree
        return tree_map(lambda g, s: L.shard(g, s, rules), tree, specs)

    def train_step(params, opt_state, batch, step):
        M = cfg.microbatches
        if M > 1:
            acc_dt = getattr(torch, cfg.grad_accum_dtype)
            loss = 0.0
            grads = tree_map(lambda t: torch.zeros_like(t, dtype=acc_dt), params)
            # each microbatch is the rows the unsharded step gives it, split over dp
            batch = {k: L.shard(x, P(None), rules) for k, x in batch.items()}
            b = next(iter(batch.values())).shape[0] // M
            for i in range(M):
                mb = {k: L.shard(x[i * b:(i + 1) * b], P("DP"), rules)
                      for k, x in batch.items()}
                mloss, mgrads = value_and_grad(loss_for, params, mb)
                mgrads = grad_shard(mgrads)
                tree_map(lambda a, g: a.copy_(a.float() + g.float()), grads, mgrads)
                del mgrads
                loss = loss + mloss
            loss = loss / M
            tree_map(lambda g: g.div_(M), grads)
        else:
            loss, grads = value_and_grad(loss_for, params, batch)
            grads = grad_shard(grads)
        loss = adamw.local(loss)

        if quorum is not None:    # WOC weighted-quorum DP commit (coord/)
            grads, quorum_metrics = quorum(grads)
        else:
            quorum_metrics = {}

        lr_scale = schedule.cosine_with_warmup(step, total=total_steps).to(loss.device)
        params, opt_state, metrics = adamw.update(
            grads, opt_state, params, opt_cfg, lr_scale=lr_scale)
        metrics = {"loss": loss, **metrics, **quorum_metrics}
        return params, opt_state, metrics

    return train_step


def batch_to(batch: dict, device) -> dict:
    """A numpy batch from ``data.host_batch`` as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_batch(cfg, dcfg: DataConfig, step: int, device) -> dict:
    """Step ``step``'s batch on ``device``: ``data.host_batch``'s tokens,
    targets and mask, and the stub frontend's inputs (``models.stub_inputs``)
    drawn on the CPU from a generator seeded by ``dcfg.seed`` and the step, so
    that every device gets the same batch."""
    batch = batch_to(host_batch(dcfg, step, 0, 1), device)
    seed = int(np.random.SeedSequence([dcfg.seed, step]).generate_state(1, np.uint64)[0])
    stub = stub_inputs(cfg, torch.Generator().manual_seed(seed), dcfg.global_batch,
                       dcfg.seq_len)
    return {**batch, **{k: t.to(device) for k, t in stub.items()}}


# ---------------------------------------------------------------------------
# CLI driver
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--resume", default=None,
                    help="checkpoint directory to resume from")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    cfg = dataclasses.replace(cfg, microbatches=1)
    fam = family(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, moment_dtype=cfg.opt_state_dtype)
    train_step = make_train_step(cfg, opt_cfg, total_steps=args.steps)
    device = default_device(args.device)

    params = fam.init_params(cfg, torch.Generator(device).manual_seed(args.seed),
                             device=device)
    opt_state = adamw.init(params, opt_cfg)
    step0 = 0
    if args.resume:
        from repro_torch.checkpoint import manager as ckpt
        params, opt_state, step0 = ckpt.restore_latest(
            args.resume, params, opt_state)
        print(f"resumed from step {step0}")

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    writer = None
    if args.ckpt_dir:
        from repro_torch.checkpoint import manager as ckpt
        writer = ckpt.AsyncCheckpointer(args.ckpt_dir)

    metrics = {}
    for step in range(step0, args.steps):
        batch = train_batch(cfg, dcfg, step, device)
        t0 = time.time()
        params, opt_state, metrics = train_step(params, opt_state, batch, step)
        loss = float(metrics["loss"])
        print(f"step {step:5d} loss {loss:8.4f} "
              f"gnorm {float(metrics['grad_norm']):8.3f} "
              f"dt {time.time()-t0:6.2f}s")
        if writer is not None and (step + 1) % args.ckpt_every == 0:
            writer.save(step + 1, params, opt_state)
    if writer is not None:
        writer.save(args.steps, params, opt_state)
        writer.wait()
    print("done")
    return params, opt_state, metrics


if __name__ == "__main__":
    main()
