"""AdamW with decoupled weight decay, float32 (or bf16) moments and
global-norm clipping (port of ``repro.optim.adamw``).

``init`` builds the state tree ``{"m", "v", "count"}``; ``update`` computes
in float32 and writes the new parameters and moments INTO the given tensors,
leaf by leaf (the JAX package returns new arrays from donated ones), so a
step needs no second copy of the model; it returns the same trees. Each
leaf is updated in slices along its first dimension of at most
``SLICE_ELEMENTS`` elements (or one index), with the same elementwise
arithmetic, so that the float32 temporaries of a 1e9-element leaf
(granite-moe-3b-a800m's stacked experts: ~30 GB of them at once) stay those
of one slice; a leaf of fewer elements is one slice. The ``moment_dtype``
knob exists because a 340B model's float32 m+v alone are 2.7 TB:
nemotron-4-340b stores its moments in bf16.

Sharded: the moments shard exactly like their parameters (``state_specs``),
so on DTensor leaves the sliced elementwise update runs on each rank's
local shards of p, g, m and v, which share placements. ``global_norm`` is
the global norm: each leaf's local sum of squares is all-reduced over the
mesh dimensions that shard it (never over one that replicates it).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.launch.shardings import P
from repro_torch.tree import tree_leaves, tree_map

# the most elements of a leaf updated at once (256 MiB in float32)
SLICE_ELEMENTS = 2 ** 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def init(params, cfg: AdamWConfig):
    """Zero moments of the parameters' shapes (and, on DTensor parameters,
    their placements) and a zero step count."""
    dt = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        return torch.zeros_like(p, dtype=dt)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def state_specs(param_specs):
    """Moments shard exactly like their parameters."""
    return {"m": param_specs, "v": param_specs, "count": P()}


def local(t):
    """The local tensor of a DTensor (its full value where it replicates);
    a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, leaves in the
    JAX package's order; a plain tensor. A DTensor leaf's local sum is
    all-reduced over the mesh dimensions that shard it."""
    total = 0
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(local(x).float()))
        if isinstance(x, DTensor):
            for i, p in enumerate(x.placements):
                if p.is_shard():
                    dist.all_reduce(sq, group=x.device_mesh.get_group(i))
                elif p.is_partial():
                    raise ValueError("global_norm: a partial sum; redistribute "
                                     "the gradient to its parameter's placements")
        total = total + sq
    return torch.sqrt(total)


def update(grads, state, params, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step, in place (see the module docstring). grads/params
    trees must match; returns (params, new_state, metrics)."""
    count = local(state["count"]) + 1
    gnorm = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)

    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    lr = cfg.lr * lr_scale

    def upd(g, m, v, p):
        rows = max(1, SLICE_ELEMENTS // p[0].numel())
        for pieces in zip(*(t.split(rows) for t in (g, m, v, p))):
            upd_slice(*pieces)

    def upd_slice(g, m, v, p):
        g = g.float() * clip
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * g * g
        mhat = m32 / c1
        vhat = v32 / c2
        step = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
        m.copy_(m32)
        v.copy_(v32)

    with torch.no_grad():
        tree_map(lambda *ts: upd(*map(local, ts)), grads, state["m"], state["v"], params)
    if isinstance(state["count"], DTensor):
        count = DTensor.from_local(count, state["count"].device_mesh,
                                   state["count"].placements, run_check=False)
    return params, {"m": state["m"], "v": state["v"], "count": count}, \
        {"grad_norm": gnorm, "lr": lr}
