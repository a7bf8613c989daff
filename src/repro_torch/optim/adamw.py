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
nemotron-4-340b stores its moments in bf16. The sharding specs
(``state_specs``) wait for ``launch/shardings``.
"""

from __future__ import annotations

import dataclasses

import torch

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
    dt = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, leaves in the
    JAX package's order."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def update(grads, state, params, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step, in place (see the module docstring). grads/params
    trees must match; returns (params, new_state, metrics)."""
    count = state["count"] + 1
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
        tree_map(upd, grads, state["m"], state["v"], params)
    return params, {"m": state["m"], "v": state["v"], "count": count}, \
        {"grad_norm": gnorm, "lr": lr}
