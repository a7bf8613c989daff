"""int8 gradient compression with error feedback (port of
``repro.optim.grad_compress``).

Quantize each gradient leaf to int8 with a per-leaf scale before the
data-parallel reduction, keep the quantization residual in an error-feedback
buffer that is added back next step (so the compression is unbiased over
time), and dequantize after the reduce. Rounding is half-to-even, as
``jnp.round`` rounds.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress(g, err):
    """g: float grad leaf; err: error feedback. Returns (q, scale, new_err).

    q is int8; g ~= q * scale + new_err.
    """
    g = g.float() + err
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    new_err = g - q.float() * scale
    return q, scale, new_err


def decompress(q, scale):
    return q.float() * scale


def compress_tree(grads, err_tree):
    out = tree_map(compress, grads, err_tree)
    pick = lambda i: tree_map(lambda _, t: t[i], grads, out)  # noqa: E731
    return pick(0), pick(1), pick(2)


def decompress_tree(qs, scales):
    return tree_map(decompress, qs, scales)


def compressed_bytes(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))   # 1 byte / element


