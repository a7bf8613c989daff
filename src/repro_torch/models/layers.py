"""Shared neural-net building blocks (port of ``repro.models.layers``).

Conventions, as in the JAX package:
  * params are nested dicts of tensors with the JAX package's keys; layer
    stacks carry a leading ``L`` dim and are driven by a Python loop (the
    JAX package's ``lax.scan``);
  * compute dtype is bf16 by default with fp32 softmax/norm accumulation;
  * initialisers draw from a ``torch.Generator`` and create tensors on its
    device. ``jax.random`` draws another stream, so tests carry the JAX
    package's parameters across (``repro_torch.convert``) instead.

``attend`` (self-attention, and an encoder-decoder's cross-attention with
keys of their own length) runs kernel K2 on CUDA tensors
(``kernels.ops.flash_attention``, differentiable through K2's backward kernel
for self-attention) and its plain version on CPU tensors. Sharding (``shard``, ``specs_*``) waits for ``launch/shardings``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (  # noqa: F401  (re-exported)
    ATTN_CHUNK, attend_chunked, attend_full)
from repro_torch.tree import tree_leaves, tree_map  # noqa: F401  (re-exported)


def stack_layers(n: int, make_layer: Callable[[], dict]) -> dict:
    """``n`` layers from ``make_layer()``, stacked on a leading dim."""
    first = make_layer()
    stacked = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    for i in range(n):
        layer = first if i == 0 else make_layer()
        _copy_into(stacked, layer, i)
    return stacked


def _copy_into(stacked, layer, i):
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_into(stacked[k], v, i)
        else:
            stacked[k][i].copy_(v)


def layer_at(layers: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda t: t[i], layers)


def unstack_layers(layers: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked tree as views, through one ``unbind``
    per leaf: its backward stacks the layers' gradients once, where
    ``layer_at`` would scatter each layer's into a zeroed full-size tensor."""
    per_leaf = tree_map(lambda t: t.unbind(0), layers)
    return [tree_map(lambda views: views[i], per_leaf) for i in range(n)]


def maybe_remat(cfg, f, *args):
    """``f(*args)``, checkpointed (``torch.utils.checkpoint``, not
    reentrant) where ``cfg.remat`` is on and autograd records (grad mode on
    and a tensor of ``args`` requiring a gradient): the port of the JAX
    package's ``jax.checkpoint`` of a layer scan's body, one checkpoint per
    layer. Without a gradient (serving encdec's encoder) a checkpoint saves
    nothing and costs host time: 5-8 ms of a seamless-m4t-medium prefill's
    51-57 on an H100."""
    if cfg.remat and torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for a in args for t in tree_leaves(a)):
        return checkpoint(f, *args, use_reentrant=False)
    return f(*args)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape, dtype: torch.dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, scale) in float32 on the generator's device, cast to
    ``dtype``; ``scale`` defaults to ``shape[0] ** -0.5``."""
    scale = scale if scale is not None else (shape[0] ** -0.5)
    return (torch.randn(shape, generator=generator, device=generator.device)
            * scale).to(dtype)


def ones(generator: torch.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=generator.device)


def zeros(generator: torch.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=generator.device)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layernorm(x, scale, bias, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dt)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, hd); positions: (..., S). Angles in float32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs       # (..., S, half)
    ang = ang[..., :, None, :]                          # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def squared_relu(x):
    r = torch.clamp_min(x, 0.0)
    return r * r


def gelu(x):
    """The tanh approximation, which ``jax.nn.gelu`` computes by default."""
    return F.gelu(x, approximate="tanh")


silu = F.silu

ACTS = {"gelu": gelu, "relu2": squared_relu, "silu": silu}


# ---------------------------------------------------------------------------
# attention (GQA, optional qk-norm)
# ---------------------------------------------------------------------------

def init_attention(generator, cfg, dtype):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(generator, (d, H * hd), dtype),
        "wk": dense_init(generator, (d, KV * hd), dtype),
        "wv": dense_init(generator, (d, KV * hd), dtype),
        "wo": dense_init(generator, (H * hd, d), dtype),
    }
    if cfg.qk_norm:
        p["q_scale"] = ones(generator, (hd,), dtype)
        p["k_scale"] = ones(generator, (hd,), dtype)
    return p


def _qkv(params, cfg, x, positions):
    """Project + reshape + qk-norm + rope. x: (B, S, d)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, H, hd)
    k = (x @ params["wk"]).reshape(B, S, KV, hd)
    v = (x @ params["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_scale"])
        k = rmsnorm(k, params["k_scale"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _group(q, KV):
    """(B, S, H, hd) -> (B, S, KV, G, hd): GQA grouping without repeating
    K/V in memory."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, KV, H // KV, hd)


def attend(q, k, v, *, causal: bool = True):
    """Self- or cross-attention, q (B,S,H,hd) against k/v (B,Sk,KV,hd) (causal
    needs Sk == S): K2 on CUDA tensors, its plain version on the CPU."""
    return ops.flash_attention(q, k, v, causal=causal)


def attention_train(params, cfg, x, positions):
    """Causal self-attention over a full sequence (train / prefill)."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, cfg, x, positions)
    o = attend(q, k, v, causal=True)
    o = o.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return o @ params["wo"]


def attention_decode(params, cfg, x, cache_k, cache_v, pos):
    """One-token decode against a (B, S, KV, hd) KV cache.

    pos: (B,) current position per sequence (uniform in batched serving).
    The new token's K/V are written into ``cache_k``/``cache_v`` IN PLACE at
    ``pos[0]`` (where the JAX package returns updated copies of a donated
    cache); the same tensors are returned.
    """
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(params, cfg, x, pos[:, None])
    # insert new kv at pos (same position for the whole batch in serving)
    cache_k.index_copy_(1, pos[:1], k.to(cache_k.dtype))
    cache_v.index_copy_(1, pos[:1], v.to(cache_v.dtype))
    S = cache_k.shape[1]
    scale = hd ** -0.5
    qg = _group(q, KV)                                      # (B,1,KV,G,hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, cache_k).float()
    logits = logits * scale
    mask = torch.arange(S, device=x.device)[None, :] <= pos[:, None]   # (B, S)
    logits = torch.where(mask[:, None, None, None, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, cache_v).reshape(B, 1, H * hd)
    return (o @ params["wo"]), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP (SwiGLU / squared-ReLU / GELU)
# ---------------------------------------------------------------------------

def init_mlp(generator, cfg, dtype):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {"wi": dense_init(generator, (d, f), dtype),
                "wg": dense_init(generator, (d, f), dtype),
                "wo": dense_init(generator, (f, d), dtype)}
    return {"wi": dense_init(generator, (d, f), dtype),
            "wo": dense_init(generator, (f, d), dtype)}


def mlp(params, cfg, x):
    if cfg.act == "swiglu":
        h = silu(x @ params["wg"]) * (x @ params["wi"])
    else:
        h = ACTS[cfg.act](x @ params["wi"])
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(generator, cfg, dtype):
    return {"table": dense_init(generator, (cfg.vocab, cfg.d_model), dtype,
                                scale=0.02)}


def embed(params, tokens):
    return params["table"][tokens]


def unembed(params, x):
    return torch.einsum("bsd,vd->bsv", x, params["table"])


def softmax_xent(logits, targets, mask=None):
    """Token-level cross-entropy with a float32 log-sum-exp; with ``mask``,
    the masked mean over at least one token."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp_min(mask.sum(), 1)
    return nll.mean()
