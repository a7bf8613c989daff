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
for self-attention) and its plain version on CPU tensors.

Sharding. Every ``init_*`` has a matching ``specs_*`` returning a
same-structure tree of ``PartitionSpec``s (the concrete mesh axes come from
``launch.shardings`` rules). With ``rules`` and DTensor parameters and
inputs, activations are DTensors: ``shard`` redistributes them (the JAX
package's ``with_sharding_constraint``) and the elementwise ops, matrix
products and norms run through DTensor's sharding rules. These run on each
rank's local shards through ``local_map`` instead:
  * ``rope`` (positions per local batch row),
  * ``attend``: K2 and its backward, batch over dp and heads over tp, so no
    collective (heads stay whole where KV does not divide tp),
  * ``attention_decode``'s softmax over a sequence-sharded cache
    (flash-decoding: two all-reduces over tp, max then sum) and its cache
    write, made only by the rank that holds position ``pos``,
  * ``write_seq``, a prefill's cache write,
  * ``softmax_xent``, over rows whose vocab is gathered.
``rules=None`` (and plain tensors) runs the single-device code unchanged.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor import zeros as mesh_zeros
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (  # noqa: F401  (re-exported)
    ATTN_CHUNK, attend_chunked, attend_full)
from repro_torch.launch.shardings import P, placements, resolve_spec
from repro_torch.tree import tree_leaves, tree_map  # noqa: F401  (re-exported)


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------

def shard(x, spec: P, rules=None):
    """Redistribute the DTensor ``x`` to ``spec``, divisibility-sanitized
    (the JAX package's sharding constraint); a no-op without rules or on a
    plain tensor. A partial sum becomes a reduce-scatter where the target
    shards the dim, an all-reduce where it replicates it."""
    if rules is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(mesh, resolve_spec(x.shape, spec, rules)))


class _GradientLikeInput(torch.autograd.Function):
    """The identity, whose backward lays the gradient out as the input is
    (replicated where the input is a partial sum, as DTensor's own
    redistribution lays a gradient out)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(Replicate() if p.is_partial() else p for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements)


def whole_gradient(x):
    """``x``, whose gradient comes back laid out as ``x`` is: reduced where
    it is a partial sum over a dim that ``x`` replicates (the input of
    tp-split products: q/k/v, the MLP's up projections, whose gradient sums
    over the split dim), gathered where ``x`` holds whole what a tp-split
    product's gradient splits (an attention output whose heads tp does not
    split, before the product that splits its flat dim; unsplit into heads
    again, a shard of it need not hold whole heads). Reduced, as the JAX
    package's partitioner reduces it, the gradient reaches the layers below
    whole; left partial, DTensor carries the sum through the residual stream
    and runs the next products below on whole weights, repeating the work on
    every tp rank. A no-op without autograd or on a plain tensor."""
    if isinstance(x, DTensor) and torch.is_grad_enabled() and x.requires_grad:
        return _GradientLikeInput.apply(x)
    return x


def proj_out(o, w, rules=None):
    """``o @ w`` for a product whose contraction dim is split over tp (an
    attention block's or an MLP's output projection), its partial sums
    reduced at once, batch over dp, as the JAX package's partitioner reduces
    them (left partial, they cost what :func:`whole_gradient` says); a plain
    product without rules. ``o``'s gradient comes back laid out as ``o``
    (:func:`whole_gradient`)."""
    return shard(whole_gradient(o) @ w, P("DP", None, None), rules)


def zeros_like_spec(x, shape, spec: P, rules=None):
    """Zeros of ``shape`` in x's dtype on x's device; a DTensor laid out by
    ``spec`` on x's mesh where ``x`` is one."""
    if not isinstance(x, DTensor):
        return x.new_zeros(shape)
    mesh = x.device_mesh
    return mesh_zeros(shape, dtype=x.dtype, device_mesh=mesh,
                      placements=placements(mesh, resolve_spec(shape, spec, rules)))


def on_shards(fn, out_placements, *args, summed=()):
    """``fn(*args)`` on each rank's local shards of the DTensor ``args``
    (``local_map``; other arguments pass as they are), its output a DTensor
    with ``out_placements``, or, for a function of several outputs, a list
    of placements per output. The arguments at the indices ``summed`` are
    replicated over mesh dimensions that split the others' work, so their
    local gradients are partial sums there (see :func:`summed_over`)."""
    several = isinstance(out_placements[0], (list, tuple))
    outs = tuple(map(list, out_placements)) if several else list(out_placements)
    grads = None
    if summed:
        others = [a for i, a in enumerate(args) if i not in summed and isinstance(a, DTensor)]
        grads = tuple(summed_over(a, others) if i in summed and isinstance(a, DTensor)
                      else getattr(a, "placements", None) for i, a in enumerate(args))
    return local_map(fn, out_placements=outs, in_grad_placements=grads)(*args)


def summed_over(t: DTensor, others) -> tuple:
    """Placements of the gradient of ``t`` where it meets ``others`` on
    local shards: a partial sum on each mesh dimension that ``t``
    replicates and one of ``others`` splits."""
    return tuple(Partial() if p == Replicate() and any(o.placements[i].is_shard()
                                                       for o in others) else p
                 for i, p in enumerate(t.placements))


def batch_on_mesh(t, like, rules):
    """``t`` (a plain tensor with the batch on its first dim, the same full
    tensor on every rank) on the mesh of the DTensor ``like``, split over dp
    where the batch divides; ``t`` itself where ``like`` is a plain tensor or
    ``t`` a DTensor already."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return distribute_tensor(t, mesh, placements(mesh, resolve_spec(t.shape, P("DP"), rules)),
                             src_data_rank=None)


def like_batch(x, t):
    """``t``, a plain tensor with the batch on its first dim (the same full
    tensor on every rank), as a DTensor split over the mesh dimensions that
    split ``x``'s batch (each rank keeps its rows); ``t`` itself where ``x``
    is a plain tensor or ``t`` a DTensor already."""
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    pl = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    return distribute_tensor(t, x.device_mesh, pl, src_data_rank=None)


def shard_offset(x: DTensor, dim: int) -> int:
    """Where this rank's shard of ``x`` starts along ``dim`` (even shards;
    mesh dimensions that split ``dim`` nest left to right)."""
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    idx = 0
    for i, p in enumerate(x.placements):
        if p == Shard(dim):
            idx = idx * mesh.size(i) + coord[i]
    return idx * x.to_local().shape[dim]


def _sharding_dims(x: DTensor, dim: int) -> list:
    return [i for i, p in enumerate(x.placements) if p == Shard(dim)]


def stacked(specs):
    """A layer's specs with the leading ``L`` dim of a stack (replicated)."""
    return tree_map(lambda s: P(None, *s), specs)


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
    """x: (..., S, H, hd); positions: (..., S). Angles in float32. On a
    DTensor, per local shard (``positions`` split like x's batch)."""
    if isinstance(x, DTensor):
        return on_shards(lambda x, p: rope(x, p, theta), x.placements, x, positions)
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


def specs_attention(cfg, rules):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": P(rules.fsdp_for(d), rules.tp_for(H * hd)),
        "wk": P(rules.fsdp_for(d), rules.tp_for(KV * hd)),
        "wv": P(rules.fsdp_for(d), rules.tp_for(KV * hd)),
        "wo": P(rules.tp_for(H * hd), rules.fsdp_for(d)),
    }
    if cfg.qk_norm:
        p["q_scale"] = P(None)
        p["k_scale"] = P(None)
    return p


def head_spec(H: int, KV: int, rules):
    """Spec of q/k/v (B,S,heads,hd): batch over dp, heads over tp where both
    the H query and the KV key heads divide it (so that a rank's q heads read
    its own kv heads)."""
    tp = "TP" if rules.tp_for(H) and rules.tp_for(KV) else None
    return P("DP", None, tp, None)


def _qkv(params, cfg, x, positions, rules=None):
    """Project + reshape + qk-norm + rope. x: (B, S, d)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = whole_gradient(x)
    q, k, v = (x @ params[w] for w in ("wq", "wk", "wv"))
    spec = head_spec(H, KV, rules) if rules is not None else None
    if spec is not None and spec[2] is None:
        # heads stay whole: gather the products' tp-split dim before it is
        # cut into heads, which a shard of it need not hold whole
        q, k, v = (shard(t, P("DP", None, None), rules) for t in (q, k, v))
    q, k, v = (t.reshape(B, S, n, hd) for t, n in ((q, H), (k, KV), (v, KV)))
    if spec is not None:
        q, k, v = (shard(t, spec, rules) for t in (q, k, v))
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


def attend(q, k, v, *, causal: bool = True, rules=None):
    """Self- or cross-attention, q (B,S,H,hd) against k/v (B,Sk,KV,hd) (causal
    needs Sk == S): K2 on CUDA tensors, its plain version on the CPU. On
    DTensors (with ``rules``), K2 runs on each rank's shards, batch over dp
    and heads over tp (``head_spec``)."""
    if isinstance(q, DTensor):
        spec = head_spec(q.shape[2], k.shape[2], rules)
        q, k, v = (shard(t, spec, rules) for t in (q, k, v))
        return on_shards(lambda q, k, v: ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal),
            q.placements, q, k, v)
    return ops.flash_attention(q, k, v, causal=causal)


def attention_train(params, cfg, x, positions, rules=None):
    """Causal self-attention over a full sequence (train / prefill)."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, cfg, x, positions, rules)
    o = attend(q, k, v, causal=True, rules=rules)
    return proj_out(o.reshape(B, S, cfg.n_heads * cfg.head_dim), params["wo"], rules)


def attention_decode(params, cfg, x, cache_k, cache_v, pos, rules=None):
    """One-token decode against a (B, S, KV, hd) KV cache.

    pos: (B,) current position per sequence (uniform in batched serving).
    The new token's K/V are written into ``cache_k``/``cache_v`` IN PLACE at
    ``pos[0]`` (where the JAX package returns updated copies of a donated
    cache); the same tensors are returned.

    With DTensors the cache is SEQUENCE-sharded over the tp axis
    (flash-decoding, ``cache_specs``): each rank holds a slice of the
    context, q/k/v of the new token are gathered whole (they are tiny), and
    :func:`_decode_attend` runs on the local shards.
    """
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if isinstance(x, DTensor):
        pos = like_batch(x, pos)
        q, k, v = _qkv(params, cfg, x, pos[:, None], rules)
        whole = P("DP", None, None, None)
        q, k, v = (shard(t, whole, rules) for t in (q, k, v))
        mesh = cache_k.device_mesh
        groups = [mesh.get_group(i) for i in _sharding_dims(cache_k, 1)]
        start = shard_offset(cache_k, 1)
        o = on_shards(lambda *a: _decode_attend(*a, groups=groups, start=start),
                      q.placements, q, k, v, cache_k, cache_v, pos)
        return proj_out(o.reshape(B, 1, H * hd), params["wo"], rules), cache_k, cache_v
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


def _decode_attend(q, k, v, cache_k, cache_v, pos, *, groups, start):
    """One rank's part of sharded decode attention, on local tensors: q, k,
    v (B,1,heads,hd) whole, this rank's cache slice (B,Sl,KV,hd) holding
    positions ``start`` to ``start + Sl`` (over the process ``groups`` that
    split the sequence). Writes k/v where this rank holds ``pos[0]``, else
    rewrites a slot with its own value. The softmax is normalised locally,
    then rescaled by this rank's share of the global sum: the maxima and the
    sums over the split key axis are two small all-reduces, and the outputs
    a third. Over one rank the share is exactly 1, and over no groups (an
    unsplit cache) there is none: the output is then the single-device
    one, bit for bit."""
    B, _, H, hd = q.shape
    KV, Sl = cache_k.shape[2], cache_k.shape[1]
    idx = (pos[:1] - start).clamp(0, Sl - 1)
    mine = ((pos[:1] >= start) & (pos[:1] < start + Sl)).view(1, 1, 1, 1)
    for c, new in ((cache_k, k), (cache_v, v)):
        c.index_copy_(1, idx, torch.where(mine, new.to(c.dtype), c.index_select(1, idx)))
    qg = _group(q, KV)                                      # (B,1,KV,G,hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, cache_k).float() * hd ** -0.5
    at = torch.arange(start, start + Sl, device=q.device)
    logits = torch.where((at[None, :] <= pos[:, None])[:, None, None, None, :],
                         logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, cache_v)       # (B,1,KV,G,hd)
    if groups:
        m = logits.amax(-1, keepdim=True)                   # (B,KV,G,1,1)
        gm = m.clone()
        for g in groups:
            dist.all_reduce(gm, op=dist.ReduceOp.MAX, group=g)
        share = torch.exp(logits - m).sum(-1, keepdim=True) * torch.exp(m - gm)
        total = share.clone()
        for g in groups:
            dist.all_reduce(total, group=g)
        o = o.float() * (share / total).permute(0, 3, 1, 2, 4)   # (B,1,KV,G,1)
        for g in groups:
            dist.all_reduce(o, group=g)
        o = o.to(q.dtype)
    return o.reshape(B, 1, H, hd)


def write_seq(cache, new, rules=None):
    """``cache[:, :S] = new`` for a cache (B, Sc, ...) and ``new`` (B, S,
    ...): a prefill's KV write. On DTensors ``new`` is gathered whole but for
    its batch and each rank writes the positions of its cache shard."""
    S = new.shape[1]
    if not isinstance(cache, DTensor):
        cache[:, :S] = new
        return
    new = shard(new, P("DP"), rules)
    start = shard_offset(cache, 1)

    def write(c, n):
        end = min(S, start + c.shape[1])
        if start < end:
            c[:, :end - start] = n[:, start:end]
        return c
    on_shards(write, cache.placements, cache, new)


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


def specs_mlp(cfg, rules):
    d, f = cfg.d_model, cfg.d_ff
    wi = P(rules.fsdp_for(d), rules.tp_for(f))
    wo = P(rules.tp_for(f), rules.fsdp_for(d))
    if cfg.act == "swiglu":
        return {"wi": wi, "wg": wi, "wo": wo}
    return {"wi": wi, "wo": wo}


def mlp(params, cfg, x, rules=None):
    x = whole_gradient(x)
    if cfg.act == "swiglu":
        h = silu(x @ params["wg"]) * (x @ params["wi"])
    else:
        h = ACTS[cfg.act](x @ params["wi"])
    h = shard(h, P("DP", None, "TP"), rules)
    return proj_out(h, params["wo"], rules)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(generator, cfg, dtype):
    return {"table": dense_init(generator, (cfg.vocab, cfg.d_model), dtype,
                                scale=0.02)}


def specs_embed(cfg, rules):
    return {"table": P(rules.tp_for(cfg.vocab),
                       rules.fsdp_for(cfg.d_model))}


def embed(params, tokens, rules=None):
    """Rows of the table. With a DTensor table, a lookup in the vocab-sharded
    table (its fsdp shards gathered), summed over tp, batch over dp; plain
    ``tokens`` are put on the table's mesh first. The table's gradient comes
    back laid out as the table, as :func:`unembed`'s does, so that the two
    are added in one layout."""
    if isinstance(params["table"], DTensor):
        tokens = batch_on_mesh(tokens, params["table"], rules)
        table = shard(whole_gradient(params["table"]), P("TP"), rules)
        return shard(F.embedding(tokens, table), P("DP", None, None), rules)
    return params["table"][tokens]


def token_embeddings(cfg, params, tokens, rules=None):
    """The tokens' embeddings in the compute dtype, batch over dp."""
    x = embed(params["embed"], tokens, rules).to(cfg.dtype())
    return shard(x, P("DP", None, None), rules)


def unembed(params, x, rules=None):
    """Logits over the (tied) table, vocab over tp; the table's gradient
    laid out as the table (:func:`embed`)."""
    logits = torch.einsum("bsd,vd->bsv", x, whole_gradient(params["table"]))
    return shard(logits, P("DP", None, "TP"), rules)


def softmax_xent(logits, targets, mask=None, rules=None):
    """Token-level cross-entropy with a float32 log-sum-exp; with ``mask``,
    the masked mean over at least one token. On DTensors, each rank takes
    its rows (vocab gathered) and the sums (or, without a mask, the means of
    equal shards) are reduced over dp."""
    if isinstance(logits, DTensor):
        logits = shard(logits, P("DP", None, None), rules)
        targets, mask = (None if t is None else shard(like_batch(logits, t), P("DP"), rules)
                         for t in (targets, mask))
        mesh = logits.device_mesh
        whole = [Replicate()] * mesh.ndim
        sums = [Partial() if p == Shard(0) else Replicate() for p in logits.placements]
        if mask is None:        # the mean of equal shards' means
            n = math.prod(mesh.size(i) for i in _sharding_dims(logits, 0))
            mean = on_shards(lambda lg, t: softmax_xent(lg, t) / n, sums, logits, targets)
            return mean.redistribute(placements=whole)
        total, count = (t.redistribute(placements=whole) for t in
                        on_shards(_nll_sums, [sums, sums], logits, targets, mask))
        return total / torch.clamp_min(count, 1)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp_min(mask.sum(), 1)
    return nll.mean()


def _nll_sums(logits, targets, mask):
    """The masked cross-entropy's numerator and denominator."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, targets[..., None].long())[..., 0]
    return (nll * mask).sum(), mask.sum()
