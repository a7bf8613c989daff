"""Token-choice top-k Mixture-of-Experts (qwen3-moe-235b, granite-moe-3b)
(port of ``repro.models.moe``).

Dispatch is sort-free, by "one-hot position", with a fixed per-expert
capacity: every (token, choice) pair takes its position within its expert's
buffer from an exclusive cumulative sum over the flattened assignment
one-hot (token-major), tokens are written into an (E, C, d) buffer, the
expert FFNs run as batched products over the stacked expert weights, and the
results are gathered back weighted by the renormalised router probabilities.
Pairs past an expert's capacity drop (standard capacity-factor semantics).

Without ``rules`` all tokens are one dispatch group (the reference's
``G = 1``). With ``rules`` the dispatch is GROUP-LOCAL, as the reference's:
tokens are grouped by their data-parallel shard (``G`` = the dp size, or 1
where it does not divide the tokens) and each group dispatches into its own
(E, C, d) buffer with a capacity from its own tokens, so which pairs drop
depends on ``G``: ``G = 2`` is a different result from ``G = 1``, not a
layout. On DTensors the routing, the dispatch and the gather back run on
each rank's groups through ``local_map``, and the expert FFN on its local
buffer shard: over tp by experts where E divides it, else by the capacity
dim (whose length is then rounded up to a multiple of tp), with the
experts' fsdp shards gathered. Plain tensors with ``rules`` run the same
group-local arithmetic on one process.
No atomics: kept (expert, position) pairs are unique, so the buffer is
written by plain index assignment (dropped pairs all go to one spare row
that is never read), and the reference's ``segment_sum`` over the K choices
of a token is a sum over a (T, K, d) view, in one order run after run.

Training (``loss_fn``) and serving are the dense transformer's
(``transformer.loss_fn``, ``prefill`` and ``decode_step``) with this block as
the feed-forward of every layer; the KV cache is the transformer's. Each
layer is checkpointed under ``cfg.remat`` as the reference's scan body is.
The capacity comes from the tokens of the call, so a microbatch of a train
step gets its own. The gradient needs nothing of its own: the scatter writes
each kept pair once and sends dropped pairs to a spare row that is sliced
off (a dropped pair gets zero gradient, as the reference's ``where`` gives),
and the gather's backward, an accumulating index-put, meets a row twice only
for dropped pairs pointed at row 0, which carry exact zeros. No auxiliary
load-balancing loss: the reference has none.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.launch.shardings import P
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.mamba2 import check_generator


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_moe_mlp(generator, cfg, dt):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": L.dense_init(generator, (d, E), torch.float32),
         "wi": L.dense_init(generator, (E, d, f), dt),
         "wo": L.dense_init(generator, (E, f, d), dt, scale=f ** -0.5)}
    if cfg.act == "swiglu":
        p["wg"] = L.dense_init(generator, (E, d, f), dt)
    return p


def moe_mlp_specs(cfg, rules):
    d, E = cfg.d_model, cfg.n_experts
    p = {"router": P(None, None),
         "wi": P(rules.tp_for(E), rules.fsdp_for(d), None),
         "wo": P(rules.tp_for(E), None, rules.fsdp_for(d))}
    if cfg.act == "swiglu":
        p["wg"] = P(rules.tp_for(E), rules.fsdp_for(d), None)
    return p


def init_layer(generator, cfg, dt):
    return {"attn": L.init_attention(generator, cfg, dt),
            "moe": init_moe_mlp(generator, cfg, dt),
            "ln1": L.ones(generator, (cfg.d_model,), dt),
            "ln2": L.ones(generator, (cfg.d_model,), dt)}


def layer_specs(cfg, rules):
    return {"attn": L.specs_attention(cfg, rules),
            "moe": moe_mlp_specs(cfg, rules),
            "ln1": P(None), "ln2": P(None)}


def param_specs(cfg, rules):
    return {"embed": L.specs_embed(cfg, rules),
            "layers": L.stacked(layer_specs(cfg, rules)), "ln_f": P(None)}


def init_params(cfg, generator: torch.Generator, *, device=None):
    """Parameters on ``device`` (default CUDA), drawn from ``generator``."""
    g = check_generator(generator, device)
    dt = cfg.pdtype()
    return {"embed": L.init_embed(g, cfg, dt),
            "layers": L.stack_layers(cfg.n_layers, lambda: init_layer(g, cfg, dt)),
            "ln_f": L.ones(g, (cfg.d_model,), dt)}


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

def capacity(cfg, tokens: int) -> int:
    """Each expert's buffer length for ``tokens`` tokens: Python's ``round``,
    halves to even, as the reference rounds."""
    return int(max(1, round(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts)))


def route(params, cfg, xf):
    """The router on tokens ``xf`` (T, d), in float32: the top-k experts
    ``top_e`` (T, K) by probability, their probabilities renormalised to sum
    to 1 (floor 1e-9) ``top_p``, and all the probabilities ``probs`` (T, E)."""
    probs = torch.softmax(xf.float() @ params["router"], dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return top_p, top_e, probs


def moe_mlp(params, cfg, x, rules=None):
    """x: (B, S, d) -> (B, S, d); group-local under ``rules``."""
    if rules is not None:
        return _moe_groups(params, cfg, x, rules)
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    Tk = B * S
    xf = x.reshape(Tk, d)
    top_p, top_e, _ = route(params, cfg, xf)

    # each (token, choice) pair's position within its expert's capacity; the
    # one-hot is laid out (E, T*K) so that the cumsum runs along the inner
    # dimension (along the outer one the card's scan took ~50 ms a layer at
    # 131,072 pairs)
    C = capacity(cfg, Tk)
    flat_e = top_e.reshape(Tk * K)
    onehot = (flat_e == torch.arange(E, device=x.device)[:, None]).int()   # (E, T*K)
    pos_in_e = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot      # exclusive
    pos = torch.gather(pos_in_e, 0, flat_e[None, :])[0].reshape(Tk, K)
    keep = pos < C
    row = top_e * C + pos                                     # row of (E*C, d)

    # scatter: kept pairs to their rows, dropped ones to the spare row E*C
    buf = x.new_zeros((E * C + 1, d))
    buf[torch.where(keep, row, E * C)] = xf[:, None, :]
    buf = buf[:E * C].view(E, C, d)

    # batched expert FFN over stacked weights
    if cfg.act == "swiglu":
        h = L.silu(torch.bmm(buf, params["wg"])) * torch.bmm(buf, params["wi"])
    else:
        h = L.ACTS[cfg.act](torch.bmm(buf, params["wi"]))
    out = torch.bmm(h, params["wo"]).view(E * C, d)

    # gather back, weighted; a dropped pair adds nothing
    got = out[torch.where(keep, row, 0)]                      # (T, K, d)
    got = torch.where(keep[..., None], got, 0)
    y = (got * top_p.to(x.dtype)[..., None]).sum(1)
    return y.reshape(B, S, d)


def groups(rules, tokens: int) -> int:
    """The dispatch groups of ``tokens`` tokens: the dp size, or 1 where it
    does not divide them."""
    G = rules._size(rules.dp_axes)
    return 1 if tokens % G else G


def group_capacity(cfg, rules, tokens: int) -> int:
    """A group's capacity; rounded up to a multiple of the tp size where the
    experts do not split over tp and the capacity dim does instead."""
    C = capacity(cfg, tokens)
    if rules.tp_for(cfg.n_experts) is None:
        k = rules._size((rules.tp_axis,)) if rules.tp_axis else 1
        C = -(-C // k) * k
    return C


def _dispatch(router, xg, cfg, C):
    """Route and dispatch each group of ``xg`` (g, Tl, d) into its own
    buffer: (buf (g, E, C, d), rows (g, Tl, K) of each pair in its group's
    flattened buffer, 0 where dropped, keep (g, Tl, K), top_p (g, Tl, K))."""
    g, Tl, d = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    top_p, top_e, _ = route({"router": router}, cfg, xg.reshape(g * Tl, d))
    top_p, top_e = top_p.view(g, Tl, K), top_e.view(g, Tl, K)
    flat_e = top_e.reshape(g, 1, Tl * K)
    onehot = (flat_e == torch.arange(E, device=xg.device)[:, None]).int()  # (g, E, Tl*K)
    pos_in_e = torch.cumsum(onehot, dim=2, dtype=torch.int32) - onehot     # exclusive
    pos = torch.gather(pos_in_e, 1, flat_e)[:, 0].reshape(g, Tl, K)
    keep = pos < C
    row = top_e * C + pos
    at = torch.arange(g, device=xg.device)[:, None, None]
    buf = xg.new_zeros((g, E * C + 1, d))
    buf[at, torch.where(keep, row, E * C)] = xg[:, :, None, :]
    return buf[:, :E * C].view(g, E, C, d), torch.where(keep, row, 0), keep, top_p


def _experts(cfg, buf, wi, wo, wg=None):
    """The expert FFNs on a buffer (g, E, C, d) and the experts' weights."""
    g, E, C, d = buf.shape
    b = buf.transpose(0, 1).reshape(E, g * C, d)
    if cfg.act == "swiglu":
        h = L.silu(torch.bmm(b, wg)) * torch.bmm(b, wi)
    else:
        h = L.ACTS[cfg.act](torch.bmm(b, wi))
    return torch.bmm(h, wo).view(E, g, C, d).transpose(0, 1)


def _combine(out, rows, keep, top_p):
    """Each token's kept pairs gathered back from ``out`` (g, E, C, d),
    weighted by their probabilities: (g, Tl, d)."""
    g, E, C, d = out.shape
    at = torch.arange(g, device=out.device)[:, None, None]
    got = out.reshape(g, E * C, d)[at, rows]                  # (g, Tl, K, d)
    got = torch.where(keep[..., None], got, 0)
    return (got * top_p.to(out.dtype)[..., None]).sum(2)


def _moe_groups(params, cfg, x, rules):
    B, S, d = x.shape
    E = cfg.n_experts
    G = groups(rules, B * S)
    Tl = B * S // G
    C = group_capacity(cfg, rules, Tl)
    xg = L.shard(x.reshape(G, Tl, d), P("DP", None, None), rules)
    names = ("wi", "wo", "wg") if cfg.act == "swiglu" else ("wi", "wo")
    if not isinstance(x, DTensor):
        buf, rows, keep, top_p = _dispatch(params["router"], xg, cfg, C)
        out = _experts(cfg, buf, *(params[k] for k in names))
        return _combine(out, rows, keep, top_p).reshape(B, S, d)
    split = xg.placements
    buf, rows, keep, top_p = L.on_shards(
        lambda r, xg: _dispatch(r, xg, cfg, C), [split] * 4, params["router"], xg,
        summed=(0,))
    ep = "TP" if rules.tp_for(E) else None
    buf = L.shard(buf, P("DP", ep, None if ep else "TP", None), rules)
    w = [L.shard(params[k], P(ep), rules) for k in names]   # fsdp shards gathered
    out = L.on_shards(lambda b, *w: _experts(cfg, b, *w), buf.placements, buf, *w,
                      summed=tuple(range(1, len(w) + 1)))
    out = L.shard(out, P("DP", None, None, None), rules)
    y = L.on_shards(_combine, split, out, rows, keep, top_p)
    if B % G or G == 1:         # the groups do not split the batch: gather them
        y = L.shard(y, P(None, None, None), rules)
    return L.shard(y.reshape(B, S, d), P("DP", None, None), rules)


def moe_ffn(cfg, layer, h, rules=None):
    return moe_mlp(layer["moe"], cfg, h, rules)


def block(cfg, layer, x, positions, rules=None):
    h = L.rmsnorm(x, layer["ln1"])
    x = x + L.attention_train(layer["attn"], cfg, h, positions, rules)
    h = L.rmsnorm(x, layer["ln2"])
    x = x + moe_mlp(layer["moe"], cfg, h, rules)
    return L.shard(x, P("DP", None, None), rules)


def loss_fn(cfg, params, batch, rules=None):
    return T.loss_fn(cfg, params, batch, rules, layer_fn=block)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

init_cache = T.init_cache
cache_specs = T.cache_specs


def prefill(cfg, params, batch, rules=None, cache_len=None):
    return T.prefill(cfg, params, batch, rules, cache_len, ffn=moe_ffn)


def decode_step(cfg, params, cache, token, pos, rules=None):
    return T.decode_step(cfg, params, cache, token, pos, rules, ffn=moe_ffn)
