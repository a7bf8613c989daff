"""Token-choice top-k Mixture-of-Experts (qwen3-moe-235b, granite-moe-3b)
(port of ``repro.models.moe``).

Dispatch is sort-free, by "one-hot position", with a fixed per-expert
capacity: every (token, choice) pair takes its position within its expert's
buffer from an exclusive cumulative sum over the flattened assignment
one-hot (token-major), tokens are written into an (E, C, d) buffer, the
expert FFNs run as batched products over the stacked expert weights, and the
results are gathered back weighted by the renormalised router probabilities.
Pairs past an expert's capacity drop (standard capacity-factor semantics).

One device, so one dispatch group (the reference's ``G = 1``, ``rules is
None``); the group-local and capacity-sharded dispatch waits for sharding.
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


def init_layer(generator, cfg, dt):
    return {"attn": L.init_attention(generator, cfg, dt),
            "moe": init_moe_mlp(generator, cfg, dt),
            "ln1": L.ones(generator, (cfg.d_model,), dt),
            "ln2": L.ones(generator, (cfg.d_model,), dt)}


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


def moe_mlp(params, cfg, x):
    """x: (B, S, d) -> (B, S, d)."""
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


def moe_ffn(cfg, layer, h):
    return moe_mlp(layer["moe"], cfg, h)


def block(cfg, layer, x, positions):
    h = L.rmsnorm(x, layer["ln1"])
    x = x + L.attention_train(layer["attn"], cfg, h, positions)
    h = L.rmsnorm(x, layer["ln2"])
    return x + moe_mlp(layer["moe"], cfg, h)


def loss_fn(cfg, params, batch):
    return T.loss_fn(cfg, params, batch, layer_fn=block)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

init_cache = T.init_cache


def prefill(cfg, params, batch, cache_len=None):
    return T.prefill(cfg, params, batch, cache_len, ffn=moe_ffn)


def decode_step(cfg, params, cache, token, pos):
    return T.decode_step(cfg, params, cache, token, pos, ffn=moe_ffn)
