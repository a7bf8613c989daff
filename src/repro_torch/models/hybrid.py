"""Zamba2-style hybrid (zamba2-1.2b): a Mamba-2 backbone with ONE shared
attention+MLP block invoked every ``cfg.shared_attn_every`` layers (port of
``repro.models.hybrid``).

The shared block's parameters are reused at every invocation and its input
is the projection of ``concat(hidden, original_embedding)``. Prefill runs
K3 inside every Mamba layer and K2 inside every shared invocation on a card.

Decode carries per-layer mamba (conv, ssd) states plus a KV cache per shared
invocation slot ((n_shared, B, S, KV, hd)). The JAX package's ``lax.scan``
is a loop over the stacked layers and its ``lax.cond`` a Python ``if``.
``loss_fn`` checkpoints each layer, the Mamba block and the shared block
after it together (``cfg.remat``), as the JAX package's ``jax.checkpoint``
of the scan body does.

Sharded (``rules``), the Mamba layers are ``mamba2``'s (K3 on local shards)
and the shared block is the transformer's attention (K2 on local shards);
the shared KV cache is sequence-split over tp, as the transformer's.
"""

from __future__ import annotations

import torch

from repro_torch.launch.shardings import P
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T


def n_shared(cfg) -> int:
    return cfg.n_layers // cfg.shared_attn_every


def _is_shared(cfg, i: int) -> bool:
    return i % cfg.shared_attn_every == cfg.shared_attn_every - 1


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_params(cfg, generator: torch.Generator, *, device=None):
    """Parameters on ``device`` (default CUDA), drawn from ``generator``."""
    g = M.check_generator(generator, device)
    dt = cfg.pdtype()
    return {
        "embed": L.init_embed(g, cfg, dt),
        "layers": L.stack_layers(cfg.n_layers,
                                 lambda: M.init_layer(g, cfg, dt)),
        "shared": {"attn": L.init_attention(g, cfg, dt),
                   "mlp": L.init_mlp(g, cfg, dt),
                   "wcat": L.dense_init(g, (2 * cfg.d_model, cfg.d_model), dt),
                   "ln1": L.ones(g, (2 * cfg.d_model,), dt),
                   "ln2": L.ones(g, (cfg.d_model,), dt)},
        "ln_f": L.ones(g, (cfg.d_model,), dt),
    }


def param_specs(cfg, rules):
    return {
        "embed": L.specs_embed(cfg, rules),
        "layers": L.stacked(M.layer_specs(cfg, rules)),
        "shared": {"attn": L.specs_attention(cfg, rules),
                   "mlp": L.specs_mlp(cfg, rules),
                   "wcat": P(rules.fsdp_for(2 * cfg.d_model),
                             rules.tp_for(cfg.d_model)),
                   "ln1": P(None), "ln2": P(None)},
        "ln_f": P(None),
    }


# ---------------------------------------------------------------------------
# shared block
# ---------------------------------------------------------------------------

def shared_block(cfg, sp, x, x0, positions, rules=None):
    """concat(h, emb0) -> proj -> attention -> mlp -> residual into x."""
    h = L.rmsnorm(torch.cat([x, x0], dim=-1), sp["ln1"])
    h = L.shard(h @ sp["wcat"], P("DP", None, None), rules)
    a = L.attention_train(sp["attn"], cfg, h, positions, rules)
    h2 = L.rmsnorm(a, sp["ln2"])
    return L.shard(x + a + L.mlp(sp["mlp"], cfg, h2, rules), P("DP", None, None), rules)


def _layer(cfg, sp, layer, x, x0, positions, shared: bool, rules=None):
    """Mamba layer, then the shared block where this layer has one."""
    x = M.block(cfg, layer, x, rules)
    return shared_block(cfg, sp, x, x0, positions, rules) if shared else x


def loss_fn(cfg, params, batch, rules=None):
    x0 = L.token_embeddings(cfg, params, batch["tokens"], rules)
    positions = T.positions_for(x0)
    x = x0
    for i, layer in enumerate(L.unstack_layers(params["layers"], cfg.n_layers)):
        x = L.maybe_remat(cfg, _layer, cfg, params["shared"], layer, x, x0, positions,
                          _is_shared(cfg, i), rules)
    x = L.rmsnorm(x, params["ln_f"])
    logits = L.unembed(params["embed"], x, rules)
    return L.softmax_xent(logits, batch["targets"], batch.get("mask"), rules)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, B, S, dtype=None, *, device=None):
    dt = dtype or cfg.dtype()
    mc = M.init_cache(cfg, B, S, dtype, device=device)
    shape = (n_shared(cfg), B, S, cfg.n_kv_heads, cfg.head_dim)
    mc["shared_k"] = mc["conv"].new_zeros(shape, dtype=dt)
    mc["shared_v"] = mc["conv"].new_zeros(shape, dtype=dt)
    return mc


def cache_specs(cfg, rules=None):
    sp = M.cache_specs(cfg, rules)
    sp["shared_k"] = T.KV_CACHE_SPEC
    sp["shared_v"] = T.KV_CACHE_SPEC
    return sp


def _shared_prefill(cfg, sp, x, x0, positions, rules=None):
    h = L.rmsnorm(torch.cat([x, x0], dim=-1), sp["ln1"])
    h = L.shard(h @ sp["wcat"], P("DP", None, None), rules)
    B, S, _ = h.shape
    q, k, v = L._qkv(sp["attn"], cfg, h, positions, rules)
    o = L.attend(q, k, v, causal=True, rules=rules)
    a = L.proj_out(o.reshape(B, S, cfg.n_heads * cfg.head_dim), sp["attn"]["wo"], rules)
    h2 = L.rmsnorm(a, sp["ln2"])
    x = L.shard(x + a + L.mlp(sp["mlp"], cfg, h2, rules), P("DP", None, None), rules)
    return x, k, v


def prefill(cfg, params, batch, rules=None, cache_len=None):
    """Logits of the last prompt token and the decode cache, whose KV slots
    are ``cache_len`` (default the prompt length) long."""
    x0 = L.token_embeddings(cfg, params, batch["tokens"], rules)
    B, S, _ = x0.shape
    positions = T.positions_for(x0)
    Sc = cache_len or S
    shape = (n_shared(cfg), B, Sc, cfg.n_kv_heads, cfg.head_dim)
    sk, sv = (L.zeros_like_spec(x0, shape, T.KV_CACHE_SPEC, rules) for _ in range(2))
    x = x0
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        layer = L.layer_at(params["layers"], i)
        h = L.rmsnorm(x, layer["ln"])
        y, (conv_st, ssm_st) = M.mixer_forward(layer["mixer"], cfg, h, rules)
        x = L.shard(x + y, P("DP", None, None), rules)
        convs.append(conv_st)
        ssms.append(ssm_st)
        if _is_shared(cfg, i):
            x, k, v = _shared_prefill(cfg, params["shared"], x, x0, positions, rules)
            j = i // cfg.shared_attn_every
            L.write_seq(sk[j], k, rules)
            L.write_seq(sv[j], v, rules)
    x = L.rmsnorm(x, params["ln_f"])
    logits = L.unembed(params["embed"], x[:, -1:], rules)
    return logits, {**M.stack_states(convs, ssms, rules), "shared_k": sk, "shared_v": sv}


def decode_step(cfg, params, cache, token, pos, rules=None):
    """One token for every sequence at position ``pos`` (B,). Updates
    ``cache`` IN PLACE (where the JAX package returns a new cache from a
    donated one) and returns it."""
    x = L.token_embeddings(cfg, params, token, rules)
    x0 = x
    sp = params["shared"]
    for i in range(cfg.n_layers):
        layer = L.layer_at(params["layers"], i)
        h = L.rmsnorm(x, layer["ln"])
        y, conv_st, ssm_st = M.mixer_decode(layer["mixer"], cfg, h,
                                            cache["conv"][i], cache["ssm"][i])
        M.write_states(cache, i, conv_st, ssm_st)
        x = L.shard(x + y, P("DP", None, None), rules)
        if _is_shared(cfg, i):
            j = i // cfg.shared_attn_every
            h = L.rmsnorm(torch.cat([x, x0], dim=-1), sp["ln1"])
            h = L.shard(h @ sp["wcat"], P("DP", None, None), rules)
            a, _, _ = L.attention_decode(sp["attn"], cfg, h, cache["shared_k"][j],
                                         cache["shared_v"][j], pos, rules)
            h2 = L.rmsnorm(a, sp["ln2"])
            x = L.shard(x + a + L.mlp(sp["mlp"], cfg, h2, rules), P("DP", None, None),
                        rules)
    x = L.rmsnorm(x, params["ln_f"])
    logits = L.unembed(params["embed"], x, rules)
    return logits, cache
