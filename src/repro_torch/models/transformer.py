"""Dense decoder-only transformer LM (qwen3-8b/1.7b, nemotron-4-340b,
phi4-mini) — also the backbone for the VLM and the decoder of the enc-dec
(port of ``repro.models.transformer``).

The JAX package's ``lax.scan`` over stacked layers is a loop here, and its
``jax.checkpoint`` of the scan body (``cfg.remat``) is
``torch.utils.checkpoint`` around each layer (``layers.maybe_remat``).
Attention runs K2 on a card, forward and backward. Decode writes the KV
cache in place, where the JAX package returns a new cache from a donated
one.

``rules`` (``launch.shardings``) with DTensor parameters and batch runs the
same code sharded: ``shard`` constraints where the reference has them, K2 on
local shards (``layers.attend``), the prefill's KV written into a cache
laid out by ``cache_specs`` (sequence over tp), and decode's attention
through ``layers.attention_decode``'s flash-decoding.
"""

from __future__ import annotations

import torch

from repro_torch import default_device
from repro_torch.launch.shardings import P
from repro_torch.models import layers as L
from repro_torch.models.mamba2 import check_generator


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_layer(generator, cfg, dt):
    return {"attn": L.init_attention(generator, cfg, dt),
            "mlp": L.init_mlp(generator, cfg, dt),
            "ln1": L.ones(generator, (cfg.d_model,), dt),
            "ln2": L.ones(generator, (cfg.d_model,), dt)}


def layer_specs(cfg, rules):
    return {"attn": L.specs_attention(cfg, rules),
            "mlp": L.specs_mlp(cfg, rules),
            "ln1": P(None), "ln2": P(None)}


def param_specs(cfg, rules):
    return {"embed": L.specs_embed(cfg, rules),
            "layers": L.stacked(layer_specs(cfg, rules)), "ln_f": P(None)}


def init_params(cfg, generator: torch.Generator, *, device=None):
    """Parameters on ``device`` (default CUDA), drawn from ``generator``."""
    g = check_generator(generator, device)
    dt = cfg.pdtype()
    return {
        "embed": L.init_embed(g, cfg, dt),
        "layers": L.stack_layers(cfg.n_layers, lambda: init_layer(g, cfg, dt)),
        "ln_f": L.ones(g, (cfg.d_model,), dt),
    }


# ---------------------------------------------------------------------------
# forward (train / prefill trunk)
# ---------------------------------------------------------------------------

def block(cfg, layer, x, positions, rules=None):
    h = L.rmsnorm(x, layer["ln1"])
    x = x + L.attention_train(layer["attn"], cfg, h, positions, rules)
    h = L.rmsnorm(x, layer["ln2"])
    x = x + L.mlp(layer["mlp"], cfg, h, rules)
    return L.shard(x, P("DP", None, None), rules)


def trunk(cfg, params, x, positions, rules=None, *, layer_fn=block):
    """The layers, each ``layer_fn(cfg, layer, x, positions, rules)`` under
    one ``L.maybe_remat`` (the MoE family passes its own block), then
    ``ln_f``."""
    for layer in L.unstack_layers(params["layers"], cfg.n_layers):
        x = L.maybe_remat(cfg, layer_fn, cfg, layer, x, positions, rules)
    return L.rmsnorm(x, params["ln_f"])


def embed_tokens(cfg, params, batch, rules=None):
    x = L.token_embeddings(cfg, params, batch["tokens"], rules)
    if cfg.family == "vlm":
        # frontend stub: precomputed InternViT patch embeddings prepended
        image = L.batch_on_mesh(batch["image_embeds"], x, rules)
        x = torch.cat([image.to(cfg.dtype()), x], dim=1)
    return L.shard(x, P("DP", None, None), rules)


def positions_for(x):
    """Positions 0..S-1 of every sequence of ``x`` (B, S, d), split like
    x's batch where x is a DTensor."""
    B, S, _ = x.shape
    return L.like_batch(x, torch.arange(S, device=x.device).expand(B, S))


def loss_fn(cfg, params, batch, rules=None, *, layer_fn=block):
    x = embed_tokens(cfg, params, batch, rules)
    x = trunk(cfg, params, x, positions_for(x), rules, layer_fn=layer_fn)
    if cfg.family == "vlm":          # loss only over the text tail
        x = x[:, cfg.n_image_tokens:]
    logits = L.unembed(params["embed"], x, rules)
    return L.softmax_xent(logits, batch["targets"], batch.get("mask"), rules)


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode against a (L,B,S,KV,hd) KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg, B, S, dtype=None, *, device=None):
    dt = dtype or cfg.dtype()
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    device = default_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


KV_CACHE_SPEC = P(None, "DP", "TP", None, None)


def cache_specs(cfg, rules=None):
    # flash-decoding layout: cache sequence axis sharded over tp; role
    # placeholders are resolved (divisibility-checked) by the launcher
    return {"k": KV_CACHE_SPEC, "v": KV_CACHE_SPEC}


def dense_ffn(cfg, layer, h, rules=None):
    return L.mlp(layer["mlp"], cfg, h, rules)


def prefill(cfg, params, batch, rules=None, cache_len=None, *, ffn=dense_ffn):
    """Logits of the last position and the KV cache, ``cache_len`` (default
    the prompt length, the image prefix included) positions long, zero past
    the prompt. ``ffn(cfg, layer, h, rules)`` is each layer's feed-forward
    block (the MoE family passes its own)."""
    x = embed_tokens(cfg, params, batch, rules)
    B, S, _ = x.shape
    positions = positions_for(x)
    shape = (cfg.n_layers, B, cache_len or S, cfg.n_kv_heads, cfg.head_dim)
    ks, vs = (L.zeros_like_spec(x, shape, KV_CACHE_SPEC, rules) for _ in range(2))
    for i, layer in enumerate(L.unstack_layers(params["layers"], cfg.n_layers)):
        h = L.rmsnorm(x, layer["ln1"])
        q, k, v = L._qkv(layer["attn"], cfg, h, positions, rules)
        o = L.attend(q, k, v, causal=True, rules=rules)
        x = x + L.proj_out(o.reshape(B, S, cfg.n_heads * cfg.head_dim), layer["attn"]["wo"],
                           rules)
        h = L.rmsnorm(x, layer["ln2"])
        x = L.shard(x + ffn(cfg, layer, h, rules), P("DP", None, None), rules)
        L.write_seq(ks[i], k, rules)
        L.write_seq(vs[i], v, rules)
    x = L.rmsnorm(x, params["ln_f"])
    logits = L.unembed(params["embed"], x[:, -1:], rules)
    return logits, {"k": ks, "v": vs}


def decode_step(cfg, params, cache, token, pos, rules=None, *, ffn=dense_ffn):
    """One token for the whole batch at position ``pos`` (B,). Updates
    ``cache`` IN PLACE and returns it. ``ffn`` as for :func:`prefill`."""
    x = L.embed(params["embed"], token, rules).to(cfg.dtype())    # (B,1,d)
    for i in range(cfg.n_layers):
        layer = L.layer_at(params["layers"], i)
        h = L.rmsnorm(x, layer["ln1"])
        a, _, _ = L.attention_decode(layer["attn"], cfg, h, cache["k"][i],
                                     cache["v"][i], pos, rules)
        x = x + a
        h = L.rmsnorm(x, layer["ln2"])
        x = L.shard(x + ffn(cfg, layer, h, rules), P("DP", None, None), rules)
    x = L.rmsnorm(x, params["ln_f"])
    logits = L.unembed(params["embed"], x, rules)
    return logits, cache
