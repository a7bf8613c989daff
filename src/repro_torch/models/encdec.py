"""Encoder-decoder backbone (seamless-m4t-medium) (port of
``repro.models.encdec``).

The audio frontend is a stub, as in the JAX package: the batch carries
precomputed frame embeddings ``frames`` (B, S_enc, d). A bidirectional
encoder runs over the frames and a causal decoder with cross-attention over
the encoder's output.

Serving: prefill runs the encoder once and caches (a) the decoder's
self-attention K/V and (b) the cross-attention K/V projected from the
encoder output (``mk``/``mv``); a decode step writes only the self cache, in
place, and reads ``mk``/``mv`` as they are. Every attention goes through
``layers.attend``, so through K2 on a card: the encoder's non-causal
self-attention, the decoder's causal self-attention, and cross-attention, q
of the decoder's length against keys of the encoder's (q of length 1 at
decode).

Training (``loss_fn``) runs the encoder over the frames and the decoder over
the tokens, each layer checkpointed under ``cfg.remat`` as the reference's
scan bodies are; every decoder layer projects the cross K/V from the
encoder's output, so their gradients flow back into the encoder. On a card
K2's backward takes all three attentions, the cross-attention's keys of the
encoder's length included.

Sharded (``rules``): as the transformer, K2 on local shards for all three
attentions; the cross K/V cache is sequence-split over tp like the self
cache (``cache_specs``), and gathered by heads where a decode step reads it.
"""

from __future__ import annotations

import torch

from repro_torch import default_device
from repro_torch.launch.shardings import P
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.mamba2 import check_generator


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_enc_layer(generator, cfg, dt):
    return {"attn": L.init_attention(generator, cfg, dt),
            "mlp": L.init_mlp(generator, cfg, dt),
            "ln1": L.ones(generator, (cfg.d_model,), dt),
            "ln2": L.ones(generator, (cfg.d_model,), dt)}


def init_dec_layer(generator, cfg, dt):
    return {"self": L.init_attention(generator, cfg, dt),
            "cross": L.init_attention(generator, cfg, dt),
            "mlp": L.init_mlp(generator, cfg, dt),
            "ln1": L.ones(generator, (cfg.d_model,), dt),
            "ln2": L.ones(generator, (cfg.d_model,), dt),
            "ln3": L.ones(generator, (cfg.d_model,), dt)}


def enc_layer_specs(cfg, rules):
    return {"attn": L.specs_attention(cfg, rules),
            "mlp": L.specs_mlp(cfg, rules),
            "ln1": P(None), "ln2": P(None)}


def dec_layer_specs(cfg, rules):
    return {"self": L.specs_attention(cfg, rules),
            "cross": L.specs_attention(cfg, rules),
            "mlp": L.specs_mlp(cfg, rules),
            "ln1": P(None), "ln2": P(None), "ln3": P(None)}


def param_specs(cfg, rules):
    return {"embed": L.specs_embed(cfg, rules),
            "enc": L.stacked(enc_layer_specs(cfg, rules)),
            "dec": L.stacked(dec_layer_specs(cfg, rules)),
            "ln_enc": P(None), "ln_f": P(None)}


def init_params(cfg, generator: torch.Generator, *, device=None):
    """Parameters on ``device`` (default CUDA), drawn from ``generator``."""
    g = check_generator(generator, device)
    dt = cfg.pdtype()
    return {
        "embed": L.init_embed(g, cfg, dt),
        "enc": L.stack_layers(cfg.encoder_layers, lambda: init_enc_layer(g, cfg, dt)),
        "dec": L.stack_layers(cfg.n_layers, lambda: init_dec_layer(g, cfg, dt)),
        "ln_enc": L.ones(g, (cfg.d_model,), dt),
        "ln_f": L.ones(g, (cfg.d_model,), dt),
    }


# ---------------------------------------------------------------------------
# cross attention (no rope, k/v from the encoder's output)
# ---------------------------------------------------------------------------

def cross_attend(params, cfg, x, mem_k, mem_v, rules=None):
    """x: (B,Sq,d); mem_k/mem_v: (B,Se,KV,hd) precomputed."""
    B, Sq, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = (L.whole_gradient(x) @ params["wq"]).reshape(B, Sq, H, hd)
    q = L.shard(q, P("DP", None, "TP", None), rules)
    o = L.attend(q, mem_k, mem_v, causal=False, rules=rules)
    return L.proj_out(o.reshape(B, Sq, H * hd), params["wo"], rules)


def cross_kv(params, cfg, mem):
    B, Se, _ = mem.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    mem = L.whole_gradient(mem)
    k = (mem @ params["wk"]).reshape(B, Se, KV, hd)
    v = (mem @ params["wv"]).reshape(B, Se, KV, hd)
    return k, v


# ---------------------------------------------------------------------------
# encoder / decoder trunks
# ---------------------------------------------------------------------------

def enc_block(cfg, layer, x, positions, rules=None):
    B, S, _ = x.shape
    h = L.rmsnorm(x, layer["ln1"])
    q, k, v = L._qkv(layer["attn"], cfg, h, positions, rules)
    o = L.attend(q, k, v, causal=False, rules=rules)
    x = x + L.proj_out(o.reshape(B, S, cfg.n_heads * cfg.head_dim), layer["attn"]["wo"],
                       rules)
    h = L.rmsnorm(x, layer["ln2"])
    x = x + L.mlp(layer["mlp"], cfg, h, rules)
    return L.shard(x, P("DP", None, None), rules)


def encode(cfg, params, frames, rules=None):
    frames = L.batch_on_mesh(frames, params["ln_enc"], rules)
    x = L.shard(frames.to(cfg.dtype()), P("DP", None, None), rules)
    positions = T.positions_for(x)
    for layer in L.unstack_layers(params["enc"], cfg.encoder_layers):
        x = L.maybe_remat(cfg, enc_block, cfg, layer, x, positions, rules)
    return L.rmsnorm(x, params["ln_enc"])


def dec_block(cfg, layer, x, enc_out, positions, rules=None):
    h = L.rmsnorm(x, layer["ln1"])
    x = x + L.attention_train(layer["self"], cfg, h, positions, rules)
    h = L.rmsnorm(x, layer["ln2"])
    mk, mv = cross_kv(layer["cross"], cfg, enc_out)
    x = x + cross_attend(layer["cross"], cfg, h, mk, mv, rules)
    h = L.rmsnorm(x, layer["ln3"])
    x = x + L.mlp(layer["mlp"], cfg, h, rules)
    return L.shard(x, P("DP", None, None), rules)


def loss_fn(cfg, params, batch, rules=None):
    enc_out = encode(cfg, params, batch["frames"], rules)
    x = L.token_embeddings(cfg, params, batch["tokens"], rules)
    positions = T.positions_for(x)
    for layer in L.unstack_layers(params["dec"], cfg.n_layers):
        x = L.maybe_remat(cfg, dec_block, cfg, layer, x, enc_out, positions, rules)
    x = L.rmsnorm(x, params["ln_f"])
    logits = L.unembed(params["embed"], x, rules)
    return L.softmax_xent(logits, batch["targets"], batch.get("mask"), rules)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, B, S, dtype=None, *, device=None):
    dt = dtype or cfg.dtype()
    Se = S // cfg.enc_len_ratio
    device = default_device(device)
    self_shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    cross_shape = (cfg.n_layers, B, Se, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(self_shape, dtype=dt, device=device),
            "v": torch.zeros(self_shape, dtype=dt, device=device),
            "mk": torch.zeros(cross_shape, dtype=dt, device=device),
            "mv": torch.zeros(cross_shape, dtype=dt, device=device)}


def cache_specs(cfg, rules=None):
    s = T.KV_CACHE_SPEC
    return {"k": s, "v": s, "mk": s, "mv": s}


def prefill(cfg, params, batch, rules=None, cache_len=None):
    """Logits of the last position and the cache: the decoder's self K/V,
    ``cache_len`` (default the prompt length) positions long and zero past
    the prompt, and the cross K/V of every layer."""
    enc_out = encode(cfg, params, batch["frames"], rules)
    x = L.token_embeddings(cfg, params, batch["tokens"], rules)
    B, S, _ = x.shape
    Se = enc_out.shape[1]
    positions = T.positions_for(x)
    kv = (cfg.n_kv_heads, cfg.head_dim)
    if rules is None:
        ks = x.new_zeros((cfg.n_layers, B, cache_len or S, *kv))
        vs = torch.zeros_like(ks)
        mks = x.new_empty((cfg.n_layers, B, Se, *kv))
        mvs = torch.empty_like(mks)
    else:
        ks, vs = (L.zeros_like_spec(x, (cfg.n_layers, B, cache_len or S, *kv),
                                    T.KV_CACHE_SPEC, rules) for _ in range(2))
        mks, mvs = (L.zeros_like_spec(x, (cfg.n_layers, B, Se, *kv), T.KV_CACHE_SPEC,
                                      rules) for _ in range(2))
    for i, layer in enumerate(L.unstack_layers(params["dec"], cfg.n_layers)):
        h = L.rmsnorm(x, layer["ln1"])
        q, k, v = L._qkv(layer["self"], cfg, h, positions, rules)
        o = L.attend(q, k, v, causal=True, rules=rules)
        x = x + L.proj_out(o.reshape(B, S, cfg.n_heads * cfg.head_dim), layer["self"]["wo"],
                           rules)
        h = L.rmsnorm(x, layer["ln2"])
        mk, mv = cross_kv(layer["cross"], cfg, enc_out)
        L.write_seq(mks[i], mk, rules)
        L.write_seq(mvs[i], mv, rules)
        x = x + cross_attend(layer["cross"], cfg, h, mks[i], mvs[i], rules)
        h = L.rmsnorm(x, layer["ln3"])
        x = L.shard(x + L.mlp(layer["mlp"], cfg, h, rules), P("DP", None, None), rules)
        L.write_seq(ks[i], k, rules)
        L.write_seq(vs[i], v, rules)
    x = L.rmsnorm(x, params["ln_f"])
    logits = L.unembed(params["embed"], x[:, -1:], rules)
    return logits, {"k": ks, "v": vs, "mk": mks, "mv": mvs}


def decode_step(cfg, params, cache, token, pos, rules=None):
    """One token for the whole batch at position ``pos`` (B,). Updates the
    self-attention cache IN PLACE and returns ``cache``; ``mk``/``mv`` are
    read only."""
    x = L.token_embeddings(cfg, params, token, rules)                   # (B,1,d)
    for i in range(cfg.n_layers):
        layer = L.layer_at(params["dec"], i)
        h = L.rmsnorm(x, layer["ln1"])
        a, _, _ = L.attention_decode(layer["self"], cfg, h, cache["k"][i],
                                     cache["v"][i], pos, rules)
        x = x + a
        h = L.rmsnorm(x, layer["ln2"])
        x = x + cross_attend(layer["cross"], cfg, h, cache["mk"][i], cache["mv"][i], rules)
        h = L.rmsnorm(x, layer["ln3"])
        x = L.shard(x + L.mlp(layer["mlp"], cfg, h, rules), P("DP", None, None), rules)
    x = L.rmsnorm(x, params["ln_f"])
    logits = L.unembed(params["embed"], x, rules)
    return logits, cache
