"""Mamba-2 SSD (state-space duality) — mamba2-780m, and the backbone of the
zamba2 hybrid (port of ``repro.models.mamba2``).

Chunked SSD (Dao & Gu 2024, arXiv:2405.21060): within a chunk of length Q
the recurrence is a masked (attention-like) matrix product — kernel K3 on a
card — and across chunks a short loop carries the (heads, headdim, d_state)
state (``repro_torch.kernels.ssd_scan``); on a card K3's gradient is its
backward kernel. Decode is an O(1) single-token state update in plain
PyTorch, as in the reference.

Layout: x is split into ``nh`` heads of size ``hp = d_inner // nh``; B and
C are shared across heads (a single group, as mamba2-780m has). The JAX
package's ``lax.scan`` over the layers is a loop, and its ``jax.checkpoint``
of the scan body (``cfg.remat``) is ``torch.utils.checkpoint`` around each
layer (``layers.maybe_remat``).

Sharded (``rules`` with DTensor parameters and batch): the fused input
projection is gathered whole over tp before its split, x, dt, A and D are
split by heads over tp, and the chunked scan (K3 and ``SSDIntraChunk`` on a
card, the loop over chunks around it) runs on each rank's local shards
through ``local_map``: heads are independent and B/C are whole on every
rank, so it needs no collective. The gated norm over the head-split
``d_inner`` and ``out_proj`` reduce over tp through DTensor. Decode's O(1)
update runs through DTensor's rules on a cache laid out by ``cache_specs``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch import default_device
from repro_torch.kernels.ssd_scan import ssd_chunked  # noqa: F401  (re-exported)
from repro_torch.launch.shardings import P
from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_mixer(generator, cfg, dt):
    d, din, N, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    conv_dim = din + 2 * N
    return {
        # [z (gate), x, B, C, dt] fused input projection
        "in_proj": L.dense_init(generator, (d, 2 * din + 2 * N + nh), dt),
        "conv_w": L.dense_init(generator, (cfg.conv_width, conv_dim), dt,
                               scale=cfg.conv_width ** -0.5),
        "conv_b": L.zeros(generator, (conv_dim,), dt),
        "A_log": L.zeros(generator, (nh,), torch.float32),   # A = -exp(A_log)
        "D": L.ones(generator, (nh,), torch.float32),
        "dt_bias": L.zeros(generator, (nh,), torch.float32),
        "norm": L.ones(generator, (din,), dt),               # gated RMSNorm scale
        "out_proj": L.dense_init(generator, (din, d), dt),
    }


def mixer_specs(cfg, rules):
    d, din, N, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    conv_dim = din + 2 * N
    return {
        "in_proj": P(rules.fsdp_for(d), rules.tp_for(2 * din + 2 * N + nh)),
        "conv_w": P(None, rules.tp_for(conv_dim)),
        "conv_b": P(rules.tp_for(conv_dim)),
        "A_log": P(rules.tp_for(nh)), "D": P(rules.tp_for(nh)),
        "dt_bias": P(rules.tp_for(nh)),
        "norm": P(rules.tp_for(din)),
        "out_proj": P(rules.tp_for(din), rules.fsdp_for(d)),
    }


def init_layer(generator, cfg, dt):
    return {"mixer": init_mixer(generator, cfg, dt),
            "ln": L.ones(generator, (cfg.d_model,), dt)}


def layer_specs(cfg, rules):
    return {"mixer": mixer_specs(cfg, rules), "ln": P(None)}


def param_specs(cfg, rules):
    return {"embed": L.specs_embed(cfg, rules),
            "layers": L.stacked(layer_specs(cfg, rules)),
            "ln_f": P(None)}


def check_generator(generator: torch.Generator, device) -> torch.Generator:
    """``generator``, once it is known to lie on ``device`` (default CUDA)."""
    device = default_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, parameters asked "
                         f"for on {device}")
    return generator


def init_params(cfg, generator: torch.Generator, *, device=None):
    """Parameters on ``device`` (default CUDA), drawn from ``generator``."""
    g = check_generator(generator, device)
    dt = cfg.pdtype()
    return {"embed": L.init_embed(g, cfg, dt),
            "layers": L.stack_layers(cfg.n_layers,
                                     lambda: init_layer(g, cfg, dt)),
            "ln_f": L.ones(g, (cfg.d_model,), dt)}


# ---------------------------------------------------------------------------
# SSD mixer
# ---------------------------------------------------------------------------

def _split_proj(params, cfg, u, rules=None):
    """u: (B,S,d) -> z (B,S,din), xBC (B,S,din+2N), dt (B,S,nh)."""
    din, N, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    zxbcdt = L.shard(L.whole_gradient(u) @ params["in_proj"], P("DP", None, None), rules)
    z, xBC, dt = torch.split(zxbcdt, [din, din + 2 * N, nh], dim=-1)
    return z, xBC, dt


def _causal_conv(params, cfg, xBC, conv_state=None):
    """Depthwise causal conv over the sequence; returns (out, new_state)."""
    W = cfg.conv_width
    if conv_state is None:
        pad = xBC.new_zeros(xBC.shape[:-2] + (W - 1, xBC.shape[-1]))
    else:
        pad = conv_state
    xp = torch.cat([pad, xBC], dim=-2)                     # (B, W-1+S, C)
    new_state = xp[..., -(W - 1):, :].clone()              # not a view of xp
    S = xBC.shape[-2]
    out = sum(xp[..., i:i + S, :] * params["conv_w"][i] for i in range(W))
    return L.silu(out + params["conv_b"]), new_state


def mixer_forward(params, cfg, u, rules=None, state=None):
    """Full-sequence mixer (prefill). Returns (y, (conv_st, ssm_st))."""
    B, S, _ = u.shape
    din, N, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    hp = din // nh
    z, xBC, dt = _split_proj(params, cfg, u, rules)
    xBC, conv_st = _causal_conv(params, cfg, xBC)
    x, Bm, Cm = torch.split(xBC, [din, N, N], dim=-1)
    x = L.shard(x.reshape(B, S, nh, hp), P("DP", None, "TP", None), rules)
    dt = F.softplus(dt.float() + params["dt_bias"])        # (B,S,nh)
    A = -torch.exp(params["A_log"])
    if rules is None:
        y, ssm_st = ssd_chunked(x, dt, A, Bm.float(), Cm.float(), params["D"],
                                cfg.ssm_chunk, initial_state=state)
    else:
        y, ssm_st = _ssd_on_shards(cfg, rules, x, dt, A, Bm.float(), Cm.float(),
                                   params["D"], state)
    y = y.reshape(B, S, din)
    y = L.rmsnorm(y * L.silu(z), params["norm"])           # gated norm
    return L.proj_out(y, params["out_proj"], rules), (conv_st, ssm_st)


def _ssd_on_shards(cfg, rules, x, dt, A, Bm, Cm, D, state):
    """``ssd_chunked`` on each rank's local shards: x (B,S,nh,hp), dt, A and
    D split by heads as x is, Bm/Cm whole but for the batch (so their
    gradients, and A's and D's over dp, are partial sums)."""
    heads = P("DP", None, "TP")
    dt = L.shard(dt, heads, rules)
    A, D = (L.shard(t, P("TP"), rules) for t in (A, D))
    Bm, Cm = (L.shard(t, P("DP", None, None), rules) for t in (Bm, Cm))
    xp = x.placements
    state_pl = tuple(Shard(1) if p == Shard(2) else p for p in xp)   # (B,nh,hp,N)
    return L.on_shards(
        lambda x, dt, A, Bm, Cm, D: ssd_chunked(x, dt, A, Bm, Cm, D, cfg.ssm_chunk,
                                                initial_state=state),
        [xp, state_pl], x, dt, A, Bm, Cm, D, summed=(2, 3, 4, 5))


def mixer_decode(params, cfg, u, conv_state, ssm_state):
    """O(1) single-token state update. u: (B,1,d)."""
    B = u.shape[0]
    din, N, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    hp = din // nh
    z, xBC, dt = _split_proj(params, cfg, u)
    # conv: shift window
    win = torch.cat([conv_state, xBC], dim=-2)             # (B, W, C)
    new_conv = win[:, 1:, :]
    out = torch.einsum("bwc,wc->bc", win, params["conv_w"])
    xBC = L.silu(out + params["conv_b"])[:, None, :]
    x, Bm, Cm = torch.split(xBC, [din, N, N], dim=-1)
    x = x.reshape(B, nh, hp)
    dt = F.softplus(dt[:, 0].float() + params["dt_bias"])  # (B,nh)
    A = -torch.exp(params["A_log"])
    dec = torch.exp(dt * A[None, :])                       # (B,nh)
    Bv = Bm[:, 0].float()                                  # (B,N)
    Cv = Cm[:, 0].float()
    contrib = (Bv[:, None, None, :] * dt[:, :, None, None]
               * x.float()[..., None])                     # (B,nh,hp,N)
    ssm_state = ssm_state.float() * dec[..., None, None] + contrib
    y = torch.einsum("bn,bhpn->bhp", Cv, ssm_state).to(u.dtype)
    y = y + x * params["D"][None, :, None].to(u.dtype)
    y = y.reshape(B, 1, din)
    y = L.rmsnorm(y * L.silu(z), params["norm"])
    return y @ params["out_proj"], new_conv, ssm_state.to(u.dtype)


# ---------------------------------------------------------------------------
# model: train / prefill / decode
# ---------------------------------------------------------------------------

def block(cfg, layer, x, rules=None):
    h = L.rmsnorm(x, layer["ln"])
    y, _ = mixer_forward(layer["mixer"], cfg, h, rules)
    return L.shard(x + y, P("DP", None, None), rules)


def trunk(cfg, params, x, rules=None):
    for layer in L.unstack_layers(params["layers"], cfg.n_layers):
        x = L.maybe_remat(cfg, block, cfg, layer, x, rules)
    return L.rmsnorm(x, params["ln_f"])


def loss_fn(cfg, params, batch, rules=None):
    x = L.token_embeddings(cfg, params, batch["tokens"], rules)
    x = trunk(cfg, params, x, rules)
    logits = L.unembed(params["embed"], x, rules)
    return L.softmax_xent(logits, batch["targets"], batch.get("mask"), rules)


def init_cache(cfg, B, S, dtype=None, *, device=None):
    """Mamba cache is O(1) in context length: conv window + SSD state."""
    dt = dtype or cfg.dtype()
    device = default_device(device)
    din, N, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    hp = din // nh
    conv_dim = din + 2 * N
    Lyr = cfg.n_layers
    return {"conv": torch.zeros((Lyr, B, cfg.conv_width - 1, conv_dim),
                                dtype=dt, device=device),
            "ssm": torch.zeros((Lyr, B, nh, hp, N), dtype=dt, device=device)}


CACHE_SPECS = {"conv": P(None, "DP", None, "TP"),
               "ssm": P(None, "DP", "TP", None, None)}


def cache_specs(cfg, rules=None):
    return dict(CACHE_SPECS)


def stack_states(convs, ssms, rules=None):
    """The per-layer states of a prefill, stacked and laid out by
    :func:`cache_specs`."""
    return {name: L.shard(torch.stack(states), CACHE_SPECS[name], rules)
            for name, states in (("conv", convs), ("ssm", ssms))}


def write_states(cache, i, conv_st, ssm_st):
    """Layer ``i``'s new decode states into ``cache``, in place."""
    for name, st in (("conv", conv_st), ("ssm", ssm_st)):
        slot = cache[name][i]
        if isinstance(slot, DTensor):
            st = st.redistribute(slot.device_mesh, slot.placements)
        slot.copy_(st)


def prefill(cfg, params, batch, rules=None, cache_len=None):
    x = L.token_embeddings(cfg, params, batch["tokens"], rules)
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        layer = L.layer_at(params["layers"], i)
        h = L.rmsnorm(x, layer["ln"])
        y, (conv_st, ssm_st) = mixer_forward(layer["mixer"], cfg, h, rules)
        x = L.shard(x + y, P("DP", None, None), rules)
        convs.append(conv_st)
        ssms.append(ssm_st)
    x = L.rmsnorm(x, params["ln_f"])
    logits = L.unembed(params["embed"], x[:, -1:], rules)
    return logits, stack_states(convs, ssms, rules)


def decode_step(cfg, params, cache, token, pos, rules=None):
    """One token for every sequence. Updates ``cache`` IN PLACE (where the
    JAX package returns a new cache from a donated one) and returns it."""
    x = L.token_embeddings(cfg, params, token, rules)
    for i in range(cfg.n_layers):
        layer = L.layer_at(params["layers"], i)
        h = L.rmsnorm(x, layer["ln"])
        y, conv_st, ssm_st = mixer_decode(layer["mixer"], cfg, h,
                                          cache["conv"][i], cache["ssm"][i])
        write_states(cache, i, conv_st, ssm_st)
        x = L.shard(x + y, P("DP", None, None), rules)
    x = L.rmsnorm(x, params["ln_f"])
    logits = L.unembed(params["embed"], x, rules)
    return logits, cache
