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
layer (``layers.maybe_remat``). The sharding specs wait for
``launch/shardings``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import default_device
from repro_torch.kernels.ssd_scan import ssd_chunked  # noqa: F401  (re-exported)
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


def init_layer(generator, cfg, dt):
    return {"mixer": init_mixer(generator, cfg, dt),
            "ln": L.ones(generator, (cfg.d_model,), dt)}


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

def _split_proj(params, cfg, u):
    """u: (B,S,d) -> z (B,S,din), xBC (B,S,din+2N), dt (B,S,nh)."""
    din, N, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    zxbcdt = u @ params["in_proj"]
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


def mixer_forward(params, cfg, u, state=None):
    """Full-sequence mixer (prefill). Returns (y, (conv_st, ssm_st))."""
    B, S, _ = u.shape
    din, N, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    hp = din // nh
    z, xBC, dt = _split_proj(params, cfg, u)
    xBC, conv_st = _causal_conv(params, cfg, xBC)
    x, Bm, Cm = torch.split(xBC, [din, N, N], dim=-1)
    x = x.reshape(B, S, nh, hp)
    dt = F.softplus(dt.float() + params["dt_bias"])        # (B,S,nh)
    A = -torch.exp(params["A_log"])
    y, ssm_st = ssd_chunked(x, dt, A, Bm.float(), Cm.float(), params["D"],
                            cfg.ssm_chunk, initial_state=state)
    y = y.reshape(B, S, din)
    y = L.rmsnorm(y * L.silu(z), params["norm"])           # gated norm
    return y @ params["out_proj"], (conv_st, ssm_st)


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

def block(cfg, layer, x):
    h = L.rmsnorm(x, layer["ln"])
    y, _ = mixer_forward(layer["mixer"], cfg, h)
    return x + y


def trunk(cfg, params, x):
    for layer in L.unstack_layers(params["layers"], cfg.n_layers):
        x = L.maybe_remat(cfg, block, cfg, layer, x)
    return L.rmsnorm(x, params["ln_f"])


def loss_fn(cfg, params, batch):
    x = L.embed(params["embed"], batch["tokens"]).to(cfg.dtype())
    x = trunk(cfg, params, x)
    logits = L.unembed(params["embed"], x)
    return L.softmax_xent(logits, batch["targets"], batch.get("mask"))


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


def prefill(cfg, params, batch, cache_len=None):
    x = L.embed(params["embed"], batch["tokens"]).to(cfg.dtype())
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        layer = L.layer_at(params["layers"], i)
        h = L.rmsnorm(x, layer["ln"])
        y, (conv_st, ssm_st) = mixer_forward(layer["mixer"], cfg, h)
        x = x + y
        convs.append(conv_st)
        ssms.append(ssm_st)
    x = L.rmsnorm(x, params["ln_f"])
    logits = L.unembed(params["embed"], x[:, -1:])
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}


def decode_step(cfg, params, cache, token, pos):
    """One token for every sequence. Updates ``cache`` IN PLACE (where the
    JAX package returns a new cache from a donated one) and returns it."""
    x = L.embed(params["embed"], token).to(cfg.dtype())
    for i in range(cfg.n_layers):
        layer = L.layer_at(params["layers"], i)
        h = L.rmsnorm(x, layer["ln"])
        y, conv_st, ssm_st = mixer_decode(layer["mixer"], cfg, h,
                                          cache["conv"][i], cache["ssm"][i])
        cache["conv"][i].copy_(conv_st)
        cache["ssm"][i].copy_(ssm_st)
        x = x + y
    x = L.rmsnorm(x, params["ln_f"])
    logits = L.unembed(params["embed"], x)
    return logits, cache
