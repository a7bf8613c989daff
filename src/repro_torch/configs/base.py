"""ModelConfig: one dataclass covering every architecture family, and the
four input shapes (port of ``repro.configs.base``).

``dtype()`` and ``pdtype()`` give torch dtypes. The JAX config's
``use_pallas`` has no counterpart: in the port the tensors' device decides
whether a kernel runs (a CUDA tensor launches it, a CPU tensor runs its plain
version), so no flag is needed. ``input_specs`` gives ``meta`` tensors where
the JAX package gives ``jax.ShapeDtypeStruct``s.
"""

from __future__ import annotations

import dataclasses

import torch

# the four assigned input shapes (seq_len, global_batch, kind)
SHAPES = {
    "train_4k":    dict(seq_len=4_096,   global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768,  global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32_768,  global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524_288, global_batch=1,   kind="decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    act: str = "swiglu"           # swiglu | relu2 | gelu
    qk_norm: bool = False
    rope_theta: float = 1e6
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba-2 SSD)
    ssm_state: int = 0
    ssm_heads: int = 0            # defaults to d_inner // 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_width: int = 4
    # hybrid (Zamba2-style shared attention)
    shared_attn_every: int = 0
    # enc-dec
    encoder_layers: int = 0
    enc_len_ratio: int = 4        # S_enc = seq_len // ratio (audio frames)
    # vlm
    n_image_tokens: int = 0       # patch embeddings prepended (stub frontend)
    # numerics / execution
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"   # nemotron-340b overrides to bf16
    grad_accum_dtype: str = "float32"  # microbatch accumulator dtype
    remat: bool = True
    microbatches: int = 1
    # long_500k applicability: sub-quadratic context handling
    supports_long_context: bool = False

    # ---- derived -----------------------------------------------------------

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_inner // 64)

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    # ---- parameter count (for 6ND roofline math) -----------------------------

    def param_count(self) -> int:
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        if self.family == "moe":
            ff = self.n_experts * (3 if self.act == "swiglu" else 2) * d * f \
                + d * self.n_experts
        else:
            ff = (3 if self.act == "swiglu" else 2) * d * f
        if self.family == "ssm":
            din, N, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
            conv_dim = din + 2 * N
            block = (d * (2 * din + 2 * N + nh)       # in_proj
                     + conv_dim * self.conv_width + din * d + 2 * nh + din)
            return L * block + V * d + d
        per_layer = attn + ff + 2 * d
        if self.family == "hybrid":
            din, N, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
            conv_dim = din + 2 * N
            mamba_block = (d * (2 * din + 2 * N + nh)
                           + conv_dim * self.conv_width + din * d
                           + 2 * nh + din)
            shared = attn + ff + 2 * d + 2 * d * d    # concat projection
            return L * mamba_block + shared + V * d + d
        total = L * per_layer + V * d + d
        if self.family == "encdec":
            total += self.encoder_layers * per_layer + L * (attn + d)  # cross
        return total

    def active_param_count(self) -> int:
        """MoE: params touched per token (6*N_active*D roofline)."""
        if self.family != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        ff = self.top_k * (3 if self.act == "swiglu" else 2) * d * f \
            + d * self.n_experts
        return L * (attn + ff + 2 * d) + self.vocab * d + d


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """``meta`` tensor stand-ins for every model input of a shape cell: the
    JAX package's keys, shapes and dtypes, never allocated; the dry-run
    traces against them. Modality frontends are stubs: seamless gets
    precomputed frame embeddings, internvl2 patch embeddings."""
    sh = SHAPES[shape_name]
    S, B, kind = sh["seq_len"], sh["global_batch"], sh["kind"]

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32, f = torch.int32, cfg.dtype()
    if kind == "decode":      # one new token against a seq_len cache
        return {"token": spec((B, 1), i32), "pos": spec((B,), i32)}
    batch = {"tokens": spec((B, S), i32)}
    if kind == "train":
        batch["targets"] = spec((B, S), i32)
        batch["mask"] = spec((B, S), f)
    if cfg.family == "encdec":
        batch["frames"] = spec((B, S // cfg.enc_len_ratio, cfg.d_model), f)
    if cfg.family == "vlm":
        batch["image_embeds"] = spec((B, cfg.n_image_tokens, cfg.d_model), f)
    return batch
