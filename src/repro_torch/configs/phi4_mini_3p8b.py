"""phi4-mini-3.8b [dense] — 32L d3072 24H (GQA kv=8) ff8192 V200064, RoPE SwiGLU [arXiv:2412.08905]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab=200064, act="swiglu", qk_norm=False, rope_theta=1e4,
    microbatches=2,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=192,
        vocab=512,
        remat=False, microbatches=1)
