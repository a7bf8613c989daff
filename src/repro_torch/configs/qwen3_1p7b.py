"""qwen3-1.7b [dense] — 28L d2048 16H (GQA kv=8) ff6144 V151936, qk_norm [hf:Qwen/Qwen3-8B family]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab=151936, act="swiglu", qk_norm=True, rope_theta=1e6,
    microbatches=2,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512,
        remat=False, microbatches=1)
