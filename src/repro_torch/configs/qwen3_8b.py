"""qwen3-8b [dense] — 36L d4096 32H (GQA kv=8) ff12288 V151936, qk_norm [hf:Qwen/Qwen3-8B]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12288,
    vocab=151936, act="swiglu", qk_norm=True, rope_theta=1e6,
    microbatches=4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512,
        remat=False, microbatches=1)
