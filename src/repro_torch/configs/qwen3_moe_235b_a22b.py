"""qwen3-moe-235b-a22b [moe] — 94L d4096 64H (GQA kv=4) expert_ff1536 V151936, 128e top-8 [hf:Qwen/Qwen3-30B-A3B family]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab=151936, act="swiglu", qk_norm=True, rope_theta=1e6,
    n_experts=128, top_k=8, capacity_factor=1.25,
    microbatches=8,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab=512, n_experts=8, top_k=2,
        remat=False, microbatches=1)
