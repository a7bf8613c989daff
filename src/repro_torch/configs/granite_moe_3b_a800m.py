"""granite-moe-3b-a800m [moe] — 32L d1536 24H (GQA kv=8) expert_ff512 V49155, 40e top-8 [hf:ibm-granite family]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, act="swiglu", qk_norm=False, rope_theta=1e4,
    n_experts=40, top_k=8, capacity_factor=1.25,
    microbatches=2,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=64,
        vocab=512, n_experts=5, top_k=2,
        remat=False, microbatches=1)
