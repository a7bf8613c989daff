"""zamba2-1.2b [hybrid] — 38L d2048 32H (kv=32) ff8192 V32000, ssm_state=64, Mamba2 + shared attn [arXiv:2411.15242]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32000, act="gelu", rope_theta=1e4,
    ssm_state=64, ssm_expand=2, ssm_chunk=128, conv_width=4,
    shared_attn_every=6, microbatches=2, supports_long_context=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, ssm_state=16, shared_attn_every=3,
        remat=False, microbatches=1)
