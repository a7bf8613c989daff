"""mamba2-780m [ssm] — 48L d1536 attn-free V50280, ssm_state=128, SSD [arXiv:2405.21060]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=50280, act="gelu", rope_theta=1e4,
    ssm_state=128, ssm_expand=2, ssm_chunk=128, conv_width=4,
    microbatches=2, supports_long_context=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=3, d_model=64, d_ff=0, vocab=512, ssm_state=16,
        remat=False, microbatches=1)
