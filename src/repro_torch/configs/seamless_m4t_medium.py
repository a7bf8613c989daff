"""seamless-m4t-medium [audio enc-dec] — 12L d1024 16H (kv=16) ff4096 V256206, frame-embedding stub frontend [arXiv:2308.11596]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256206, act="gelu", rope_theta=1e4,
    encoder_layers=12, enc_len_ratio=4, microbatches=1,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, encoder_layers=2,
        remat=False, microbatches=1)
