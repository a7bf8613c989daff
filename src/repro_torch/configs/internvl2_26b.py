"""internvl2-26b [vlm] — 48L d6144 48H (GQA kv=8) ff16384 V92553, InternViT patch-embedding stub [arXiv:2404.16821]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92553, act="swiglu", qk_norm=False, rope_theta=1e4,
    n_image_tokens=256, microbatches=8,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=192,
        vocab=512, n_image_tokens=8,
        remat=False, microbatches=1)
