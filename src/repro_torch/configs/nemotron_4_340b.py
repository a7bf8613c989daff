"""nemotron-4-340b [dense] — 96L d18432 96H (GQA kv=8) ff73728 V256000, squared-ReLU [arXiv:2402.16819]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_ff=73728,
    vocab=256000, act="relu2", qk_norm=False, rope_theta=1e4,
    microbatches=16, grad_accum_dtype="bfloat16", opt_state_dtype="bfloat16",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=384,
        vocab=512, opt_state_dtype="float32",
        remat=False, microbatches=1)
