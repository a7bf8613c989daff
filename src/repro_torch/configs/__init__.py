"""Architecture registry: ``get("<arch-id>")`` -> ModelConfig (port of
``repro.configs``).

Every architecture of the JAX package is a module exporting ``CONFIG`` (the
published hyperparameters) and ``smoke()`` (a reduced same-family config for
CPU tests). Names and aliases are the JAX package's.
"""

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig

ARCHS = [
    "qwen3_8b", "qwen3_1p7b", "nemotron_4_340b", "phi4_mini_3p8b",
    "zamba2_1p2b", "qwen3_moe_235b_a22b", "granite_moe_3b_a800m",
    "mamba2_780m", "seamless_m4t_medium", "internvl2_26b",
]
ALL_ARCHS = ARCHS   # every architecture of the JAX package is ported

# canonical ids as assigned (dashes) -> module names
ALIASES = {a.replace("_", "-").replace("-1p7b", "-1.7b")
            .replace("-3p8b", "-3.8b").replace("-1p2b", "-1.2b"): a
           for a in ARCHS}


def _module(name: str):
    mod = name.replace("-", "_").replace(".", "p")
    if mod not in ARCHS:
        mod = ALIASES.get(name, mod)
    if mod not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke(name: str) -> ModelConfig:
    return _module(name).smoke()


__all__ = ["ARCHS", "ALL_ARCHS", "get", "smoke", "ModelConfig", "SHAPES"]
