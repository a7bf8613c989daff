"""Model families (port of ``repro.models``). Each module exposes the same
functional interface:

  init_params(cfg, generator, *, device) / param_specs(cfg, rules)
  loss_fn(cfg, params, batch, rules)
  init_cache(cfg, B, S, *, device) / cache_specs(cfg, rules)
  prefill(cfg, params, batch, rules, cache_len)
  decode_step(cfg, params, cache, token, pos, rules)

``rules`` (``launch.shardings``) defaults to None, the single-device code;
with it and DTensor inputs laid out by the specs, the same code runs
sharded. Every family of the JAX
package is here, and every one serves and trains. The encdec and vlm
families' frontends are stubs: their batches carry the frontend's output
beside the tokens (:func:`stub_inputs`).
"""

import torch

from repro_torch.models import encdec, hybrid, mamba2, moe, transformer, vlm

FAMILIES = {
    "dense": transformer,
    "moe": moe,
    "ssm": mamba2,
    "hybrid": hybrid,
    "encdec": encdec,
    "vlm": vlm,
}


def family(cfg):
    if cfg.family in FAMILIES:
        return FAMILIES[cfg.family]
    raise ValueError(f"unknown model family {cfg.family!r}")


def stub_inputs(cfg, generator: torch.Generator, B: int, S: int) -> dict:
    """The stub frontends' inputs of a batch of ``B`` sequences of ``S``
    tokens, standard normal in the compute dtype on the generator's device:
    ``frames`` (B, S // enc_len_ratio, d) for encdec, ``image_embeds``
    (B, n_image_tokens, d) for vlm, nothing for the other families (as
    ``repro.launch.train``'s CLI makes them)."""
    stub = {"encdec": ("frames", S // cfg.enc_len_ratio),
            "vlm": ("image_embeds", cfg.n_image_tokens)}.get(cfg.family)
    if stub is None:
        return {}
    name, length = stub
    return {name: torch.randn((B, length, cfg.d_model), generator=generator,
                              device=generator.device).to(cfg.dtype())}
