"""Model families (port of ``repro.models``). Each module exposes the same
functional interface for serving:

  init_params(cfg, generator, *, device)
  init_cache(cfg, B, S, *, device)
  prefill(cfg, params, batch, cache_len)
  decode_step(cfg, params, cache, token, pos)

and, for training, ``loss_fn(cfg, params, batch)``. Every family of the JAX
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
