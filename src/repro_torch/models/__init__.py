"""Model families (port of ``repro.models``). Each module exposes the same
functional interface for serving:

  init_params(cfg, generator, *, device)
  init_cache(cfg, B, S, *, device)
  prefill(cfg, params, batch, cache_len)
  decode_step(cfg, params, cache, token, pos)

and, for training, ``loss_fn(cfg, params, batch)``.

Only the ported families are listed; the others raise NotImplementedError.
"""

from repro_torch.models import hybrid, mamba2, transformer

FAMILIES = {
    "dense": transformer,
    "ssm": mamba2,
    "hybrid": hybrid,
}

# families of the JAX package that the port does not have yet
NOT_PORTED = ("moe", "encdec", "vlm")


def family(cfg):
    if cfg.family in FAMILIES:
        return FAMILIES[cfg.family]
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(f"model family {cfg.family!r} ({cfg.name}) is "
                                  f"not ported to repro_torch yet; ported: "
                                  f"{sorted(FAMILIES)}")
    raise ValueError(f"unknown model family {cfg.family!r}")
