"""Model families (port of ``repro.models``). Each module exposes the same
functional interface for serving:

  init_params(cfg, generator, *, device)
  init_cache(cfg, B, S, *, device)
  prefill(cfg, params, batch, cache_len)
  decode_step(cfg, params, cache, token, pos)

and, for training, ``loss_fn(cfg, params, batch)``. Every family of the JAX
package is here; the moe, encdec and vlm families serve but have no
``loss_fn`` yet (``launch.train.make_train_step`` raises for them).
"""

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
