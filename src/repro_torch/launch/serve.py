"""Serving step builders (prefill + batched decode) and a small CLI demo
(port of ``repro.launch.serve``).

The decode step updates the cache in place (the JAX package donates it).
With ``rules`` (``launch.shardings``), parameters and requests laid out on
a mesh (``launch.train.distribute_tree``), prefill and decode run sharded:
the KV caches in the flash-decoding layout, sequence split over the tp
axis (``cache_specs`` of each family).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, default_device
from repro_torch.models import family, stub_inputs


def make_prefill_step(cfg, cache_len=None, *, rules=None):
    fam = family(cfg)

    def prefill_step(params, batch):
        return fam.prefill(cfg, params, batch, rules, cache_len=cache_len)
    return prefill_step


def make_decode_step(cfg, *, rules=None):
    fam = family(cfg)

    def decode_step(params, cache, token, pos):
        return fam.decode_step(cfg, params, cache, token, pos, rules)
    return decode_step


def abstract_cache(cfg, B, S):
    """The decode cache's shapes and dtypes, as ``meta`` tensors."""
    return family(cfg).init_cache(cfg, B, S, device="meta")


def prefix_len(cfg) -> int:
    """Positions ahead of the prompt's tokens: the image embeddings of the
    vlm family, which its prefill prepends."""
    return cfg.n_image_tokens if cfg.family == "vlm" else 0


def make_batch(cfg, generator: torch.Generator, B: int, S: int) -> dict:
    """A random request batch on the generator's device: ``tokens`` (B, S)
    and the stub frontends' inputs (``models.stub_inputs``)."""
    tokens = torch.randint(2, cfg.vocab, (B, S), generator=generator,
                           device=generator.device)
    return {"tokens": tokens, **stub_inputs(cfg, generator, B, S)}


# ---------------------------------------------------------------------------
# CLI demo: greedy decode a few tokens with the smoke config (always)
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch)
    fam = family(cfg)
    device = default_device(args.device)
    gen = torch.Generator(device).manual_seed(args.seed)
    params = fam.init_params(cfg, gen, device=device)
    B, S = args.batch, args.prompt_len
    batch = make_batch(cfg, gen, B, S)
    pos0 = S + prefix_len(cfg)          # decode starts after any image prefix
    prefill = make_prefill_step(cfg, cache_len=pos0 + args.gen)
    decode = make_decode_step(cfg)

    t0 = time.time()
    with torch.inference_mode():
        logits, cache = prefill(params, batch)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        out = [tok]
        for i in range(args.gen - 1):
            pos = torch.full((B,), pos0 + i, dtype=torch.int64, device=device)
            logits, cache = decode(params, cache, tok, pos)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            out.append(tok)
    toks = torch.cat(out, dim=1)
    print(f"generated {tuple(toks.shape)} in {time.time()-t0:.2f}s:")
    print(toks.cpu())
    return toks


if __name__ == "__main__":
    main()
