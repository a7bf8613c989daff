"""Deterministic synthetic token pipeline (a numpy copy of
``repro.data.pipeline``: the same ``(cfg, step, shard)`` gives the same
tokens, bit for bit).

Tokens are a pure hash of (seed, step, shard, position): any host can
produce exactly its shard of any step without coordination or I/O, restart
is trivially reproducible (the checkpoint stores only the step counter),
and elastic re-sharding just changes the (shard, n_shards) pair.

Documents are synthetic Zipf-ish segments separated by EOS so sequence
packing and masking paths are exercised.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 1
    mean_doc_len: int = 512


def _rng_for(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))


def host_batch(cfg: DataConfig, step: int, shard: int, n_shards: int):
    """The (tokens, targets, mask) numpy arrays for one host's shard."""
    if cfg.global_batch % n_shards:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"into {n_shards} shards")
    b = cfg.global_batch // n_shards
    rng = _rng_for(cfg, step, shard)
    # Zipf-ish marginal over the vocab, cheap to sample
    z = rng.zipf(1.3, size=(b, cfg.seq_len + 1))
    tokens = (z % (cfg.vocab - 2)) + 2
    # synthetic document boundaries -> EOS + loss mask
    doc_ends = rng.random((b, cfg.seq_len + 1)) < 1.0 / cfg.mean_doc_len
    tokens = np.where(doc_ends, cfg.eos_id, tokens).astype(np.int32)
    inputs = tokens[:, :-1]
    targets = tokens[:, 1:]
    mask = np.ones_like(targets, dtype=np.float32)
    return {"tokens": inputs, "targets": targets, "mask": mask}


def iterate(cfg: DataConfig, shard: int = 0, n_shards: int = 1,
            start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield host_batch(cfg, step, shard, n_shards)
        step += 1
