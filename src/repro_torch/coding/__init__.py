"""Adaptive payload striping: a Crossword-style erasure-coding subsystem.

Makes payload size a first-class protocol dimension:

  * :mod:`repro_torch.coding.rs` — pure-Python Reed-Solomon over GF(256)
    (encode / decode / reconstruct, property-tested),
  * :mod:`repro_torch.coding.policy` — the per-instance full-copy vs (k, m)
    stripe decision (payload size x weighted-quorum composition x
    link-health EMAs),
  * :mod:`repro_torch.coding.manager` — the per-replica state machine: shard
    distribution, the weighted-reconstructable commit gate,
    reconstruction-on-read, and crash-recovery shard re-fetch.

Default-off: without the ``Scenario.coding`` knob no manager is
constructed and every run is bit-identical to the pre-coding code.
"""

from repro_torch.coding.manager import (CodingConfig, CodingManager,
                                  drain_pending_reads)
from repro_torch.coding.policy import StripePlan, choose_plan
from repro_torch.coding.rs import decode, encode, reconstruct, shard_len

__all__ = [
    "CodingConfig", "CodingManager", "StripePlan", "choose_plan",
    "decode", "drain_pending_reads", "encode", "reconstruct",
    "shard_len",
]
