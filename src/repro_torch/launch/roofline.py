"""Three-term roofline of a traced step (port of ``repro.launch.roofline``).

  compute    = FLOPs / peak_FLOP/s
  memory     = bytes / HBM_bw
  collective = collective_bytes / link_bw

all per device: the counts come from ``launch.op_analysis``, which counts
the operators run on one rank's local shards while the dry-run traces the
step (``launch.dryrun``). A collective's payload is the largest tensor among
its inputs and outputs, the rule of the reference's analyzer
(``repro.launch.hlo_analysis``): within 2x of the ring-transfer bytes for
every collective kind, which is what a dominant-term analysis needs. The
reference's ``collective_bytes(hlo_text)`` and its HLO regexes have no
counterpart: the port has no HLO text, and the counter sees each collective
as an operator.

NVIDIA H100 SXM constants (per GPU, NVIDIA's H100 Tensor Core GPU data
sheet): 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3, 900
GB/s of NVLink 4 (all links together). The link figure holds inside one
8-GPU NVLink domain; a 256- or 512-rank mesh crosses nodes, whose network is
slower, so there the collective term is a lower bound. The rates assume the
card's full 700 W power limit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 900e9


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_by_kind: Dict[str, int]
    chips: int
    model_flops: float = 0.0

    # flops/hbm_bytes/coll_bytes are PER-DEVICE (the counter sees the local
    # shards), so each term is already a per-chip time; the aggregate
    # formulas (whole-model totals / (chips * peak)) coincide because
    # whole-model = per-device * chips.

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / traced FLOPs: how much of the traced compute is
        'useful' (catches remat recompute + padding/dispatch waste)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Upper bound on achievable MFU given the dominant term."""
        t_total = max(self.t_compute, self.t_memory, self.t_collective)
        if t_total == 0:
            return 0.0
        return (self.model_flops / (self.chips * PEAK_FLOPS)) / t_total

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.coll_bytes,
            "collective_by_kind": self.coll_by_kind,
            "chips": self.chips, "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def analyze(costs, *, chips: int, model_flops: float = 0.0) -> Roofline:
    """The roofline of ``costs``, the per-device ``op_analysis.Costs`` of a
    traced step (where the reference reads a compiled artifact's HLO)."""
    return Roofline(
        flops=float(costs.flops),
        hbm_bytes=float(costs.bytes),
        coll_bytes=float(sum(costs.coll.values())),
        coll_by_kind={k: int(v) for k, v in costs.coll.items()},
        chips=chips, model_flops=model_flops)


def model_flops_for(cfg, shape_name: str) -> float:
    """6*N*D for training, 2*N*D for prefill, 2*N_active*B per decode step
    (+ attention KV reads are in the memory term, not flops)."""
    from repro_torch.configs.base import SHAPES
    sh = SHAPES[shape_name]
    S, B, kind = sh["seq_len"], sh["global_batch"], sh["kind"]
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * (S * B)
    if kind == "prefill":
        return 2.0 * n_active * (S * B)
    return 2.0 * n_active * B        # one decoded token per sequence
