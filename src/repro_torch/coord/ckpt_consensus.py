"""Checkpoint commits through the slow path: a checkpoint is a HOT object.

"Which step is the latest durable checkpoint" is shared mutable state that
every host reads on restart — the paper's slow path (leader-coordinated,
node-weighted quorum) is exactly the right tool. The leader serializes
"checkpoint @ step S" decisions; a manifest only becomes COMMITTED once
hosts holding a strict weight majority have acked their shard files as
fsync'd, and the manifest embeds the quorum certificate. Restart readers
ignore manifests without a valid certificate, so a torn/partial write can
never be mistaken for the latest checkpoint.

Driven by explicit events (propose/ack) so it works identically under the
test-suite, the single-host launcher, and a real multi-host deployment.

Port of ``repro.coord.ckpt_consensus``. The state is host-side: the weights
are computed by ``repro_torch.core.weights.geometric_weights`` on the CPU,
whatever card the process has, and kept as numpy.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import weights as W


@dataclasses.dataclass
class PendingCommit:
    step: int
    acked: Dict[int, bool]
    files: List[str]


class CheckpointConsensus:
    def __init__(self, n_hosts: int, *, t_fail: int = 1,
                 steepness: Optional[float] = None):
        self.n = n_hosts
        if steepness is None:
            steepness = (W.solve_steepness(
                n_hosts, max(1, min(t_fail, (n_hosts - 1) // 2)))
                if n_hosts >= 3 else 1.5)
        self.weights = W.geometric_weights(n_hosts, steepness,
                                           device="cpu").numpy()
        self.threshold = float(self.weights.sum()) / 2.0
        self.pending: Dict[int, PendingCommit] = {}
        self.committed_step: int = -1

    def propose(self, step: int, files: List[str]) -> None:
        self.pending[step] = PendingCommit(step, {}, files)

    def ack(self, step: int, host: int) -> bool:
        """Host reports its shard fsync'd. Returns True when the commit
        certificate forms (strict weight majority, Thm-1 semantics)."""
        p = self.pending.get(step)
        if p is None:
            return False
        p.acked[host] = True
        w = sum(self.weights[h] for h in p.acked)
        if w > self.threshold and step > self.committed_step:
            self.committed_step = step
            return True
        return False

    def certificate(self, step: int) -> dict:
        p = self.pending[step]
        hosts = sorted(p.acked)
        return {"step": step, "hosts": hosts,
                "weight": float(sum(self.weights[h] for h in hosts)),
                "threshold": self.threshold,
                "files": p.files}

    def write_manifest(self, directory, step: int) -> pathlib.Path:
        path = pathlib.Path(directory) / f"manifest_{step:08d}.json"
        cert = self.certificate(step)
        cert["committed"] = cert["weight"] > cert["threshold"]
        path.write_text(json.dumps(cert, indent=2))
        return path

    @staticmethod
    def latest_committed(directory) -> Optional[dict]:
        best = None
        for p in sorted(pathlib.Path(directory).glob("manifest_*.json")):
            try:
                m = json.loads(p.read_text())
            except (OSError, json.JSONDecodeError):
                continue
            if m.get("committed") and m.get("weight", 0) > m.get(
                    "threshold", float("inf")):
                if best is None or m["step"] > best["step"]:
                    best = m
        return best
