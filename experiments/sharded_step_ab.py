"""Time qwen3-1.7b's sharded training step (a 1x1 ("data", "model") mesh
over NCCL) of one tree of the repository, for A/B comparisons of two trees
on one card:

    python3 experiments/sharded_step_ab.py TREE LABEL

TREE is the root of a checkout (e.g. an unpacked ``git archive`` of the
parent commit); its ``chip_smoke.py`` runs ``training_path`` (3 steps) and
then ``sharded_training_path``. Prints one JSON line: the unsharded median
step, the sharded steps and their median, and the sharded profile's wall
time, idle share, device launches and top host entries. Run the two trees
in turns (A B B A), each in a process of its own.
"""

import contextlib
import io
import json
import sys
from pathlib import Path


def main(tree: str, label: str) -> None:
    root = Path(tree).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    import chip_smoke as cs
    cs._build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    with contextlib.redirect_stdout(io.StringIO()):
        unsharded = cs.training_path(cs.DENSE_ARCH, "training_path", 0, 3)
        torch.cuda.empty_cache()
        sharded = cs.sharded_training_path(cs.DENSE_ARCH, "sharded_training_path", 0,
                                           unsharded)
    p = sharded["profile"]
    print(json.dumps({"label": label, "card": cs.device_line(),
                      "unsharded_median": unsharded["step_s_median_after_first"],
                      "sharded_steps": [s["step_s"] for s in sharded["steps"]],
                      "sharded_median_timed": sharded["step_s_median_timed"],
                      "profiled_wall_ms": p["wall_ms"], "idle": p["device_idle_share"],
                      "launches": p["device_launches"], "top_host_ms": p["top_host_ms"]}))


if __name__ == "__main__":
    main(*sys.argv[1:3])
