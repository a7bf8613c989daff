"""Quickstart, PyTorch port: weighted-quorum math on a batch of operations
(the data-plane hot spot), through ``repro_torch.core.quorum``.

The port's twin of section 3 of ``examples/quickstart.py``: the same
arrivals and weights, the same committed flags, commit times and quorum
sizes. On a CUDA device the commit runs kernel K1; on the CPU its plain
version.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import math

import torch

from repro_torch import default_device
from repro_torch.core import weights as W
from repro_torch.core.quorum import quorum_commit

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: cuda, which must exist)")
args = ap.parse_args()
device = default_device(args.device)

# -- batched quorum commit (kernel K1's math) ---------------------------------
arrivals = torch.tensor([[1.0, 3.0, 2.0, math.inf, 4.0],
                         [2.0, 1.0, math.inf, math.inf, math.inf]], device=device)
weights = W.geometric_weights(5, 1.9, device=device).tile(2, 1)
res = quorum_commit(arrivals, weights)
print("batched quorum commit:")
for i in range(2):
    print(f"  op{i}: committed={bool(res.committed[i])} "
          f"t={float(res.commit_time[i]):.1f} "
          f"quorum_size={int(res.quorum_size[i])}")
