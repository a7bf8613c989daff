"""Where K3's forward kernel spends a block's time, on one GPU.

Builds a copy of ``src/repro_torch`` under ``build/k3_phases/`` whose
``ssd_scan.cu`` carries ``clock64()`` stamps in each consumer warpgroup of
the first 256 blocks (one thread each): the block's start, the end of the
C Bᵀ phase, and for each of the first 16 heads the wait for x, the products
(forming, wgmma and y's staging) and the rest up to the next head (the
state's staging, the store issue and the next head's wait for its output
stage).
Runs K3 from that copy at the serving prefill's and the training
microbatch's shapes (x bf16) and prints each phase's median over the blocks,
in SM cycles and as a share of the block. The stamps cost a few percent; the
graph time of the same call without them is ``chip_smoke.py``'s ``ms``.

    PYTHONPATH=src python3 experiments/k3_phases.py      # one GPU, ~30 s
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "k3_phases"
SHAPES = ((8, 16, 128, 64, 64, 64), (4, 16, 128, 64, 64, 64))   # B, nc, Q, nh, hp, N
HEADS = 16          # heads a block stamps: the kernel's 16 a block
SLOTS = 80

# (anchor in ssd_scan.cu, text put before it)
STAMPS = [
    ("namespace {\n\nconstexpr int kQT",
     f"__device__ long long g_phase[256][2][{SLOTS}];\n"),
    ("  // seg and dt of the block's heads, 0 past Q\n",
     "  const int pb = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;\n"
     "#define STAMP(k) if (pb < 256 && ltid == 0) g_phase[pb][cw][k] = clock64()\n"
     "  STAMP(0);\n"),
    ("  named_sync(1, kConsumerThreads);  // B's parts are read", "  STAMP(1);\n"),
    ("    if (tma_x) {\n      mbar_wait(&full[s], (it / stages) & 1);\n",
     f"    if (it < {HEADS}) STAMP(2 + 4 * it);\n"),
    ("    const float si[2] = {seg_h[i0], seg_h[i0 + 8]};",
     f"    if (it < {HEADS}) STAMP(3 + 4 * it);\n"),
    ("    if (tma_x) {  // the x stage is done with", f"    if (it < {HEADS}) STAMP(4 + 4 * it);\n"),
    ("  if (tma_out && ltid == 0) bulk_wait_read<0>();", f"  STAMP({SLOTS - 1});\n"),
]
READER = """
extern "C" int ssd_phase_read(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_phase, sizeof(g_phase)));
}
"""


def make_copy() -> None:
    """The stamped copy of the package under build/k3_phases/src."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", COPY / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = COPY / "src" / "repro_torch" / "kernels" / "csrc" / "ssd_scan.cu"
    text = cu.read_text()
    for anchor, stamp in STAMPS:
        if text.count(anchor) != 1:
            raise SystemExit(f"k3_phases: anchor not found once in ssd_scan.cu: {anchor!r}")
        text = text.replace(anchor, stamp + anchor)
    cu.write_text(text + READER)


def measure() -> dict:
    """Runs in the copy: each phase's median over the stamped blocks."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator("cuda").manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0)}
    for shape in SHAPES:
        B, nc, Q, nh, hp, N = shape

        def r(*size):
            return torch.randn(size, generator=gen, device="cuda")
        dt = torch.nn.functional.softplus(r(B, nc, Q, nh) - 2.0)
        seg = torch.cumsum(dt * -torch.exp(0.5 * r(nh)), dim=2)
        args = (r(B, nc, Q, nh, hp).bfloat16(), dt, seg, r(B, nc, Q, N), r(B, nc, Q, N))
        for _ in range(3):
            ssd.ssd_intra_chunk_cuda(*args)
        torch.cuda.synchronize()
        buf = np.zeros((256, 2, SLOTS), dtype=np.int64)
        if _build.library("ssd_scan").ssd_phase_read(ctypes.c_void_p(buf.ctypes.data)):
            raise RuntimeError("k3_phases: reading the stamps failed")
        per = {}
        for cw in (0, 1):
            b = buf[:, cw, :].astype(np.float64)
            block = b[:, SLOTS - 1] - b[:, 0]
            heads = [b[:, 2 + 4 * i: 6 + 4 * i] for i in range(HEADS - 1)]
            phases = {
                "cb_phase": b[:, 1] - b[:, 0],
                "x_wait": np.concatenate([h[:, 1] - h[:, 0] for h in heads]),
                "products": np.concatenate([h[:, 2] - h[:, 1] for h in heads]),
                "staging_and_stores": np.concatenate(
                    [b[:, 2 + 4 * (i + 1)] - h[:, 2] for i, h in enumerate(heads)]),
            }
            med = {k: float(np.median(v)) for k, v in phases.items()}
            med["block"] = float(np.median(block))
            med["cb_phase_share_of_block"] = med["cb_phase"] / med["block"]
            per[f"consumer_{cw}"] = med
        out[str(list(shape))] = per
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--measure":
        print(json.dumps(measure()))
        return 0
    make_copy()
    run = subprocess.run([sys.executable, __file__, "--measure"], cwd=COPY,
                         env={**os.environ, "PYTHONPATH": str(COPY / "src")},
                         capture_output=True, text=True, timeout=600)
    print(run.stdout.strip() or run.stderr[-4000:])
    return run.returncode


if __name__ == "__main__":
    sys.exit(main())
