"""Where K3's backward spends its time, on one GPU.

Copies a ``repro_torch`` package (``--tree``, by default this checkout's)
under ``build/k3_bwd_phases/`` and edits its ``ssd_scan_bwd.cu``, then
runs K3's backward from each copy at the zamba2-1.2b training shape (4,
16, 128, 64, 64, 64), x bf16, and prints each copy's device time split by
kernel (``torch.profiler``, 20 calls) and, for the stamped copy, each
phase's median over blocks of the per-warp sums of SM cycles (``clock64()``,
lane 0 of each warp, written once at the warp's end):

* the ``wgmma`` kernel (this checkout's, since K3's backward was redesigned
  for Hopper): ``stamped`` by role (``HOPPER_PHASES``: the consumers' and
  the producer's phases) and ``plain``;
* the ``mma.sync`` kernel before it (``--tree`` on ``git archive 082377f``,
  the last commit with it): ``stamped`` (``PHASES``), ``no_readback`` (the heads
  kernel no longer reads its partial sums back from global memory before
  adding a head to them; its outputs are wrong, only its time is of use)
  and ``plain``.

Stamps are issue times: a phase that ends in a load or a product that is
not waited for is charged to the next phase that waits, and SASS may move
a stamp across a barrier wait, so a wait can show up in the next phase.
The stamps cost a few percent.

    PYTHONPATH=src python3 experiments/k3_bwd_phases.py                     # ~2 min
    PYTHONPATH=src python3 experiments/k3_bwd_phases.py --tree parent/src/repro_torch
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "k3_bwd_phases"
SHAPE = (4, 16, 128, 64, 64, 64)   # B, nc, Q, nh, hp, N
BLOCKS = 256                        # blocks whose stamps are kept (the grid has 128)
WARPS = 16
PHASES = ("cb", "load_wait", "T", "R", "readback_issue", "dots_f64", "exps_M_K_partials",
          "MT_dy", "dx_store", "head_last_sums")
N_SLOTS = len(PHASES) + 1           # and the block's total

LAP = ("{{ const long long tn = clock64(); ph[{k}] += tn - ts; ts = tn; }}\n")

# (anchor, replacement) pairs applied once each
STAMPS = [
    ("namespace {\n\nconstexpr int kThreads = 512;",
     f"__device__ long long g_bwd_phase[{BLOCKS}][{WARPS}][{N_SLOTS}];\n"
     "namespace {\n\nconstexpr int kThreads = 512;"),
    ("  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"
     "  const int g = lane / 4, t = lane % 4;  // fragment row and column\n",
     "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"
     "  const int g = lane / 4, t = lane % 4;  // fragment row and column\n"
     "  const int pb = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;\n"
     f"  long long ph[{len(PHASES)}] = {{}};\n"
     "  const long long t_begin = clock64();\n  long long ts = t_begin;\n"),
    ("  __syncthreads();  // C is spent: its space holds the slab buffers from here on\n",
     "  __syncthreads();  // C is spent: its space holds the slab buffers from here on\n"
     + LAP.format(k=0)),
    ("    const int h = h_begin + s / nslab, p0 = kSlab * (s % nslab), pw = min(kSlab, hp - p0);\n"
     "    const bool first",
     LAP.format(k=1) +
     "    const int h = h_begin + s / nslab, p0 = kSlab * (s % nslab), pw = min(kSlab, hp - p0);\n"
     "    const bool first"),
    ("      // R = x dS over this half's column tiles", LAP.format(k=2)
     + "      // R = x dS over this half's column tiles"),
    ("      // the strip's blocks on and right of the diagonal", LAP.format(k=3)
     + "      // the strip's blocks on and right of the diagonal"),
    ("        // dM_ij = dy_i . x_j, the float32 value nearest the exact product\n",
     LAP.format(k=4) + "        // dM_ij = dy_i . x_j, the float32 value nearest the exact product\n"),
    ("        const float4 cb4 =\n", LAP.format(k=5) + "        const float4 cb4 =\n"),
    ("        *reinterpret_cast<float4*>(mine) = make_float4(m[0], m[1], m[2], m[3]);\n",
     LAP.format(k=6)
     + "        *reinterpret_cast<float4*>(mine) = make_float4(m[0], m[1], m[2], m[3]);\n"),
    ("        }\n      }\n#pragma unroll\n      for (int hr = 0; hr < 2; ++hr) {\n"
     "        colk[hr] +=",
     "        }\n        " + LAP.format(k=7) + "      }\n#pragma unroll\n"
     "      for (int hr = 0; hr < 2; ++hr) {\n        colk[hr] +="),
    ("    if (head_last) {  // the head's ddt and dseg from the slots\n",
     LAP.format(k=8) + "    if (head_last) {  // the head's ddt and dseg from the slots\n"),
    ("    }\n  }\n}\n\n// dC = dCB B and dB",
     "    }\n    " + LAP.format(k=9) + "  }\n"
     f"  if (lane == 0 && pb < {BLOCKS}) {{\n"
     f"    for (int k = 0; k < {len(PHASES)}; ++k) g_bwd_phase[pb][warp][k] = ph[k];\n"
     f"    g_bwd_phase[pb][warp][{len(PHASES)}] = clock64() - t_begin;\n  }}\n"
     "}\n\n// dC = dCB B and dB"),
]
# The wgmma kernel (this file's ssd_scan_bwd.cu since its redesign for
# Hopper): per warp of the consumers and of the producer, in the same slots
# as PHASES' table below, by role.
HOPPER_WARPS = 12
HOPPER_PHASES = {
    "consumer": ("cb", "wait_ready_dS", "T_and_xdS_products", "xdS_into_dBs_and_dw",
                 "w_T", "wait_ready_dy", "MT_dy_form_issue_wait", "float64_dots_K_dCB",
                 "", "other", "dx_store", "ddt_dseg"),
    "producer": ("", "wait_free_dS_parts", "wait_dS_tma", "wait_x_or_dy_tma", "split_dS",
                 "split_dy", "seg_dt_w", "wait_free_dy", "wait_free_x", "other", "", ""),
}
HOPPER_SLOTS = 12
HLAP = "{{ const long long tn = clock64(); pst[{k}] += tn - ts; ts = tn; }}\n"


def around(anchor: str, before: int | None, after: int | None, indent: str) -> tuple[str, str]:
    """Stamps before and after an anchor line (slots, or None)."""
    return (anchor, (indent + HLAP.format(k=before) if before is not None else "") + anchor
            + (indent + HLAP.format(k=after) if after is not None else ""))


HOPPER_STAMPS = [
    ("namespace {\n\nconstexpr int kQT = 128;",
     f"__device__ long long g_bwd_phase[{BLOCKS}][{HOPPER_WARPS}][{HOPPER_SLOTS + 1}];\n"
     "namespace {\n\nconstexpr int kQT = 128;"),
    ("  if (threadIdx.x == 0) {\n    mbar_init(xfull, 1);",
     "  const int pb = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;\n"
     f"  long long pst[{HOPPER_SLOTS}] = {{}};\n"
     "  const long long t_begin = clock64();\n  long long ts = t_begin;\n"
     f"#define PHASE_OUT if (threadIdx.x % 32 == 0 && pb < {BLOCKS}) {{ "
     f"for (int k = 0; k < {HOPPER_SLOTS}; ++k) g_bwd_phase[pb][threadIdx.x / 32][k] = pst[k]; "
     f"g_bwd_phase[pb][threadIdx.x / 32][{HOPPER_SLOTS}] = clock64() - t_begin; }}\n"
     "  if (threadIdx.x == 0) {\n    mbar_init(xfull, 1);"),
    # producer
    around("      if (it % halves == 0) {  // the head's seg, dt and w_j = dt_j exp(seg_last - seg_j)\n",
           9, None, "      "),
    ("        v[2 * kQT + pt] = pt < Q ? d * exp2_ftz((sl - s) * kLog2e) : 0.0f;\n      }\n",
     "        v[2 * kQT + pt] = pt < Q ? d * exp2_ftz((sl - s) * kLog2e) : 0.0f;\n      }\n"
     "      " + HLAP.format(k=6)),
    around("          mbar_wait(sfull, sphase);\n", 9, 2, "          "),
    around("          mbar_wait(xfull, xphase);\n", 9, 3, "          "),
    around("        if (it > 0 || np > 0) named_sync(kBarFreeS, kThreads);  // the parts are free\n",
           9, 1, "        "),
    around("        named_arrive(kBarReadyS, kThreads);\n", 4, None, "        "),
    around("      if (it > 0) named_sync(kBarFreeB, kThreads);  // the last item's dy and parts are free\n",
           9, 7, "      "),
    around("        mbar_wait(yfull, yphase);\n", 9, 3, "        "),
    around("      named_arrive(kBarReadyB, kThreads);\n", 5, None, "      "),
    around("        named_sync(kBarFreeX, kThreads);  // the consumers are done with x's tile\n", 9, 8,
           "        "),
    ("    }\n    return;\n  }\n", "    }\n    PHASE_OUT\n    return;\n  }\n"),
    # consumers
    ("  regs_inc<kConsumerRegs>();\n", "  regs_inc<kConsumerRegs>();\n  " + HLAP.format(k=9)),
    ("  float acc[32];", "  " + HLAP.format(k=0) + "  float acc[32];"),
    around("      named_sync(kBarReadyS, kThreads);\n", 9, 1, "      "),
    ("      wgmma_commit();\n      wgmma_wait<0>();\n      fence_regs(acc);\n#pragma unroll\n"
     "      for (int kk = 0; kk < 4; ++kk) fence_regs(bf[kk]);\n",
     "      wgmma_commit();\n      wgmma_wait<0>();\n      fence_regs(acc);\n#pragma unroll\n"
     "      for (int kk = 0; kk < 4; ++kk) fence_regs(bf[kk]);\n      " + HLAP.format(k=2)),
    around("    // dx starts as w_j T_j\n", 3, None, "    "),
    around("    named_sync(kBarReadyB, kThreads);\n", 4, 5, "    "),
    around("    // dx of the strip's rows and the item's columns\n", 6, None, "    "),
    around("    // ---- on the item that completes the head, the float64 dM_ij = dy_i . x_j\n", 10,
           None, "    "),
    around("    if (it + 1 < items) named_arrive(kBarFreeB, kThreads);  // dy and its parts are free\n",
           7, None, "    "),
    ("      named_sync(kBarConsumers, kConsumerThreads);  // the slots are read\n    }\n  }\n",
     "      named_sync(kBarConsumers, kConsumerThreads);  // the slots are read\n    }\n    "
     + HLAP.format(k=11) + "  }\n  PHASE_OUT\n"),
]

READER = """
extern "C" int ssd_bwd_phase_read(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_bwd_phase, sizeof(g_bwd_phase)));
}
"""
NO_READBACK = [
    ("old[e] = !first && i >= j && i < Q ? dcb[i * Q + j] : 0.0f;", "old[e] = 0.0f;"),
    ("!first && tb + n < tn_end && j < Q && col < N ? dbs[j * N + col] : 0.0f;", "0.0f;"),
]


def edited(tree: Path, name: str, edits, tail: str = "") -> Path:
    """A copy of ``tree`` under build/k3_bwd_phases/<name>/src with the edits
    applied to ssd_scan_bwd.cu."""
    dst = COPY / name / "src" / "repro_torch"
    shutil.rmtree(COPY / name, ignore_errors=True)
    shutil.copytree(tree, dst, ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "kernels" / "csrc" / "ssd_scan_bwd.cu"
    text = cu.read_text()
    for anchor, new in edits:
        if text.count(anchor) != 1:
            raise SystemExit(f"k3_bwd_phases: anchor not found once in {cu}: {anchor!r}")
        text = text.replace(anchor, new)
    cu.write_text(text + tail)
    return dst.parent


def measure(stamped: str) -> dict:
    """Runs in a copy: the per-kernel device times and, for the stamped
    copy, each phase's median over the blocks."""
    import ctypes

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator("cuda").manual_seed(0)
    B, nc, Q, nh, hp, N = SHAPE

    def r(*size):
        return torch.randn(size, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(r(B, nc, Q, nh) - 2.0)
    seg = torch.cumsum(dt * -torch.exp(0.5 * r(nh)), dim=2)
    args = (r(B, nc, Q, nh, hp).bfloat16(), dt, seg, r(B, nc, Q, N), r(B, nc, Q, N),
            r(B, nc, Q, nh, hp), r(B, nc, nh, hp, N), r(B, nc, nh))
    for _ in range(3):
        ssd.ssd_intra_chunk_bwd_cuda(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            ssd.ssd_intra_chunk_bwd_cuda(*args)
        torch.cuda.synchronize()
    kernels = {e.key: e.self_device_time_total / 1e3 / 20 for e in prof.key_averages()
               if e.self_device_time_total > 0}
    out = {"device": torch.cuda.get_device_name(0), "kernel_ms": kernels}
    if stamped == "hopper":
        ssd.ssd_intra_chunk_bwd_cuda(*args)
        torch.cuda.synchronize()
        buf = np.zeros((BLOCKS, HOPPER_WARPS, HOPPER_SLOTS + 1), dtype=np.int64)
        if _build.library("ssd_scan_bwd").ssd_bwd_phase_read(ctypes.c_void_p(buf.ctypes.data)):
            raise RuntimeError("k3_bwd_phases: reading the stamps failed")
        blocks = B * nc * -(-nh // ssd.BWD_HEADS_PER_BLOCK)
        b = buf[:min(blocks, BLOCKS)].astype(np.float64)
        out["block_cycles_median"] = float(np.median(b[:, :, -1].max(axis=1)))
        for role, warps in (("producer", slice(0, 4)), ("consumer", slice(4, 12))):
            out[f"{role}_cycles_median_of_warp_sums"] = {
                name: float(np.median(b[:, warps, k])) for k, name in
                enumerate(HOPPER_PHASES[role]) if name}
    elif stamped:
        ssd.ssd_intra_chunk_bwd_cuda(*args)
        torch.cuda.synchronize()
        buf = np.zeros((BLOCKS, WARPS, N_SLOTS), dtype=np.int64)
        if _build.library("ssd_scan_bwd").ssd_bwd_phase_read(ctypes.c_void_p(buf.ctypes.data)):
            raise RuntimeError("k3_bwd_phases: reading the stamps failed")
        blocks = B * nc * -(-nh // ssd.BWD_HEADS_PER_BLOCK)
        b = buf[:min(blocks, BLOCKS)].astype(np.float64)
        total = b[:, :, -1]
        out["block_cycles_median"] = float(np.median(total.max(axis=1)))
        out["phase_cycles_median_of_warp_sums"] = {
            name: float(np.median(b[:, :, k])) for k, name in enumerate(PHASES)}
        out["phase_share_of_warp_total"] = {
            name: float(np.median(b[:, :, k] / total)) for k, name in enumerate(PHASES)}
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", type=Path, default=ROOT / "src" / "repro_torch")
    parser.add_argument("--measure", choices=("stamped", "hopper", "plain"))
    a = parser.parse_args()
    if a.measure:
        print(json.dumps(measure(a.measure if a.measure != "plain" else "")))
        return 0
    source = (a.tree / "kernels" / "csrc" / "ssd_scan_bwd.cu").read_text()
    if "wgmma_rs<64>(acc, f[" in source:     # the wgmma kernel
        runs = {"hopper": edited(a.tree, "stamped", HOPPER_STAMPS, READER),
                "plain": edited(a.tree, "plain", [])}
    else:
        runs = {"stamped": edited(a.tree, "stamped", STAMPS, READER),
                "no_readback": edited(a.tree, "no_readback", NO_READBACK),
                "plain": edited(a.tree, "plain", [])}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    result = {"card": card, "shape": list(SHAPE)}
    for name, src in runs.items():
        run = subprocess.run([sys.executable, __file__, "--measure",
                              name if name in ("stamped", "hopper") else "plain"],
                             cwd=src.parent, env={**os.environ, "PYTHONPATH": str(src)},
                             capture_output=True, text=True, timeout=900)
        if run.returncode:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        result[name] = json.loads(run.stdout.strip().splitlines()[-1])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
