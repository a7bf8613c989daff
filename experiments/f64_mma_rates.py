"""The float64 tensor-core shapes and the float32/bf16-to-float64 conversion
on one GPU: which ``mma.sync`` shape K3's backward should issue for its
float64 products (dy xᵀ and C Bᵀ), and what converting an operand costs.

Builds a small CUDA library under ``build/f64_mma_rates/`` and, for each of
``mma.sync`` m8n8k4, m16n8k4, m16n8k8 and m16n8k16 in float64:

* checks one product against numpy, with the fragment layouts K3's
  backward assumes (g = lane / 4, t = lane % 4; A rows g and g + 8, column
  t + 4 q for register q; B row t + 4 q, column g; D rows g and g + 8,
  columns 2 t and 2 t + 1);
* times a loop of products from registers, four independent accumulators a
  warp, over every SM, and prints TFLOP/s and FLOP a cycle an SM (at the SM
  clock read from nvidia-smi while it ran).

Then it times ``cvt.f64.f32`` and the bf16 widening followed by it, as
conversions a cycle an SM, against the CUDA Programming Guide's table (16
for compute capability 9.0).

    python3 experiments/f64_mma_rates.py      # one GPU, ~20 s
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "f64_mma_rates"

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// one product of each shape: a[16][16], b[16][8] (row-major, only the
// shape's part read), d[16][8]
template <int M, int K>
__device__ void frag_mma(const double* a, const double* b, double* d);

template <>
__device__ void frag_mma<8, 4>(const double* a, const double* b, double* d) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  double d0 = 0, d1 = 0;
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(d0), "+d"(d1) : "d"(a[g * 16 + t]), "d"(b[t * 8 + g]));
  d[g * 8 + 2 * t] = d0;
  d[g * 8 + 2 * t + 1] = d1;
}

#define D4 "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])

template <>
__device__ void frag_mma<16, 4>(const double* a, const double* b, double* dd) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  double d[4] = {0, 0, 0, 0};
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
               : D4 : "d"(a[g * 16 + t]), "d"(a[(g + 8) * 16 + t]), "d"(b[t * 8 + g]));
  for (int e = 0; e < 4; ++e) dd[(g + 8 * (e >> 1)) * 8 + 2 * t + (e & 1)] = d[e];
}

template <>
__device__ void frag_mma<16, 8>(const double* a, const double* b, double* dd) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  double d[4] = {0, 0, 0, 0};
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : D4
               : "d"(a[g * 16 + t]), "d"(a[(g + 8) * 16 + t]), "d"(a[g * 16 + t + 4]),
                 "d"(a[(g + 8) * 16 + t + 4]), "d"(b[t * 8 + g]), "d"(b[(t + 4) * 8 + g]));
  for (int e = 0; e < 4; ++e) dd[(g + 8 * (e >> 1)) * 8 + 2 * t + (e & 1)] = d[e];
}

template <>
__device__ void frag_mma<16, 16>(const double* a, const double* b, double* dd) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  double d[4] = {0, 0, 0, 0};
  double av[8], bv[4];
  for (int q = 0; q < 8; ++q) av[q] = a[(g + 8 * (q & 1)) * 16 + t + 4 * (q >> 1)];
  for (int q = 0; q < 4; ++q) bv[q] = b[(t + 4 * q) * 8 + g];
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
               "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
               : D4
               : "d"(av[0]), "d"(av[1]), "d"(av[2]), "d"(av[3]), "d"(av[4]), "d"(av[5]),
                 "d"(av[6]), "d"(av[7]), "d"(bv[0]), "d"(bv[1]), "d"(bv[2]), "d"(bv[3]));
  for (int e = 0; e < 4; ++e) dd[(g + 8 * (e >> 1)) * 8 + 2 * t + (e & 1)] = d[e];
}

template <int M, int K>
__global__ void check_kernel(const double* a, const double* b, double* d) { frag_mma<M, K>(a, b, d); }

// throughput: four independent accumulators a warp, operands in registers
template <int M, int K>
__device__ __forceinline__ void step(double (&d)[4][4], const double* av, const double* bv);

template <>
__device__ __forceinline__ void step<8, 4>(double (&d)[4][4], const double* av, const double* bv) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
                 : "+d"(d[c][0]), "+d"(d[c][1]) : "d"(av[c]), "d"(bv[c]));
}
template <>
__device__ __forceinline__ void step<16, 4>(double (&d)[4][4], const double* av, const double* bv) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                 : "+d"(d[c][0]), "+d"(d[c][1]), "+d"(d[c][2]), "+d"(d[c][3])
                 : "d"(av[c]), "d"(av[c + 1]), "d"(bv[c]));
}
template <>
__device__ __forceinline__ void step<16, 8>(double (&d)[4][4], const double* av, const double* bv) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+d"(d[c][0]), "+d"(d[c][1]), "+d"(d[c][2]), "+d"(d[c][3])
                 : "d"(av[c]), "d"(av[c + 1]), "d"(av[c + 2]), "d"(av[c + 3]), "d"(bv[c]),
                   "d"(bv[c + 1]));
}
template <>
__device__ __forceinline__ void step<16, 16>(double (&d)[4][4], const double* av, const double* bv) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
                 "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
                 : "+d"(d[c][0]), "+d"(d[c][1]), "+d"(d[c][2]), "+d"(d[c][3])
                 : "d"(av[c]), "d"(av[c + 1]), "d"(av[c + 2]), "d"(av[c + 3]), "d"(av[c + 4]),
                   "d"(av[c + 5]), "d"(av[c + 6]), "d"(av[c + 7]), "d"(bv[c]), "d"(bv[c + 1]),
                   "d"(bv[c + 2]), "d"(bv[c + 3]));
}

template <int M, int K>
__global__ void rate_kernel(double* out, int iters, double seed) {
  double av[12], bv[8], d[4][4] = {};
  for (int q = 0; q < 12; ++q) av[q] = seed * (threadIdx.x + q);
  for (int q = 0; q < 8; ++q) bv[q] = seed / (threadIdx.x + q + 1);
  for (int it = 0; it < iters; ++it) step<M, K>(d, av, bv);
  double s = 0;
  for (int c = 0; c < 4; ++c)
    for (int e = 0; e < 4; ++e) s += d[c][e];
  if (s == 12345.0) out[threadIdx.x] = s;  // keeps the loop
}

// conversions a thread: 8 independent chains of float32 (or bf16) -> float64
template <bool kBf16>
__global__ void cvt_kernel(double* out, int iters, float seed) {
  float v[8];
  uint32_t acc[8] = {};
  for (int q = 0; q < 8; ++q) v[q] = seed * (threadIdx.x + q);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float f = v[q];
      if (kBf16) f = __uint_as_float(__float_as_uint(f) & 0xffff0000u);
      // every result is used (its high word folded into acc by one integer
      // op), so that no conversion is dead code; no float64 arithmetic on the
      // way, and the next input from the float32 pipe
      const double x = static_cast<double>(f);
      acc[q] ^= __double2hiint(x);
      v[q] = fmaf(v[q], 1.0001f, 1e-7f);
    }
  }
  uint32_t s = 0;
  for (int q = 0; q < 8; ++q) s += acc[q];
  if (s == 12345u) out[threadIdx.x] = s;
}

extern "C" int check(int m, int k, const double* a, const double* b, double* d) {
  if (m == 8) check_kernel<8, 4><<<1, 32>>>(a, b, d);
  else if (k == 4) check_kernel<16, 4><<<1, 32>>>(a, b, d);
  else if (k == 8) check_kernel<16, 8><<<1, 32>>>(a, b, d);
  else check_kernel<16, 16><<<1, 32>>>(a, b, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rate(int m, int k, double* out, int blocks, int warps, int iters) {
  const dim3 grid(blocks), block(32 * warps);
  if (m == 8) rate_kernel<8, 4><<<grid, block>>>(out, iters, 1e-3);
  else if (k == 4) rate_kernel<16, 4><<<grid, block>>>(out, iters, 1e-3);
  else if (k == 8) rate_kernel<16, 8><<<grid, block>>>(out, iters, 1e-3);
  else rate_kernel<16, 16><<<grid, block>>>(out, iters, 1e-3);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cvt(int bf16, double* out, int blocks, int warps, int iters) {
  if (bf16) cvt_kernel<true><<<blocks, 32 * warps>>>(out, iters, 1e-3f);
  else cvt_kernel<false><<<blocks, 32 * warps>>>(out, iters, 1e-3f);
  return static_cast<int>(cudaGetLastError());
}
"""

SHAPES = ((8, 4), (16, 4), (16, 8), (16, 16))   # (M, K); N = 8


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    BUILD.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD / "f64_mma_rates.cu", BUILD / "f64_mma_rates.so"
    src.write_text(SOURCE)
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    return ctypes.CDLL(str(lib))


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout
    return float(out.strip().splitlines()[0])


def timed(launch, reps: int = 5) -> tuple[float, float]:
    """Median ms of ``reps`` launches (after one warm-up), and the SM clock
    (MHz) read right after them."""
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), sm_clock_mhz()


def main() -> None:
    lib = build()
    ptr = ctypes.c_void_p
    lib.check.argtypes = [ctypes.c_int, ctypes.c_int, ptr, ptr, ptr]
    lib.rate.argtypes = [ctypes.c_int, ctypes.c_int, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.cvt.argtypes = [ctypes.c_int, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    out = {"card": card, "sms": sms, "mma": {}, "cvt": {}}
    sink = torch.zeros(1024, dtype=torch.float64, device="cuda")
    for m, k in SHAPES:
        a = rng.normal(size=(16, 16))
        b = rng.normal(size=(16, 8))
        ta, tb = (torch.from_numpy(v).cuda() for v in (a, b))
        td = torch.zeros(16, 8, dtype=torch.float64, device="cuda")
        if lib.check(m, k, ta.data_ptr(), tb.data_ptr(), td.data_ptr()):
            raise RuntimeError(f"check m{m}k{k} failed to launch")
        want = a[:m, :k] @ b[:k, :]
        err = float(np.abs(td.cpu().numpy()[:m] - want).max())
        rows = {}
        for warps in (4, 8, 16):
            iters = 4096
            blocks = 4 * sms
            if lib.rate(m, k, sink.data_ptr(), blocks, warps, 1):
                rows[f"{warps}_warps_a_block"] = "launch refused"
                continue
            ms, mhz = timed(lambda: lib.rate(m, k, sink.data_ptr(), blocks, warps, iters))
            flop = 2.0 * m * 8 * k * 4 * iters * warps * blocks
            rows[f"{warps}_warps_a_block"] = {
                "ms": ms, "tflops": flop / ms / 1e9, "sm_mhz": mhz,
                "flop_per_cycle_per_sm": flop / (ms * 1e-3) / (mhz * 1e6) / sms}
        out["mma"][f"m{m}n8k{k}"] = {"layout_max_abs_err": err, **rows}
    for bf16 in (0, 1):
        iters, warps, blocks = 4096, 16, 4 * sms
        ms, mhz = timed(lambda: lib.cvt(bf16, sink.data_ptr(), blocks, warps, iters))
        n = 8.0 * iters * 32 * warps * blocks
        out["cvt"]["bf16" if bf16 else "float32"] = {
            "ms": ms, "sm_mhz": mhz, "per_cycle_per_sm": n / (ms * 1e-3) / (mhz * 1e6) / sms}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
