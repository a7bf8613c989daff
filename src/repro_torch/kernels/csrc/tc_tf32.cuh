// TF32 tensor-core helpers shared by K3's forward (ssd_scan.cu) and its
// backward (ssd_scan_bwd.cu), beside the cp.async copies of cp_async.cuh:
// the 3xTF32 split, the mma.sync m16n8k8 TF32 product with float32
// accumulators, and the zero-padded staging of a row-major tile.
//
// Fragment layouts of mma.sync m16n8k8 .tf32 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row major), 4 registers: {row g, col t}, {row g + 8, col t},
//     {row g, col t + 4}, {row g + 8, col t + 4};
//   B (8 x 8), 2 registers: {k row t, col g}, {k row t + 4, col g};
//   C/D (16 x 8), 4 floats: {row g, cols 2t, 2t + 1}, {row g + 8, cols 2t, 2t + 1}.
// The order of k within one product does not matter, so an accumulator
// tile is the A operand of one k step when k's slot t is taken as column 2t
// and slot t + 4 as column 2t + 1, and the B operand's rows follow the same
// order.
//
// 3xTF32: an operand a is split once into a_hi = tf32(a) and
// a_lo = tf32(a - a_hi), and a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, which
// keeps float32 accuracy (one TF32 product of rounded operands is 1e-3 off
// in relative terms). A bf16 value is exact in TF32 and is not split.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

__host__ __device__ __forceinline__ int round_up(int n, int m) { return (n + m - 1) / m * m; }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo, each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b for one m16n8k8 tile: TF32 inputs, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b in the 3xTF32 split
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], uint32_t bhi0,
                                           uint32_t bhi1, uint32_t blo0, uint32_t blo1) {
  mma_tf32(d, alo, bhi0, bhi1);
  mma_tf32(d, ahi, blo0, blo1);
  mma_tf32(d, ahi, bhi0, bhi1);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// dst[r][c] = src[r * stride + c] for r < rows, c < cols, and 0 elsewhere in
// [0, rows_pad) x [0, cols_pad), row pitch `pitch`, by the block's THREADS
// threads; by 16-byte cp.async when `vec` (cols and stride multiples of 16
// bytes, src aligned), else by plain loads.
template <int THREADS, typename T>
__device__ __forceinline__ void stage(T* dst, int pitch, const T* src, int64_t stride,
                                      int rows, int cols, int rows_pad, int cols_pad,
                                      bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    const int chunks = cols_pad / kVec;
    for (int c = threadIdx.x; c < rows_pad * chunks; c += THREADS) {
      const int r = c / chunks, e = (c % chunks) * kVec;
      const bool valid = r < rows && e < cols;
      cp_async16(dst + r * pitch + e, src + (valid ? r * stride + e : 0), valid);
    }
  } else {
    for (int c = threadIdx.x; c < rows_pad * cols_pad; c += THREADS) {
      const int r = c / cols_pad, e = c % cols_pad;
      dst[r * pitch + e] = r < rows && e < cols ? src[r * stride + e] : T(0.0f);
    }
  }
}

}  // namespace
