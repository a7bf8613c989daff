// bf16 tensor-core helpers shared by K2's forward (flash_attention.cu) and
// its backward (flash_attention_bwd.cu), beside the cp.async copies of
// cp_async.cuh: ldmatrix fragment loads, the mma.sync m16n8k16 bf16 product with
// float32 accumulators, ex2.approx and bf16 packing.
//
// Fragment layouts of mma.sync m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major), 4 registers of two bf16: {row g, cols 2t..2t+1},
//     {row g + 8, cols 2t..}, {row g, cols 2t + 8..}, {row g + 8, cols 2t + 8..};
//   B (16 x 8), 2 registers: {k rows 2t..2t+1, col g}, {k rows 2t + 8.., col g};
//   C/D (16 x 8), 4 floats: {row g, cols 2t, 2t + 1}, {row g + 8, cols 2t, 2t + 1}.
// So the accumulators of two neighbouring 8-column tiles, rounded to bf16
// and packed in pairs, are the A operand of one k step of 16.
//
// Rows in shared memory are padded by 16 bytes (tc_pitch), which makes every
// ldmatrix (8 rows of 16 bytes) free of bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;

template <int HD>
__host__ __device__ constexpr int tc_pitch() { return HD + 8; }  // bf16 elements per smem row: +16 bytes

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b for one m16n8k16 tile: bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, flushing results below float32's normal range to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16 in one register, the first in the low half;
// lo_r and hi_r get the rounded values
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float& lo_r, float& hi_r) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  lo_r = __low2float(v);
  hi_r = __high2float(v);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [r0, r0 + ROWS) of a (S, HD) bf16 slice with row stride `stride`
// elements into dst (row pitch tc_pitch<HD>()), by cp.async; rows at or past
// S are zero-filled.
template <int HD, int ROWS>
__device__ __forceinline__ void tc_load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                             int64_t stride, int r0, int S) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks in a row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kTcThreads) {
    const int r = c / kChunks, d0 = (c % kChunks) * 8;
    const bool valid = r0 + r < S;
    cp_async16(dst + r * tc_pitch<HD>() + d0, src + (valid ? (r0 + r) * stride + d0 : 0), valid);
  }
}

}  // namespace
