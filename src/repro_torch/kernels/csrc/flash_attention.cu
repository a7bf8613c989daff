// K2 on Hopper: causal GQA self-attention, or non-causal GQA self- or
// cross-attention, with an online softmax (flash attention), forward. Its
// backward, which recomputes the probabilities from the log-sum-exp this
// kernel can write, is flash_attention_bwd.cu.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py,
// `flash_attention` and its `_kernel`. The plain PyTorch version of the same
// function is `flash_attention_plain` in
// src/repro_torch/kernels/flash_attention.py.
//
// For q (B,S,H,hd) and k, v (B,Sk,KV,hd), contiguous, float32 or bfloat16:
// o[b,i,h] = sum_j softmax_j(s_ij) v[b,j,h/(H/KV)] with
// s_ij = (q[b,i,h] . k[b,j,h/(H/KV)]) * hd^-0.5, and s_ij = -1e30 where key j
// is masked (j > i when causal, and j >= Sk). The keys have a length of
// their own, Sk >= 1, for cross-attention: an encoder-decoder's decoder
// reads Sk encoder frames, with S = 1 at decode. Causal attention needs
// Sk == S, which the wrapper checks (the reference aligns a causal mask at
// the top left, a case no model asks for). The running max m, the running
// sum l and the accumulator are float32; o = acc / max(l, 1e-30), rounded to
// q's dtype. Where the caller passes an lse buffer (training), each row's
// log-sum-exp of the scaled logits, lse[b,h,i] = m + log(l) in float32, goes
// to it, (B,H,S); serving passes null and the kernels do what they did
// without it.
//
// Bound: operations. At the serving path's prefill (B 8, S 2048, H = KV = 32,
// hd 64, causal, bf16) the work is 4*B*H*S*S*hd/2 = 1.37e11 FLOP against
// 268 MB of inputs and output: 512 FLOP a byte, above the card's bf16 ridge
// of 295, so the tensor cores, not the memory, bound it (0.139 ms at 989
// TFLOP/s). Cross-attention does 4*B*H*S*Sk*hd: at the seamless prefill's
// (8, 2048 q, 512 k, 16, 16, 64) 3.44e10 FLOP against 84 MB, 0.035 ms.
//
// The dtype selects one of two kernels; nothing falls back from one to the
// other.
//
// bfloat16: `flash_attention_bf16_kernel`, on the tensor cores.
//   * One block of 4 warps owns a q tile of one (b, h); each warp owns 32 q
//     rows (two 16-row m tiles) at hd <= 64 and 16 at hd 128 and 192, and
//     keeps their m, l and float32 output accumulator in registers for the
//     whole k loop (the TPU kernel carries them in VMEM across a sequential
//     k-grid axis), and their Q fragments too up to hd 128; at hd 192 (96
//     accumulators) each k step reads Q's fragments from the Q tile in
//     shared memory. With two m tiles, each K or V fragment read from shared
//     memory feeds two mma.
//   * S = Q K^T runs as mma.sync m16n8k16 bf16 with float32 accumulation:
//     a bf16 x bf16 product is exact in float32, so the scores equal the
//     reference's float32 scores up to summation order. Scale and mask are
//     applied to the accumulators.
//   * The online softmax works on the accumulator fragments: row max and
//     row sum by shuffles within a quad (the 4 lanes that hold one row). The
//     softmax's arithmetic, not the tensor cores, holds the kernel back, so
//     the scale is folded into the exponent: p = 2^(s * scale * log2 e - m'),
//     one FFMA and one ex2.approx.ftz an entry; the mask runs only on the
//     diagonal tile and the ragged last tile.
//   * P is rounded to bf16 in registers and used as the A operand of the
//     P V mma as it stands: the m16n8 accumulator layout of two key tiles is
//     the A layout of one m16n8k16 step. l sums the rounded P, so numerator
//     and denominator use the same weights. (On the TPU the float32
//     dot_general of p and v runs as one bf16 pass of the MXU at default
//     precision, which rounds p the same way.)
//   * K and V tiles of 64 keys arrive by cp.async in a two-stage ring in
//     shared memory: tile t+1 is copied while tile t is multiplied. Rows are
//     padded by 16 bytes, which makes every ldmatrix (8 rows of 16 bytes)
//     free of bank conflicts; V's B fragments come through ldmatrix.trans.
//     These helpers are in tc_bf16.cuh, which the backward shares.
//   * The output tile is staged through the Q tile's shared memory and
//     written with 16-byte stores.
//   * Causal: k tiles wholly above the diagonal are never loaded, a warp
//     skips a tile that lies wholly above its own rows, and q tiles are
//     handed out heaviest first. GQA reads the kv head of each query head in place. Any
//     S and Sk: rows past S and keys past Sk are zero-filled by cp.async and
//     masked (the TPU kernel asserts that S divides into its blocks). hd 16,
//     32, 64, 128, 192 (nemotron-4-340b's 18,432 over 96 heads; 128 KB of
//     shared memory a block at hd 192).
//   * Registers (CUDA 12.8 nvcc -O3 for sm_90a, as chip_smoke.py prints
//     them): 246 at hd 64 (two blocks of 4 warps an SM), 178 at hd 128, 180
//     at hd 192 (one block an SM), 186 at hd 32, 151 at hd 16; no spills.
//
// float32: `flash_attention_f32_kernel`, on CUDA cores. The float32 contract
// is 1e-4, which no bf16 or TF32 product meets; only the smoke model's
// card-against-CPU check calls it. One block of 4 warps per 64-row q tile;
// each lane holds 2 keys of a 64-key tile for the scores and hd/32 output
// columns; K and V tiles are staged in shared memory (K rows padded by one
// float) and read by all four warps; numerics follow the Pallas kernel step
// for step (a tile's probabilities multiply v in float32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;      // q rows per warp
constexpr int kBQ = kWarps * kRows;  // q rows per block
constexpr int kBK = 64;        // keys per tile, 2 per lane
constexpr float kNegInf = -1e30f;


template <int HD>
constexpr int smem_floats() {
  return kBQ * HD + kBK * (HD + 1) + kBK * HD + kWarps * kRows * kBK;
}

// Rows [r0, r0 + rows) of a (S, HD) slice with row stride `stride` elements
// into dst (row pitch `pitch`); rows at or past S are 0.
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const float* src,
                                          int64_t stride, int r0, int rows, int S) {
  constexpr int kVec = 4;  // floats in one 16-byte load
  constexpr int kChunks = HD / kVec;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, d0 = (c % kChunks) * kVec;
    float* out = dst + r * pitch + d0;
    if (r0 + r < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + d0);
      const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) out[i] = e[i];
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) out[i] = 0.0f;
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int S, int Sk, int H, int KV, float scale,
    bool causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kKPitch = HD + 1;
  constexpr int kCols = (HD + 31) / 32;  // output columns per lane (lanes >= HD idle at 16)
  float* qs = smem;                   // [kBQ][HD]
  float* ks = qs + kBQ * HD;          // [kBK][HD + 1]
  float* vs = ks + kBK * kKPitch;     // [kBK][HD]
  float* ps = vs + kBK * HD;          // [kWarps][kRows][kBK]

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kBQ;
  const int row0 = q0 + warp * kRows;
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const float* qb = q + (static_cast<int64_t>(b) * S * H + h) * HD;
  const float* kb = k + (static_cast<int64_t>(b) * Sk * KV + kvh) * HD;
  const float* vb = v + (static_cast<int64_t>(b) * Sk * KV + kvh) * HD;

  load_rows<HD>(qs, HD, qb, q_stride, q0, kBQ, S);

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  int n_kt = (Sk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);  // skip tiles above the diagonal
  const float* qw = qs + warp * kRows * HD;
  float* pw = ps + warp * kRows * kBK;
  const float* k_lo = ks + lane * kKPitch;
  const float* k_hi = ks + (lane + 32) * kKPitch;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed (and q is loaded)
    load_rows<HD>(ks, kKPitch, kb, kv_stride, k0, kBK, Sk);
    load_rows<HD>(vs, HD, vb, kv_stride, k0, kBK, Sk);
    __syncthreads();

    // scores of the warp's 16 rows against keys k0 + lane and k0 + lane + 32
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float ka[4], kc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = k_lo[d + i];
        kc[i] = k_hi[d + i];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * HD + d);
        s[r][0] = fmaf(qv.x, ka[0], s[r][0]);
        s[r][0] = fmaf(qv.y, ka[1], s[r][0]);
        s[r][0] = fmaf(qv.z, ka[2], s[r][0]);
        s[r][0] = fmaf(qv.w, ka[3], s[r][0]);
        s[r][1] = fmaf(qv.x, kc[0], s[r][1]);
        s[r][1] = fmaf(qv.y, kc[1], s[r][1]);
        s[r][1] = fmaf(qv.z, kc[2], s[r][1]);
        s[r][1] = fmaf(qv.w, kc[3], s[r][1]);
      }
    }

    // online softmax, row by row; every lane keeps every row's m and l
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = row0 + r;
      float p[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        const bool keep = kpos < Sk && (!causal || kpos <= qpos);
        p[c] = keep ? s[r][c] * scale : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(p[0], p[1])));
      p[0] = expf(p[0] - m_new);
      p[1] = expf(p[1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p[0] + p[1]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      pw[r * kBK + lane] = p[0];
      pw[r * kBK + lane + 32] = p[1];
    }
    __syncwarp();

    // acc[r][c] += sum_j p[r][j] v[j][lane + 32 c]
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float vv[4][kCols];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          vv[jj][c] = lane + 32 * c < HD ? vs[(j + jj) * HD + lane + 32 * c] : 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(pw + r * kBK + j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc[r][c] = fmaf(pv.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(pv.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(pv.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(pv.w, vv[3][c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = row0 + r;
    if (qpos < S) {
      float* out = o + ((static_cast<int64_t>(b) * S + qpos) * H + h) * HD;
      const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (lane + 32 * c < HD) out[lane + 32 * c] = acc[r][c] / denom;
      if (lse != nullptr && lane == 0)
        lse[(static_cast<int64_t>(b) * H + h) * S + qpos] = m[r] + logf(denom);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async K/V ring
// ---------------------------------------------------------------------------

constexpr int kTcBK = 64;              // keys per k tile
constexpr float kLog2e = 1.4426950408889634f;

// 16-row m tiles a warp owns: two where the registers allow it (each K and V
// fragment read from shared memory then feeds two mma), one at hd 128
template <int HD>
__host__ __device__ constexpr int tc_mtiles() { return HD <= 64 ? 2 : 1; }
template <int HD>
__host__ __device__ constexpr int tc_bq() { return kTcWarps * 16 * tc_mtiles<HD>(); }

template <int HD>
constexpr int tc_smem_bytes() {  // the Q tile and two stages of K and V
  return (tc_bq<HD>() + 4 * kTcBK) * tc_pitch<HD>() * 2;
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads) flash_attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int S, int Sk, int H, int KV, float scale_log2, bool causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = tc_pitch<HD>();
  constexpr int MT = tc_mtiles<HD>();  // 16-row m tiles of the warp
  constexpr int BQ = tc_bq<HD>();      // q rows of the block
  constexpr int WR = 16 * MT;          // q rows of the warp
  constexpr int kSteps = HD / 16;      // k steps of Q K^T, and pairs of 8-column tiles of P V
  constexpr int kNT = kTcBK / 8;       // 8-key tiles of S
  constexpr int kDT = HD / 8;          // 8-column tiles of the output
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][P]
  __nv_bfloat16* ks = qs + BQ * P;                                   // [2][kTcBK][P]
  __nv_bfloat16* vs = ks + 2 * kTcBK * P;                            // [2][kTcBK][P]

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row and column pair
  const int q0 = qt * BQ;
  const int row0 = q0 + warp * WR;
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const __nv_bfloat16* qb = q + (static_cast<int64_t>(b) * S * H + h) * HD;
  const __nv_bfloat16* kb = k + (static_cast<int64_t>(b) * Sk * KV + kvh) * HD;
  const __nv_bfloat16* vb = v + (static_cast<int64_t>(b) * Sk * KV + kvh) * HD;

  int n_kt = (Sk + kTcBK - 1) / kTcBK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / kTcBK + 1);  // skip tiles above the diagonal

  tc_load_rows<HD, BQ>(qs, qb, q_stride, q0, S);
  tc_load_rows<HD, kTcBK>(ks, kb, kv_stride, 0, Sk);
  tc_load_rows<HD, kTcBK>(vs, vb, kv_stride, 0, Sk);
  cp_async_commit();

  // the warp's Q fragments, WR rows x HD, held in registers up to hd 128; at
  // hd 192 they would take 48 registers beside 96 accumulators, so each k
  // step reads them from the Q tile in shared memory instead
  constexpr bool kQInRegs = HD <= 128;
  uint32_t qa[MT][kQInRegs ? kSteps : 1][4];
  float acc[MT][kDT][4];        // output accumulators: rows g and g + 8 of each m tile
  float m[MT][2], l[MT][2];     // running max of the raw scores; this lane's part of the row sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.0f;
#pragma unroll
    for (int n = 0; n < kDT; ++n) acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.0f;
  }

  // ldmatrix addresses: lane supplies row (lane % 8) of matrix lane / 8
  const int lm_r = lane % 8, lm_m = lane / 8;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_kt) {  // copy tile kt + 1 while tile kt is multiplied
      const int nxt = (kt + 1) & 1;
      tc_load_rows<HD, kTcBK>(ks + nxt * kTcBK * P, kb, kv_stride, (kt + 1) * kTcBK, Sk);
      tc_load_rows<HD, kTcBK>(vs + nxt * kTcBK * P, vb, kv_stride, (kt + 1) * kTcBK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQInRegs) {
      if (kt == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk)
            ldmatrix_x4(qa[mt][kk], qs + (warp * WR + 16 * mt + lm_r + 8 * (lm_m % 2)) * P +
                                        16 * kk + 8 * (lm_m / 2));
      }
    }
    const int k0 = kt * kTcBK;
    if (causal && k0 > row0 + WR - 1) {  // every key of the tile lies above the warp's rows
      __syncthreads();
      continue;
    }
    const __nv_bfloat16* kst = ks + stage * kTcBK * P;
    const __nv_bfloat16* vst = vs + stage * kTcBK * P;

    // s = Q K^T for the warp's rows and the tile's 64 keys
    float s[MT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if constexpr (!kQInRegs) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(qa[mt][0], qs + (warp * WR + 16 * mt + lm_r + 8 * (lm_m % 2)) * P +
                                     16 * kk + 8 * (lm_m / 2));
      }
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        uint32_t kf[4];  // B fragments of key tiles 2 jp and 2 jp + 1
        ldmatrix_x4(kf, kst + (16 * jp + lm_r + 8 * (lm_m / 2)) * P + 16 * kk + 8 * (lm_m % 2));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * jp], qa[mt][kQInRegs ? kk : 0], kf[0], kf[1]);
          mma_bf16(s[mt][2 * jp + 1], qa[mt][kQInRegs ? kk : 0], kf[2], kf[3]);
        }
      }
    }

    // mask; s[.][j][0..1] are row g, s[.][j][2..3] row g + 8. The scale is
    // applied in the exponent (scale > 0 keeps the max where it is).
    if (k0 + kTcBK > Sk || (causal && k0 + kTcBK - 1 > row0)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = row0 + 16 * mt + g + 8 * (e >> 1);
            if (kpos >= Sk || (causal && kpos > qpos)) s[mt][j][e] = kNegInf;
          }
    }

    // online softmax on the fragments: row max over the quad
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[mt][r];
#pragma unroll
        for (int j = 0; j < kNT; ++j) mx = fmaxf(mx, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2_ftz((m[mt][r] - mx) * scale_log2);
        m[mt][r] = mx;
        l[mt][r] *= alpha;
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          acc[mt][n][2 * r] *= alpha;
          acc[mt][n][2 * r + 1] *= alpha;
        }
      }
    }

    // P in bf16 as the A operand of P V, 16 keys a step; l sums the rounded P
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      // A = {row g keys 0-7, row g+8 keys 0-7, row g keys 8-15, row g+8 keys 8-15}
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float m0 = m[mt][0] * scale_log2, m1 = m[mt][1] * scale_log2;
        float r0, r1;
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // key tiles 2 kk and 2 kk + 1
          const float* sj = s[mt][2 * kk + half];
          pa[mt][2 * half] = pack_bf16(exp2_ftz(fmaf(sj[0], scale_log2, -m0)),
                                       exp2_ftz(fmaf(sj[1], scale_log2, -m0)), r0, r1);
          l[mt][0] += r0 + r1;
          pa[mt][2 * half + 1] = pack_bf16(exp2_ftz(fmaf(sj[2], scale_log2, -m1)),
                                           exp2_ftz(fmaf(sj[3], scale_log2, -m1)), r0, r1);
          l[mt][1] += r0 + r1;
        }
      }
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        uint32_t vf[4];  // B fragments of output tiles 2 dp and 2 dp + 1
        ldmatrix_x4_trans(vf, vst + (16 * kk + lm_r + 8 * (lm_m % 2)) * P + 16 * dp + 8 * (lm_m / 2));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * dp], pa[mt], vf[0], vf[1]);
          mma_bf16(acc[mt][2 * dp + 1], pa[mt], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // the stage is consumed before the next copy into it
  }

  // o = acc / l, staged through the warp's own rows of the Q tile
  __nv_bfloat16* ow = qs + warp * WR * P;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
      const float denom = fmaxf(l[mt][r], 1e-30f);
      const int row = row0 + 16 * mt + g + 8 * r;
      // m holds raw scores and l sums 2^((s - m) scale log2 e), so the
      // natural log-sum-exp of the scaled logits is (m scale log2 e + log2 l) ln 2
      if (lse != nullptr && t == 0 && row < S)
        lse[(static_cast<int64_t>(b) * H + h) * S + row] =
            (m[mt][r] * scale_log2 + log2f(denom)) * 0.6931471805599453f;
      l[mt][r] = 1.0f / denom;
    }
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(ow + (16 * mt + g) * P + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[mt][n][0] * l[mt][0], acc[mt][n][1] * l[mt][0]);
      *reinterpret_cast<__nv_bfloat162*>(ow + (16 * mt + g + 8) * P + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[mt][n][2] * l[mt][1], acc[mt][n][3] * l[mt][1]);
    }
  }
  __syncwarp();
  constexpr int kChunks = HD / 8;
  for (int c = lane; c < WR * kChunks; c += 32) {
    const int r = c / kChunks, d0 = (c % kChunks) * 8;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(o + ((static_cast<int64_t>(b) * S + row0 + r) * H + h) * HD + d0) =
          *reinterpret_cast<const uint4*>(ow + r * P + d0);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               int S, int Sk, int H, int KV, bool causal, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<HD>() * sizeof(float);
  auto kernel = flash_attention_f32_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, Sk, H, KV,
      static_cast<float>(1.0 / sqrt(static_cast<double>(HD))),  // float(hd ** -0.5)
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                int S, int Sk, int H, int KV, bool causal, cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<HD>();
  auto kernel = flash_attention_bf16_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + tc_bq<HD>() - 1) / tc_bq<HD>(), H, B);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  kernel<<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, S, Sk, H, KV,
      scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
           int Sk, int H, int KV, bool causal, bool is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<HD>(q, k, v, o, lse, B, S, Sk, H, KV, causal, stream)
                 : launch_f32<HD>(q, k, v, o, lse, B, S, Sk, H, KV, causal, stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(). The wrapper has
// checked shapes, dtypes, contiguity and alignment; hd is 16, 32, 64, 128 or
// 192,
// Sk >= 1, and causal only where Sk == S.
// bfloat16 inputs run the tensor-core kernel, float32 inputs the CUDA-core
// kernel. `lse` is a float32 (B,H,S) buffer for each row's log-sum-exp, or
// null.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, void* lse, int B, int S, int Sk, int H,
                                      int KV, int hd, int causal, int is_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0, bf = is_bf16 != 0;
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, l, B, S, Sk, H, KV, c, bf, s);
    case 32: return launch<32>(q, k, v, o, l, B, S, Sk, H, KV, c, bf, s);
    case 64: return launch<64>(q, k, v, o, l, B, S, Sk, H, KV, c, bf, s);
    case 128: return launch<128>(q, k, v, o, l, B, S, Sk, H, KV, c, bf, s);
    case 192: return launch<192>(q, k, v, o, l, B, S, Sk, H, KV, c, bf, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
