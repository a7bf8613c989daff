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
// bfloat16: `flash_attention_bf16_kernel`, warp-specialised, with TMA tile
// loads and wgmma products (the helpers are in hopper.cuh, which the
// backward shares).
//   * A block owns 64 NC q rows of one (b, h): NC = 3 consumer warpgroups up
//     to hd 64, 2 above, each 64 rows, plus one producer warpgroup. Tensor
//     maps over the (B, S, heads, hd) layouts (4-D, swizzled, built by the
//     host function below with cuTensorMapEncodeTiled, which comes from the
//     driver through cudaGetDriverEntryPointByVersion: no -lcuda) let one
//     thread of the producer load Q once and keep a ring of 3 K/V stages of
//     128 keys (64 at hd 192) in flight on mbarriers (full: the bytes have
//     landed; empty: every consumer warp is done with the stage). A query
//     head's K/V tile is the kv-head coordinate h / (H/KV) of the map, and
//     TMA's zero fill past S and Sk replaces the cp.async zero fill. The
//     producer gives its registers to the consumers (setmaxnreg: 24 and 240
//     with two consumers, 24 and 160 with three).
//   * S = Q K^T is wgmma m64nBNk16 with Q's and K's tiles as K-major A and
//     B operands in shared memory. Float32
//     accumulators; a bf16 x bf16 product is exact in float32, so the scores
//     equal the reference's float32 scores up to summation order. The online
//     softmax works on the accumulator fragments (row max and row sum by
//     quad shuffles, scale folded into the exponent: p = 2^(s scale log2 e -
//     m'), ex2.approx.ftz; the mask runs only on the diagonal tile and the
//     ragged last tile). P is rounded to bf16 in registers and is the
//     register A operand of O += P V, with V's tile as a transposed B; l sums
//     the rounded P, so numerator and denominator use the same weights. (On
//     the TPU the float32 dot_general of p and v runs as one bf16 pass of the
//     MXU at default precision, which rounds p the same way.)
//   * Two consumers pipeline: tile t's S and tile t - 1's P V go to the
//     tensor cores together, and tile t's softmax runs while P V does (P of
//     two tiles in registers), and they take turns to issue (ping-pong on
//     named barriers). Three consumers take one tile at a time and overlap
//     each other.
//   * The output tile is staged through the warpgroup's rows of the Q tile
//     (swizzled) and stored by TMA, which clips rows past S.
//   * Causal: k tiles wholly above the diagonal are never loaded, a
//     warpgroup skips a tile that lies wholly above its rows, and q tiles are
//     handed out heaviest first. Any S and Sk (the TPU kernel asserts that S
//     divides into its blocks). hd 16, 32, 64, 128, 192 (nemotron-4-340b's
//     18,432 over 96 heads).
//   * Shared memory: 121 KB a block at hd 64, 225 KB at hd 128, 193 KB at
//     hd 192; one block an SM. Registers: see chip_smoke.py's
//     {"resource_usage": ...} line (ptxas reports the launch count, 168 or
//     128; the consumers run with 240 or 160).
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

#include "hopper.cuh"

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
// bfloat16: a TMA producer warp and two wgmma consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct FwdTiles {
  // consumer warpgroups of 64 q rows each: three up to hd 64, where 160
  // registers a thread hold a warpgroup's state; else two, with 240
  static constexpr int NC = HD <= 64 ? 3 : 2;
  static constexpr int BQ = 64 * NC;                  // q rows of a block
  static constexpr int THREADS = kWgThreads * (NC + 1);  // and the producer's warpgroup
  static constexpr int CONSUMER_REGS = NC == 3 ? 160 : 240;
  // two consumers overlap a tile's softmax with their own products (P of
  // two tiles in registers); three have no registers for that and overlap
  // each other's
  static constexpr bool PIPE = NC == 2;
  static constexpr int BN = HD > 128 ? 64 : 128;      // keys of a k tile
  static constexpr int STAGES = 3;                    // K/V stages in flight
  static constexpr int Q_ELEMS = BQ * HD;
  static constexpr int KV_ELEMS = BN * HD;
  static constexpr int BARRIERS = 1 + 3 * STAGES;
  // 1 KB of slack to align the tiles to 1024 bytes, then Q, the K and V
  // stages and the barriers
  static constexpr int BYTES = 1024 + 2 * (Q_ELEMS + 2 * STAGES * KV_ELEMS) + 8 * BARRIERS;
};

template <int HD>
__global__ void __launch_bounds__(FwdTiles<HD>::THREADS, 1) flash_attention_bf16_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
    float* __restrict__ lse, int S, int Sk, int H, int KV, float scale_log2, bool causal) {
  using T = Tile<HD>;
  using F = FwdTiles<HD>;
  constexpr int BN = F::BN, ST = F::STAGES, BQ = F::BQ;
  extern __shared__ uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(align_smem(smem_raw));  // [NP][BQ][PC]
  bf16* ks = qs + F::Q_ELEMS;                                  // [ST][NP][BN][PC]
  bf16* vs = ks + ST * F::KV_ELEMS;                            // [ST][NP][BN][PC]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + ST * F::KV_ELEMS);
  uint64_t* k_full = q_full + 1;   // [ST]
  uint64_t* v_full = k_full + ST;  // [ST]
  uint64_t* empty = v_full + ST;   // [ST]

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  int n_kt = (Sk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BN + 1);  // skip tiles above the diagonal
  const int wg = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    prefetch_map(&tq);
    prefetch_map(&tk);
    prefetch_map(&tv);
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 4 * F::NC);  // one arrival from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the K/V ring full
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(q_full, F::Q_ELEMS * 2);
      for (int p = 0; p < T::NP; ++p)
        for (int r = 0; r < BQ; r += 64)
          tma_load(qs + (p * BQ + r) * T::PC, &tq, q_full, p * T::PC, h, q0 + r, b);
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % ST;
        mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        bf16* kst = ks + s * F::KV_ELEMS;
        bf16* vst = vs + s * F::KV_ELEMS;
        mbar_arrive_tx(&k_full[s], F::KV_ELEMS * 2);
        for (int p = 0; p < T::NP; ++p)
          for (int r = 0; r < BN; r += 64)
            tma_load(kst + (p * BN + r) * T::PC, &tk, &k_full[s], p * T::PC, kvh, it * BN + r, b);
        mbar_arrive_tx(&v_full[s], F::KV_ELEMS * 2);
        for (int p = 0; p < T::NP; ++p)
          for (int r = 0; r < BN; r += 64)
            tma_load(vst + (p * BN + r) * T::PC, &tv, &v_full[s], p * T::PC, kvh, it * BN + r, b);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows q0 + 64 cw .. q0 + 64 cw + 63
  regs_inc<F::CONSUMER_REGS>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * cw + 16 * warp;  // the warp's first row
  const int wg_last = q0 + 64 * cw + 63;      // the warpgroup's last row
  const bf16* qw = qs + 64 * cw * T::PC;

  float o[HD / 2];  // output accumulator: rows g and g + 8 of the warp
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
  float l[2] = {0.0f, 0.0f};        // this lane's part of the row sums
  float sc[BN / 2];                 // S of the tile in hand
  uint32_t pa[BN / 16][4], pb[BN / 16][4];  // P of two tiles: one in P V, one being formed
  // tiles that hold a key at or below one of the warpgroup's rows; the rest
  // (causal, hd 192's 64-key tiles) lie wholly above them
  const int n_my = causal ? min(n_kt, wg_last / BN + 1) : n_kt;

  // Ping-pong: the two warpgroups take turns to issue their products, so
  // that one's softmax runs while the other's products do. Warpgroup cw
  // waits at named barrier 4 + cw for its turn and hands it over at the
  // other's (1 + cw is its epilogue's). Only two, and where both walk the
  // same tiles: 128-key tiles.
  constexpr bool kPingPong = F::NC == 2 && BN == BQ;
  auto my_turn = [&]() __attribute__((always_inline)) {
    if constexpr (kPingPong) named_sync(4 + cw, 2 * kWgThreads);
  };
  auto your_turn = [&](bool last) __attribute__((always_inline)) {
    // warpgroup 0 takes the first turn, so warpgroup 1's last hand-over
    // would find no turn left to start
    if constexpr (kPingPong)
      if (!(last && cw == 1)) named_arrive(5 - cw, 2 * kWgThreads);
  };

  // the warpgroup's stage of tile `it` is done with
  auto release = [&](int it) __attribute__((always_inline)) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % ST]);
  };
  // S = Q K^T of tile it, on its own wgmma group
  auto issue_s = [&](int it) __attribute__((always_inline)) {
    const bf16* kst = ks + (it % ST) * F::KV_ELEMS;
    mbar_wait(&k_full[it % ST], (it / ST) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::kSteps; ++kk)
      wgmma_ss<BN>(sc, desc_k<HD>(qw, BQ, kk), desc_k<HD>(kst, BN, kk), kk > 0);
    wgmma_commit();
  };
  // O += P V of tile it
  auto issue_pv = [&](int it, const uint32_t (&p)[BN / 16][4]) __attribute__((always_inline)) {
    const bf16* vst = vs + (it % ST) * F::KV_ELEMS;
    mbar_wait(&v_full[it % ST], (it / ST) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<HD>(o, p[kk], desc_mn<HD>(vst, BN, kk), 1);
    wgmma_commit();
  };
  // the online softmax of tile it on sc: the new row max, P in bf16 into p
  // (the register A operand of O += P V), l scaled and summing the rounded
  // P; returns the factors by which O is still to be scaled
  auto softmax = [&](int it, uint32_t (&p)[BN / 16][4], float (&alpha)[2]) __attribute__((always_inline)) {
    const int k0 = it * BN;
    // mask; sc[4j + e] is row g + 8 (e >> 1), key 8j + 2t + (e & 1). The
    // scale is applied in the exponent (scale > 0 keeps the max where it is).
    if (k0 + BN > Sk || (causal && k0 + BN - 1 > row0)) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const int qpos = row0 + g + 8 * (e >> 1);
          if (kpos >= Sk || (causal && kpos > qpos)) sc[4 * j + e] = kNegInf;
        }
    }
    // row max over the lane's entries in 4 independent chains, then over the quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx[4] = {m[r], m[r], m[r], m[r]};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mx[j % 4] = fmaxf(mx[j % 4], fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      float mr = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
      alpha[r] = exp2_ftz((m[r] - mr) * scale_log2);
      m[r] = mr;
    }
    const float m0 = m[0] * scale_log2, m1 = m[1] * scale_log2;
    float ls[2][4] = {};  // the tile's sums of the rounded P, 4 chains a row
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // key chunks 2 kk and 2 kk + 1
        const float* sj = sc + 4 * (2 * kk + half);
        const int c = (2 * kk + half) % 4;
        float r0, r1;
        p[kk][2 * half] = pack_bf16(exp2_ftz(fmaf(sj[0], scale_log2, -m0)),
                                    exp2_ftz(fmaf(sj[1], scale_log2, -m0)), r0, r1);
        ls[0][c] += r0 + r1;
        p[kk][2 * half + 1] = pack_bf16(exp2_ftz(fmaf(sj[2], scale_log2, -m1)),
                                        exp2_ftz(fmaf(sj[3], scale_log2, -m1)), r0, r1);
        ls[1][c] += r0 + r1;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = fmaf(l[r], alpha[r], (ls[r][0] + ls[r][1]) + (ls[r][2] + ls[r][3]));
  };
  auto rescale = [&](const float (&alpha)[2]) __attribute__((always_inline)) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
  };
  mbar_wait(q_full, 0);
  if constexpr (!F::PIPE) {
    // one tile at a time: S, softmax, O scaled, O += P V
    for (int it = 0; it < n_my; ++it) {
      issue_s(it);
      wgmma_wait<0>();
      fence_regs(sc);
      float alpha[2];
      softmax(it, pa, alpha);
      rescale(alpha);
      fence_regs(o);
      issue_pv(it, pa);
      wgmma_wait<0>();
      fence_regs(o);
      release(it);
    }
  } else {
    // Tile it's S and tile it - 1's P V go to the tensor cores together,
    // and tile it's softmax runs while P V does: P of two tiles in registers,
    // pa and pb by turns (the loop runs two tiles a pass, so that the
    // registers alternate without copies). One step is one turn.
    auto step = [&](int it, uint32_t (&p_prev)[BN / 16][4],
                    uint32_t (&p)[BN / 16][4]) __attribute__((always_inline)) {
      my_turn();
      issue_s(it);
      issue_pv(it - 1, p_prev);
      your_turn(false);
      wgmma_wait<1>();  // S of tile it
      fence_regs(sc);
      float alpha[2];
      softmax(it, p, alpha);
      fence_regs(p);  // the exponentials run here, beside P V, not after the wait
      fence_regs(l);
      wgmma_wait<0>();  // P V of tile it - 1
      fence_regs(o);
      release(it - 1);
      rescale(alpha);
    };
    if constexpr (kPingPong)
      if (cw == 1) named_arrive(4, 2 * kWgThreads);  // warpgroup 0 goes first
    my_turn();
    issue_s(0);
    your_turn(false);
    wgmma_wait<0>();
    fence_regs(sc);
    float alpha[2];
    softmax(0, pa, alpha);  // O is 0: nothing to scale
    int it = 1;
    for (; it + 1 < n_my; it += 2) {
      step(it, pa, pb);
      step(it + 1, pb, pa);
    }
    if (it < n_my) {
      step(it, pa, pb);
      my_turn();
      issue_pv(it, pb);
    } else {
      my_turn();
      issue_pv(it - 1, pa);
    }
    your_turn(true);
    wgmma_wait<0>();
    fence_regs(o);
    release(n_my - 1);
  }
  for (int skip = n_my; skip < n_kt; ++skip) {  // tiles above the rows: wait, then hand back
    mbar_wait(&k_full[skip % ST], (skip / ST) & 1);
    release(skip);
  }

  // o = acc / l, staged through the warpgroup's own rows of the Q tile and
  // stored by TMA (rows past S are not written); the log-sum-exp
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float denom = fmaxf(l[r], 1e-30f);
    const int row = row0 + g + 8 * r;
    // m holds raw scores and l sums 2^((s - m) scale log2 e), so the
    // natural log-sum-exp of the scaled logits is (m scale log2 e + log2 l) ln 2
    if (lse != nullptr && t == 0 && row < S)
      lse[(static_cast<int64_t>(b) * H + h) * S + row] =
          (m[r] * scale_log2 + log2f(denom)) * 0.6931471805599453f;
    inv[r] = 1.0f / denom;
  }
  stage_tile<HD>(qs, BQ, 64 * cw, o, inv[0], inv[1]);
  fence_proxy_async();
  named_sync(1 + cw, kWgThreads);
  if (tid == 0) {
    for (int p = 0; p < T::NP; ++p)
      tma_store(&to, qs + (p * BQ + 64 * cw) * T::PC, p * T::PC, h, q0 + 64 * cw, b);
    tma_store_wait();
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
  CUtensorMap tq, tk, tv, to;
  int err = make_map<HD>(&tq, q, B, S, H);
  if (err == 0) err = make_map<HD>(&tk, k, B, Sk, KV);
  if (err == 0) err = make_map<HD>(&tv, v, B, Sk, KV);
  if (err == 0) err = make_map<HD>(&to, o, B, S, H);
  if (err != 0) return err;
  constexpr int bytes = FwdTiles<HD>::BYTES;
  auto kernel = flash_attention_bf16_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int BQ = FwdTiles<HD>::BQ;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  kernel<<<grid, FwdTiles<HD>::THREADS, bytes, stream>>>(tq, tk, tv, to, lse, S, Sk, H, KV,
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
