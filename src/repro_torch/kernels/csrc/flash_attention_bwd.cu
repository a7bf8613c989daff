// K2's backward on Hopper: dQ, dK and dV of causal GQA self-attention, or
// of non-causal GQA attention with keys of their own length (an
// encoder-decoder's cross-attention), by recompute from the forward's
// log-sum-exp, with no atomics.
//
// The JAX package takes this gradient by differentiating `layers.attend`
// (src/repro/models/layers.py:188), which the Pallas TPU kernel of
// src/repro/kernels/flash_attention.py (`flash_attention` :77, pallas_call
// :91) computes forward; the Pallas kernel has no backward of its own. The
// plain PyTorch version is the autograd gradient of `flash_attention_plain`
// in src/repro_torch/kernels/flash_attention.py.
//
// For q, dO (B,S,H,hd), k, v (B,Sk,KV,hd), float32 or bfloat16, and the
// forward's lse (B,H,S) float32, with query head h reading kv head
// h / (H/KV), s_ij = q_i . k_j * hd^-0.5 (masked: j > i when causal, and
// j >= Sk), P_ij = exp(s_ij - lse_i), dP_ij = dO_i . v_j, D_i = sum_j P_ij dP_ij,
// dS_ij = P_ij (dP_ij - D_i):
//   dQ_i = hd^-0.5 sum_j dS_ij k_j,
//   dK_j = hd^-0.5 sum over the G query heads of kv head j's head and over i
//          of dS_ij q_i,
//   dV_j = sum likewise of P_ij dO_i.
// Gradients are rounded to the inputs' dtype once, at the end. Causal
// attention needs Sk == S, which the wrapper checks (the reference aligns a
// causal mask of Sk != S at the top left, and no model asks for it); K, V,
// dK and dV take Sk as their sequence length, Q, dO, dQ, the lse and the
// scratch S.
//
// D_i equals dO_i . o_i for the exact o; it is taken from the recomputed P
// and dP, not from the forward's output o, because in bf16 o is rounded: an
// error e in D_i moves dQ_i by -hd^-0.5 e sum_j P_ij k_j, which adds up over
// the keys where the true dQ_i is a small difference (measured on an H100:
// from the rounded o, dQ's worst row error against a float32 gradient was
// 4-8x the plain bf16 autograd gradient's; tests/test_torch_cuda.py). The
// forward's output is therefore not an input here.
//
// Bound: operations. At the training shape (B 4, S 2048, H 16, KV 8, hd
// 128, causal) the five products of the gradient take 10 B H hd S(S+1)/2 =
// 1.72e11 FLOP against 168 MB of inputs and outputs (0.174 ms at the bf16
// tensor cores' 989 TFLOP/s, 0.050 ms of bytes at 3.35 TB/s). Keys of their
// own length take 10 B H hd S Sk: at the seamless-m4t-medium training
// cross-attention (B 8, S 2048, Sk 512, H 16, KV 16, hd 64, non-causal)
// 8.59e10 FLOP against about 137 MB (0.087 ms of operations, 0.041 ms of
// bytes).
//
// The dtype selects the kernels; nothing falls back from one pair to the
// other.
//
// bfloat16: `attn_bwd_dq_bf16_kernel`, then `attn_bwd_dkdv_bf16_kernel`,
// each warp-specialised: one producer warpgroup keeps tiles in flight by
// TMA on mbarriers and hands its registers (setmaxnreg 24) to two consumer
// warpgroups of 64 rows (240 registers) that issue wgmma products with
// float32 accumulators (the helpers and the tile layout are in hopper.cuh,
// shared with the forward; tensor maps over the (B, S, heads, hd) layouts are
// built by the host function below, cuTensorMapEncodeTiled found through
// cudaGetDriverEntryPointByVersion, no -lcuda). They issue nine products
// where the gradient needs five (S and dP are formed three times), 3.1e11
// FLOP at the training shape, to need no atomics and no float32 dS in device
// memory; every sum runs in a fixed order, so two runs give the same bits.
//   * D/dQ: one block per (b, h, 128-row q tile), each consumer 64 rows. Q
//     and dO are loaded once; K and V tiles of 128 keys up to hd 64 (64
//     above) stream through a ring of 3 stages (2 at hd 192), which runs on
//     from the first walk over the key tiles into the second.
//       - S = Q K^T and dP = dO V^T with Q and dO as register A operands
//         (loaded once; from shared memory at hd 192) and K, V as K-major B.
//       - Walk 1 sums l = sum_j P and sum_j P dP with P from the forward's
//         lse. Then D = sum P dP / l and lse' = lse + ln l: P is renormalised
//         to sum to 1 in this kernel's own arithmetic, so sum_j dS_ij is 0 up
//         to rounding. (The forward's l sums P rounded to bf16; from its lse
//         alone the rows' sums miss 1 by up to a bf16 rounding, and dQ then
//         misses the bf16 row limit at small S:
//         tests/test_torch_kernel_numerics.py.)
//       - Walk 2 forms S and dP again, P from lse', dS = P (dP - D) rounded
//         to bf16 in registers, and uses dS as the register A operand of
//         dQ += dS K, K's tile a transposed B.
//     D and lse' go to the float32 scratch (2, B, H, S) for dK/dV.
//   * dK/dV: one block per (b, kv head, 128-key tile), each consumer 64
//     keys, whose dK and dV accumulators stay in registers for the whole walk
//     over the G query heads of the kv head and their 64-row q tiles. K and V
//     are loaded once; Q and dO stream through a ring of 3 stages (2 at hd
//     192) by TMA, lse' and D beside them, loaded by the producer warp's
//     lanes. S^T = K Q^T and dP^T = V dO^T take K and V as A and Q, dO as
//     K-major B from shared memory; P^T and dS^T, rounded to bf16, are the
//     register A operands of dV += P^T dO and dK += dS^T Q, with dO and Q as
//     transposed B. At hd 192, where dK and dV would take 192 accumulators a
//     thread, a block takes 64 keys and its consumers split the work: one
//     forms S^T and dV, the other S^T, dP^T and dK.
//   * The tile index is the grid's slowest axis, so the heaviest causal
//     tiles (the last q tiles for dQ, the first key tiles for dK/dV) start
//     first. D/dQ walks ceil(Sk / BN) key tiles (non-causal) and dK/dV has
//     ceil(Sk / 128) blocks a (b, kv head), each walking every q tile; a
//     consumer skips (waits for and hands back) a tile that lies wholly above
//     its rows or keys. Masked entries are selected to 0, on the diagonal and
//     ragged tiles only. TMA zero-fills rows past S and keys past Sk; the
//     outputs are staged through the consumer's own rows of Q (dQ) or K and V
//     (dK, dV), swizzled, and stored by TMA, which clips rows past S and keys
//     past Sk. hd 16, 32, 64, 128, 192.
//   * Registers: see chip_smoke.py's {"resource_usage": ...} line (ptxas
//     reports the launch count, 168; the consumers run with 240).
//
// float32: `attn_bwd_dq_f32_kernel`, then `attn_bwd_dkdv_f32_kernel`, on CUDA
// cores in float32 throughout (the float32 contract is 1e-4, which no bf16 or
// TF32 product meets; training runs in bf16):
//   * D/dQ: one block of 256 threads per (b, head, 64-row q tile) keeps Q,
//     dO and lse in shared memory and its two accumulators in registers
//     (thread (tr, tc) owns rows tr + 16a and columns tc + 16c), and walks
//     the k tiles at or below the diagonal (all ceil(Sk / 64), non-causal), heaviest q tiles first, forming
//     dQ_i = hd^-0.5 (sum_j P_ij dP_ij k_j - D_i sum_j P_ij k_j) in one pass;
//     it writes D to the scratch for dK/dV.
//   * dK/dV: one block of 256 threads per (b, kv head, 64-key tile) keeps
//     the tile's K and V and its dK and dV accumulators for the whole walk
//     over the G query heads of its kv head and the q tiles at or below the
//     diagonal; per q tile it stages Q, dO, lse and D, forms S and dP for the
//     64 x 64 tile, writes P and dS to shared memory, and accumulates P^T dO
//     and dS^T Q.
//   * Tiles are float32 in shared memory with odd row pitches (hd + 1, 65),
//     so sixteen rows read at one column fall in sixteen banks. At hd 192
//     the four tiles take 226 KB of shared memory a block, one block an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTile = 64;      // q rows of a q tile, keys of a k tile
constexpr int kPP = kTile + 1;  // pitch of the P and dS tiles

template <int HD>
__host__ __device__ constexpr int pitch() { return HD + 1; }

// Rows [r0, r0 + kTile) of a (S, HD) slice with row stride `stride` elements
// into dst (row pitch HD + 1); rows at or past S are 0.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t stride, int r0,
                                          int S) {
  for (int c = threadIdx.x; c < kTile * HD; c += kThreads) {
    const int r = c / HD, d = c % HD;
    dst[r * pitch<HD>() + d] = r0 + r < S ? src[(r0 + r) * stride + d] : 0.0f;
  }
}

// S = Q K^T and dP = dO V^T for the thread's rows tr + 16a and keys tc + 16c
template <int HD>
__device__ __forceinline__ void scores(float (&s)[4][4], float (&dp)[4][4], const float* qs,
                                       const float* dos, const float* ks, const float* vs,
                                       int tr, int tc) {
  constexpr int P = pitch<HD>();
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qv[a] = qs[(tr + 16 * a) * P + d];
      dov[a] = dos[(tr + 16 * a) * P + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kv[c] = ks[(tc + 16 * c) * P + d];
      vv[c] = vs[(tc + 16 * c) * P + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
        dp[a][c] = fmaf(dov[a], vv[c], dp[a][c]);
      }
  }
}

// s <- P = exp(s scale - lse), masked logits at -1e30, for the thread's rows
// (q0 + tr + 16a) and keys (k0 + tc + 16c); rows at or past S and keys at or
// past Sk are masked
__device__ __forceinline__ void probs(float (&s)[4][4], const float* ls, int q0, int k0,
                                      int tr, int tc, int S, int Sk, float scale,
                                      bool causal) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = tr + 16 * a, i = q0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + tc + 16 * c;
      const bool keep = i < S && j < Sk && (!causal || j <= i);
      s[a][c] = expf((keep ? s[a][c] * scale : kNegInf) - ls[r]);
    }
  }
}

// Rows [q0, q0 + kTile) of one (b, h)'s row statistic into shared memory; 0
// past S
__device__ __forceinline__ void load_rows_stat(float* dst, const float* src, int q0, int S) {
  if (threadIdx.x < kTile) {
    const int i = q0 + threadIdx.x;
    dst[threadIdx.x] = i < S ? src[i] : 0.0f;
  }
}

template <int HD>
constexpr int dkdv_f32_smem_bytes() { return (4 * kTile * pitch<HD>() + 2 * kTile * kPP + 2 * kTile) * 4; }
template <int HD>
constexpr int dq_f32_smem_bytes() { return (4 * kTile * pitch<HD>() + 2 * kTile * kPP + kTile) * 4; }

// dK and dV of one (b, kv head, 64-key tile)
template <int HD>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ D,
    float* __restrict__ dk, float* __restrict__ dv, int S, int Sk, int H, int KV, float scale,
    bool causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int P = pitch<HD>();
  constexpr int NC = HD / 16;  // output columns a thread owns
  float* ks = smem;            // [kTile][P]
  float* vs = ks + kTile * P;  // [kTile][P]
  float* qs = vs + kTile * P;  // [kTile][P]
  float* dos = qs + kTile * P;  // [kTile][P]
  float* ps = dos + kTile * P;  // [kTile][kPP]: P[i][j]
  float* dss = ps + kTile * kPP;  // [kTile][kPP]: dS[i][j]
  float* ls = dss + kTile * kPP;  // [kTile]
  float* Ds = ls + kTile;         // [kTile]

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile;
  const int G = H / KV;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const int64_t kv_off = (static_cast<int64_t>(b) * Sk * KV + kvh) * HD;
  load_tile<HD>(ks, k + kv_off, kv_stride, k0, Sk);
  load_tile<HD>(vs, v + kv_off, kv_stride, k0, Sk);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.0f;

  const int n_qt = (S + kTile - 1) / kTile;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t q_off = (static_cast<int64_t>(b) * S * H + h) * HD;
    const int64_t stat_off = (static_cast<int64_t>(b) * H + h) * S;
    // q tiles that hold a row at or below the diagonal of this key tile
    for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile is consumed (and K, V are loaded)
      load_tile<HD>(qs, q + q_off, q_stride, q0, S);
      load_tile<HD>(dos, dout + q_off, q_stride, q0, S);
      load_rows_stat(ls, lse + stat_off, q0, S);
      load_rows_stat(Ds, D + stat_off, q0, S);
      __syncthreads();

      float s[4][4], dp[4][4];
      scores<HD>(s, dp, qs, dos, ks, vs, tr, tc);
      probs(s, ls, q0, k0, tr, tc, S, Sk, scale, causal);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ps[(tr + 16 * a) * kPP + tc + 16 * c] = s[a][c];
          dss[(tr + 16 * a) * kPP + tc + 16 * c] = s[a][c] * (dp[a][c] - Ds[tr + 16 * a]);
        }
      __syncthreads();

      // dV[j] += sum_i P[i][j] dO[i], dK[j] += sum_i dS[i][j] Q[i] for the
      // thread's keys tr + 16a and columns tc + 16c
#pragma unroll 2
      for (int i = 0; i < kTile; ++i) {
        float pv[4], dsv[4], dov[NC], qv[NC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = ps[i * kPP + tr + 16 * a];
          dsv[a] = dss[i * kPP + tr + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dov[c] = dos[i * P + tc + 16 * c];
          qv[c] = qs[i * P + tc + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv_acc[a][c] = fmaf(pv[a], dov[c], dv_acc[a][c]);
            dk_acc[a][c] = fmaf(dsv[a], qv[c], dk_acc[a][c]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + tr + 16 * a;
    if (j >= Sk) continue;
    const int64_t off = kv_off + static_cast<int64_t>(j) * kv_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + tc + 16 * c] = dk_acc[a][c] * scale;
      dv[off + tc + 16 * c] = dv_acc[a][c];
    }
  }
}

// D and dQ of one (b, head, 64-row q tile)
template <int HD>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ D,
    float* __restrict__ dq, int S, int Sk, int H, int KV, float scale, bool causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int P = pitch<HD>();
  constexpr int NC = HD / 16;
  float* qs = smem;                 // [kTile][P]
  float* dos = qs + kTile * P;      // [kTile][P]
  float* ks = dos + kTile * P;      // [kTile][P]
  float* vs = ks + kTile * P;       // [kTile][P]
  float* ps = vs + kTile * P;       // [kTile][kPP]: P[i][j]
  float* pds = ps + kTile * kPP;    // [kTile][kPP]: P[i][j] dP[i][j]
  float* ls = pds + kTile * kPP;    // [kTile]

  const int n_qt = (S + kTile - 1) / kTile;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kTile;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const int64_t q_off = (static_cast<int64_t>(b) * S * H + h) * HD;
  const int64_t kv_off = (static_cast<int64_t>(b) * Sk * KV + kvh) * HD;
  const int64_t stat_off = (static_cast<int64_t>(b) * H + h) * S;
  load_tile<HD>(qs, q + q_off, q_stride, q0, S);
  load_tile<HD>(dos, dout + q_off, q_stride, q0, S);
  load_rows_stat(ls, lse + stat_off, q0, S);

  // sum_j P dP k_j and sum_j P k_j for the thread's rows tr + 16a and
  // columns tc + 16c; the thread's part of D for its rows
  float pdk[4][NC], pk[4][NC], d_part[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    d_part[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) pdk[a][c] = pk[a][c] = 0.0f;
  }

  // k tiles at or below the diagonal; every one of the Sk keys' tiles when
  // non-causal
  const int n_kt = causal ? qt + 1 : (Sk + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile is consumed (and Q, dO are loaded)
    load_tile<HD>(ks, k + kv_off, kv_stride, k0, Sk);
    load_tile<HD>(vs, v + kv_off, kv_stride, k0, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<HD>(s, dp, qs, dos, ks, vs, tr, tc);
    probs(s, ls, q0, k0, tr, tc, S, Sk, scale, causal);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pd = s[a][c] * dp[a][c];
        d_part[a] += pd;
        ps[(tr + 16 * a) * kPP + tc + 16 * c] = s[a][c];
        pds[(tr + 16 * a) * kPP + tc + 16 * c] = pd;
      }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float pv[4], pdv[4], kv[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pv[a] = ps[(tr + 16 * a) * kPP + j];
        pdv[a] = pds[(tr + 16 * a) * kPP + j];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = ks[j * P + tc + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          pdk[a][c] = fmaf(pdv[a], kv[c], pdk[a][c]);
          pk[a][c] = fmaf(pv[a], kv[c], pk[a][c]);
        }
    }
  }

  // D over the row's 16 threads (lanes of one half-warp), then dQ
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) d_part[a] += __shfl_xor_sync(0xffffffffu, d_part[a], o);
    const int i = q0 + tr + 16 * a;
    if (i >= S) continue;
    if (tc == 0) D[stat_off + i] = d_part[a];
    const int64_t off = q_off + static_cast<int64_t>(i) * q_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[off + tc + 16 * c] = (pdk[a][c] - d_part[a] * pk[a][c]) * scale;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: a TMA producer warp and two wgmma consumer warpgroups a block
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;             // one warpgroup
constexpr int kTcThreads = 3 * kWgThreads;  // the producer's warpgroup and two consumers

// D/dQ: 128 q rows a block (64 a consumer), K/V tiles of 128 keys up to hd
// 64 and of 64 above (S, dP and dQ's accumulators must fit 240 registers)
template <int HD>
struct DqTiles {
  static constexpr int BQ = 128;
  static constexpr int BN = HD <= 64 ? 128 : 64;
  static constexpr int STAGES = HD > 128 ? 2 : 3;
  static constexpr int Q_ELEMS = BQ * HD;
  static constexpr int KV_ELEMS = BN * HD;
  static constexpr int BARRIERS = 1 + 3 * STAGES;
  static constexpr int BYTES = 1024 + 2 * (2 * Q_ELEMS + 2 * STAGES * KV_ELEMS) + 8 * BARRIERS;
};

// dK/dV: 128 keys a block (64 a consumer), q tiles of 64 rows. At hd 192
// dK and dV together would take 192 accumulators a thread, so a block takes
// 64 keys and its two consumers split the work: one forms S^T and dV, the
// other S^T, dP^T and dK (SPLIT).
template <int HD>
struct DkvTiles {
  static constexpr bool SPLIT = HD > 128;
  static constexpr int BK = SPLIT ? 64 : 128;
  static constexpr int BQ = 64;
  static constexpr int STAGES = HD > 128 ? 2 : 3;
  static constexpr int KV_ELEMS = BK * HD;
  static constexpr int Q_ELEMS = BQ * HD;
  static constexpr int BARRIERS = 1 + 2 * STAGES;
  static constexpr int BYTES = 1024 + 2 * (2 * KV_ELEMS + 2 * STAGES * Q_ELEMS) +
                               4 * 2 * STAGES * BQ + 8 * BARRIERS;
};

// D, lse' and dQ of one (b, head, 128-row q tile); the tile index is
// blockIdx.z, heaviest causal tile first
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1) attn_bwd_dq_bf16_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,
    float* __restrict__ scratch, int B, int S, int Sk, int H, int KV, float scale, bool causal) {
  using T = Tile<HD>;
  using F = DqTiles<HD>;
  constexpr int BQ = F::BQ, BN = F::BN, ST = F::STAGES;
  extern __shared__ uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(align_smem(smem_raw));  // [NP][BQ][PC]
  bf16* dos = qs + F::Q_ELEMS;                                 // [NP][BQ][PC]
  bf16* ks = dos + F::Q_ELEMS;                                 // [ST][NP][BN][PC]
  bf16* vs = ks + ST * F::KV_ELEMS;                            // [ST][NP][BN][PC]
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(vs + ST * F::KV_ELEMS);
  uint64_t* k_full = qd_full + 1;  // [ST]
  uint64_t* v_full = k_full + ST;  // [ST]
  uint64_t* empty = v_full + ST;   // [ST]

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.z) : blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  // k tiles at or below the diagonal; every one of the Sk keys' tiles when
  // non-causal. The ring walks them twice.
  int n_kt = (Sk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BN + 1);
  const int wg = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    prefetch_map(&tk);
    prefetch_map(&tv);
    mbar_init(qd_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(qd_full, 2 * F::Q_ELEMS * 2);
      for (int p = 0; p < T::NP; ++p)
        for (int r = 0; r < BQ; r += 64) {
          tma_load(qs + (p * BQ + r) * T::PC, &tq, qd_full, p * T::PC, h, q0 + r, b);
          tma_load(dos + (p * BQ + r) * T::PC, &tdo, qd_full, p * T::PC, h, q0 + r, b);
        }
      for (int it = 0; it < 2 * n_kt; ++it) {
        const int s = it % ST;
        const int k0 = (it < n_kt ? it : it - n_kt) * BN;
        mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        bf16* kst = ks + s * F::KV_ELEMS;
        bf16* vst = vs + s * F::KV_ELEMS;
        mbar_arrive_tx(&k_full[s], F::KV_ELEMS * 2);
        for (int p = 0; p < T::NP; ++p)
          for (int r = 0; r < BN; r += 64)
            tma_load(kst + (p * BN + r) * T::PC, &tk, &k_full[s], p * T::PC, kvh, k0 + r, b);
        mbar_arrive_tx(&v_full[s], F::KV_ELEMS * 2);
        for (int p = 0; p < T::NP; ++p)
          for (int r = 0; r < BN; r += 64)
            tma_load(vst + (p * BN + r) * T::PC, &tv, &v_full[s], p * T::PC, kvh, k0 + r, b);
      }
    }
    return;
  }

  regs_inc<240>();
  const int cw = wg - 1;  // rows q0 + 64 cw ..
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * cw + 16 * warp;
  const int wg_last = q0 + 64 * cw + 63;
  const bf16* qw = qs + 64 * cw * T::PC;
  const bf16* dow = dos + 64 * cw * T::PC;
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * S;
  float* D_out = scratch + stat;
  float* lse2_out = scratch + static_cast<int64_t>(B) * H * S + stat;
  const float scale_log2 = scale * kLog2e;

  // the lane's rows g and g + 8: -(lse log2 e), then -(lse' log2 e)
  float ml[2], l[2] = {0.0f, 0.0f}, pd[2] = {0.0f, 0.0f}, Dr[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    ml[r] = row < S ? -lse[stat + row] * kLog2e : 0.0f;
  }
  float acc[HD / 2];  // dQ
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  float sc[BN / 2], dp[BN / 2];  // S and dP of the tile in hand
  // Q and dO as the register A operands of S and dP up to hd 128 (their B,
  // K and V, alone then come from shared memory: an m64n64k16 product with
  // both operands there reads shared memory as fast as it can deliver)
  constexpr bool kQRegs = HD <= 128;
  uint32_t qf[kQRegs ? T::kSteps : 1][4], dof[kQRegs ? T::kSteps : 1][4];

  // The ring holds walk 1's tiles (ring index kt), then walk 2's (n_kt +
  // kt). The warpgroup forms the n_my tiles of each walk that hold a key at
  // or below one of its rows; it waits for the others and hands them back.
  const int n_my = causal ? min(n_kt, wg_last / BN + 1) : n_kt;
  const int total = 2 * n_my;
  auto ring = [&](int i) __attribute__((always_inline)) { return i < n_my ? i : n_kt + i - n_my; };
  auto release = [&](int r) __attribute__((always_inline)) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[r % ST]);
  };
  int r_seen = -1;  // the last ring index issued or handed back
  // hands back the tiles before ring index r that the warpgroup skips
  auto skip_to = [&](int r) __attribute__((always_inline)) {
    for (int x = r_seen + 1; x < r; ++x) {
      mbar_wait(&k_full[x % ST], (x / ST) & 1);
      release(x);
    }
    r_seen = r;
  };
  // S = Q K^T and dP = dO V^T of ring tile r, for the warpgroup's 64 rows,
  // on a wgmma group each
  auto issue_sdp = [&](int r, float (&s_)[BN / 2], float (&d_)[BN / 2]) __attribute__((always_inline)) {
    const int st = r % ST;
    const uint32_t par = (r / ST) & 1;
    const bf16* kst = ks + st * F::KV_ELEMS;
    const bf16* vst = vs + st * F::KV_ELEMS;
    skip_to(r);
    mbar_wait(&k_full[st], par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::kSteps; ++kk) {
      if constexpr (kQRegs)
        wgmma_rs_k<BN>(s_, qf[kk], desc_k<HD>(kst, BN, kk), kk > 0);
      else
        wgmma_ss<BN>(s_, desc_k<HD>(qw, BQ, kk), desc_k<HD>(kst, BN, kk), kk > 0);
    }
    wgmma_commit();
    mbar_wait(&v_full[st], par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::kSteps; ++kk) {
      if constexpr (kQRegs)
        wgmma_rs_k<BN>(d_, dof[kk], desc_k<HD>(vst, BN, kk), kk > 0);
      else
        wgmma_ss<BN>(d_, desc_k<HD>(dow, BQ, kk), desc_k<HD>(vst, BN, kk), kk > 0);
    }
    wgmma_commit();
  };
  // tile i from its S and dP: walk 1 adds to the sums, walk 2 issues dQ += dS K
  auto process = [&](int i, float (&s_)[BN / 2], float (&d_)[BN / 2]) __attribute__((always_inline)) {
    const bool walk2 = i >= n_my;
    const int k0 = (walk2 ? i - n_my : i) * BN;
    if (i == n_my) {  // D and lse' from walk 1's sums, over the quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 1);
        pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 2);
        const int row = row0 + g + 8 * r;
        if (l[r] > 0.0f) {
          Dr[r] = pd[r] / l[r];
          ml[r] -= log2f(l[r]);
        }
        if (t == 0 && row < S) {
          D_out[row] = Dr[r];
          lse2_out[row] = -ml[r] * kLn2;
        }
      }
    }
    // P = 2^(s scale log2 e - lse log2 e); s_[4j + e] is row g + 8 (e >> 1),
    // key 8j + 2t + (e & 1). Masked entries are 0. dP is still on the
    // tensor cores meanwhile.
    const bool masked = k0 + BN > Sk || (causal && k0 + BN - 1 > row0);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(fmaf(s_[4 * j + e], scale_log2, ml[e >> 1]));
        if (masked) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const int qpos = row0 + g + 8 * (e >> 1);
          if (kpos >= Sk || (causal && kpos > qpos)) p = 0.0f;
        }
        s_[4 * j + e] = p;
      }
    fence_regs(s_);
    wgmma_wait<0>();  // dP
    fence_regs(d_);
    if (!walk2) {  // the sums in 4 independent chains a row
      float lc[2][4] = {}, pc[2][4] = {};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lc[e >> 1][j % 4] += s_[4 * j + e];
          pc[e >> 1][j % 4] = fmaf(s_[4 * j + e], d_[4 * j + e], pc[e >> 1][j % 4]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += (lc[r][0] + lc[r][1]) + (lc[r][2] + lc[r][3]);
        pd[r] += (pc[r][0] + pc[r][1]) + (pc[r][2] + pc[r][3]);
      }
      fence_regs(l);  // formed here, not sunk into the next tile's products
      fence_regs(pd);
    } else {
      // dS = P (dP - D) in bf16 as the register A operand of dQ += dS K
      uint32_t a[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // key chunks 2 kk and 2 kk + 1
          const float* sj = s_ + 4 * (2 * kk + half);
          const float* dj = d_ + 4 * (2 * kk + half);
          a[kk][2 * half] = pack_bf16(sj[0] * (dj[0] - Dr[0]), sj[1] * (dj[1] - Dr[0]));
          a[kk][2 * half + 1] = pack_bf16(sj[2] * (dj[2] - Dr[1]), sj[3] * (dj[3] - Dr[1]));
        }
      const bf16* kst = ks + (ring(i) % ST) * F::KV_ELEMS;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<HD>(acc, a[kk], desc_mn<HD>(kst, BN, kk), 1);
    }
    wgmma_commit();  // walk 1: an empty group
  };
  // tile by tile: hand back the last tile once its dQ is done, then S and
  // dP of this one, then its walk's work
  mbar_wait(qd_full, 0);
  if constexpr (kQRegs) {
    load_a<HD>(qs, BQ, 64 * cw, qf);
    load_a<HD>(dos, BQ, 64 * cw, dof);
  }
  for (int i = 0; i < total; ++i) {
    wgmma_wait<0>();
    fence_regs(acc);
    if (i > 0) release(ring(i - 1));
    issue_sdp(ring(i), sc, dp);
    wgmma_wait<1>();  // S
    fence_regs(sc);
    process(i, sc, dp);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release(ring(total - 1));
  skip_to(2 * n_kt);

  // dQ = scale acc, staged through the warpgroup's own rows of the Q tile
  stage_tile<HD>(qs, BQ, 64 * cw, acc, scale, scale);
  fence_proxy_async();
  named_sync(1 + cw, kWgThreads);
  if (tid == 0) {
    for (int p = 0; p < T::NP; ++p)
      tma_store(&tdq, qs + (p * BQ + 64 * cw) * T::PC, p * T::PC, h, q0 + 64 * cw, b);
    tma_store_wait();
  }
}

// dK and dV of one (b, kv head, key tile); the tile index is blockIdx.z,
// heaviest causal tile first
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1) attn_bwd_dkdv_bf16_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
    const float* __restrict__ scratch, int B, int S, int Sk, int H, int KV, float scale,
    bool causal) {
  using T = Tile<HD>;
  using F = DkvTiles<HD>;
  constexpr int BK = F::BK, BQ = F::BQ, ST = F::STAGES;
  constexpr bool SPLIT = F::SPLIT;
  extern __shared__ uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(align_smem(smem_raw));  // [NP][BK][PC]
  bf16* vs = ks + F::KV_ELEMS;                                 // [NP][BK][PC]
  bf16* qs = vs + F::KV_ELEMS;                                 // [ST][NP][BQ][PC]
  bf16* dos = qs + ST * F::Q_ELEMS;                            // [ST][NP][BQ][PC]
  float* ls = reinterpret_cast<float*>(dos + ST * F::Q_ELEMS);  // [ST][BQ]: -(lse' log2 e)
  float* Ds = ls + ST * BQ;                                     // [ST][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Ds + ST * BQ);
  uint64_t* full = kv_full + 1;  // [ST]
  uint64_t* empty = full + ST;   // [ST]

  const int kvh = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int G = H / KV;
  const int k0 = kt * BK;
  const float* D_in = scratch;
  const float* lse2_in = scratch + static_cast<int64_t>(B) * H * S;
  // the walk: it = g nq + (qt - qt0) over the G query heads and the q tiles
  // that hold a row at or below the diagonal of this key tile (every q
  // tile, non-causal)
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  const int nq = n_qt - qt0;
  const int n_it = G * nq;
  const int wg = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    prefetch_map(&tq);
    prefetch_map(&tdo);
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer warp: Q and dO by TMA, lse' and D by its lanes
    regs_dec<24>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 32) {
      if (lane == 0) {
        mbar_arrive_tx(kv_full, 2 * F::KV_ELEMS * 2);
        for (int p = 0; p < T::NP; ++p)
          for (int r = 0; r < BK; r += 64) {
            tma_load(ks + (p * BK + r) * T::PC, &tk, kv_full, p * T::PC, kvh, k0 + r, b);
            tma_load(vs + (p * BK + r) * T::PC, &tv, kv_full, p * T::PC, kvh, k0 + r, b);
          }
      }
      int h = kvh * G, qt = qt0;  // ring tile it's head and q tile
      for (int it = 0; it < n_it; ++it) {
        const int s = it % ST;
        const int i0 = qt * BQ;
        mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        const int64_t stat = (static_cast<int64_t>(b) * H + h) * S;
        for (int r = lane; r < BQ; r += 32) {
          const int i = i0 + r;
          ls[s * BQ + r] = i < S ? -lse2_in[stat + i] * kLog2e : 0.0f;
          Ds[s * BQ + r] = i < S ? D_in[stat + i] : 0.0f;
        }
        if (lane == 0) {
          mbar_arrive_tx(&full[s], 2 * F::Q_ELEMS * 2);
          for (int p = 0; p < T::NP; ++p) {
            tma_load(qs + s * F::Q_ELEMS + p * BQ * T::PC, &tq, &full[s], p * T::PC, h, i0, b);
            tma_load(dos + s * F::Q_ELEMS + p * BQ * T::PC, &tdo, &full[s], p * T::PC, h, i0, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
        if (++qt == n_qt) {
          qt = qt0;
          ++h;
        }
      }
    }
    return;
  }

  regs_inc<240>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the warpgroup's keys: its own 64 (both of SPLIT's warpgroups the block's 64)
  const int kw = SPLIT ? k0 : k0 + 64 * cw;
  const int kwarp = kw + 16 * warp;  // the warp's first key
  const bf16* kwp = ks + (kw - k0) * T::PC;
  const bf16* vwp = vs + (kw - k0) * T::PC;
  // SPLIT: warpgroup 0 forms dV, warpgroup 1 dK
  const bool want_dv = !SPLIT || cw == 0;
  const bool want_dk = !SPLIT || cw == 1;
  const float scale_log2 = scale * kLog2e;

  float acc_v[HD / 2];                 // dV (SPLIT: dV or dK)
  float acc_k[SPLIT ? 1 : HD / 2];     // dK
  // dK's accumulator: acc_k, or SPLIT's dK warpgroup's acc_v
  auto& acc_dk = [&]() __attribute__((always_inline)) -> float (&)[HD / 2] {
    if constexpr (SPLIT)
      return acc_v;
    else
      return acc_k;
  }();
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_v[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (SPLIT ? 1 : HD / 2); ++i) acc_k[i] = 0.0f;
  mbar_wait(kv_full, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % ST;
    const uint32_t par = (it / ST) & 1;
    const int i0 = (qt0 + it % nq) * BQ;
    mbar_wait(&full[s], par);
    // a warpgroup whose keys all lie above every row of the tile has nothing to add
    if (!(causal && i0 + BQ - 1 < kw)) {
      const bf16* qst = qs + s * F::Q_ELEMS;
      const bf16* dost = dos + s * F::Q_ELEMS;
      const float* lst = ls + s * BQ;
      const float* dst = Ds + s * BQ;

      // S^T = K Q^T and dP^T = V dO^T for the warpgroup's 64 keys and the
      // tile's rows, on a wgmma group each
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kSteps; ++kk)
        wgmma_ss<BQ>(st, desc_k<HD>(kwp, BK, kk), desc_k<HD>(qst, BQ, kk), kk > 0);
      wgmma_commit();
      if (want_dk) {
#pragma unroll
        for (int kk = 0; kk < T::kSteps; ++kk)
          wgmma_ss<BQ>(dpt, desc_k<HD>(vwp, BK, kk), desc_k<HD>(dost, BQ, kk), kk > 0);
      }
      wgmma_commit();  // SPLIT's dV warpgroup: an empty group
      wgmma_wait<1>();  // S^T
      fence_regs(st);

      // P^T: st[4j + e] is key kwarp + g + 8 (e >> 1), row i0 + 8j + 2t + (e & 1)
      const bool masked = i0 + BQ > S || (causal && i0 < kwarp + 15);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 lj = *reinterpret_cast<const float2*>(lst + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_ftz(fmaf(st[4 * j + e], scale_log2, (e & 1) ? lj.y : lj.x));
          if (masked) {
            const int qpos = i0 + 8 * j + 2 * t + (e & 1);
            const int kpos = kwarp + g + 8 * (e >> 1);
            if (qpos >= S || (causal && kpos > qpos)) p = 0.0f;
          }
          st[4 * j + e] = p;
        }
      }
      // dV += P^T dO, 16 rows a k step, P^T in bf16, while dP^T finishes
      uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // row chunks 2 kk and 2 kk + 1
          const float* pj = st + 4 * (2 * kk + half);
          pa[kk][2 * half] = pack_bf16(pj[0], pj[1]);
          pa[kk][2 * half + 1] = pack_bf16(pj[2], pj[3]);
        }
      fence_regs(acc_v);
      wgmma_fence();
      if (want_dv) {
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<HD>(acc_v, pa[kk], desc_mn<HD>(dost, BQ, kk), 1);
      }
      wgmma_commit();
      if (want_dk) {
        wgmma_wait<1>();  // dP^T
        fence_regs(dpt);
        // dS^T = P^T (dP^T - D), in bf16; dK += dS^T Q
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 dj = *reinterpret_cast<const float2*>(dst + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dj.y : dj.x));
        }
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float* sj = dpt + 4 * (2 * kk + half);
            sa[kk][2 * half] = pack_bf16(sj[0], sj[1]);
            sa[kk][2 * half + 1] = pack_bf16(sj[2], sj[3]);
          }
        fence_regs(acc_dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<HD>(acc_dk, sa[kk], desc_mn<HD>(qst, BQ, kk), 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // dK = scale acc_k and dV = acc_v, staged through the warpgroup's rows of
  // K and V and stored by TMA (keys past Sk are not written). SPLIT's two
  // warpgroups read both tiles until both are done.
  if constexpr (SPLIT) {
    named_sync(1, 2 * kWgThreads);
    bf16* tile = want_dv ? vs : ks;
    stage_tile<HD>(tile, BK, 0, acc_v, want_dv ? 1.0f : scale, want_dv ? 1.0f : scale);
    fence_proxy_async();
    named_sync(2 + cw, kWgThreads);
    if (tid == 0) {
      for (int p = 0; p < T::NP; ++p)
        tma_store(want_dv ? &tdv : &tdk, tile + p * BK * T::PC, p * T::PC, kvh, k0, b);
      tma_store_wait();
    }
  } else {
    stage_tile<HD>(ks, BK, 64 * cw, acc_k, scale, scale);
    stage_tile<HD>(vs, BK, 64 * cw, acc_v, 1.0f, 1.0f);
    fence_proxy_async();
    named_sync(1 + cw, kWgThreads);
    if (tid == 0) {
      for (int p = 0; p < T::NP; ++p) {
        tma_store(&tdk, ks + (p * BK + 64 * cw) * T::PC, p * T::PC, kvh, kw, b);
        tma_store(&tdv, vs + (p * BK + 64 * cw) * T::PC, p * T::PC, kvh, kw, b);
      }
      tma_store_wait();
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               float* scratch, void* dq, void* dk, void* dv, int B, int S, int Sk, int H,
               int KV, bool causal, cudaStream_t stream) {
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));  // float(hd ** -0.5)
  const int n_qt = (S + kTile - 1) / kTile, n_kt = (Sk + kTile - 1) / kTile;

  auto dqk = attn_bwd_dq_f32_kernel<HD>;  // D, then dQ
  constexpr int dq_bytes = dq_f32_smem_bytes<HD>();
  cudaError_t err =
      cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<dim3(n_qt, H, B), kThreads, dq_bytes, stream>>>(q_, k_, v_, do_, lse, scratch,
                                                        static_cast<float*>(dq), S, Sk, H, KV,
                                                        scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dkdv = attn_bwd_dkdv_f32_kernel<HD>;  // with D
  constexpr int dkdv_bytes = dkdv_f32_smem_bytes<HD>();
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<dim3(n_kt, KV, B), kThreads, dkdv_bytes, stream>>>(
      q_, k_, v_, do_, lse, scratch, static_cast<float*>(dk), static_cast<float*>(dv), S, Sk, H,
      KV, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                float* scratch, void* dq, void* dk, void* dv, int B, int S, int Sk, int H,
                int KV, bool causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tdq, tdk, tdv;
  int err = make_map<HD>(&tq, q, B, S, H);
  if (err == 0) err = make_map<HD>(&tk, k, B, Sk, KV);
  if (err == 0) err = make_map<HD>(&tv, v, B, Sk, KV);
  if (err == 0) err = make_map<HD>(&tdo, dout, B, S, H);
  if (err == 0) err = make_map<HD>(&tdq, dq, B, S, H);
  if (err == 0) err = make_map<HD>(&tdk, dk, B, Sk, KV);
  if (err == 0) err = make_map<HD>(&tdv, dv, B, Sk, KV);
  if (err != 0) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));  // float(hd ** -0.5)

  auto dqk = attn_bwd_dq_bf16_kernel<HD>;  // D and lse', then dQ
  constexpr int dq_bytes = DqTiles<HD>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (S + DqTiles<HD>::BQ - 1) / DqTiles<HD>::BQ;
  dqk<<<dim3(H, B, n_qt), kTcThreads, dq_bytes, stream>>>(tq, tk, tv, tdo, tdq, lse, scratch, B,
                                                          S, Sk, H, KV, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  auto dkdv = attn_bwd_dkdv_bf16_kernel<HD>;  // with D and lse'
  constexpr int dkdv_bytes = DkvTiles<HD>::BYTES;
  e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_kt = (Sk + DkvTiles<HD>::BK - 1) / DkvTiles<HD>::BK;
  dkdv<<<dim3(KV, B, n_kt), kTcThreads, dkdv_bytes, stream>>>(tq, tk, tv, tdo, tdk, tdv, scratch,
                                                              B, S, Sk, H, KV, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           float* scratch, void* dq, void* dk, void* dv, int B, int S, int Sk, int H, int KV,
           bool causal, bool is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<HD>(q, k, v, dout, lse, scratch, dq, dk, dv, B, S, Sk, H, KV,
                                   causal, stream)
                 : launch_f32<HD>(q, k, v, dout, lse, scratch, dq, dk, dv, B, S, Sk, H, KV,
                                  causal, stream);
}

}  // namespace

// Launches the D/dQ kernel, then the dK/dV kernel, on `stream` and returns
// the first CUDA error, or 0. The wrapper has checked shapes, dtypes,
// contiguity and alignment; hd is 16, 32, 64, 128 or 192; Sk >= 1, and causal
// only where Sk == S; `scratch` is float32 (2, B, H, S): D, then (bf16 only)
// lse'; dq, dk, dv have the inputs' dtype and shapes, and every element of
// them is written.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, void* scratch,
                                          void* dq, void* dk, void* dv, int B, int S,
                                          int Sk, int H, int KV, int hd, int causal,
                                          int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0, bf = is_bf16 != 0;
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  switch (hd) {
    case 16: return launch<16>(q, k, v, dout, l, sc, dq, dk, dv, B, S, Sk, H, KV, c, bf, s);
    case 32: return launch<32>(q, k, v, dout, l, sc, dq, dk, dv, B, S, Sk, H, KV, c, bf, s);
    case 64: return launch<64>(q, k, v, dout, l, sc, dq, dk, dv, B, S, Sk, H, KV, c, bf, s);
    case 128: return launch<128>(q, k, v, dout, l, sc, dq, dk, dv, B, S, Sk, H, KV, c, bf, s);
    case 192: return launch<192>(q, k, v, dout, l, sc, dq, dk, dv, B, S, Sk, H, KV, c, bf, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
