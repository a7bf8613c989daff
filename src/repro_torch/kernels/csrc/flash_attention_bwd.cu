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
// bfloat16: `attn_bwd_dq_bf16_kernel`, then `attn_bwd_dkdv_bf16_kernel`, on
// the tensor cores (mma.sync m16n8k16, bf16 operands, float32 accumulators;
// the helpers are in tc_bf16.cuh). They issue nine products where the
// gradient needs five (S and dP are formed three times), 3.1e11 FLOP at the
// training shape, to need no atomics and no float32 dS in device memory.
//   * D/dQ: one block of 4 warps per (b, h, 64-row q tile), each warp 16
//     rows. Q and dO stay in shared memory; K and V tiles of 64 keys arrive
//     by cp.async in a two-stage ring, which runs on from the first walk
//     over the key tiles into the second.
//       - Walk 1 forms S = Q K^T and dP = dO V^T and sums l = sum_j P and
//         sum_j P dP with P from the forward's lse. Then D = sum P dP / l and
//         lse' = lse + ln l: P is renormalised to sum to 1 in this kernel's
//         own arithmetic, so sum_j dS_ij is 0 up to rounding. (The forward's
//         l sums P rounded to bf16; from its lse alone the rows' sums miss 1
//         by up to a bf16 rounding, and dQ then misses the bf16 row limit at
//         small S: tests/test_torch_kernel_numerics.py.)
//       - Walk 2 forms S and dP again, P from lse', dS = P (dP - D) rounded
//         to bf16 in registers, and uses dS as the A operand of dQ += dS K
//         as it stands (the accumulators of two 8-key tiles are one k step),
//         with K's B fragments through ldmatrix.trans.
//     D and lse' go to the float32 scratch (2, B, H, S) for dK/dV.
//   * dK/dV: one block of 4 warps per (b, kv head, 64-key tile), each warp
//     16 keys, whose dK and dV accumulators stay in registers for the whole
//     walk over the G query heads of the kv head and their q tiles (64 rows,
//     32 at hd 128 and 192 to keep the accumulators of S^T and dP^T small). K and V
//     stay in shared memory; Q, dO, lse' and D stream through a two-stage
//     cp.async ring. It forms S^T = K Q^T and dP^T = V dO^T, so P^T and
//     dS^T come out of the accumulators in the A layout of dV += P^T dO and
//     dK += dS^T Q, with dO and Q through ldmatrix.trans.
//   * The tile index is the grid's slowest axis, so the heaviest causal
//     tiles (the last q tiles for dQ, the first key tiles for dK/dV) start
//     first. D/dQ walks ceil(Sk / 64) key tiles (non-causal) and dK/dV has
//     ceil(Sk / 64) blocks a (b, kv head), each walking every q tile.
//     Masked entries are selected to 0, on the diagonal and ragged tiles
//     only. Rows past S and keys past Sk are zero-filled by cp.async; their
//     results are never stored. Outputs are staged through the warp's own
//     rows of shared memory into 16-byte stores. hd 16, 32, 64, 128, 192.
//   * hd 192 (nemotron-4-340b): dK and dV would take 192 accumulators a
//     thread, dQ 96 beside S and dP. So two blocks share each tile, each
//     owning half of the output's columns (col_split, the grid's x axis
//     doubled) and forming S and dP over the whole head dim for itself: 15
//     products where the gradient needs five (nine below hd 192). Only the
//     first half's block writes D and lse'.
//   * Registers (nvcc -O3 for sm_90a, as chip_smoke.py prints them): D/dQ
//     168 at hd 192 (8 bytes spilled), 240 at hd 128, 164 at hd 64, 128 at hd
//     32 and 16; dK/dV 218 at hd 192, 243 at hd 128, 229 at hd 64, 128 at hd
//     32 (4 bytes spilled), 87 at hd 16. Two blocks
//     of 4 warps fit an SM at hd 128.
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

#include "tc_bf16.cuh"

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
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async rings
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kBT = 64;  // q rows of a D/dQ block, keys of a dK/dV block and of a k tile

// q rows of a dK/dV q tile: 32 at hd 128 and 192 keeps S^T and dP^T at 16
// accumulators each beside the 128 (96 at hd 192, col_split) of dK and dV
template <int HD>
__host__ __device__ constexpr int dkdv_qrows() { return HD >= 128 ? 32 : 64; }

// blocks that share one tile's output columns: two at hd 192, each owning
// half of dQ's (or of dK's and dV's) columns and forming S and dP over the
// whole head dim for itself, so that its accumulators stay at the size of
// hd 96's
template <int HD>
__host__ __device__ constexpr int col_split() { return HD > 128 ? 2 : 1; }

template <int HD>
constexpr int dq_bf16_smem_bytes() {  // Q, dO, two stages of K and V
  return 6 * kBT * tc_pitch<HD>() * 2;
}
template <int HD>
constexpr int dkdv_bf16_smem_bytes() {  // K, V, two stages of Q and dO, of lse' and D
  return (2 * kBT + 4 * dkdv_qrows<HD>()) * tc_pitch<HD>() * 2 + 4 * dkdv_qrows<HD>() * 4;
}

// D, lse' and dQ of one (b, head, 64-row q tile); the tile index is
// blockIdx.z, heaviest causal tile first
template <int HD>
__global__ void __launch_bounds__(kTcThreads) attn_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ scratch,
    bf16* __restrict__ dq, int S, int Sk, int H, int KV, float scale, bool causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = tc_pitch<HD>();
  constexpr int NCOL = HD / col_split<HD>();  // dQ columns of the block
  constexpr int kSteps = HD / 16;  // k steps of Q K^T
  constexpr int kNT = kBT / 8;     // 8-key tiles of a k tile
  constexpr int kDT = NCOL / 8;    // 8-column tiles of the block's dQ
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kBT][P]
  bf16* dos = qs + kBT * P;                      // [kBT][P]
  bf16* ks = dos + kBT * P;                      // [2][kBT][P]
  bf16* vs = ks + 2 * kBT * P;                   // [2][kBT][P]

  const int n_qt = (S + kBT - 1) / kBT;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.z) : blockIdx.z;
  const int h = blockIdx.x / col_split<HD>(), b = blockIdx.y;
  const int c0 = (blockIdx.x % col_split<HD>()) * NCOL;  // the block's first dQ column
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * kBT;
  const int row0 = q0 + warp * 16;
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const bf16* qb = q + (static_cast<int64_t>(b) * S * H + h) * HD;
  const bf16* dob = dout + (static_cast<int64_t>(b) * S * H + h) * HD;
  const bf16* kb = k + (static_cast<int64_t>(b) * Sk * KV + kvh) * HD;
  const bf16* vb = v + (static_cast<int64_t>(b) * Sk * KV + kvh) * HD;
  const int64_t stat = (static_cast<int64_t>(b) * H + h) * S;
  float* D_out = scratch + stat;
  float* lse2_out = scratch + static_cast<int64_t>(gridDim.y) * H * S + stat;
  const float scale_log2 = scale * kLog2e;

  // k tiles at or below the diagonal; every one of the Sk keys' tiles when
  // non-causal
  const int n_kt = causal ? qt + 1 : (Sk + kBT - 1) / kBT;
  tc_load_rows<HD, kBT>(qs, qb, q_stride, q0, S);
  tc_load_rows<HD, kBT>(dos, dob, q_stride, q0, S);
  tc_load_rows<HD, kBT>(ks, kb, kv_stride, 0, Sk);
  tc_load_rows<HD, kBT>(vs, vb, kv_stride, 0, Sk);
  cp_async_commit();

  // the lane's rows g and g + 8 of the warp: -(lse log2 e), then -(lse' log2 e)
  float ml[2], l[2] = {0.0f, 0.0f}, pd[2] = {0.0f, 0.0f}, Dr[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    ml[r] = row < S ? -lse[stat + row] * kLog2e : 0.0f;
  }
  float acc[kDT][4];  // dQ: rows g and g + 8, columns 8n + 2t, 8n + 2t + 1
#pragma unroll
  for (int n = 0; n < kDT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  // ldmatrix addresses: lane supplies row (lane % 8) of matrix lane / 8. A
  // fragments (and B fragments through .trans) take matrices in the order
  // (rows 0-7, cols 0-7), (rows 8-15, cols 0-7), (rows 0-7, cols 8-15), ...;
  // B fragments of an n-major tile (rows 0-7, cols 0-7), (rows 0-7, cols 8-15), ...
  const int lm_r = lane % 8, lm_m = lane / 8;
  const int a_off = (lm_r + 8 * (lm_m % 2)) * P + 8 * (lm_m / 2);
  const int b_off = (lm_r + 8 * (lm_m / 2)) * P + 8 * (lm_m % 2);
  const bf16* qw = qs + warp * 16 * P;
  const bf16* dow = dos + warp * 16 * P;

  // walk 1 over the k tiles (it < n_kt), then walk 2 (it >= n_kt)
  for (int it = 0; it < 2 * n_kt; ++it) {
    const int stage = it & 1;
    if (it + 1 < 2 * n_kt) {  // copy the next tile while this one is used
      const int nk = it + 1 < n_kt ? it + 1 : it + 1 - n_kt;
      const int nxt = (it + 1) & 1;
      tc_load_rows<HD, kBT>(ks + nxt * kBT * P, kb, kv_stride, nk * kBT, Sk);
      tc_load_rows<HD, kBT>(vs + nxt * kBT * P, vb, kv_stride, nk * kBT, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool walk2 = it >= n_kt;
    const int k0 = (walk2 ? it - n_kt : it) * kBT;
    if (it == n_kt) {  // D and lse' from walk 1's sums, over the quad
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
        if (c0 == 0 && t == 0 && row < S) {
          D_out[row] = Dr[r];
          lse2_out[row] = -ml[r] * kLn2;
        }
      }
    }
    const bf16* kst = ks + stage * kBT * P;
    const bf16* vst = vs + stage * kBT * P;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows and the tile's 64 keys
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, qw + a_off + 16 * kk);
      ldmatrix_x4(da, dow + a_off + 16 * kk);
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        uint32_t kf[4], vf[4];  // B fragments of key tiles 2 jp and 2 jp + 1
        ldmatrix_x4(kf, kst + 16 * jp * P + b_off + 16 * kk);
        ldmatrix_x4(vf, vst + 16 * jp * P + b_off + 16 * kk);
        mma_bf16(s[2 * jp], qa, kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[2 * jp], da, vf[0], vf[1]);
        mma_bf16(dp[2 * jp + 1], da, vf[2], vf[3]);
      }
    }

    // P = 2^(s scale log2 e - lse log2 e); s[.][0..1] are row g, s[.][2..3]
    // row g + 8. Masked entries are 0.
    const bool masked = k0 + kBT > Sk || (causal && k0 + kBT - 1 > row0);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(fmaf(s[j][e], scale_log2, ml[e >> 1]));
        if (masked) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const int qpos = row0 + g + 8 * (e >> 1);
          if (kpos >= Sk || (causal && kpos > qpos)) p = 0.0f;
        }
        s[j][e] = p;
      }

    if (!walk2) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          l[e >> 1] += s[j][e];
          pd[e >> 1] = fmaf(s[j][e], dp[j][e], pd[e >> 1]);
        }
    } else {
      // dS = P (dP - D) in bf16 as the A operand of dQ += dS K, 16 keys a step
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        uint32_t a[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // key tiles 2 kk and 2 kk + 1
          const float* sj = s[2 * kk + half];
          const float* dj = dp[2 * kk + half];
          a[2 * half] = pack_bf16(sj[0] * (dj[0] - Dr[0]), sj[1] * (dj[1] - Dr[0]));
          a[2 * half + 1] = pack_bf16(sj[2] * (dj[2] - Dr[1]), sj[3] * (dj[3] - Dr[1]));
        }
#pragma unroll
        for (int np = 0; np < kDT / 2; ++np) {
          uint32_t kf[4];  // B fragments of dQ's column tiles 2 np and 2 np + 1
          ldmatrix_x4_trans(kf, kst + 16 * kk * P + a_off + c0 + 16 * np);
          mma_bf16(acc[2 * np], a, kf[0], kf[1]);
          mma_bf16(acc[2 * np + 1], a, kf[2], kf[3]);
        }
      }
    }
    __syncthreads();  // the stage is consumed before the next copy into it
  }

  // dQ = scale acc, staged through the warp's own rows of the Q tile
  bf16* ow = qs + warp * 16 * P;
#pragma unroll
  for (int n = 0; n < kDT; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(ow + g * P + 8 * n + 2 * t) =
        __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(ow + (g + 8) * P + 8 * n + 2 * t) =
        __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
  __syncwarp();
  constexpr int kChunks = NCOL / 8;
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, d0 = (c % kChunks) * 8;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(dq + ((static_cast<int64_t>(b) * S + row0 + r) * H + h) * HD +
                                c0 + d0) = *reinterpret_cast<const uint4*>(ow + r * P + d0);
  }
}

// dK and dV of one (b, kv head, 64-key tile); the tile index is blockIdx.z,
// heaviest causal tile first
template <int HD>
__global__ void __launch_bounds__(kTcThreads) attn_bwd_dkdv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ scratch, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int S, int Sk, int H, int KV, float scale, bool causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = tc_pitch<HD>();
  constexpr int QR = dkdv_qrows<HD>();  // q rows of a q tile
  constexpr int NCOL = HD / col_split<HD>();  // dK and dV columns of the block
  constexpr int kSteps = HD / 16;       // k steps of K Q^T
  constexpr int kNT = QR / 8;           // 8-row tiles of a q tile
  constexpr int kDT = NCOL / 8;         // 8-column tiles of the block's dK and dV
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kBT][P]
  bf16* vs = ks + kBT * P;                       // [kBT][P]
  bf16* qs = vs + kBT * P;                       // [2][QR][P]
  bf16* dos = qs + 2 * QR * P;                   // [2][QR][P]
  float* ls = reinterpret_cast<float*>(dos + 2 * QR * P);  // [2][QR]: -(lse' log2 e)
  float* Ds = ls + 2 * QR;                                  // [2][QR]

  const int kvh = blockIdx.x / col_split<HD>(), b = blockIdx.y, kt = blockIdx.z;
  const int c0 = (blockIdx.x % col_split<HD>()) * NCOL;  // the block's first dK, dV column
  const int G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = kt * kBT;
  const int kw = k0 + warp * 16;  // the warp's first key
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * HD;
  const int64_t kv_off = (static_cast<int64_t>(b) * Sk * KV + kvh) * HD;
  const float* D_in = scratch;
  const float* lse2_in = scratch + static_cast<int64_t>(gridDim.y) * H * S;
  const float scale_log2 = scale * kLog2e;

  // the walk: it = g nq + (qt - qt0) over the G query heads and the q tiles
  // that hold a row at or below the diagonal of this key tile (every q
  // tile, non-causal)
  const int n_qt = (S + QR - 1) / QR;
  const int qt0 = causal ? k0 / QR : 0;
  const int nq = n_qt - qt0;
  const int n_it = G * nq;

  tc_load_rows<HD, kBT>(ks, k + kv_off, kv_stride, k0, Sk);
  tc_load_rows<HD, kBT>(vs, v + kv_off, kv_stride, k0, Sk);
  {
    const int64_t q_off = (static_cast<int64_t>(b) * S * H + kvh * G) * HD;
    tc_load_rows<HD, QR>(qs, q + q_off, q_stride, qt0 * QR, S);
    tc_load_rows<HD, QR>(dos, dout + q_off, q_stride, qt0 * QR, S);
    cp_async_commit();
    if (threadIdx.x < QR) {
      const int i = qt0 * QR + threadIdx.x;
      const int64_t so = (static_cast<int64_t>(b) * H + kvh * G) * S + i;
      ls[threadIdx.x] = i < S ? -lse2_in[so] * kLog2e : 0.0f;
      Ds[threadIdx.x] = i < S ? D_in[so] : 0.0f;
    }
  }

  float dka[kDT][4], dva[kDT][4];  // keys g and g + 8 of the warp, columns 8n + 2t, + 1
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  const int lm_r = lane % 8, lm_m = lane / 8;
  const int a_off = (lm_r + 8 * (lm_m % 2)) * P + 8 * (lm_m / 2);
  const int b_off = (lm_r + 8 * (lm_m / 2)) * P + 8 * (lm_m % 2);
  const bf16* kwp = ks + warp * 16 * P;
  const bf16* vwp = vs + warp * 16 * P;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    const bool more = it + 1 < n_it;
    float next_l = 0.0f, next_d = 0.0f;
    if (more) {  // copy the next q tile while this one is used
      const int h = kvh * G + (it + 1) / nq;
      const int nq0 = (qt0 + (it + 1) % nq) * QR;
      const int nxt = (it + 1) & 1;
      const int64_t q_off = (static_cast<int64_t>(b) * S * H + h) * HD;
      tc_load_rows<HD, QR>(qs + nxt * QR * P, q + q_off, q_stride, nq0, S);
      tc_load_rows<HD, QR>(dos + nxt * QR * P, dout + q_off, q_stride, nq0, S);
      cp_async_commit();
      const int i = nq0 + static_cast<int>(threadIdx.x);
      if (threadIdx.x < QR && i < S) {  // into registers now, to shared memory below
        const int64_t so = (static_cast<int64_t>(b) * H + h) * S + i;
        next_l = -lse2_in[so] * kLog2e;
        next_d = D_in[so];
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (qt0 + it % nq) * QR;
    // a warp whose keys all lie above every row of the tile has nothing to add
    if (!(causal && q0 + QR - 1 < kw)) {
      const bf16* qst = qs + stage * QR * P;
      const bf16* dost = dos + stage * QR * P;
      const float* lst = ls + stage * QR;
      const float* dst = Ds + stage * QR;

      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys and the tile's rows
      float st[kNT][4], dpt[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, kwp + a_off + 16 * kk);
        ldmatrix_x4(va, vwp + a_off + 16 * kk);
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp) {
          uint32_t qf[4], df[4];  // B fragments of row tiles 2 jp and 2 jp + 1
          ldmatrix_x4(qf, qst + 16 * jp * P + b_off + 16 * kk);
          ldmatrix_x4(df, dost + 16 * jp * P + b_off + 16 * kk);
          mma_bf16(st[2 * jp], ka, qf[0], qf[1]);
          mma_bf16(st[2 * jp + 1], ka, qf[2], qf[3]);
          mma_bf16(dpt[2 * jp], va, df[0], df[1]);
          mma_bf16(dpt[2 * jp + 1], va, df[2], df[3]);
        }
      }

      // P^T and dS^T: st[j][e] is key kw + g + 8 (e >> 1), row q0 + 8j + 2t + (e & 1)
      const bool masked = q0 + QR > S || (causal && q0 < kw + 15);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float2 lj = *reinterpret_cast<const float2*>(lst + 8 * j + 2 * t);
        const float2 dj = *reinterpret_cast<const float2*>(dst + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_ftz(fmaf(st[j][e], scale_log2, (e & 1) ? lj.y : lj.x));
          if (masked) {
            const int qpos = q0 + 8 * j + 2 * t + (e & 1);
            const int kpos = kw + g + 8 * (e >> 1);
            if (qpos >= S || (causal && kpos > qpos)) p = 0.0f;
          }
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - ((e & 1) ? dj.y : dj.x));
        }
      }

      // dV += P^T dO and dK += dS^T Q, 16 rows a step, P^T and dS^T in bf16
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        uint32_t pa[4], sa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // row tiles 2 kk and 2 kk + 1
          const float* pj = st[2 * kk + half];
          const float* sj = dpt[2 * kk + half];
          pa[2 * half] = pack_bf16(pj[0], pj[1]);
          pa[2 * half + 1] = pack_bf16(pj[2], pj[3]);
          sa[2 * half] = pack_bf16(sj[0], sj[1]);
          sa[2 * half + 1] = pack_bf16(sj[2], sj[3]);
        }
#pragma unroll
        for (int np = 0; np < kDT / 2; ++np) {
          uint32_t of[4], qf[4];  // B fragments of column tiles 2 np and 2 np + 1
          ldmatrix_x4_trans(of, dost + 16 * kk * P + a_off + c0 + 16 * np);
          ldmatrix_x4_trans(qf, qst + 16 * kk * P + a_off + c0 + 16 * np);
          mma_bf16(dva[2 * np], pa, of[0], of[1]);
          mma_bf16(dva[2 * np + 1], pa, of[2], of[3]);
          mma_bf16(dka[2 * np], sa, qf[0], qf[1]);
          mma_bf16(dka[2 * np + 1], sa, qf[2], qf[3]);
        }
      }
    }
    __syncthreads();  // the stage is consumed before the next copy into it
    if (more && threadIdx.x < QR) {
      ls[((it + 1) & 1) * QR + threadIdx.x] = next_l;
      Ds[((it + 1) & 1) * QR + threadIdx.x] = next_d;
    }
  }

  // dK = scale dka and dV = dva, staged through the warp's own rows of K and V
  bf16* kout = ks + warp * 16 * P;
  bf16* vout = vs + warp * 16 * P;
#pragma unroll
  for (int n = 0; n < kDT; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(kout + g * P + 8 * n + 2 * t) =
        __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(kout + (g + 8) * P + 8 * n + 2 * t) =
        __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
    *reinterpret_cast<__nv_bfloat162*>(vout + g * P + 8 * n + 2 * t) =
        __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(vout + (g + 8) * P + 8 * n + 2 * t) =
        __floats2bfloat162_rn(dva[n][2], dva[n][3]);
  }
  __syncwarp();
  constexpr int kChunks = NCOL / 8;
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, d0 = (c % kChunks) * 8;
    if (kw + r < Sk) {
      const int64_t off = kv_off + static_cast<int64_t>(kw + r) * kv_stride + c0 + d0;
      *reinterpret_cast<uint4*>(dk + off) = *reinterpret_cast<const uint4*>(kout + r * P + d0);
      *reinterpret_cast<uint4*>(dv + off) = *reinterpret_cast<const uint4*>(vout + r * P + d0);
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
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));  // float(hd ** -0.5)
  const int n_qt = (S + kBT - 1) / kBT, n_kt = (Sk + kBT - 1) / kBT;

  auto dqk = attn_bwd_dq_bf16_kernel<HD>;  // D and lse', then dQ
  constexpr int dq_bytes = dq_bf16_smem_bytes<HD>();
  cudaError_t err =
      cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<dim3(H * col_split<HD>(), B, n_qt), kTcThreads, dq_bytes, stream>>>(
      q_, k_, v_, do_, lse, scratch, static_cast<bf16*>(dq), S, Sk, H, KV, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dkdv = attn_bwd_dkdv_bf16_kernel<HD>;  // with D and lse'
  constexpr int dkdv_bytes = dkdv_bf16_smem_bytes<HD>();
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<dim3(KV * col_split<HD>(), B, n_kt), kTcThreads, dkdv_bytes, stream>>>(
      q_, k_, v_, do_, scratch, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Sk, H, KV,
      scale, causal);
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
