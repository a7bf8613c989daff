// K2's backward on Hopper: dQ, dK and dV of causal or non-causal GQA
// self-attention, by recompute from the forward's log-sum-exp, with no
// atomics.
//
// The JAX package takes this gradient by differentiating `layers.attend`
// (src/repro/models/layers.py:188), which the Pallas TPU kernel of
// src/repro/kernels/flash_attention.py (`flash_attention` :77, pallas_call
// :91) computes forward; the Pallas kernel has no backward of its own. The
// plain PyTorch version is the autograd gradient of `flash_attention_plain`
// in src/repro_torch/kernels/flash_attention.py.
//
// For q, dO (B,S,H,hd), k, v (B,S,KV,hd), float32 or bfloat16, and the
// forward's lse (B,H,S) float32, with query head h reading kv head
// h / (H/KV), s_ij = q_i . k_j * hd^-0.5 (-1e30 where key j is masked: j > i
// when causal, and j >= S), P_ij = exp(s_ij - lse_i), dP_ij = dO_i . v_j,
// and everything below in float32:
//   (a) per (b, h, q tile): D_i = sum_j P_ij dP_ij and
//       dQ_i = hd^-0.5 sum_j P_ij (dP_ij - D_i) k_j, in one pass over the
//       keys as hd^-0.5 (sum_j P_ij dP_ij k_j - D_i sum_j P_ij k_j);
//   (b) per (b, kv head, key tile), with dS_ij = P_ij (dP_ij - D_i):
//       dV_j = sum over the G query heads of kv head j's head and over i of
//       P_ij dO_i, and dK_j = hd^-0.5 sum likewise of dS_ij q_i.
// Gradients are rounded to the inputs' dtype once, at the end.
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
// tensor cores' 989 TFLOP/s, 0.050 ms of bytes at 3.35 TB/s). This kernel
// recomputes P and dP in both (a) and (b) and forms sum P k beside
// sum P dP k, eight products, on the CUDA cores in float32: it is the simple
// version that is right, and the tensor cores (mma/wgmma, TMA) are work for
// a later change.
//
// Design:
//   * (a) one block of 256 threads per (b, head, 64-row q tile) keeps Q,
//     dO and lse in shared memory and its two accumulators in registers
//     (thread (tr, tc) owns rows tr + 16a and columns tc + 16c), and walks
//     the k tiles at or below the diagonal, heaviest q tiles first; it
//     writes D for (b).
//   * (b) one block of 256 threads per (b, kv head, 64-key tile) keeps the
//     tile's K and V and its dK and dV accumulators (in registers: thread
//     (tr, tc) owns key rows tr + 16a and columns tc + 16c) for the whole
//     walk over the G query heads of its kv head and the 64-row q tiles at
//     or below the diagonal. Per q tile it stages Q, dO, lse and D in
//     shared memory, forms S and dP for the 64 x 64 tile (thread (tr, tc):
//     rows tr + 16a, keys tc + 16c), writes P and dS to shared memory, and
//     accumulates P^T dO and dS^T Q. Causal blocks with the lowest keys have
//     the most q tiles and are handed out first.
//   * Tiles are float32 in shared memory with odd row pitches (hd + 1, 65),
//     so sixteen rows read at one column fall in sixteen banks. Rows and
//     keys at or past S are zero and masked. hd 16, 32, 64, 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;      // q rows of a q tile, keys of a k tile
constexpr int kPP = kTile + 1;  // pitch of the P and dS tiles
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
__host__ __device__ constexpr int pitch() { return HD + 1; }

// Rows [r0, r0 + kTile) of a (S, HD) slice with row stride `stride` elements
// into dst as float32 (row pitch HD + 1); rows at or past S are 0.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t stride, int r0,
                                          int S) {
  for (int c = threadIdx.x; c < kTile * HD; c += kThreads) {
    const int r = c / HD, d = c % HD;
    dst[r * pitch<HD>() + d] = r0 + r < S ? to_float(src[(r0 + r) * stride + d]) : 0.0f;
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
// (q0 + tr + 16a) and keys (k0 + tc + 16c); rows or keys at or past S are
// masked
__device__ __forceinline__ void probs(float (&s)[4][4], const float* ls, int q0, int k0,
                                      int tr, int tc, int S, float scale, bool causal) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = tr + 16 * a, i = q0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + tc + 16 * c;
      const bool keep = i < S && j < S && (!causal || j <= i);
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
constexpr int dkdv_smem_bytes() { return (4 * kTile * pitch<HD>() + 2 * kTile * kPP + 2 * kTile) * 4; }
template <int HD>
constexpr int dq_smem_bytes() { return (4 * kTile * pitch<HD>() + 2 * kTile * kPP + kTile) * 4; }

// (b) dK and dV of one (b, kv head, 64-key tile)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ D,
    T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KV, float scale, bool causal) {
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
  const int64_t kv_off = (static_cast<int64_t>(b) * S * KV + kvh) * HD;
  load_tile<T, HD>(ks, k + kv_off, kv_stride, k0, S);
  load_tile<T, HD>(vs, v + kv_off, kv_stride, k0, S);

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
      load_tile<T, HD>(qs, q + q_off, q_stride, q0, S);
      load_tile<T, HD>(dos, dout + q_off, q_stride, q0, S);
      load_rows_stat(ls, lse + stat_off, q0, S);
      load_rows_stat(Ds, D + stat_off, q0, S);
      __syncthreads();

      float s[4][4], dp[4][4];
      scores<HD>(s, dp, qs, dos, ks, vs, tr, tc);
      probs(s, ls, q0, k0, tr, tc, S, scale, causal);
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
    if (j >= S) continue;
    const int64_t off = kv_off + static_cast<int64_t>(j) * kv_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + tc + 16 * c] = from_float<T>(dk_acc[a][c] * scale);
      dv[off + tc + 16 * c] = from_float<T>(dv_acc[a][c]);
    }
  }
}

// (a) D and dQ of one (b, head, 64-row q tile)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ D,
    T* __restrict__ dq, int S, int H, int KV, float scale, bool causal) {
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
  const int64_t kv_off = (static_cast<int64_t>(b) * S * KV + kvh) * HD;
  const int64_t stat_off = (static_cast<int64_t>(b) * H + h) * S;
  load_tile<T, HD>(qs, q + q_off, q_stride, q0, S);
  load_tile<T, HD>(dos, dout + q_off, q_stride, q0, S);
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

  const int n_kt = causal ? qt + 1 : n_qt;  // k tiles at or below the diagonal
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile is consumed (and Q, dO are loaded)
    load_tile<T, HD>(ks, k + kv_off, kv_stride, k0, S);
    load_tile<T, HD>(vs, v + kv_off, kv_stride, k0, S);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<HD>(s, dp, qs, dos, ks, vs, tr, tc);
    probs(s, ls, q0, k0, tr, tc, S, scale, causal);
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
    for (int c = 0; c < NC; ++c)
      dq[off + tc + 16 * c] = from_float<T>((pdk[a][c] - d_part[a] * pk[a][c]) * scale);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* D, void* dq, void* dk, void* dv, int B, int S, int H,
           int KV, bool causal, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));  // float(hd ** -0.5)
  const int n_t = (S + kTile - 1) / kTile;

  auto dqk = attn_bwd_dq_kernel<T, HD>;  // (a): D, then dQ
  constexpr int dq_bytes = dq_smem_bytes<HD>();
  cudaError_t err =
      cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<dim3(n_t, H, B), kThreads, dq_bytes, stream>>>(q_, k_, v_, do_, lse, D,
                                                       static_cast<T*>(dq), S, H, KV, scale,
                                                       causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dkdv = attn_bwd_dkdv_kernel<T, HD>;  // (b), with (a)'s D
  constexpr int dkdv_bytes = dkdv_smem_bytes<HD>();
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<dim3(n_t, KV, B), kThreads, dkdv_bytes, stream>>>(
      q_, k_, v_, do_, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dtype(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, float* D, void* dq, void* dk, void* dv, int B, int S, int H,
                 int KV, bool causal, bool is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch<__nv_bfloat16, HD>(q, k, v, dout, lse, D, dq, dk, dv, B, S, H, KV,
                                             causal, stream)
                 : launch<float, HD>(q, k, v, dout, lse, D, dq, dk, dv, B, S, H, KV, causal,
                                     stream);
}

}  // namespace

// Launches (a) and (b) on `stream` and returns the first CUDA error, or 0.
// The wrapper has checked shapes, dtypes, contiguity and alignment; hd is 16,
// 32, 64 or 128; `D` is float32 (B,H,S) scratch; dq, dk, dv have the inputs'
// dtype and shapes, and every element of them is written.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, void* D,
                                          void* dq, void* dk, void* dv, int B, int S,
                                          int H, int KV, int hd, int causal, int is_bf16,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0, bf = is_bf16 != 0;
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  switch (hd) {
    case 16: return launch_dtype<16>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, KV, c, bf, s);
    case 32: return launch_dtype<32>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, KV, c, bf, s);
    case 64: return launch_dtype<64>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, KV, c, bf, s);
    case 128: return launch_dtype<128>(q, k, v, dout, l, d, dq, dk, dv, B, S, H, KV, c, bf, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
