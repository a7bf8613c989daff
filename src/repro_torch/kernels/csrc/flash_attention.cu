// K2 on Hopper: causal or non-causal GQA self-attention with an online
// softmax (flash attention), forward only.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py,
// `flash_attention` and its `_kernel`. The plain PyTorch version of the same
// function is `flash_attention_plain` in
// src/repro_torch/kernels/flash_attention.py.
//
// For q (B,S,H,hd) and k, v (B,S,KV,hd), contiguous, float32 or bfloat16:
// o[b,i,h] = sum_j softmax_j(s_ij) v[b,j,h/(H/KV)] with
// s_ij = (q[b,i,h] . k[b,j,h/(H/KV)]) * hd^-0.5, and s_ij = -1e30 where key j
// is masked (j > i when causal, and j >= S). The running max m, the running
// sum l and the accumulator are float32; o = acc / max(l, 1e-30), rounded to
// q's dtype. Numerics follow the Pallas kernel step for step: inputs are
// widened to float32, and a tile's probabilities multiply v in float32.
//
// Bound: operations. At the serving path's prefill (B 8, S 2048, H = KV = 32,
// hd 64, causal) the work is 4*B*H*S*S*hd/2 = 1.37e11 FLOP against 268 MB
// of inputs and output: 512 FLOP a byte, above the card's ridge in bf16.
//
// What the design does, against the TPU kernel it replaces:
//   * The TPU kernel carries m, l and acc in VMEM scratch across a sequential
//     k-grid axis. Here one block owns one (b, h, 64-row q tile) and walks
//     the k tiles itself, so the online-softmax state stays in registers:
//     each of the 4 warps owns 16 q rows, each lane 2 keys of a 64-key tile
//     for the scores and hd/32 output columns of the 16 rows.
//   * K and V tiles are staged once in shared memory and read by all four
//     warps; K rows are padded by one float so that 32 lanes reading 32 keys
//     hit 32 banks; q rows and probabilities are read as broadcast float4.
//   * Causal: k tiles wholly above the diagonal are never loaded, and q
//     tiles are handed out heaviest first.
//   * GQA reads the kv head of each query head in place: K/V are never
//     repeated in memory.
//   * Any S: rows and keys past S are masked (the TPU kernel asserts that S
//     divides into its blocks).
// The products run on CUDA cores in float32 (no tensor cores): right first;
// wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;      // q rows per warp
constexpr int kBQ = kWarps * kRows;  // q rows per block
constexpr int kBK = 64;        // keys per tile, 2 per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int HD>
constexpr int smem_floats() {
  return kBQ * HD + kBK * (HD + 1) + kBK * HD + kWarps * kRows * kBK;
}

// Rows [r0, r0 + rows) of a (S, HD) slice with row stride `stride` elements,
// widened to float32 into dst (row pitch `pitch`); rows at or past S are 0.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const T* src,
                                          int64_t stride, int r0, int rows, int S) {
  constexpr int kVec = 16 / sizeof(T);  // elements in one 16-byte load
  constexpr int kChunks = HD / kVec;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, d0 = (c % kChunks) * kVec;
    float* out = dst + r * pitch + d0;
    if (r0 + r < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + d0);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) out[i] = widen(e[i]);
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int S, int H, int KV, float scale, bool causal) {
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
  const T* qb = q + (static_cast<int64_t>(b) * S * H + h) * HD;
  const T* kb = k + (static_cast<int64_t>(b) * S * KV + kvh) * HD;
  const T* vb = v + (static_cast<int64_t>(b) * S * KV + kvh) * HD;

  load_rows<T, HD>(qs, HD, qb, q_stride, q0, kBQ, S);

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);  // skip tiles above the diagonal
  const float* qw = qs + warp * kRows * HD;
  float* pw = ps + warp * kRows * kBK;
  const float* k_lo = ks + lane * kKPitch;
  const float* k_hi = ks + (lane + 32) * kKPitch;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed (and q is loaded)
    load_rows<T, HD>(ks, kKPitch, kb, kv_stride, k0, kBK, S);
    load_rows<T, HD>(vs, HD, vb, kv_stride, k0, kBK, S);
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
        const bool keep = kpos < S && (!causal || kpos <= qpos);
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
      T* out = o + ((static_cast<int64_t>(b) * S + qpos) * H + h) * HD;
      const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (lane + 32 * c < HD) narrow(out + lane + 32 * c, acc[r][c] / denom);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, bool causal, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<HD>() * sizeof(float);
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KV,
      static_cast<float>(1.0 / sqrt(static_cast<double>(HD))),  // float(hd ** -0.5)
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S,
              int H, int KV, int hd, bool causal, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KV, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(). The wrapper has
// checked shapes, dtypes, contiguity and alignment; hd is 16, 32, 64 or 128.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int S, int H, int KV, int hd,
                                      int causal, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, causal != 0, s);
  return launch_hd<float>(q, k, v, o, B, S, H, KV, hd, causal != 0, s);
}
