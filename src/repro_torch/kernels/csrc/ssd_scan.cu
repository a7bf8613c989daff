// K3 on Hopper: the Mamba-2 SSD intra-chunk block.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py,
// `ssd_intra_chunk` and its `_kernel`. The plain PyTorch version of the same
// function is `ssd_intra_chunk_plain` in src/repro_torch/kernels/ssd_scan.py.
//
// For each (batch b, chunk c, head h), with x (Q, hp), dt and seg (Q,) and
// B and C (Q, N), all in float32 inside (x arrives in bf16 or float32):
//   M[i][j]  = (C_i . B_j) * exp(seg_i - seg_j) * dt_j   for i >= j, else 0
//   y        = M x                                        (Q, hp)
//   state    = sum_j exp(seg_{Q-1} - seg_j) dt_j x_j^T B_j (hp, N)
//   decay    = exp(seg_{Q-1})
// B and C are shared by all heads (one group). Layouts, all contiguous:
// x, y (B,nc,Q,nh,hp); dt, seg (B,nc,Q,nh); B, C (B,nc,Q,N);
// state (B,nc,nh,hp,N); decay (B,nc,nh).
//
// Bound: float32 operations. At the serving path's prefill (B 8, nc 16,
// Q 128, nh 64, hp 64, N 64) the lower triangles of C B^T and of M x and the
// state product take 1.7e10 FLOP against 553 MB moved (mostly y and state
// written in float32): 32 FLOP a byte, above the card's float32 ridge of 20.
//
// What the design does, against the TPU kernel it replaces:
//   * The TPU grid (B, nc, nh) forms C B^T, a Q x Q x N product, once per
//     head, though it is the same for every head. Here a block owns one
//     (b, c) and a group of heads: it forms the lower triangle of C B^T once
//     in shared memory and loops over its heads.
//   * Per head, M is built once in shared memory (one exp per entry of the
//     lower triangle) and y = M x runs over the triangle only: each thread
//     holds up to 8 rows x 4 columns of y in registers, its rows spread over
//     the chunk so that the triangle's work is even across threads.
//   * Entries above the diagonal are never computed: exp(seg_i - seg_j) there
//     can overflow to inf, and inf * 0 would be NaN.
//   * Shared memory above 48 KB (199 KB at Q 128, N 64) is opted into
//     with cudaFuncSetAttribute; x is staged in column tiles of at most 64
//     so that Q = N = hp = 128 still fits.
// Products run on CUDA cores in float32, as the reference asks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;    // rows of a thread's register tile
constexpr int kMaxTile = 64;   // columns of x staged at a time
constexpr int kMaxDim = 128;   // largest Q, hp and N

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

struct Layout {  // shared-memory carve-up, in floats
  int qp, n4, pt4, cb, mc, xs, bs, vec, total;
  __host__ __device__ Layout(int Q, int N, int pt) {
    qp = Q + 1;                      // pitch of the Q x Q matrices
    n4 = round4(N);                  // pitch of B and C
    pt4 = round4(pt);                // pitch of the x tile
    cb = 0;                          // C B^T, lower triangle
    mc = cb + round4(Q * qp);        // C while C B^T is formed, then M
    xs = mc + round4(Q * (qp > n4 ? qp : n4));
    bs = xs + Q * pt4;               // B
    vec = bs + Q * n4;               // seg, dt, w
    total = vec + 3 * Q;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_intra_chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ seg, const float* __restrict__ bm,
    const float* __restrict__ cm, float* __restrict__ y,
    float* __restrict__ state, float* __restrict__ decay, int nc, int Q,
    int nh, int hp, int N, int heads_per_block, int pt) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(Q, N, pt);
  float* cb = smem + lay.cb;
  float* mc = smem + lay.mc;
  float* xs = smem + lay.xs;
  float* bs = smem + lay.bs;
  float* seg_s = smem + lay.vec;
  float* dt_s = seg_s + Q;
  float* w_s = dt_s + Q;
  const int qp = lay.qp, n4 = lay.n4, pt4 = lay.pt4;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t bc = static_cast<int64_t>(blockIdx.z) * nc + blockIdx.y;

  // B and C of the chunk, zero-padded to n4 columns; one warp per row
  const float* b_src = bm + bc * Q * N;
  const float* c_src = cm + bc * Q * N;
  for (int i = warp; i < Q; i += kWarps) {
    for (int n = lane; n < n4; n += 32) {
      bs[i * n4 + n] = n < N ? b_src[i * N + n] : 0.0f;
      mc[i * n4 + n] = n < N ? c_src[i * N + n] : 0.0f;
    }
  }
  __syncthreads();

  // C B^T, lower triangle: a warp per row i, a lane per column j. Each lane
  // starts its sum over n at n = lane, so that the 32 lanes read 32 banks.
  for (int i = warp; i < Q; i += kWarps) {
    const float* ci = mc + i * n4;
    for (int j = lane; j <= i; j += 32) {
      const float* bj = bs + j * n4;
      float acc = 0.0f;
      int n = lane % N;
      for (int t = 0; t < N; ++t) {
        acc = fmaf(ci[n], bj[n], acc);
        if (++n == N) n = 0;
      }
      cb[i * qp + j] = acc;
    }
  }

  const int h_end = min(nh, (static_cast<int>(blockIdx.x) + 1) * heads_per_block);
  for (int h = blockIdx.x * heads_per_block; h < h_end; ++h) {
    __syncthreads();  // C B^T is formed; the previous head is done with M, x, w
    for (int i = tid; i < Q; i += kThreads) {
      seg_s[i] = seg[(bc * Q + i) * nh + h];
      dt_s[i] = dt[(bc * Q + i) * nh + h];
    }
    __syncthreads();
    const float seg_last = seg_s[Q - 1];
    for (int i = tid; i < Q; i += kThreads) w_s[i] = dt_s[i] * expf(seg_last - seg_s[i]);
    if (tid == 0) decay[bc * nh + h] = expf(seg_last);
    for (int i = warp; i < Q; i += kWarps) {
      const float seg_i = seg_s[i];
      for (int j = lane; j <= i; j += 32)
        mc[i * qp + j] = cb[i * qp + j] * expf(seg_i - seg_s[j]) * dt_s[j];
    }

    for (int p0 = 0; p0 < hp; p0 += pt) {
      const int pw = min(pt, hp - p0);
      __syncthreads();  // M and w are built; the previous tile is done with x
      for (int j = warp; j < Q; j += kWarps) {
        const T* xj = x + ((bc * Q + j) * nh + h) * hp + p0;
        for (int p = lane; p < pt4; p += 32) xs[j * pt4 + p] = p < pw ? widen(xj[p]) : 0.0f;
      }
      __syncthreads();

      // y rows i = rg + rows_g * a, columns 4 cg .. 4 cg + 3 of the tile
      {
        const int groups = pt4 / 4;
        const int rows_g = kThreads / groups;
        const int cg = tid % groups, rg = tid / groups;
        if (rg < rows_g) {
          float acc[kMaxRows][4];
#pragma unroll
          for (int a = 0; a < kMaxRows; ++a) acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.0f;
          const float4* x4 = reinterpret_cast<const float4*>(xs) + cg;
          // segment a0 runs j over (row a0-1, row a0]: rows a >= a0 take it
#pragma unroll
          for (int a0 = 0; a0 < kMaxRows; ++a0) {
            const int i0 = rg + rows_g * a0;
            if (i0 < Q) {
              for (int j = a0 == 0 ? 0 : i0 - rows_g + 1; j <= i0; ++j) {
                const float4 xv = x4[j * groups];
#pragma unroll
                for (int a = a0; a < kMaxRows; ++a) {
                  const int i = rg + rows_g * a;
                  if (i < Q) {
                    const float mij = mc[i * qp + j];
                    acc[a][0] = fmaf(mij, xv.x, acc[a][0]);
                    acc[a][1] = fmaf(mij, xv.y, acc[a][1]);
                    acc[a][2] = fmaf(mij, xv.z, acc[a][2]);
                    acc[a][3] = fmaf(mij, xv.w, acc[a][3]);
                  }
                }
              }
            }
          }
#pragma unroll
          for (int a = 0; a < kMaxRows; ++a) {
            const int i = rg + rows_g * a;
            if (i < Q) {
              float* out = y + ((bc * Q + i) * nh + h) * hp + p0;
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (4 * cg + c < pw) out[4 * cg + c] = acc[a][c];
            }
          }
        }
      }

      // state rows p = rg + rows_g * a of the tile, columns n = 4 cg .. 4 cg + 3
      {
        const int groups = n4 / 4;
        const int rows_g = kThreads / groups;
        const int cg = tid % groups, rg = tid / groups;
        if (rg < rows_g) {
          float acc[kMaxRows][4];
#pragma unroll
          for (int a = 0; a < kMaxRows; ++a) acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.0f;
          const float4* b4 = reinterpret_cast<const float4*>(bs) + cg;
          for (int j = 0; j < Q; ++j) {
            const float4 bv = b4[j * groups];
            const float wj = w_s[j];
#pragma unroll
            for (int a = 0; a < kMaxRows; ++a) {
              const int p = rg + rows_g * a;
              if (p < pw) {
                const float xw = xs[j * pt4 + p] * wj;
                acc[a][0] = fmaf(xw, bv.x, acc[a][0]);
                acc[a][1] = fmaf(xw, bv.y, acc[a][1]);
                acc[a][2] = fmaf(xw, bv.z, acc[a][2]);
                acc[a][3] = fmaf(xw, bv.w, acc[a][3]);
              }
            }
          }
#pragma unroll
          for (int a = 0; a < kMaxRows; ++a) {
            const int p = rg + rows_g * a;
            if (p < pw) {
              float* out = state + ((bc * nh + h) * hp + p0 + p) * N;
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (4 * cg + c < N) out[4 * cg + c] = acc[a][c];
            }
          }
        }
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for sizes the kernel does not take (Q, hp or N above
// 128, or a shared-memory need above the card's opt-in limit). The wrapper
// has checked shapes, dtypes and contiguity.
extern "C" int ssd_intra_chunk_launch(
    const void* x, int x_is_bf16, const float* dt, const float* seg,
    const float* bm, const float* cm, float* y, float* state, float* decay,
    int batch, int nc, int Q, int nh, int hp, int N, int heads_per_block,
    void* stream) {
  if (Q < 1 || Q > kMaxDim || hp < 1 || hp > kMaxDim || N < 1 || N > kMaxDim ||
      heads_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // widest x tile (at most 64 columns, which the register tiles assume) that fits
  int pt = hp < kMaxTile ? hp : kMaxTile;
  while (pt > 4 && Layout(Q, N, pt).total * sizeof(float) > static_cast<size_t>(limit))
    pt = (pt + 1) / 2;
  const size_t bytes = Layout(Q, N, pt).total * sizeof(float);
  if (bytes > static_cast<size_t>(limit)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nh + heads_per_block - 1) / heads_per_block, nc, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    auto kernel = ssd_intra_chunk_kernel<__nv_bfloat16>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, bytes, s>>>(static_cast<const __nv_bfloat16*>(x), dt, seg,
                                         bm, cm, y, state, decay, nc, Q, nh, hp, N,
                                         heads_per_block, pt);
  } else {
    auto kernel = ssd_intra_chunk_kernel<float>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, bytes, s>>>(static_cast<const float*>(x), dt, seg, bm, cm,
                                         y, state, decay, nc, Q, nh, hp, N,
                                         heads_per_block, pt);
  }
  return static_cast<int>(cudaGetLastError());
}
