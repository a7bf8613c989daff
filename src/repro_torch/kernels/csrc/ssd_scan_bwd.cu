// K3's backward on Hopper: the gradient of the Mamba-2 SSD intra-chunk block.
//
// The JAX package has no Pallas backward for K3 (src/repro/kernels/ssd_scan.py,
// `ssd_intra_chunk`): it differentiates the plain `ssd_chunked` of
// src/repro/models/mamba2.py. This replaces that gradient for the port. The
// plain PyTorch version of the same function is `ssd_intra_chunk_bwd_plain`
// in src/repro_torch/kernels/ssd_scan.py, and this kernel computes its
// formulas. For each (batch b, chunk c, head h), with x (Q, hp), dt and seg
// (Q,), B and C (Q, N), and the gradients dy (Q, hp), dS (hp, N) and
// ddecay of y, state and decay:
//   L_ij  = exp(seg_i - seg_j), CB_ij = C_i . B_j, M_ij = CB_ij L_ij dt_j (i >= j)
//   w_j   = exp(seg_last - seg_j) dt_j
//   dx_j  = sum_{i>=j} M_ij dy_i + w_j dS B_j
//   K_ij  = (dy_i . x_j) CB_ij L_ij,  dw_j = x_j . dS B_j = B_j . (x dS)_j
//   ddt_j = sum_i K_ij + dw_j exp(seg_last - seg_j)
//   dseg_j = sum_i' K_ji' dt_i' - dt_j sum_i K_ij - dw_j w_j
//            (+ sum_j dw_j w_j + ddecay exp(seg_last) at j = last)
//   dCB_ij = sum_h (dy_i . x_j) L_ij dt_j,  dC = dCB B,  dB = dCB^T C + sum_h w_j (x dS)_j
// Layouts, all contiguous: x, dx, dy (B,nc,Q,nh,hp); dt, seg, ddt, dseg
// (B,nc,Q,nh); B, C, dB, dC (B,nc,Q,N); dS (B,nc,nh,hp,N); ddecay (B,nc,nh).
//
// Two kernels, no atomics, so that runs repeat bit for bit:
//   * ssd_bwd_heads_kernel, one block per (b, c, group of heads): forms the
//     lower triangle of C B^T once into shared memory, then for each head of
//     its group the three products dM = dy x^T (lower triangle), R = x dS
//     and dx = M^T dy + (w B) dS^T, with M formed from C B^T, seg and dt as
//     its operand is loaded. It writes dx, ddt and dseg, and keeps the
//     group's partial sums over heads of dC B^T and of the state's part of
//     dB in a float32 scratch (B, nc, groups, Q, Q + N), each element
//     updated by one thread in head order;
//   * ssd_bwd_bc_kernel, one block per (b, c, 64 x 64 output tile): sums the
//     groups' partials in a fixed order and forms dC = dCB B and
//     dB = dCB^T C + dBs.
// Row and column sums of the Q x Q terms go through warp shuffles and a
// per-slot buffer in shared memory, summed in a fixed order.
//
// Every product is a 64 x 64 output tile on float32 CUDA cores (one 4 x 4
// tile a thread, k in chunks of 32 staged through shared memory), which
// keeps float32 accuracy without the 3xTF32 split of the forward. Any Q, hp
// and N from 1 to 128: tiles are zero-padded as they are staged and masked
// on output.
//
// Bound, at zamba2-1.2b's training microbatch (B 4, nc 16, Q 128, nh 64,
// hp 64, N 64, x bf16): each input read once and each output written once
// is 0.35 GB (x 67 MB, dy 134 MB, dS 67 MB, dx 67 MB, the rest 17 MB),
// 0.105 ms at 3.35 TB/s. The products the gradient needs (the lower
// triangles of dy x^T and M^T dy, x dS, (w B) dS^T, C B^T, and dC, dB) are
// 1.75e10 FLOP. The card's fastest float32-accurate route for them is
// 3xTF32 on the tensor cores, as the forward runs: 3 TF32 products for
// each float32 one, 2 where one side is the bf16 x, 4.4e10 FLOP as issued,
// 0.088 ms at 495 TFLOP/s. So the bytes bound this function, at 0.105 ms.
// This kernel, on the CUDA cores, has a floor of its own: the 1.75e10 FLOP
// at 67 TFLOP/s take 0.26 ms; the tensor cores are work for a later
// version. The design pays for its simplicity: 64 x 64 tiles on the
// diagonal compute their upper half too, and operands are read from global
// memory (L2) as each chunk is staged.
//
// Registers (CUDA 12.8 nvcc -O3 for sm_90a, as chip_smoke.py prints them):
// the heads kernel 128 (its bound for two blocks of 256 threads an SM)
// with 4 bytes spilled, the dC/dB kernel 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 128;          // largest Q, hp and N
constexpr int kTile = 64;             // output tile edge
constexpr int kChunk = 32;            // k values staged at a time
constexpr int kPitch = kTile + 4;     // staged rows, 16-byte aligned
constexpr int kMaxTiles = kMaxDim / kTile;
constexpr int kWarps = kThreads / 32;

struct Stage {
  float a[kChunk][kPitch];  // a[k][m]
  float b[kChunk][kPitch];  // b[k][n]
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// acc[r][c] += sum_{k0 <= k < k1} A(m0 + 4 ty + r, k) B(k, n0 + 4 tx + c), with
// tx = tid % 16, ty = tid / 16. load_a(m, k) and load_b(k, n) are called only
// for m < M, n < Nn and k < k1; everything else is staged as 0. The loads
// walk k fastest, or m (a_m_fast) and n (b_n_fast) fastest, to follow the
// operand's contiguous axis. Starts and ends with the block in step.
template <bool kAMFast, bool kBNFast, typename LoadA, typename LoadB>
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], Stage& st, int m0, int n0, int M,
                                         int Nn, int k0, int k1, LoadA load_a, LoadB load_b) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int kc = k0; kc < k1; kc += kChunk) {
    __syncthreads();  // the last chunk is consumed
    for (int e = tid; e < kChunk * kTile; e += kThreads) {
      const int k = kAMFast ? e / kTile : e % kChunk;
      const int m = kAMFast ? e % kTile : e / kChunk;
      st.a[k][m] = (kc + k < k1 && m0 + m < M) ? load_a(m0 + m, kc + k) : 0.0f;
    }
    for (int e = tid; e < kChunk * kTile; e += kThreads) {
      const int k = kBNFast ? e / kTile : e % kChunk;
      const int n = kBNFast ? e % kTile : e / kChunk;
      st.b[k][n] = (kc + k < k1 && n0 + n < Nn) ? load_b(kc + k, n0 + n) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&st.a[k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&st.b[k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
}

// Sum of v over the 16 threads of a half-warp (one ty, every tx), in a fixed
// order; every lane of the half-warp gets it.
__device__ __forceinline__ float sum_over_tx(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct HeadsLayout {  // shared memory of ssd_bwd_heads_kernel, in floats
  int cb, rowp, colp, dwp, vec, total;
  __host__ __device__ explicit HeadsLayout(int Q) {
    cb = sizeof(Stage) / sizeof(float);
    rowp = cb + Q * Q;                    // [kMaxTiles][kMaxDim]: sum_j K_ij dt_j by j tile
    colp = rowp + kMaxTiles * kMaxDim;    // [kMaxTiles * kWarps][kMaxDim]: sum_i K_ij by warp
    dwp = colp + kMaxTiles * kWarps * kMaxDim;  // [kMaxTiles][kMaxDim]: dw_j by n tile
    vec = dwp + kMaxTiles * kMaxDim;      // seg, dt, w, e, dseg: [5][kMaxDim]
    total = vec + 5 * kMaxDim;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_heads_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ seg,
    const float* __restrict__ bm, const float* __restrict__ cm, const float* __restrict__ dy,
    const float* __restrict__ dstate, const float* __restrict__ ddecay, T* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dseg, float* __restrict__ scratch, int nc,
    int Q, int nh, int hp, int N, int heads_per_block) {
  extern __shared__ __align__(16) float smem[];
  const HeadsLayout lay(Q);
  Stage& st = *reinterpret_cast<Stage*>(smem);
  float* cbs = smem + lay.cb;  // C B^T, [Q][Q], lower triangle
  float* rowp = smem + lay.rowp;
  float* colp = smem + lay.colp;
  float* dwp = smem + lay.dwp;
  float* segs = smem + lay.vec;
  float* dts = segs + kMaxDim;
  float* ws = dts + kMaxDim;     // w_j = exp(seg_last - seg_j) dt_j
  float* es = ws + kMaxDim;      // exp(seg_last - seg_j)
  float* dsegs = es + kMaxDim;   // dseg before the last row's term

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16, warp = tid / 32, lane = tid % 32;
  const int groups = gridDim.x, g = blockIdx.x;
  const int64_t bc = static_cast<int64_t>(blockIdx.z) * nc + blockIdx.y;
  const int h_begin = g * heads_per_block, h_end = min(nh, h_begin + heads_per_block);
  const float* Bc = bm + bc * Q * N;
  const float* Cc = cm + bc * Q * N;
  float* dcb = scratch + (bc * groups + g) * Q * (Q + N);  // [Q][Q]
  float* dbs = dcb + Q * Q;                                // [Q][N]
  const int tq = (Q + kTile - 1) / kTile, tn = (N + kTile - 1) / kTile;
  const int tp = (hp + kTile - 1) / kTile;
  const int64_t ld = static_cast<int64_t>(nh) * hp;  // row stride of x and dy

  // C B^T on and below the diagonal (tiles ti >= tj)
  for (int ti = 0; ti < tq; ++ti)
    for (int tj = 0; tj <= ti; ++tj) {
      float acc[4][4];
      zero(acc);
      mma_tile<false, false>(
          acc, st, kTile * ti, kTile * tj, Q, Q, 0, N,
          [=](int i, int n) { return Cc[i * N + n]; },
          [=](int n, int j) { return Bc[j * N + n]; });
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = kTile * ti + 4 * ty + r, j = kTile * tj + 4 * tx + c;
          if (i < Q && j < Q) cbs[i * Q + j] = acc[r][c];
        }
    }

  for (int h = h_begin; h < h_end; ++h) {
    const bool first = h == h_begin;
    const T* xh = x + bc * Q * ld + static_cast<int64_t>(h) * hp;
    const float* dyh = dy + bc * Q * ld + static_cast<int64_t>(h) * hp;
    const float* dsh = dstate + (bc * nh + h) * hp * N;
    __syncthreads();  // the last head is done with the vectors
    for (int j = tid; j < Q; j += kThreads) {
      segs[j] = seg[(bc * Q + j) * nh + h];
      dts[j] = dt[(bc * Q + j) * nh + h];
    }
    __syncthreads();
    const float seg_last = segs[Q - 1];
    for (int j = tid; j < Q; j += kThreads) {
      es[j] = expf(seg_last - segs[j]);
      ws[j] = es[j] * dts[j];
    }
    // (the first mma_tile below syncs before anything reads es or ws)

    // dM = dy x^T on and below the diagonal; K = dM CB L, dCB += dM L dt_j
    for (int ti = 0; ti < tq; ++ti)
      for (int tj = 0; tj <= ti; ++tj) {
        float acc[4][4];
        zero(acc);
        mma_tile<false, false>(
            acc, st, kTile * ti, kTile * tj, Q, Q, 0, hp,
            [=](int i, int p) { return dyh[i * ld + p]; },
            [=](int p, int j) { return widen(xh[j * ld + p]); });
        float rsum[4] = {0.0f, 0.0f, 0.0f, 0.0f}, csum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = kTile * ti + 4 * ty + r, j = kTile * tj + 4 * tx + c;
            if (i < Q && j <= i) {
              const float l = expf(segs[i] - segs[j]);
              const float k = acc[r][c] * cbs[i * Q + j] * l;
              rsum[r] += k * dts[j];
              csum[c] += k;
              const float d = acc[r][c] * l * dts[j];
              dcb[i * Q + j] = first ? d : dcb[i * Q + j] + d;
            }
          }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = sum_over_tx(rsum[r]);
          const int i = kTile * ti + 4 * ty + r;
          if (tx == 0 && i < Q) rowp[tj * kMaxDim + i] = v;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float v = csum[c] + __shfl_xor_sync(0xffffffffu, csum[c], 16);
          const int j = kTile * tj + 4 * tx + c;
          if (lane < 16 && j < Q) colp[(ti * kWarps + warp) * kMaxDim + j] = v;
        }
      }

    // R = x dS (Q x N): dBs += w_j R_j, dw_j = B_j . R_j
    for (int tj = 0; tj < tq; ++tj)
      for (int tb = 0; tb < tn; ++tb) {
        float acc[4][4];
        zero(acc);
        mma_tile<false, true>(
            acc, st, kTile * tj, kTile * tb, Q, N, 0, hp,
            [=](int j, int p) { return widen(xh[j * ld + p]); },
            [=](int p, int n) { return dsh[p * N + n]; });
        float rsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = kTile * tj + 4 * ty + r, n = kTile * tb + 4 * tx + c;
            if (j < Q && n < N) {
              rsum[r] += Bc[j * N + n] * acc[r][c];
              const float d = ws[j] * acc[r][c];
              dbs[j * N + n] = first ? d : dbs[j * N + n] + d;
            }
          }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = sum_over_tx(rsum[r]);
          const int j = kTile * tj + 4 * ty + r;
          if (tx == 0 && j < Q) dwp[tb * kMaxDim + j] = v;
        }
      }

    // dx = M^T dy + (w B) dS^T, M formed as it is staged
    for (int tj = 0; tj < tq; ++tj)
      for (int tpp = 0; tpp < tp; ++tpp) {
        float acc[4][4];
        zero(acc);
        mma_tile<false, true>(
            acc, st, kTile * tj, kTile * tpp, Q, hp, kTile * tj, Q,
            [=](int j, int i) {
              return i >= j ? cbs[i * Q + j] * expf(segs[i] - segs[j]) * dts[j] : 0.0f;
            },
            [=](int i, int p) { return dyh[i * ld + p]; });
        mma_tile<false, false>(
            acc, st, kTile * tj, kTile * tpp, Q, hp, 0, N,
            [=](int j, int n) { return ws[j] * Bc[j * N + n]; },
            [=](int n, int p) { return dsh[p * N + n]; });
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = kTile * tj + 4 * ty + r, p = kTile * tpp + 4 * tx + c;
            if (j < Q && p < hp) narrow(dx + (bc * Q + j) * ld + static_cast<int64_t>(h) * hp + p,
                                        acc[r][c]);
          }
      }
    // (mma_tile ended in step: rowp, colp and dwp are complete)

    for (int j = tid; j < Q; j += kThreads) {
      float rowk = 0.0f, colk = 0.0f, dw = 0.0f;
      for (int t = 0; t <= j / kTile; ++t) rowk += rowp[t * kMaxDim + j];
      for (int s = (j / kTile) * kWarps; s < tq * kWarps; ++s) colk += colp[s * kMaxDim + j];
      for (int t = 0; t < tn; ++t) dw += dwp[t * kMaxDim + j];
      ddt[(bc * Q + j) * nh + h] = colk + dw * es[j];
      dsegs[j] = rowk - dts[j] * colk - dw * ws[j];
      dwp[j] = dw * ws[j];  // read below, after the sync; dwp's slots are spent
    }
    __syncthreads();
    for (int j = tid; j < Q; j += kThreads) {
      float v = dsegs[j];
      if (j == Q - 1) {  // seg_last's terms: sum_j dw_j w_j and the decay's
        float last = ddecay[bc * nh + h] * expf(seg_last);
        for (int i = 0; i < Q; ++i) last += dwp[i];
        v += last;
      }
      dseg[(bc * Q + j) * nh + h] = v;
    }
  }
}

// dC = dCB B and dB = dCB^T C + dBs, with dCB and dBs summed over the groups
// in order. blockIdx.x: the output tiles of dC, then those of dB.
__global__ void __launch_bounds__(kThreads) ssd_bwd_bc_kernel(
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ scratch, float* __restrict__ dbm, float* __restrict__ dcm, int nc,
    int Q, int N, int groups) {
  __shared__ __align__(16) Stage st;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t bc = static_cast<int64_t>(blockIdx.z) * nc + blockIdx.y;
  const int tq = (Q + kTile - 1) / kTile, tn = (N + kTile - 1) / kTile;
  const bool is_db = blockIdx.x >= tq * tn;
  const int tile = is_db ? blockIdx.x - tq * tn : blockIdx.x;
  const int m0 = kTile * (tile / tn), n0 = kTile * (tile % tn);
  const float* Bc = bm + bc * Q * N;
  const float* Cc = cm + bc * Q * N;
  const float* part = scratch + bc * groups * Q * (Q + N);
  const int64_t stride = static_cast<int64_t>(Q) * (Q + N);  // between groups
  auto dcb = [=](int i, int j) {  // sum over groups of dC B^T at i >= j
    float v = 0.0f;
    for (int g = 0; g < groups; ++g) v += part[g * stride + i * Q + j];
    return v;
  };
  float acc[4][4];
  zero(acc);
  if (!is_db) {  // dC_i = sum_{j <= i} dCB_ij B_j
    mma_tile<false, true>(
        acc, st, m0, n0, Q, N, 0, min(Q, m0 + kTile),
        [=](int i, int j) { return j <= i ? dcb(i, j) : 0.0f; },
        [=](int j, int n) { return Bc[j * N + n]; });
  } else {       // dB_j = sum_{i >= j} dCB_ij C_i + dBs_j
    mma_tile<true, true>(
        acc, st, m0, n0, Q, N, m0, Q,
        [=](int j, int i) { return i >= j ? dcb(i, j) : 0.0f; },
        [=](int i, int n) { return Cc[i * N + n]; });
  }
  float* out = (is_db ? dbm : dcm) + bc * Q * N;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = m0 + 4 * ty + r, n = n0 + 4 * tx + c;
      if (m < Q && n < N) {
        float v = acc[r][c];
        if (is_db)
          for (int g = 0; g < groups; ++g) v += part[g * stride + Q * Q + m * N + n];
        out[m * N + n] = v;
      }
    }
}

template <typename T>
int launch(const T* x, const float* dt, const float* seg, const float* bm, const float* cm,
           const float* dy, const float* dstate, const float* ddecay, T* dx, float* ddt,
           float* dseg, float* dbm, float* dcm, float* scratch, int batch, int nc, int Q, int nh,
           int hp, int N, int heads_per_block, int limit, cudaStream_t stream) {
  const int bytes = HeadsLayout(Q).total * static_cast<int>(sizeof(float));
  if (bytes > limit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ssd_bwd_heads_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (nh + heads_per_block - 1) / heads_per_block;
  kernel<<<dim3(groups, nc, batch), kThreads, bytes, stream>>>(
      x, dt, seg, bm, cm, dy, dstate, ddecay, dx, ddt, dseg, scratch, nc, Q, nh, hp, N,
      heads_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((Q + kTile - 1) / kTile) * ((N + kTile - 1) / kTile);
  ssd_bwd_bc_kernel<<<dim3(2 * tiles, nc, batch), kThreads, 0, stream>>>(
      bm, cm, scratch, dbm, dcm, nc, Q, N, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for sizes the kernels do not take (Q, hp or N
// outside 1..128, or a shared-memory need above the card's opt-in limit).
// `scratch` holds batch * nc * ceil(nh / heads_per_block) * Q * (Q + N)
// floats. The wrapper has checked shapes, dtypes and contiguity.
extern "C" int ssd_intra_chunk_bwd_launch(
    const void* x, int x_is_bf16, const float* dt, const float* seg, const float* bm,
    const float* cm, const float* dy, const float* dstate, const float* ddecay, void* dx,
    float* ddt, float* dseg, float* dbm, float* dcm, float* scratch, int batch, int nc, int Q,
    int nh, int hp, int N, int heads_per_block, void* stream) {
  if (Q < 1 || Q > kMaxDim || hp < 1 || hp > kMaxDim || N < 1 || N > kMaxDim || nh < 1 ||
      heads_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), dt, seg, bm, cm, dy, dstate, ddecay,
                  static_cast<__nv_bfloat16*>(dx), ddt, dseg, dbm, dcm, scratch, batch, nc, Q,
                  nh, hp, N, heads_per_block, limit, s);
  return launch(static_cast<const float*>(x), dt, seg, bm, cm, dy, dstate, ddecay,
                static_cast<float*>(dx), ddt, dseg, dbm, dcm, scratch, batch, nc, Q, nh, hp, N,
                heads_per_block, limit, s);
}
