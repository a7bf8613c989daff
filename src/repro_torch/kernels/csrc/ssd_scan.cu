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
// Bound: bytes. At the serving path's prefill (B 8, nc 16, Q 128, nh 64,
// hp 64, N 64, x bf16) the kernel moves 553 MB (mostly y and state written
// in float32): 0.165 ms at 3.35 TB/s. Its products (the lower triangles of
// C B^T and of M x, and the state product) are 1.74e10 FLOP; as issued here
// on the TF32 tensor cores (3 products each for C B^T and the state, 2 for
// M x) they take 0.087 ms at 495 TFLOP/s. (On CUDA cores in float32 they
// would take 0.259 ms at 67 TFLOP/s, which bounded the first version.)
//
// What the design does, against the TPU kernel it replaces:
//   * Tensor cores at float32 accuracy. Every product runs as mma.sync
//     m16n8k8 TF32 with float32 accumulation in the 3xTF32 split: an operand
//     a is split once, where it is formed or loaded, into a_hi = tf32(a) and
//     a_lo = tf32(a - a_hi), and a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi.
//     Plain TF32 (one product of rounded operands) is 1e-3 off in relative
//     terms and fails the float32 contract of 1e-4; the split keeps float32
//     accuracy. A bf16 x is exact in TF32, so M x takes two products
//     (M_hi x + M_lo x); a float32 x takes three.
//   * The TPU grid (B, nc, nh) forms C B^T, a Q x Q x N product, once per
//     head, though it is the same for every head. Here a block owns one
//     (b, c) and a group of heads: it forms the lower triangle of C B^T once
//     (16 x 8 tiles on or below the diagonal only) and keeps it in shared
//     memory packed tile by tile in the A-fragment order of the M x product,
//     so each warp reads its fragments with conflict-free 32-float rows.
//   * Per head, M's A fragments are formed in registers from C B^T, seg and
//     dt (one exp per entry) and split there; entries above the diagonal are
//     never computed: exp(seg_i - seg_j) there can overflow to inf, and
//     inf * 0 would be NaN. Output tiles of y (16 rows x 32 columns) are
//     handed to warps in a snake order over the triangle's rows, so that
//     the warps' work is even; the state's tiles go round-robin.
//   * The next head's x, seg and dt arrive by cp.async into a second buffer
//     while the current head is multiplied. x is staged as it arrives (bf16
//     or float32), and C only while C B^T is formed, in the space the x
//     buffers use afterwards. Rows are padded so that the fragment loads of
//     x and B hit 32 banks. At Q 128, N 64, hp 64 a block takes 110 KB of
//     shared memory, so two blocks (16 warps) fit on an SM; where two x
//     buffers do not fit (Q = hp = N = 128, x float32) the kernel keeps one
//     and loads each head after the last.
//   * Any Q, hp and N from 1 to 128: ragged tiles are zero-padded in shared
//     memory and masked on output; rows whose length is not a multiple of
//     16 bytes are loaded without cp.async.
//   * 32 heads share a block's C B^T on the serving path (the wrapper's
//     HEADS_PER_BLOCK): at nh 64 the grid is 256 blocks, one wave of two
//     blocks an SM. The k loops are unrolled by two, so that one step's
//     fragments are formed while the last step's mma run.
//   * Registers (CUDA 12.8 nvcc -O3 for sm_90a, as chip_smoke.py prints
//     them): 123 with a bf16 x, 120 with a float32 x, under the 128 that two
//     blocks of 256 threads an SM allow; no spills.

#include "tc_tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 128;  // largest Q, hp and N
constexpr int kGroup = 4;     // 8-column output tiles per warp unit

struct Layout {  // shared-memory carve-up, in bytes
  int QP;        // Q padded to 16 rows
  int mt, nt;    // 16-row tiles and 8-column tiles of the Q x Q triangle
  int tiles;     // 16 x 8 tiles of C B^T on or below the diagonal
  int NP, CP, XP;  // row pitches of B and C (floats) and of x (elements)
  int bs, r0, xbuf, vec, total;
  __host__ __device__ Layout(int Q, int N, int hp, int x_bytes, int nbuf) {
    QP = round_up(Q, 16);
    mt = QP / 16;
    nt = (Q + 7) / 8;
    tiles = mt * (mt + 1) - (2 * mt - nt);
    NP = round_up(N, 32) + 8;  // = 8 (mod 32): B fragments of the state hit 32 banks
    CP = round_up(N, 32) + 4;  // = 4 (mod 32): A fragments of C B^T hit 32 banks
    XP = x_bytes == 2 ? round_up(hp, 16) + 8 : round_up(hp, 32) + 8;
    bs = tiles * 128 * 4;
    r0 = bs + QP * NP * 4;
    xbuf = QP * XP * x_bytes;
    const int c_bytes = QP * CP * 4;
    vec = r0 + (c_bytes > nbuf * xbuf ? c_bytes : nbuf * xbuf);
    total = vec + 2 * 2 * QP * 4;  // seg and dt, two buffers
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_intra_chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ seg,
    const float* __restrict__ bm, const float* __restrict__ cm, float* __restrict__ y,
    float* __restrict__ state, float* __restrict__ decay, int nc, int Q, int nh, int hp,
    int N, int heads_per_block, int nbuf, bool vec_bc, bool vec_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kExactX = sizeof(T) == 2;  // a bf16 x is exact in TF32
  const Layout lay(Q, N, hp, sizeof(T), nbuf);
  const int QP = lay.QP, mt = lay.mt, nt = lay.nt, NP = lay.NP, XP = lay.XP;
  float* cb = reinterpret_cast<float*>(smem_raw);             // packed C B^T tiles
  float* bs = reinterpret_cast<float*>(smem_raw + lay.bs);    // [QP][NP]
  float* cs = reinterpret_cast<float*>(smem_raw + lay.r0);    // [QP][CP], then x
  float* vecs = reinterpret_cast<float*>(smem_raw + lay.vec);  // [2][seg QP, dt QP]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row and column
  const int64_t bc = static_cast<int64_t>(blockIdx.z) * nc + blockIdx.y;
  const int h_begin = blockIdx.x * heads_per_block;
  const int h_end = min(nh, h_begin + heads_per_block);
  const int Nc = round_up(N, 8);

  // B and C of the chunk, zero-padded
  stage<kThreads, float>(bs, NP, bm + bc * Q * N, N, Q, N, QP, Nc, vec_bc);
  stage<kThreads, float>(cs, lay.CP, cm + bc * Q * N, N, Q, N, QP, Nc, vec_bc);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // C B^T on and below the diagonal, 3xTF32, one 16 x 8 tile per warp at a
  // time; stored in the A-fragment order of M x: value (r, c) of tile T at
  // T * 128 + (r / 8 + 2 (c / 4)) * 32 + (r % 8) * 4 + c % 4
  for (int tile = warp; tile < lay.tiles; tile += kWarps) {
    int i = 0;
    while ((i + 1) * (i + 2) <= tile) ++i;
    const int j = tile - i * (i + 1);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < Nc; k0 += 8) {
      uint32_t ahi[4], alo[4], bhi[2], blo[2];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split(cs[(16 * i + g + 8 * (r & 1)) * lay.CP + k0 + t + 4 * (r >> 1)], ahi[r], alo[r]);
#pragma unroll
      for (int r = 0; r < 2; ++r) split(bs[(8 * j + g) * NP + k0 + t + 4 * r], bhi[r], blo[r]);
      mma_3xtf32(acc, ahi, alo, bhi[0], bhi[1], blo[0], blo[1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // acc[e] is (row g + 8 (e / 2), column 2 t + e % 2)
      const int r = g + 8 * (e >> 1), c = 2 * t + (e & 1);
      cb[tile * 128 + (r / 8 + 2 * (c / 4)) * 32 + (r % 8) * 4 + c % 4] = acc[e];
    }
  }
  __syncthreads();  // C is no longer needed: its space holds x from here on

  // head loads: x rows (zero-padded to QP x round16(hp)), seg and dt
  auto load_head = [&](int h, int buf) {
    T* xs = reinterpret_cast<T*>(smem_raw + lay.r0 + buf * lay.xbuf);
    stage<kThreads, T>(xs, XP, x + (bc * Q * nh + h) * hp, static_cast<int64_t>(nh) * hp, Q, hp, QP,
             round_up(hp, 16), vec_x);
    float* sv = vecs + buf * 2 * QP;
    for (int j = tid; j < QP; j += kThreads) {
      const bool valid = j < Q;
      const int64_t at = valid ? (bc * Q + j) * nh + h : 0;
      cp_async4(sv + j, seg + at, valid);
      cp_async4(sv + QP + j, dt + at, valid);
    }
    cp_async_commit();
  };

  const int ntp = (hp + 7) / 8;                    // 8-column tiles of y
  const int ngy = (ntp + kGroup - 1) / kGroup;     // column groups of y
  const int mtp = (hp + 15) / 16;                  // 16-row tiles of the state
  const int ntn = (N + 7) / 8;                     // 8-column tiles of the state
  const int ngs = (ntn + kGroup - 1) / kGroup;
  const int ksteps = (Q + 7) / 8;                  // k steps of the state product

  load_head(h_begin, 0);
  for (int h = h_begin, k = 0; h < h_end; ++h, ++k) {
    __syncthreads();  // the previous head is done with every buffer
    const int buf = nbuf == 2 ? k & 1 : 0;
    if (nbuf == 2 && h + 1 < h_end) {
      load_head(h + 1, buf ^ 1);  // overlaps this head's products
      cp_async_wait<1>();
    } else {
      if (nbuf == 1 && k > 0) load_head(h, 0);
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* xs = reinterpret_cast<const T*>(smem_raw + lay.r0 + buf * lay.xbuf);
    const float* seg_s = vecs + buf * 2 * QP;
    const float* dt_s = seg_s + QP;
    const float seg_last = seg_s[Q - 1];
    if (tid == 0) decay[bc * nh + h] = expf(seg_last);

    // y = M x over the triangle: units (16-row tile, 4 column tiles), in a
    // snake order from the longest rows down
    const int units_y = mt * ngy;
    for (int round = 0; round * kWarps < units_y; ++round) {
      const int u = round * kWarps + (round % 2 ? kWarps - 1 - warp : warp);
      if (u >= units_y) continue;
      const int i = mt - 1 - u / ngy, grp = u % ngy;
      float acc[kGroup][4];
#pragma unroll
      for (int n = 0; n < kGroup; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
      const int kmax = min(2 * i + 2, nt);
      const float* cbi = cb + i * (i + 1) * 128 + lane;
      const float seg_row[2] = {seg_s[16 * i + g], seg_s[16 * i + g + 8]};
#pragma unroll 2
      for (int kk = 0; kk < kmax; ++kk) {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 16 * i + g + 8 * (r & 1), col = 8 * kk + t + 4 * (r >> 1);
          float mv = 0.0f;
          if (col <= row && row < Q)
            mv = cbi[kk * 128 + r * 32] * __expf(seg_row[r & 1] - seg_s[col]) * dt_s[col];
          split(mv, ahi[r], alo[r]);
        }
        const T* x0 = xs + (8 * kk + t) * XP + g;
        const T* x1 = x0 + 4 * XP;
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          const int pt = kGroup * grp + n;
          if (pt < ntp) {
            const float v0 = widen(x0[8 * pt]), v1 = widen(x1[8 * pt]);
            if (kExactX) {
              mma_tf32(acc[n], alo, __float_as_uint(v0), __float_as_uint(v1));
              mma_tf32(acc[n], ahi, __float_as_uint(v0), __float_as_uint(v1));
            } else {
              uint32_t bhi0, blo0, bhi1, blo1;
              split(v0, bhi0, blo0);
              split(v1, bhi1, blo1);
              mma_3xtf32(acc[n], ahi, alo, bhi0, bhi1, blo0, blo1);
            }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
        const int col = 8 * (kGroup * grp + n) + 2 * t;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = 16 * i + g + 8 * hr;
          if (row < Q && col < hp) {
            float* out = y + ((bc * Q + row) * nh + h) * hp + col;
            if (hp % 2 == 0) {
              *reinterpret_cast<float2*>(out) = make_float2(acc[n][2 * hr], acc[n][2 * hr + 1]);
            } else {
              out[0] = acc[n][2 * hr];
              if (col + 1 < hp) out[1] = acc[n][2 * hr + 1];
            }
          }
        }
      }
    }

    // state = (x w)^T B, w_j = dt_j exp(seg_last - seg_j): units (16 rows of
    // p, 4 column tiles of n), round-robin
    for (int u = warp; u < mtp * ngs; u += kWarps) {
      const int pm = u / ngs, grp = u % ngs;
      float acc[kGroup][4];
#pragma unroll
      for (int n = 0; n < kGroup; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < ksteps; ++kk) {
        float w[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = 8 * kk + t + 4 * c;
          w[c] = j < Q ? dt_s[j] * __expf(seg_last - seg_s[j]) : 0.0f;
        }
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // A[p][j] = x[j][p] w_j
          const int p = 16 * pm + g + 8 * (r & 1), j = 8 * kk + t + 4 * (r >> 1);
          split(widen(xs[j * XP + p]) * w[r >> 1], ahi[r], alo[r]);
        }
        const float* b0 = bs + (8 * kk + t) * NP + g;
        const float* b1 = b0 + 4 * NP;
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          const int ntile = kGroup * grp + n;
          if (ntile < ntn) {
            uint32_t bhi0, blo0, bhi1, blo1;
            split(b0[8 * ntile], bhi0, blo0);
            split(b1[8 * ntile], bhi1, blo1);
            mma_3xtf32(acc[n], ahi, alo, bhi0, bhi1, blo0, blo1);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
        const int col = 8 * (kGroup * grp + n) + 2 * t;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int p = 16 * pm + g + 8 * hr;
          if (p < hp && col < N) {
            float* out = state + ((bc * nh + h) * hp + p) * N + col;
            if (N % 2 == 0) {
              *reinterpret_cast<float2*>(out) = make_float2(acc[n][2 * hr], acc[n][2 * hr + 1]);
            } else {
              out[0] = acc[n][2 * hr];
              if (col + 1 < N) out[1] = acc[n][2 * hr + 1];
            }
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const T* x, const float* dt, const float* seg, const float* bm, const float* cm,
           float* y, float* state, float* decay, int batch, int nc, int Q, int nh, int hp,
           int N, int heads_per_block, int limit, cudaStream_t stream) {
  int nbuf = 2;
  if (Layout(Q, N, hp, sizeof(T), 2).total > limit) nbuf = 1;
  const int bytes = Layout(Q, N, hp, sizeof(T), nbuf).total;
  if (bytes > limit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ssd_intra_chunk_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_bc = N % 4 == 0 && reinterpret_cast<uintptr_t>(bm) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(cm) % 16 == 0;
  const bool vec_x = hp % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((nh + heads_per_block - 1) / heads_per_block, nc, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(x, dt, seg, bm, cm, y, state, decay, nc, Q, nh,
                                            hp, N, heads_per_block, nbuf, vec_bc, vec_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for sizes the kernel does not take (Q, hp or N
// outside 1..128, or a shared-memory need above the card's opt-in limit).
// The wrapper has checked shapes, dtypes and contiguity.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), dt, seg, bm, cm, y, state, decay,
                  batch, nc, Q, nh, hp, N, heads_per_block, limit, s);
  return launch(static_cast<const float*>(x), dt, seg, bm, cm, y, state, decay, batch, nc,
                Q, nh, hp, N, heads_per_block, limit, s);
}
