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
//   e_j   = exp(seg_last - seg_j), w_j = e_j dt_j, T = B dS^T (Q x hp)
//   dx_j  = sum_{i>=j} M_ij dy_i + w_j T_j
//   K_ij  = (dy_i . x_j) CB_ij L_ij,  dw_j = x_j . T_j
//   ddt_j = sum_i K_ij + dw_j e_j
//   dseg_j = sum_i' K_ji' dt_i' - dt_j sum_i K_ij - dw_j w_j
//            (+ sum_j dw_j w_j + ddecay exp(seg_last) at j = last)
//   dCB_ij = sum_h (dy_i . x_j) L_ij dt_j,  dC = dCB B,  dB = dCB^T C + sum_h w_j (x dS)_j
// Layouts, all contiguous: x, dx, dy (B,nc,Q,nh,hp); dt, seg, ddt, dseg
// (B,nc,Q,nh); B, C, dB, dC (B,nc,Q,N); dS (B,nc,nh,hp,N); ddecay (B,nc,nh).
//
// Two kernels, no atomics, so that runs repeat bit for bit:
//   * ssd_bwd_heads_kernel, one block per (b, c, group of heads), writes dx,
//     ddt and dseg, and the group's partial sums over heads of dC B^T and
//     of the state's part of dB into a float32 scratch (B, nc, groups,
//     Q, Q + N), each element updated by one thread in head order;
//   * ssd_bwd_bc_kernel, one block per (b, c, 16-row output strip), sums the
//     groups' partials in a fixed order and forms dC = dCB B and
//     dB = dCB^T C + dBs.
//
// Bound, at zamba2-1.2b's training microbatch (B 4, nc 16, Q 128, nh 64,
// hp 64, N 64, x bf16): each input read once and each output written once
// is 0.35 GB (x 67 MB, dy 134 MB, dS 67 MB, dx 67 MB, the rest 17 MB),
// 0.105 ms at 3.35 TB/s. The products the gradient needs (the lower
// triangles of dy x^T and M^T dy, x dS, B dS^T, C B^T, and dC, dB) are
// 1.75e10 FLOP. At the accuracy the gradient is held to (below), dy x^T
// and C B^T (4.4e9) take 0.066 ms on the float64 tensor cores at 67
// TFLOP/s, and the rest, in the 3xTF32 split on the TF32 tensor cores (3
// products for each float32 one, 2 where one side is the bf16 x), 0.070 ms
// at 495 TFLOP/s. So the operations bound the function, at 0.136 ms.
//
// What the design does about it:
//   * Tensor cores at float32 accuracy: M^T dy, B dS^T, x dS (per head) and
//     dC, dB (per chunk) are mma.sync m16n8k8 TF32 with float32 accumulators
//     in the 3xTF32 split (tc_tf32.cuh); a bf16 x is exact in TF32, so x dS
//     takes two products.
//   * dy x^T and C B^T run in float64 on the tensor cores (mma.sync m8n8k4:
//     exact products, sums to 2^-53), each entry rounded once to float32,
//     the float32 value nearest the exact dot product. Both feed
//     K_ij = dM_ij CB_ij L_ij, whose sums ddt and dseg are small differences
//     of large terms, and the gradient is held to 1e-4 of the closed form
//     evaluated in float64. Float32 dot products of length 64 carry a few
//     ulps of error, and that alone moves ddt by about 1e-4: at the
//     training shape the plain version in float32 (cuBLAS) lies 1.1x the
//     limit from the float64 evaluation, the 3xTF32 version of this kernel
//     (whose tensor cores also truncate each sum) lay 1.56x from it. Rounded
//     once, ddt lies within 0.4x. These two are 25% of the FLOP (47% of the
//     operations bound); the float64 tensor cores run at 67 TFLOP/s.
//   * Only tiles on or below the diagonal. The block forms C B^T once, as
//     16 x 16 blocks (j, i) with i >= j, and keeps it in shared memory in the
//     accumulator order of a 16 x 8 tile, a float4 a lane. Two warps own
//     each 16-row strip of j, one half of the slab's 64 columns of dx each
//     (the warps of strips w and 7 - w share an SM sub-partition, so each
//     sub-partition has the same share of the triangle; those of strip
//     7 - w, with w + 1 blocks to strip w's 8 - w, also form x dS for both
//     strips, which took 10% off the kernel's time). For each 16 x 16
//     block of its strip, a warp forms S = x_j dy_i^T = dM^T for its half of
//     the 16 i at its lanes' accumulator positions, then, per entry, one exp
//     for L, shared by K, dCB and M; entries above the diagonal are never
//     formed (exp overflows there, and the gradient stays finite where the
//     reference's is NaN). M^T, in the accumulator layout, is the A operand
//     of dx += M^T dy at once (k slot t as column 2t, slot t + 4 as 2t + 1):
//     the two warps swap their halves of it through 1 KB of shared memory
//     (a named barrier of the pair), so M never goes to shared memory whole,
//     and dy x^T and M^T dy read the same staged dy.
//   * Row sums (dw, sum_i K_ij) come from the accumulator fragments through
//     quad shuffles, a slot for each half; column sums (sum_j K_ij dt_j)
//     through shuffles over the fragment's rows into one slot per strip,
//     summed in strip order.
//   * Each head is staged once: dy (float32), x, dS, seg and dt arrive by
//     cp.async into one of two buffers while the last head is multiplied.
//     x, dy and dS are staged 64 columns of hp at a time (a slab), so that
//     hp = 128 fits: the row and column sums add up over a head's slabs.
//   * Shared memory at Q 128, hp 64, N 64, x bf16: C B^T 36 KB, B 34 KB,
//     the M^T swap 8 KB, sum slots 6.5 KB, and two buffers of 70 KB (dy 34,
//     x 18, dS 17): 225 KB, one block of 16 warps an SM (at most 128
//     registers a thread). Two blocks an SM would allow 113 KB each, which
//     holds neither two buffers nor, with one, C B^T, B, dy, x and dS at
//     once. Where two buffers do not fit (N = 128, or a float32 x) the
//     kernel keeps one and loads each head after the last.
//   * Any Q, hp and N from 1 to 128: tiles are zero-padded as they are
//     staged and masked on output; rows whose length is not a multiple of
//     16 bytes are staged without cp.async.
//
// Registers (CUDA 12.8 nvcc -O3 for sm_90a, as chip_smoke.py prints them):
// the heads kernel 128, the cap for 512 threads, spilling 8 bytes (bf16 x)
// or 4 (float32 x); the dC/dB kernel 48. At the training shape it takes
// about 1 ms on an H100 80GB HBM3 at 700 W (PERF.md, kernel table), about
// 7x the bound: one block an SM, issue- and latency-bound.

#include "tc_tf32.cuh"

namespace {

constexpr int kThreads = 512;          // two warps a 16-row strip of Q = 128
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 128;           // largest Q, hp and N
constexpr int kSlab = 64;              // columns of hp staged at a time
constexpr int kHalfTiles = kSlab / 16; // 8-column tiles of a warp's half of a slab
constexpr int kYP = kSlab + 4;         // row pitch of dy (floats): = 4 (mod 32)

struct HeadsLayout {  // shared memory of ssd_bwd_heads_kernel, in bytes
  int QP, mt, blocks;  // Q padded to 16; 16-row strips; 16 x 16 blocks of the triangle
  int NP, XP;          // row pitch of B, C and dS (floats), of x (elements)
  int cb, b, xch, slots, slab, total;    // regions
  int dy, x, ds, vec, slab_bytes;        // offsets inside one slab buffer
  __host__ __device__ HeadsLayout(int Q, int N, int x_bytes, int nbuf) {
    QP = round_up(Q, 16);
    mt = QP / 16;
    blocks = mt * (mt + 1) / 2;
    NP = round_up(N, 32) + 4;                      // = 4 (mod 32)
    XP = x_bytes == 2 ? kSlab + 8 : kSlab + 4;     // 36 or 68 words a row: = 4 (mod 32)
    cb = 0;                                        // blocks x 256 floats
    b = cb + blocks * 256 * 4;                     // [QP][NP]
    xch = b + QP * NP * 4;                         // M^T halves [mt][2][128]
    slots = xch + mt * 256 * 4;  // rowK [mt][QP], colK [2][QP] (float64), dw [2][QP], dw w [QP], 4 more
    slab = slots + (mt + 7) * QP * 4 + 16;
    dy = 0;                                        // [QP][kYP]
    x = dy + QP * kYP * 4;                         // [QP][XP]
    ds = x + QP * XP * x_bytes;                    // [kSlab][NP]
    vec = ds + kSlab * NP * 4;                     // seg, dt [2][QP]
    slab_bytes = vec + 2 * QP * 4;
    const int c_bytes = QP * NP * 4;               // C, while C B^T is formed
    total = slab + (c_bytes > nbuf * slab_bytes ? c_bytes : nbuf * slab_bytes);
  }
};

// two neighbouring values
__device__ __forceinline__ void pair(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void pair(const __nv_bfloat16* p, float& a, float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// d += a b with a held as floats: split in 3xTF32, or exact (a bf16 x) in two
// products against b's halves
template <bool kExact>
__device__ __forceinline__ void mma_a(float (&d)[4], const float (&a)[4], uint32_t bhi0,
                                      uint32_t bhi1, uint32_t blo0, uint32_t blo1) {
  if constexpr (kExact) {
    uint32_t ar[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) ar[r] = __float_as_uint(a[r]);
    mma_tf32(d, ar, blo0, blo1);
    mma_tf32(d, ar, bhi0, bhi1);
  } else {
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) split(a[r], ahi[r], alo[r]);
    mma_3xtf32(d, ahi, alo, bhi0, bhi1, blo0, blo1);
  }
}

// d += a b for one m8n8k4 tile in float64 on the tensor cores: a {row g,
// col t}, b {row t, col g}, d {row g, cols 2t, 2t + 1}
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// a_j . b_i over k < K (a multiple of 4; rows zero-padded) for the rows
// j = g + 8 hr of `a` and i = 2t + c of `b`, at the positions e = 2 hr + c of
// a 16 x 8 accumulator tile: float64 products and sums (exact products, sums
// to 2^-53), rounded once to float32, so that each is the float32 value
// nearest the exact dot product, as the plain version's are
template <typename TA>
__device__ __forceinline__ void dots_f64(float (&out)[4], const TA* a, int a_pitch,
                                         const float* b, int b_pitch, int K, int g, int t) {
  double d[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
  for (int k0 = 0; k0 < K; k0 += 4) {
    const double bv = b[g * b_pitch + k0 + t];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) mma_f64(d[hr], widen(a[(g + 8 * hr) * a_pitch + k0 + t]), bv);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = __double2float_rn(d[e >> 1][e & 1]);
}

// the two warps of strip jt meet (named barrier 1 + jt, 64 threads)
__device__ __forceinline__ void strip_sync(int jt) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + jt) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_heads_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ seg,
    const float* __restrict__ bm, const float* __restrict__ cm, const float* __restrict__ dy,
    const float* __restrict__ dstate, const float* __restrict__ ddecay, T* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dseg, float* __restrict__ scratch, int nc,
    int Q, int nh, int hp, int N, int heads_per_block, int nbuf, bool vec_bc, bool vec_x,
    bool vec_dy, bool vec_ds) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kExactX = sizeof(T) == 2;  // a bf16 x is exact in TF32
  const HeadsLayout lay(Q, N, sizeof(T), nbuf);
  const int QP = lay.QP, mt = lay.mt, NP = lay.NP, XP = lay.XP;
  float* cbp = reinterpret_cast<float*>(smem_raw + lay.cb);   // packed C B^T blocks
  float* bs = reinterpret_cast<float*>(smem_raw + lay.b);     // [QP][NP]
  float* xch = reinterpret_cast<float*>(smem_raw + lay.xch);  // [mt][2][128]: M^T halves
  float* rowks = reinterpret_cast<float*>(smem_raw + lay.slots);  // [mt][QP]
  double* colks = reinterpret_cast<double*>(rowks + mt * QP);  // [2][QP]: sum_i K_ij, by half
  float* dws = reinterpret_cast<float*>(colks + 2 * QP);          // [2][QP]: dw_j, by half
  float* dwws = dws + 2 * QP;      // dw_j w_j
  float* last_part = dwws + QP;    // dseg at j = last before seg_last's terms
  unsigned char* slab0 = smem_raw + lay.slab;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row and column
  const int groups = gridDim.x;
  const int64_t bc = static_cast<int64_t>(blockIdx.z) * nc + blockIdx.y;
  const int h_begin = blockIdx.x * heads_per_block;
  const int h_end = min(nh, h_begin + heads_per_block);
  const int Nc = round_up(N, 8);
  const int64_t ld = static_cast<int64_t>(nh) * hp;  // row stride of x, dy and dx
  float* dcb = scratch + (bc * groups + blockIdx.x) * Q * (Q + N);  // [Q][Q] at (i, j), i >= j
  float* dbs = dcb + Q * Q;                                         // [Q][N]

  // B (kept) and C (only while C B^T is formed), zero-padded
  float* cs = reinterpret_cast<float*>(slab0);
  stage<kThreads, float>(bs, NP, bm + bc * Q * N, N, Q, N, QP, Nc, vec_bc);
  stage<kThreads, float>(cs, NP, cm + bc * Q * N, N, Q, N, QP, Nc, vec_bc);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // C B^T over the 16 x 16 blocks (jt, ib >= jt), in order of jt then ib,
  // each as two 16 x 8 halves, stored as the accumulators of a 16 x 8 tile
  // (rows j, columns i) would hold it: value (j, i) of half u at
  // u * 128 + lane * 4 + e; each entry the float32 value nearest the exact
  // C_i . B_j (dots_f64; see the header)
  for (int u = warp; u < 2 * lay.blocks; u += kWarps) {
    int jt = 0, rem = u / 2;
    while (rem >= mt - jt) rem -= mt - jt++;
    const int j0 = 16 * jt, i0 = 16 * (jt + rem) + 8 * (u % 2);
    float v[4];
    dots_f64(v, bs + j0 * NP, NP, cs + i0 * NP, NP, Nc, g, t);
    *reinterpret_cast<float4*>(cbp + u * 128 + lane * 4) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();  // C is spent: its space holds the slab buffers from here on

  // a slab: head h, columns p0 .. p0 + pw of hp (dy, x and the rows of dS),
  // and the head's seg and dt
  const int nslab = (hp + kSlab - 1) / kSlab;
  const int slabs = (h_end - h_begin) * nslab;
  auto load_slab = [&](int s, int buf) {
    const int h = h_begin + s / nslab, p0 = kSlab * (s % nslab), pw = min(kSlab, hp - p0);
    unsigned char* base = slab0 + buf * lay.slab_bytes;
    const int64_t at = bc * Q * ld + static_cast<int64_t>(h) * hp + p0;
    stage<kThreads, float>(reinterpret_cast<float*>(base + lay.dy), kYP, dy + at, ld, Q, pw,
                           QP, round_up(pw, 8), vec_dy);
    stage<kThreads, T>(reinterpret_cast<T*>(base + lay.x), XP, x + at, ld, Q, pw, QP,
                       round_up(pw, 8), vec_x);
    stage<kThreads, float>(reinterpret_cast<float*>(base + lay.ds), NP,
                           dstate + ((bc * nh + h) * hp + p0) * N, N, pw, N, round_up(pw, 8),
                           Nc, vec_ds);
    float* sv = reinterpret_cast<float*>(base + lay.vec);
    for (int j = tid; j < QP; j += kThreads) {
      const bool valid = j < Q;
      const int64_t v = valid ? (bc * Q + j) * nh + h : 0;
      cp_async4(sv + j, seg + v, valid);
      cp_async4(sv + QP + j, dt + v, valid);
    }
  };

  // two warps a strip of 16 rows of j (warps w and w + 4 of each half share
  // an SM sub-partition and own strips w and 7 - w, so each sub-partition
  // has the same share of the triangle); `half` picks the warp's 32 columns
  // of the slab for dx and its half of each 16 x 16 block's i
  const int w8 = warp % 8, half = warp / 8;
  const int jt = w8 < 4 ? w8 : 11 - w8;
  const int j0 = 16 * jt;
  int blk0 = 0;                                // the strip's first block in C B^T's order
  for (int s = 0; s < jt; ++s) blk0 += mt - s;
  const int ntn = (N + 7) / 8;                 // 8-column tiles of N, and this half's
  const int tn_begin = half * ((ntn + 1) / 2), tn_end = min(ntn, tn_begin + (ntn + 1) / 2);

  load_slab(0, 0);
  cp_async_commit();
  for (int s = 0; s < slabs; ++s) {
    __syncthreads();  // the previous slab is done with every buffer and slot
    const int buf = nbuf == 2 ? s & 1 : 0;
    if (nbuf == 2 && s + 1 < slabs) load_slab(s + 1, buf ^ 1);  // overlaps this slab
    if (nbuf == 1 && s > 0) load_slab(s, 0);
    cp_async_commit();
    if (nbuf == 2) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();

    const int h = h_begin + s / nslab, p0 = kSlab * (s % nslab), pw = min(kSlab, hp - p0);
    const bool first = s == 0;                    // the block's first write of its partials
    const bool head_first = s % nslab == 0, head_last = s % nslab == nslab - 1;
    const unsigned char* base = slab0 + buf * lay.slab_bytes;
    const float* dys = reinterpret_cast<const float*>(base + lay.dy);
    const T* xs = reinterpret_cast<const T*>(base + lay.x);
    const float* dss = reinterpret_cast<const float*>(base + lay.ds);
    const float* segs = reinterpret_cast<const float*>(base + lay.vec);
    const float* dts = segs + QP;
    const float seg_last = segs[Q - 1];
    const int ntp = (pw + 7) / 8;                 // 8-column tiles (and k steps) of the slab
    const int tp0 = kHalfTiles * half;            // this warp's first column tile

    if (jt < mt) {
      float seg_r[2], dt_r[2], w_r[2];            // this thread's rows j0 + g, j0 + g + 8
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int j = j0 + g + 8 * hr;
        seg_r[hr] = segs[j];
        dt_r[hr] = dts[j];
        w_r[hr] = j < Q ? expf(seg_last - seg_r[hr]) * dt_r[hr] : 0.0f;
      }

      // T = B dS^T over the strip and this half's columns (k over N); dx
      // starts as w_j T_j. Each k step's products start from zero and are
      // added in float32: the tensor cores round each sum toward zero, and
      // over N = 128 such a chain moved dw = x . T by up to 1e-4
      float acc[kHalfTiles][4];
#pragma unroll
      for (int n = 0; n < kHalfTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
      for (int k0 = 0; k0 < Nc; k0 += 8) {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split(bs[(j0 + g + 8 * (r & 1)) * NP + k0 + t + 4 * (r >> 1)], ahi[r], alo[r]);
#pragma unroll
        for (int n = 0; n < kHalfTiles; ++n) {
          if (tp0 + n < ntp) {
            const float* d0 = dss + (8 * (tp0 + n) + g) * NP + k0 + t;
            uint32_t bhi0, blo0, bhi1, blo1;
            split(d0[0], bhi0, blo0);
            split(d0[4], bhi1, blo1);
            float step[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_3xtf32(step, ahi, alo, bhi0, bhi1, blo0, blo1);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] += step[e];
          }
        }
      }
      // dw_j = x_j . T_j over this half's columns, summed over the quad's
      // columns; the halves and the slabs add up in the slots
      float dw_r[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < kHalfTiles; ++n) {
        if (tp0 + n < ntp) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float x0, x1;
            pair(xs + (j0 + g + 8 * hr) * XP + 8 * (tp0 + n) + 2 * t, x0, x1);
            dw_r[hr] += x0 * acc[n][2 * hr] + x1 * acc[n][2 * hr + 1];
          }
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        dw_r[hr] += __shfl_xor_sync(0xffffffffu, dw_r[hr], 1);
        dw_r[hr] += __shfl_xor_sync(0xffffffffu, dw_r[hr], 2);
        float* slot = dws + half * QP + j0 + g + 8 * hr;
        if (t == 0) *slot = head_first ? dw_r[hr] : *slot + dw_r[hr];
#pragma unroll
        for (int n = 0; n < kHalfTiles; ++n) {
          acc[n][2 * hr] *= w_r[hr];
          acc[n][2 * hr + 1] *= w_r[hr];
        }
      }

      // R = x dS over this half's column tiles of N, four at a time (k over
      // the slab's columns, slot t as column 2t and slot t + 4 as 2t + 1, so
      // that x is read in pairs); dBs_j += w_j R_j. At Q = 128 the warps of
      // strip 7 - w (w < 4) take it for both strips of their sub-partition,
      // whose strip w has 8 - w blocks of the triangle to their w + 1
      for (int pass = 0; pass < 2; ++pass) {
        const int js = pass == 0 ? jt : 7 - jt;  // the strip whose rows
        if (mt == 8 ? jt < 4 : pass == 1) continue;
        const int r0 = 16 * js;
        float wp[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int j = r0 + g + 8 * hr;
          wp[hr] = js == jt ? w_r[hr] : (j < Q ? expf(seg_last - segs[j]) * dts[j] : 0.0f);
        }
        for (int tb = tn_begin; tb < tn_end; tb += 4) {
          float racc[4][4], old[4][4];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = r0 + g + 8 * (e >> 1), col = 8 * (tb + n) + 2 * t + (e & 1);
              racc[n][e] = 0.0f;
              old[n][e] =
                  !first && tb + n < tn_end && j < Q && col < N ? dbs[j * N + col] : 0.0f;
            }
          }
          for (int k0 = 0; k0 < 8 * ntp; k0 += 8) {
            float a[4];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr)
              pair(xs + (r0 + g + 8 * hr) * XP + k0 + 2 * t, a[hr], a[2 + hr]);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              if (tb + n < tn_end) {
                const float* d0 = dss + (k0 + 2 * t) * NP + 8 * (tb + n) + g;
                uint32_t bhi0, blo0, bhi1, blo1;
                split(d0[0], bhi0, blo0);
                split(d0[NP], bhi1, blo1);
                mma_a<kExactX>(racc[n], a, bhi0, bhi1, blo0, blo1);
              }
            }
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = r0 + g + 8 * (e >> 1), col = 8 * (tb + n) + 2 * t + (e & 1);
              if (tb + n < tn_end && j < Q && col < N)
                dbs[j * N + col] = old[n][e] + wp[e >> 1] * racc[n][e];
            }
          }
        }
      }

      // the strip's blocks on and right of the diagonal. Per block this warp
      // takes the 8 i of its half: S = x_j dy_i^T (= dM^T), then K, dCB and
      // M^T from one exp an entry; the two warps swap their M^T halves, and
      // each adds M^T dy to its columns of dx
      double colk[2] = {0.0, 0.0};  // in float64: the exact sum of these K
      float* mine = xch + (jt * 2 + half) * 128 + lane * 4;
      const float* theirs = xch + (jt * 2 + (half ^ 1)) * 128 + lane * 4;
      for (int ib = jt; ib < mt; ++ib) {
        const int i0 = 16 * ib + 8 * half;      // this warp's 8 i
        float old[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + g + 8 * (e >> 1), i = i0 + 2 * t + (e & 1);
          old[e] = !first && i >= j && i < Q ? dcb[i * Q + j] : 0.0f;
        }
        // dM_ij = dy_i . x_j, the float32 value nearest the exact product
        float sv[4];
        dots_f64(sv, xs + j0 * XP, XP, dys + i0 * kYP, kYP, 8 * ntp, g, t);
        const float4 cb4 =
            *reinterpret_cast<const float4*>(cbp + (blk0 + ib - jt) * 256 + half * 128 + lane * 4);
        const float cbv[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
        float m[4], rk[2] = {0.0f, 0.0f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, j = j0 + g + 8 * hr, i = i0 + 2 * t + (e & 1);
          const bool on = i >= j && i < Q;
          const float l = on ? expf(segs[i] - seg_r[hr]) : 0.0f;
          const float ldt = l * dt_r[hr];
          const float k = sv[e] * cbv[e] * l;
          colk[hr] += k;
          rk[e & 1] += k * dt_r[hr];
          if (on) dcb[i * Q + j] = old[e] + sv[e] * ldt;
          m[e] = cbv[e] * ldt;                                  // M_ij
        }
        // sum_j K_ij dt_j over the warp's rows, into the strip's slot
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          rk[c] += __shfl_xor_sync(0xffffffffu, rk[c], 4);
          rk[c] += __shfl_xor_sync(0xffffffffu, rk[c], 8);
          rk[c] += __shfl_xor_sync(0xffffffffu, rk[c], 16);
          float* slot = rowks + jt * QP + i0 + 2 * t + c;
          if (g == 0) *slot = head_first ? rk[c] : *slot + rk[c];
        }
        *reinterpret_cast<float4*>(mine) = make_float4(m[0], m[1], m[2], m[3]);
        strip_sync(jt);  // both halves of M^T are in place
        const float4 o4 = *reinterpret_cast<const float4*>(theirs);
        const float other[4] = {o4.x, o4.y, o4.z, o4.w};
        strip_sync(jt);  // both are read: the next block may overwrite them
        // M^T as the A operand over k = each half's 8 i: a0 (j g, i 2t) is
        // m[0], a1 (g + 8, 2t) m[2], a2 (g, 2t + 1) m[1], a3 m[3]
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          const bool own = kh == half;
          uint32_t mhi[4], mlo[4];
          split(own ? m[0] : other[0], mhi[0], mlo[0]);
          split(own ? m[2] : other[2], mhi[1], mlo[1]);
          split(own ? m[1] : other[1], mhi[2], mlo[2]);
          split(own ? m[3] : other[3], mhi[3], mlo[3]);
          const float* d0 = dys + (16 * ib + 8 * kh + 2 * t) * kYP + 8 * tp0 + g;
#pragma unroll
          for (int n = 0; n < kHalfTiles; ++n) {
            if (tp0 + n < ntp) {
              uint32_t bhi0, blo0, bhi1, blo1;
              split(d0[8 * n], bhi0, blo0);
              split(d0[8 * n + kYP], bhi1, blo1);
              mma_3xtf32(acc[n], mhi, mlo, bhi0, bhi1, blo0, blo1);
            }
          }
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        colk[hr] += __shfl_xor_sync(0xffffffffu, colk[hr], 1);
        colk[hr] += __shfl_xor_sync(0xffffffffu, colk[hr], 2);
        double* slot = colks + half * QP + j0 + g + 8 * hr;
        if (t == 0) *slot = head_first ? colk[hr] : *slot + colk[hr];
      }

      // dx of the strip's rows and this warp's columns of the slab
      const bool pairs = hp % 2 == 0;
#pragma unroll
      for (int n = 0; n < kHalfTiles; ++n) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int j = j0 + g + 8 * hr, c = 8 * (tp0 + n) + 2 * t;
          if (tp0 + n < ntp && j < Q && c < pw) {
            T* out = dx + (bc * Q + j) * ld + static_cast<int64_t>(h) * hp + p0 + c;
            if (pairs) {
              store2(out, acc[n][2 * hr], acc[n][2 * hr + 1]);
            } else {
              store(out, acc[n][2 * hr]);
              if (c + 1 < pw) store(out + 1, acc[n][2 * hr + 1]);
            }
          }
        }
      }
    }

    if (head_last) {  // the head's ddt and dseg from the slots
      __syncthreads();
      for (int j = tid; j < Q; j += kThreads) {
        float rowk = 0.0f;
        for (int s2 = 0; s2 <= j / 16; ++s2) rowk += rowks[s2 * QP + j];
        const float colk = static_cast<float>(colks[j] + colks[QP + j]);
        const float dw = dws[j] + dws[QP + j];
        const float e = expf(seg_last - segs[j]), w = e * dts[j];
        ddt[(bc * Q + j) * nh + h] = colk + dw * e;
        dwws[j] = dw * w;
        const float v = rowk - dts[j] * colk - dw * w;
        if (j < Q - 1) dseg[(bc * Q + j) * nh + h] = v;
        else *last_part = v;
      }
      __syncthreads();
      if (warp == 0) {  // seg_last's terms: sum_j dw_j w_j and the decay's
        float v = 0.0f;
        for (int j = lane; j < Q; j += 32) v += dwws[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0)
          dseg[(bc * Q + Q - 1) * nh + h] =
              *last_part + (v + ddecay[bc * nh + h] * expf(seg_last));
      }
    }
  }
}

// dC = dCB B and dB = dCB^T C + dBs, with dCB and dBs summed over the groups
// in order, on the tensor cores in 3xTF32. One block per (b, c, 16-row strip
// of the output); blockIdx.x: the strips of dC, then those of dB. The strip
// of dCB (dC: rows i, columns j <= i; dB: columns j, rows i >= j) is summed
// into shared memory as the A operand, B or C beside it as the B operand.
constexpr int kBcThreads = 128;
constexpr int kBcWarps = kBcThreads / 32;

struct BcLayout {  // shared memory of ssd_bwd_bc_kernel, in bytes
  int QP, mt, AP, OP, op, total;
  __host__ __device__ BcLayout(int Q, int N) {
    QP = round_up(Q, 16);
    mt = QP / 16;
    AP = round_up(QP, 32) + 4;  // A strip [16][AP]: = 4 (mod 32)
    OP = round_up(N, 32) + 8;   // B or C [QP][OP]: = 8 (mod 32)
    op = 16 * AP * 4;
    total = op + QP * OP * 4;
  }
};

__global__ void __launch_bounds__(kBcThreads) ssd_bwd_bc_kernel(
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ scratch, float* __restrict__ dbm, float* __restrict__ dcm, int nc,
    int Q, int N, int groups, bool vec_bc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BcLayout lay(Q, N);
  const int AP = lay.AP, OP = lay.OP, Nc = round_up(N, 8);
  float* as = reinterpret_cast<float*>(smem_raw);            // [16][AP]
  float* os = reinterpret_cast<float*>(smem_raw + lay.op);   // [QP][OP]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bool is_db = blockIdx.x >= lay.mt;
  const int m0 = 16 * (is_db ? blockIdx.x - lay.mt : blockIdx.x);
  const int64_t bc = static_cast<int64_t>(blockIdx.z) * nc + blockIdx.y;
  const float* part = scratch + bc * groups * Q * (Q + N);
  const int64_t stride = static_cast<int64_t>(Q) * (Q + N);  // between groups
  // k runs over j <= i for dC_i, over i >= j for dB_j
  const int k_lo = is_db ? m0 : 0, k_hi = is_db ? lay.QP : m0 + 16, nk = k_hi - k_lo;

  stage<kBcThreads, float>(os + k_lo * OP, OP, (is_db ? cm : bm) + bc * Q * N + k_lo * N, N,
                           min(Q, k_hi) - k_lo, N, nk, Nc, vec_bc);
  cp_async_commit();
  for (int e = tid; e < 16 * nk; e += kBcThreads) {  // the strip of dCB, 0 above the diagonal
    const int r = is_db ? e % 16 : e / nk, k = k_lo + (is_db ? e / 16 : e % nk);
    const int i = is_db ? k : m0 + r, j = is_db ? m0 + r : k;
    float v = 0.0f;
    if (i < Q && j <= i)
      for (int gr = 0; gr < groups; ++gr) v += part[gr * stride + i * Q + j];
    as[r * AP + k] = v;
  }
  cp_async_wait<0>();
  __syncthreads();

  float* out = (is_db ? dbm : dcm) + bc * Q * N;
  for (int nt = warp; nt < Nc / 8; nt += kBcWarps) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
      uint32_t ahi[4], alo[4], bhi[2], blo[2];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split(as[(g + 8 * (r & 1)) * AP + k0 + t + 4 * (r >> 1)], ahi[r], alo[r]);
#pragma unroll
      for (int r = 0; r < 2; ++r) split(os[(k0 + t + 4 * r) * OP + 8 * nt + g], bhi[r], blo[r]);
      mma_3xtf32(acc, ahi, alo, bhi[0], bhi[1], blo[0], blo[1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + g + 8 * (e >> 1), n = 8 * nt + 2 * t + (e & 1);
      if (m < Q && n < N) {
        float v = acc[e];
        if (is_db)
          for (int gr = 0; gr < groups; ++gr) v += part[gr * stride + Q * Q + m * N + n];
        out[m * N + n] = v;
      }
    }
  }
}

template <typename T>
int launch(const T* x, const float* dt, const float* seg, const float* bm, const float* cm,
           const float* dy, const float* dstate, const float* ddecay, T* dx, float* ddt,
           float* dseg, float* dbm, float* dcm, float* scratch, int batch, int nc, int Q, int nh,
           int hp, int N, int heads_per_block, int limit, cudaStream_t stream) {
  int nbuf = 2;
  if (HeadsLayout(Q, N, sizeof(T), 2).total > limit) nbuf = 1;
  const int bytes = HeadsLayout(Q, N, sizeof(T), nbuf).total;
  if (bytes > limit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ssd_bwd_heads_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec_bc = N % 4 == 0 && aligned(bm) && aligned(cm);
  const bool vec_x = hp % (16 / sizeof(T)) == 0 && aligned(x);
  const bool vec_dy = hp % 4 == 0 && aligned(dy);
  const bool vec_ds = N % 4 == 0 && aligned(dstate);
  const int groups = (nh + heads_per_block - 1) / heads_per_block;
  kernel<<<dim3(groups, nc, batch), kThreads, bytes, stream>>>(
      x, dt, seg, bm, cm, dy, dstate, ddecay, dx, ddt, dseg, scratch, nc, Q, nh, hp, N,
      heads_per_block, nbuf, vec_bc, vec_x, vec_dy, vec_ds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const BcLayout bc_lay(Q, N);
  err = cudaFuncSetAttribute(ssd_bwd_bc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bc_lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_bc_kernel<<<dim3(2 * bc_lay.mt, nc, batch), kBcThreads, bc_lay.total, stream>>>(
      bm, cm, scratch, dbm, dcm, nc, Q, N, groups, vec_bc);
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
