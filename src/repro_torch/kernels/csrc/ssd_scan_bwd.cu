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
//   * ssd_bwd_heads_kernel, one block per (b, c, group of G heads), writes
//     dx, ddt and dseg, and, once after its last head, the group's sums over
//     its heads of dC B^T and of the state's part of dB into a float32
//     scratch (B, nc, groups, Q, Q + N);
//   * ssd_bwd_bc_kernel, one block per (b, c, 16-row output strip), sums the
//     groups in order and forms dC = dCB B and dB = dCB^T C + dBs with
//     float32 FMAs (1.3e8 FLOP at the training shape).
//
// Bound, at zamba2-1.2b's training microbatch (B 4, nc 16, Q 128, nh 64,
// hp 64, N 64, x bf16): each input read once and each output written once
// is 0.35 GB (x 67 MB, dy 134 MB, dS 67 MB, dx 67 MB, the rest 17 MB),
// 0.105 ms at 3.35 TB/s. The products are, per head, the lower triangles of
// dy x^T and M^T dy, and B dS^T and x dS; per chunk C B^T, dC and dB. Split
// as this kernel issues them: dy x^T and C B^T (4.4e9 FLOP) in float64 on
// the tensor cores, 0.066 ms at 67 TFLOP/s (mma.sync m16n8k8, twice
// m8n8k4's rate: experiments/f64_mma_rates.py); the rest as bf16 wgmma
// products, B dS^T and M^T dy six for each float32 product, x dS three
// (6.5e10 FLOP over M^T dy's triangle; the kernel's whole 64-row tiles
// issue 7.7e10), 0.065 ms at 989 TFLOP/s. The operations bound it, at
// 0.133 ms with dC and dB's FMAs, if the float64 and the bf16 products do
// not overlap (chip_smoke.time_k3_backward).
//
// What the design does about it:
//   * Float32 accuracy from bf16 wgmma, as K3's forward (ssd_scan.cu):
//     wgmma takes .tf32 only K-major, and dy and dS are MN-major operands of
//     M^T dy and x dS. A float32 value is three bf16 parts (hopper.cuh,
//     split3_bf16); a product with one float32 side takes three bf16
//     products, with two the six pairs (p, q) with p + q <= 2. dy's and dS's
//     parts are formed once a head, in shared memory, where they serve as
//     K-major (T = B dS^T) and MN-major (x dS, M^T dy) operands alike; B's
//     parts (T's A operand) and M^T's (M^T dy's) are formed in registers; a
//     bf16 x is the exact K-major A operand of x dS as TMA lands it.
//   * dy x^T and C B^T stay float64 products, each entry rounded once to
//     float32 (ddt and dseg, small differences of large sums, miss the 1e-4
//     float64 contract with float32 products: tests/test_torch_kernel_numerics.py).
//     wgmma has no float64: they run on mma.sync m16n8k8, in 16 x 16 blocks
//     of the triangle, x (or B) as the A operand, its float64 fragments
//     formed once a head for a strip and kept in registers, dy (or C) the B
//     operand, converted where it is read (a float64 copy of dy, 64 KB a
//     head, does not fit in shared memory beside the rest).
//   * Warp specialisation: a producer warpgroup (setmaxnreg 56) and two
//     consumer warpgroups (224; 128 x 56 + 256 x 224 is the launch's 384 x
//     168, and a larger sum hangs setmaxnreg.inc) of 64 rows j each. One
//     producer thread loads a head's x (bf16), dy (float32) and dS (float32,
//     64 columns of N at a time) by TMA on three mbarriers; the producer
//     warpgroup writes dS's and dy's bf16 parts and the head's seg, dt and w
//     and hands them over on named barriers. The next head's x and dS land
//     while this head's products run; dy waits for the float64 products of
//     this one, which read it.
//   * Consumer 0's warp w owns the 16-row strip w of j, consumer 1's warp w
//     the strip 7 - w. Per head a consumer runs T = B dS^T into its
//     accumulators and x dS into a second set (added into the state's part
//     of dB, w_j R_j, which stays in registers over the block's heads, and
//     giving dw_j = B_j . R_j: R's short chains, x exact, hold ddt where
//     x_j . T_j, after T's chain of truncated sums over N 128, did not),
//     scales T by w_j, issues M^T dy's k steps over i (8 and 4 at Q 128, four
//     steps a wgmma group, each step's entries of M^T formed in registers:
//     one exp an entry, a masked entry's exponent -inf, C B^T from shared
//     memory) and stores dx; then each warp forms, for its 16 x 16 blocks,
//     dy_i . x_j in float64, K, the block's dC B^T entries (summed over the
//     heads in shared memory), row sums through shuffles into a slot per
//     strip and column sums in float64 into a slot per block, which phase C
//     adds in a fixed order. The two warps of a sub-partition (strips w and
//     7 - w) share their 9 blocks 4 and 5 (`segment`).
//   * C B^T is formed once a block, the same blocks by the same warps, in
//     float64 from B and C in device memory, and kept in shared memory in
//     the accumulator layout (36 KB).
//   * Partial sums on chip: dC B^T in shared memory and the state's part of
//     dB in registers, summed over the block's heads in head order and
//     written once. G is 32: 128 blocks at the training shape, one wave of
//     one block an SM (225 KB of shared memory), C B^T formed once for 32
//     heads.
//   * hp above 64 runs as two halves (x, dy and the rows of dS), each forming
//     M again; the float64 dy_i . x_j then sums over both halves at the second,
//     reading x and dy from device memory. N above 64 runs as two panels of dS.
//   * Any Q, hp and N from 1 to 128, x bf16 or float32. Where TMA cannot take
//     a row (not a multiple of 16 bytes, a misaligned base) the producer loads
//     with ordinary loads into the same tiles; a float32 x is read from
//     device memory where it is used (its parts formed in registers).
//   * Fixed numerics: no atomics, each output element written once, every
//     sum in a fixed order; two calls give the same bits.
//   * What ptxas needs to keep wgmma asynchronous: no wgmma group spans the
//     branches of a runtime trip count (M^T dy's 8 and 4 steps are
//     compile-time cases, others go a step at a time), and the thread-index
//     arithmetic is not hoisted out of the head loop (see `tq`). Registers:
//     chip_smoke.py's {"resource_usage": ...} line.
//   * Where the time goes (experiments/k3_bwd_phases.py, PERF.md): the
//     float64 products and their per-block K and dC B^T work take the
//     largest share of a head (42%), run after the bf16 products in each
//     consumer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kQT = 128;                    // chunk rows (Q padded)
constexpr int kPC = 64;                     // columns of hp an item takes, of N a dS panel
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kProducerRegs = 56;           // setmaxnreg: 128 x 56 + 256 x 224 = 384 x 168
constexpr int kConsumerRegs = 224;
constexpr int kStrips = kQT / 16;
constexpr int kBlocks = kStrips * (kStrips + 1) / 2;  // 16 x 16 blocks of the triangle
constexpr int kMaxDim = 128;
constexpr int kSplit = 4;         // blocks of strip w that consumer 0's warp w keeps
constexpr float kLog2e = 1.4426950408889634f;
// named barriers (0 is __syncthreads)
constexpr int kBarReadyS = 1;     // a dS panel's parts (and, at the first, x) are ready
constexpr int kBarFreeS = 2;      // the consumers are done with a dS panel's parts
constexpr int kBarReadyB = 3;     // dy's parts are ready
constexpr int kBarFreeB = 4;      // the consumers are done with dy's parts
constexpr int kBarConsumers = 5;  // the consumer warpgroups
constexpr int kBarProducer = 6;   // the producer warpgroup
constexpr int kBarFreeX = 7;      // the consumers are done with x's tile

// pair i of the products of two split operands, smallest first: (A part, B part)
__host__ __device__ constexpr int pair_a(int i) {
  constexpr int a[6] = {2, 1, 0, 1, 0, 0};
  return a[i];
}
__host__ __device__ constexpr int pair_b(int i) {
  constexpr int b[6] = {0, 1, 2, 0, 1, 0};
  return b[i];
}

// shared-memory carve-up, in bytes from the 1024-aligned start
struct Layout {
  int xs, dys, dss, dsp, dyp, cbs, dcbs, vec, slots, bar, total;
  __host__ __device__ explicit Layout(bool x_tile) {
    int o = 0;
    xs = o;
    o += x_tile ? kQT * kPC * 2 : 0;  // x's (128, 64) bf16 tile
    dys = o;
    o += kQT * kPC * 4;               // dy's (128, 64) float32 tile: two panels of 32 columns
    dss = o;
    o += kPC * kPC * 4;               // a (64, 64) panel of dS, float32: two panels of 32
    dsp = o;
    o += 3 * kPC * kPC * 2;           // its three bf16 parts
    dyp = o;
    o += 3 * kQT * kPC * 2;           // dy's three bf16 parts
    cbs = o;
    o += kBlocks * 256 * 4;           // C B^T in the accumulator layout, by block
    dcbs = o;
    o += kBlocks * 256 * 4;           // the heads' sum of dC B^T, the same layout
    vec = o;
    o += 2 * 3 * kQT * 4;             // seg, dt, w of a head, two buffers
    slots = o;  // rowk [strip][i], colk [k step][j] (float64), dw, dw w, last
    o += kStrips * kQT * 4 + kStrips * kQT * 8 + 2 * kQT * 4 + 16;
    bar = o;
    o += 64;
    total = 1024 + o;
  }
};

// the 16 x 16 block (strip js, k step kk >= js) in C B^T's and dC B^T's order
__device__ __forceinline__ int block_index(int js, int kk) {
  return js * kStrips - js * (js - 1) / 2 + kk - js;
}

// element (r, c) of a float32 tile of kQT or 64 rows in panels of 32
// columns (128-byte rows, 128-byte swizzle, as TMA lands it), in floats
__device__ __forceinline__ int f32_at(int rows, int r, int c) {
  return (c >> 5) * rows * 32 + r * 32 + ((((c & 31) >> 2) ^ (r & 7)) << 2) + (c & 3);
}
// element (r, c) of a bf16 tile of 64 columns (tile_offset's layout), in elements
__device__ __forceinline__ int bf16_at(int rows, int r, int c) {
  return tile_offset<64>(rows, r, c) >> 1;
}

// d += a b for one m16n8k8 tile in float64 on the tensor cores: a {rows g,
// g + 8; columns t, t + 4}, b {rows t, t + 4; column g}, d {rows g, g + 8;
// columns 2t, 2t + 1}
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4], double b0,
                                        double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// a_j . b_i in float64 over k < K for the rows j0 + g (+ 8) of `a` and the
// columns i0 + 8 nt + 2t (+ 1) of two 8-column tiles nt of `b`, from loaders
// a(j, k) and b(i, k) that give 0 outside the operands; each entry rounded
// once to float32 (the float32 value nearest the exact dot product): out[nt]
// in the accumulator order of a 16 x 8 tile. (C B^T, and dy x^T where hp
// is above 64; the heads' dy x^T at hp <= 64 goes through `block_dots`.)
template <typename LA, typename LB>
__device__ __forceinline__ void dots_f64(float (&out)[2][4], LA a, LB b, int j0, int i0, int K,
                                         int g, int t) {
  double d[2][4] = {};
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 8) {
    const double av[4] = {a(j0 + g, k0 + t), a(j0 + g + 8, k0 + t), a(j0 + g, k0 + t + 4),
                          a(j0 + g + 8, k0 + t + 4)};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      mma_f64(d[nt], av, b(i0 + 8 * nt + g, k0 + t), b(i0 + 8 * nt + g, k0 + t + 4));
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[nt][e] = __double2float_rn(d[nt][e]);
}

template <typename T>
__device__ __forceinline__ float ldx(const T* p) {
  return to_float(*p);
}

// A warp's float64 operand cache: rows j0 + g, j0 + g + 8 of `a` (a loader
// a(j, k), 0 outside the operand) at the A fragments of 8 k steps of 8
template <typename LA>
__device__ __forceinline__ void load_cache(double (&xa)[8][4], LA a, int j0, int g, int t) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    xa[s][0] = a(j0 + g, 8 * s + t);
    xa[s][1] = a(j0 + g + 8, 8 * s + t);
    xa[s][2] = a(j0 + g, 8 * s + t + 4);
    xa[s][3] = a(j0 + g + 8, 8 * s + t + 4);
  }
}

// dots_f64 over 64 columns with `a` from such a cache: two accumulators a
// tile (even and odd k steps), so that four chains of products are in flight
// (four accumulators spilled and ran slower)
template <typename LB>
__device__ __forceinline__ void block_dots(float (&out)[2][4], const double (&xa)[8][4], LB b,
                                           int i0, int g, int t) {
  double d[2][2][4] = {};
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int i = i0 + 8 * nt + g;
      mma_f64(d[nt][s & 1], xa[s], b(i, 8 * s + t), b(i, 8 * s + t + 4));
    }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[nt][e] = __double2float_rn(d[nt][0][e] + d[nt][1][e]);
}

// The 16 x 16 blocks of the triangle whose float64 products (C B^T once a
// block, dy x^T once a head) a consumer warp forms: segment q (0 or 1) is the
// strip js and its k steps [lo, hi). The two warps of an SM sub-partition,
// consumer 0's warp w (strip w, 8 - w blocks) and consumer 1's (strip 7 - w,
// w + 1), share their 9 blocks 5 and 4: consumer 1's warp also takes strip
// w's blocks from k step w + 5 on.
struct Segment {
  int js, lo, hi;
};
__device__ __forceinline__ Segment segment(int cw, int w, int q, int mt) {
  if (cw == 0) return q == 0 ? Segment{w, w, min(w + kSplit, mt)} : Segment{w, 0, 0};
  return q == 0 ? Segment{kStrips - 1 - w, kStrips - 1 - w, mt} : Segment{w, w + kSplit, mt};
}

// the three bf16 parts of four float32 values of a swizzled float32 tile (rows
// `rows`, columns c .. c + 3 of row r) into three swizzled bf16 tiles
__device__ __forceinline__ void split_chunk(bf16* parts, const float* src, int rows, int r,
                                            int c) {
  const float4 v = *reinterpret_cast<const float4*>(src + f32_at(rows, r, c));
  uint32_t lo[3], hi[3];
  split3_bf16(v.x, v.y, lo[0], lo[1], lo[2]);
  split3_bf16(v.z, v.w, hi[0], hi[1], hi[2]);
  const int at = bf16_at(rows, r, c);
#pragma unroll
  for (int q = 0; q < 3; ++q)
    *reinterpret_cast<uint2*>(parts + q * rows * kPC + at) = make_uint2(lo[q], hi[q]);
}

// NP: panels of 64 columns of N (1 or 2)
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_heads_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
    const __grid_constant__ CUtensorMap tds, const T* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ seg, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ dy,
    const float* __restrict__ dstate, const float* __restrict__ ddecay, T* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dseg, float* __restrict__ scratch, int nc,
    int Q, int nh, int hp, int N, int G, int tma_mask) {
  constexpr bool kBf16 = sizeof(T) == 2;   // a bf16 x has a tile in shared memory
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const Layout lay(kBf16);
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.xs);
  float* dys = reinterpret_cast<float*>(smem + lay.dys);
  float* dss = reinterpret_cast<float*>(smem + lay.dss);
  bf16* dsp = reinterpret_cast<bf16*>(smem + lay.dsp);
  bf16* dyp = reinterpret_cast<bf16*>(smem + lay.dyp);
  float4* cbs = reinterpret_cast<float4*>(smem + lay.cbs);
  float4* dcbs = reinterpret_cast<float4*>(smem + lay.dcbs);
  float* vec = reinterpret_cast<float*>(smem + lay.vec);            // [2][3][kQT]
  float* rowk = reinterpret_cast<float*>(smem + lay.slots);         // [kStrips][kQT]
  double* colk = reinterpret_cast<double*>(rowk + kStrips * kQT);   // [kStrips][kQT]
  float* dws = reinterpret_cast<float*>(colk + kStrips * kQT);      // [kQT]
  float* dwws = dws + kQT;                                          // [kQT]
  float* last_part = dwws + kQT;
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + lay.bar);    // x has landed
  uint64_t* yfull = xfull + 1;                                      // dy has landed
  uint64_t* sfull = xfull + 2;                                      // a dS panel has landed

  const int64_t bc = static_cast<int64_t>(blockIdx.z) * nc + blockIdx.y;
  const int h0 = blockIdx.x * G;
  const int heads = min(G, nh - h0);
  const int halves = (hp + kPC - 1) / kPC;
  const int items = heads * halves;  // (head, half of hp) in order
  const int wg = threadIdx.x / 128;
  const int64_t ld = static_cast<int64_t>(nh) * hp;  // row stride of x, dy and dx

  if (threadIdx.x == 0) {
    mbar_init(xfull, 1);
    mbar_init(yfull, 1);
    mbar_init(sfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: loads each item's tiles, x and dS ahead of the item, and
    // forms dS's and dy's bf16 parts
    regs_dec<kProducerRegs>();
    const int pt = threadIdx.x;
    if (pt == 0) {
      if (tma_mask & 1) prefetch_map(&tx);
      if (tma_mask & 2) prefetch_map(&tdy);
      if (tma_mask & 4) prefetch_map(&tds);
    }
    // x, dy and a dS panel of item it: by TMA (one thread; the bytes land on
    // xfull, yfull and sfull) or, where TMA cannot take the rows, by ordinary
    // loads of every producer thread, zero past Q, hp and N
    auto load_x = [&](int it) {
      if constexpr (kBf16) {
        const int h = h0 + it / halves, p0 = kPC * (it % halves);
        if (tma_mask & 1) {
          if (pt == 0) {
            mbar_arrive_tx(xfull, kQT * kPC * 2);
            for (int r = 0; r < kQT; r += 64)  // a box is 64 rows
              tma_load(xs + r * kPC, &tx, xfull, p0, h, r, static_cast<int>(bc));
          }
        } else {
          for (int e = pt; e < kQT * kPC; e += 128) {
            const int j = e / kPC, c = e % kPC;
            xs[bf16_at(kQT, j, c)] =
                j < Q && p0 + c < hp ? x[(bc * Q + j) * ld + static_cast<int64_t>(h) * hp + p0 + c]
                                     : __float2bfloat16_rn(0.0f);
          }
        }
      }
    };
    auto load_dy = [&](int it) {
      const int h = h0 + it / halves, p0 = kPC * (it % halves);
      if (tma_mask & 2) {
        if (pt == 0) {
          mbar_arrive_tx(yfull, kQT * kPC * 4);
          for (int r = 0; r < kQT; r += 64)
            for (int pc = 0; pc < 2; ++pc)
              tma_load(dys + pc * kQT * 32 + r * 32, &tdy, yfull, p0 + 32 * pc, h, r,
                       static_cast<int>(bc));
        }
      } else {
        for (int e = pt; e < kQT * kPC; e += 128) {
          const int j = e / kPC, c = e % kPC;
          dys[f32_at(kQT, j, c)] =
              j < Q && p0 + c < hp ? dy[(bc * Q + j) * ld + static_cast<int64_t>(h) * hp + p0 + c]
                                   : 0.0f;
        }
      }
    };
    auto load_ds = [&](int it, int np) {
      const int h = h0 + it / halves, p0 = kPC * (it % halves);
      if (tma_mask & 4) {
        if (pt == 0) {
          mbar_arrive_tx(sfull, kPC * kPC * 4);
          for (int pc = 0; pc < 2; ++pc)
            tma_load(dss + pc * kPC * 32, &tds, sfull, kPC * np + 32 * pc, p0, h,
                     static_cast<int>(bc));
        }
      } else {
        const float* src = dstate + ((bc * nh + h) * hp) * N;
        for (int e = pt; e < kPC * kPC; e += 128) {
          const int p = e / kPC, n = e % kPC;
          dss[f32_at(kPC, p, n)] =
              p0 + p < hp && kPC * np + n < N ? src[(p0 + p) * N + kPC * np + n] : 0.0f;
        }
      }
    };
    load_x(0);
    load_ds(0, 0);
    for (int it = 0, xphase = 0, yphase = 0, sphase = 0; it < items; ++it) {
      const int hh = it / halves;
      if (it % halves == 0) {  // the head's seg, dt and w_j = dt_j exp(seg_last - seg_j)
        const int h = h0 + hh;
        float* v = vec + (hh & 1) * 3 * kQT;
        const int64_t at = (bc * Q + pt) * nh + h;
        const float s = pt < Q ? seg[at] : 0.0f, d = pt < Q ? dt[at] : 0.0f;
        const float sl = seg[(bc * Q + Q - 1) * nh + h];
        v[pt] = s;
        v[kQT + pt] = d;
        v[2 * kQT + pt] = pt < Q ? d * exp2_ftz((sl - s) * kLog2e) : 0.0f;
      }
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        if (tma_mask & 4) {
          mbar_wait(sfull, sphase);
          sphase ^= 1;
        }
        if (np == 0 && (tma_mask & 1)) {  // the consumers read x from the first panel on
          mbar_wait(xfull, xphase);
          xphase ^= 1;
        }
        if (it > 0 || np > 0) named_sync(kBarFreeS, kThreads);  // the parts are free
        named_sync(kBarProducer, 128);  // every producer thread's ordinary loads are in place
        for (int e = pt; e < kPC * kPC / 4; e += 128) split_chunk(dsp, dss, kPC, e >> 4, 4 * (e & 15));
        fence_proxy_async();
        named_sync(kBarProducer, 128);  // dss is read: the next panel may land
        if (np + 1 < NP) load_ds(it, np + 1);
        else if (it + 1 < items) load_ds(it + 1, 0);
        named_arrive(kBarReadyS, kThreads);
      }
      if (it > 0) named_sync(kBarFreeB, kThreads);  // the last item's dy and parts are free
      load_dy(it);
      if (tma_mask & 2) {
        mbar_wait(yfull, yphase);
        yphase ^= 1;
      }
      named_sync(kBarProducer, 128);
      for (int e = pt; e < kQT * kPC / 4; e += 128) split_chunk(dyp, dys, kQT, e >> 4, 4 * (e & 15));
      fence_proxy_async();
      named_arrive(kBarReadyB, kThreads);
      if (it + 1 < items) {
        named_sync(kBarFreeX, kThreads);  // the consumers are done with x's tile
        load_x(it + 1);
      }
    }
    return;
  }

  // consumers: consumer cw's warp w owns the 16-row strip js of j (w, or
  // 7 - w for consumer 1) in M^T dy, T and dx, and rows 64 cw + 16 w .. of
  // x dS and the state's part of dB; the float64 products' blocks go by
  // `segment`
  regs_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int ltid = threadIdx.x % 128, ctid = threadIdx.x - 128;
  const int warp = ltid / 32, lane = ltid % 32;
  const int g = lane / 4, t = lane % 4;
  const int js = cw == 0 ? warp : kStrips - 1 - warp;
  const int mt = (Q + 15) / 16;       // strips (and k steps of i) that hold rows
  const int kk_lo = 4 * cw;           // the consumer's first k step of i

  // C B^T of the warp's blocks: CB_ij = B_j . C_i, rows j of B against
  // columns i of C, in float64, rounded once; dC B^T's sums start at zero
  {
    auto bload = [&](int j, int n) {
      return j < Q && n < N ? static_cast<double>(bm[(bc * Q + j) * N + n]) : 0.0;
    };
    auto cload = [&](int i, int n) {
      return i < Q && n < N ? static_cast<double>(cm[(bc * Q + i) * N + n]) : 0.0;
    };
    for (int q = 0; q < 2; ++q) {
      const Segment sg = segment(cw, warp, q, mt);
      if (sg.lo >= sg.hi) continue;
      double ba[8][4];
      if (N <= kPC) load_cache(ba, bload, 16 * sg.js, g, t);
      for (int kk = sg.lo; kk < sg.hi; ++kk) {
        float cb[2][4];
        if (N <= kPC) block_dots(cb, ba, cload, 16 * kk, g, t);
        else dots_f64(cb, bload, cload, 16 * sg.js, 16 * kk, N, g, t);
        const int b = block_index(sg.js, kk);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          cbs[(2 * b + nt) * 32 + lane] = make_float4(cb[nt][0], cb[nt][1], cb[nt][2], cb[nt][3]);
          dcbs[(2 * b + nt) * 32 + lane] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
    }
  }

  float acc[32];        // T, then dx, of the item's 64 columns of hp (rows: the strip's)
  float dbs[NP][32];    // the state's part of dB over the block's heads, by panel of N
#pragma unroll
  for (int np = 0; np < NP; ++np)
#pragma unroll
    for (int e = 0; e < 32; ++e) dbs[np][e] = 0.0f;
  float dwr[2] = {0.0f, 0.0f};      // dw of x dS's rows rn, rn + 8, over the head's halves

  for (int it = 0; it < items; ++it) {
    const int hh = it / halves, h = h0 + hh, ph = it % halves, p0 = kPC * ph;
    const bool last = ph == halves - 1;
    const float* segv = vec + (hh & 1) * 3 * kQT;
    const float* dtv = segv + kQT;
    const float* wv = dtv + kQT;
    // The thread's indices pass through an empty asm at each item, so that
    // the addresses below are computed inside the loop: hoisted out of it,
    // they leave too few registers for wgmma's pipeline (ptxas then
    // serialises every wgmma), as in K3's forward.
    int tq = t, gq = g, wq = warp;
    asm volatile("" : "+r"(tq), "+r"(gq), "+r"(wq));
    const int jsq = cw == 0 ? wq : kStrips - 1 - wq;
    const int jr[2] = {16 * jsq + gq, 16 * jsq + gq + 8};   // the thread's rows j
    const int rn = 64 * cw + 16 * wq + gq;                  // its rows of x dS: rn, rn + 8
    const T* xh = x + bc * Q * ld + static_cast<int64_t>(h) * hp;    // x[j][p] at xh[j * ld + p]
    const float* dyh = dy + bc * Q * ld + static_cast<int64_t>(h) * hp;

    // ---- T = B dS^T and R = x dS, a panel of N at a time
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      // B at the thread's rows j and the panel's k steps (device memory,
      // read while the panel's parts are formed)
      float bv[4][4][2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = jr[r & 1], n = kPC * np + 16 * kk + 8 * (r >> 1) + 2 * tq;
          const float* b = bm + (bc * Q + j) * N + n;
          bv[kk][r][0] = j < Q && n < N ? b[0] : 0.0f;
          bv[kk][r][1] = j < Q && n + 1 < N ? b[1] : 0.0f;
        }
      // B at x dS's rows rn, rn + 8 and accumulator columns, for dw
      float bd[8][2][2];
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int j = rn + 8 * rh, n = kPC * np + 8 * c + 2 * tq;
          const float* b = bm + (bc * Q + j) * N + n;
          bd[c][rh][0] = j < Q && n < N ? b[0] : 0.0f;
          bd[c][rh][1] = j < Q && n + 1 < N ? b[1] : 0.0f;
        }
      named_sync(kBarReadyS, kThreads);
      uint32_t bf[4][3][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split3_bf16(bv[kk][r][0], bv[kk][r][1], bf[kk][0][r], bf[kk][1][r], bf[kk][2][r]);
      float racc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int pr = 0; pr < 6; ++pr)
          wgmma_rs_k<64>(acc, bf[kk][pair_a(pr)], desc_k<64>(dsp + pair_b(pr) * kPC * kPC, kPC, kk),
                         np > 0 || kk > 0 || pr > 0);
      if constexpr (kBf16) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 2; q >= 0; --q)
            wgmma_ss_mn<64>(racc, desc_k<64>(xs + 64 * cw * kPC, kQT, kk),
                            desc_mn<64>(dsp + q * kPC * kPC, kPC, kk), kk > 0 || q < 2);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(bf[kk]);
      if constexpr (!kBf16) {  // a float32 x: its parts as the register A operand
        auto x_item = [&](int j, int c) {  // 0 past Q and hp
          return j < Q && p0 + c < hp ? xh[j * ld + p0 + c] : 0.0f;
        };
        uint32_t xf[4][3][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = rn + 8 * (r & 1), c = 16 * kk + 8 * (r >> 1) + 2 * tq;
            split3_bf16(x_item(j, c), x_item(j, c + 1), xf[kk][0][r], xf[kk][1][r],
                        xf[kk][2][r]);
          }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int pr = 0; pr < 6; ++pr)
            wgmma_rs<64>(racc, xf[kk][pair_a(pr)],
                         desc_mn<64>(dsp + pair_b(pr) * kPC * kPC, kPC, kk), kk > 0 || pr > 0);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(xf[kk]);
      }
      fence_regs(racc);
      if (it + 1 < items || np + 1 < NP) named_arrive(kBarFreeS, kThreads);
      const float wn[2] = {wv[rn], wv[rn + 8]};
#pragma unroll
      for (int e = 0; e < 32; ++e) dbs[np][e] += wn[(e >> 1) & 1] * racc[e];
      // dw_j = x_j . T_j = B_j . R_j, from R's accumulators, which start
      // afresh each panel and take x exact: T's chain of truncated sums over
      // N 128 left ddt above its limit (tests/test_torch_kernel_numerics.py)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          s += bd[c][rh][0] * racc[4 * c + 2 * rh] + bd[c][rh][1] * racc[4 * c + 2 * rh + 1];
        dwr[rh] += s;
      }
    }

    // dx starts as w_j T_j
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const float w = wv[jr[rh]];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[4 * c + 2 * rh] *= w;
        acc[4 * c + 2 * rh + 1] *= w;
      }
    }
    if (it + 1 < items) named_arrive(kBarFreeX, kThreads);  // x's tile is free

    // ---- dx += M^T dy over the k steps of i: each step's entries of M^T
    // formed in registers (one exp an entry, no branch: a masked entry's
    // exponent is -inf, whose exp is 0; 0 where the block (jsq, kk) lies above
    // the diagonal), split in three, against dy's three parts
    named_sync(kBarReadyB, kThreads);
    const float seg_r[2] = {segv[jr[0]], segv[jr[1]]};
    const float dt_r[2] = {dtv[jr[0]], dtv[jr[1]]};
    // A fragment register r of k step kk: row jr[r & 1], columns
    // 16 kk + 8 (r >> 1) + 2 t, + 1
    auto form_m = [&](int kk, uint32_t (&f)[3][4]) __attribute__((always_inline)) {
      if (kk >= jsq) {
        const int b = block_index(jsq, kk);
        const float4 c4[2] = {cbs[2 * b * 32 + lane], cbs[(2 * b + 1) * 32 + lane]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4& c = c4[r >> 1];
          const float cbv[2] = {r & 1 ? c.z : c.x, r & 1 ? c.w : c.y};
          float v[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int i = 16 * kk + 8 * (r >> 1) + 2 * tq + q;
            const float arg =
                i >= jr[r & 1] && i < Q ? (segv[i] - seg_r[r & 1]) * kLog2e : -INFINITY;
            v[q] = cbv[q] * exp2_ftz(arg) * dt_r[r & 1];
          }
          split3_bf16(v[0], v[1], f[0][r], f[1][r], f[2][r]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 3; ++q) f[q][0] = f[q][1] = f[q][2] = f[q][3] = 0u;
      }
    };
    auto issue_m = [&](int kk, const uint32_t (&f)[3][4]) __attribute__((always_inline)) {
#pragma unroll
      for (int pr = 0; pr < 6; ++pr)
        wgmma_rs<64>(acc, f[pair_a(pr)], desc_mn<64>(dyp + pair_b(pr) * kQT * kPC, kQT, kk), 1);
    };
    // at a step count known when compiling (8 and 4: consumer 0's and 1's at
    // Q 128), four steps' parts are formed in registers of their own and
    // issued back to back as one wgmma group, the next four formed while they
    // run; a group that spanned the branches of a runtime count would make
    // ptxas serialise every wgmma of the kernel. Other counts go a step at a
    // time.
    auto group4 = [&](int kk0, uint32_t (&f)[4][3][4]) __attribute__((always_inline)) {
#pragma unroll
      for (int s = 0; s < 4; ++s) form_m(kk0 + s, f[s]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) issue_m(kk0 + s, f[s]);
      wgmma_commit();
    };
    const int steps = max(0, mt - kk_lo);
    if (steps == 8) {
      uint32_t fa[4][3][4], fb[4][3][4];
      group4(kk_lo, fa);
      group4(kk_lo + 4, fb);
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        fence_regs(fa[s]);
        fence_regs(fb[s]);
      }
    } else if (steps == 4) {
      uint32_t fa[4][3][4];
      group4(kk_lo, fa);
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int s = 0; s < 4; ++s) fence_regs(fa[s]);
    } else {
      for (int s = 0; s < steps; ++s) {
        uint32_t f[3][4];
        form_m(kk_lo + s, f);
        wgmma_fence();
        issue_m(kk_lo + s, f);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(f);
      }
    }

    // dx of the strip's rows and the item's columns
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int j = jr[rh], p = p0 + 8 * c + 2 * tq;
        if (j < Q && p < hp) {
          T* out = dx + (bc * Q + j) * ld + static_cast<int64_t>(h) * hp + p;
          if (hp % 2 == 0) {  // p is even: the pair is aligned
            if constexpr (kBf16)
              *reinterpret_cast<__nv_bfloat162*>(out) =
                  __floats2bfloat162_rn(acc[4 * c + 2 * rh], acc[4 * c + 2 * rh + 1]);
            else
              *reinterpret_cast<float2*>(out) = make_float2(acc[4 * c + 2 * rh], acc[4 * c + 2 * rh + 1]);
          } else {
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1)
              if (p + e1 < hp) {
                if constexpr (kBf16)
                  out[e1] = __float2bfloat16_rn(acc[4 * c + 2 * rh + e1]);
                else
                  out[e1] = acc[4 * c + 2 * rh + e1];
              }
          }
        }
      }

    // ---- on the item that completes the head, the float64 dM_ij = dy_i . x_j
    // of the warp's blocks (rounded once), and from it K_ij = dM_ij CB_ij L_ij,
    // its column sums (float64, a slot a block's k step) and row sums
    // (sum_j K_ij dt_j over the strip's rows, into the strip's slot), and the
    // block's dC B^T entries dM_ij L_ij dt_j added to the heads' sums
    if (last) {
      auto block_k = [&](const float (&dm)[2][4], int jb, int kk) __attribute__((always_inline)) {
        const int b = block_index(jb, kk);
        const int jq[2] = {16 * jb + gq, 16 * jb + gq + 8};
        const float sj[2] = {segv[jq[0]], segv[jq[1]]}, dj[2] = {dtv[jq[0]], dtv[jq[1]]};
        float rk[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};   // [nt][column parity]
        double ck[2] = {0.0, 0.0};                       // [row half]
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float4 c4 = cbs[(2 * b + nt) * 32 + lane];
          const float cbv[4] = {c4.x, c4.y, c4.z, c4.w};
          float4* rec = dcbs + (2 * b + nt) * 32 + lane;
          float4 o = *rec;
          float* ov = reinterpret_cast<float*>(&o);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rh = e >> 1, i = 16 * kk + 8 * nt + 2 * tq + (e & 1);
            const float arg = i >= jq[rh] && i < Q ? (segv[i] - sj[rh]) * kLog2e : -INFINITY;
            const float l = exp2_ftz(arg);
            const float k = dm[nt][e] * cbv[e] * l;
            ck[rh] += k;
            rk[nt][e & 1] += k * dj[rh];
            ov[e] += dm[nt][e] * (l * dj[rh]);
          }
          *rec = o;
        }
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          double v = ck[rh];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (tq == 0) colk[kk * kQT + jq[rh]] = v;
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float v = rk[nt][c];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (gq == 0) rowk[jb * kQT + 16 * kk + 8 * nt + 2 * tq + c] = v;
          }
      };
      auto xload = [&](int j, int p) {
        return j < Q && p < hp ? static_cast<double>(ldx(xh + j * ld + p)) : 0.0;
      };
      for (int q = 0; q < 2; ++q) {
        const Segment sg = segment(cw, wq, q, mt);
        if (sg.lo >= sg.hi) continue;
        if (hp <= kPC) {  // x's fragments from device memory, dy from its tile
          double xa[8][4];
          load_cache(xa, xload, 16 * sg.js, gq, tq);
          for (int kk = sg.lo; kk < sg.hi; ++kk) {
            float dm[2][4];
            block_dots(dm, xa, [&](int i, int p) { return static_cast<double>(dys[f32_at(kQT, i, p)]); },
                       16 * kk, gq, tq);
            block_k(dm, sg.js, kk);
          }
        } else {  // both halves, from device memory
          for (int kk = sg.lo; kk < sg.hi; ++kk) {
            float dm[2][4];
            dots_f64(dm, xload,
                     [&](int i, int p) {
                       return i < Q && p < hp ? static_cast<double>(dyh[i * ld + p]) : 0.0;
                     },
                     16 * sg.js, 16 * kk, hp, gq, tq);
            block_k(dm, sg.js, kk);
          }
        }
      }
    }
    if (it + 1 < items) named_arrive(kBarFreeB, kThreads);  // dy and its parts are free

    if (last) {  // the head's ddt and dseg
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float dwv = dwr[rh];
        dwv += __shfl_xor_sync(0xffffffffu, dwv, 1);
        dwv += __shfl_xor_sync(0xffffffffu, dwv, 2);
        if (tq == 0) dws[rn + 8 * rh] = dwv;
        dwr[rh] = 0.0f;
      }
      named_sync(kBarConsumers, kConsumerThreads);
      const float seg_last = segv[Q - 1];
      if (ctid < Q) {
        const int j = ctid;
        float rsum = 0.0f;
        for (int s = 0; s <= j / 16; ++s) rsum += rowk[s * kQT + j];
        double csum = 0.0;
        for (int kk = j / 16; kk < mt; ++kk) csum += colk[kk * kQT + j];
        const float ck = static_cast<float>(csum);
        const float e = exp2_ftz((seg_last - segv[j]) * kLog2e), w = e * dtv[j];
        ddt[(bc * Q + j) * nh + h] = ck + dws[j] * e;
        dwws[j] = dws[j] * w;
        const float v = rsum - dtv[j] * ck - dws[j] * w;
        if (j < Q - 1) dseg[(bc * Q + j) * nh + h] = v;
        else *last_part = v;
      }
      named_sync(kBarConsumers, kConsumerThreads);
      if (ctid < 32) {  // seg_last's terms: sum_j dw_j w_j and the decay's
        float v = 0.0f;
        for (int j = ctid; j < Q; j += 32) v += dwws[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (ctid == 0)
          dseg[(bc * Q + Q - 1) * nh + h] =
              *last_part + (v + ddecay[bc * nh + h] * exp2_ftz(seg_last * kLog2e));
      }
      named_sync(kBarConsumers, kConsumerThreads);  // the slots are read
    }
  }

  // the group's partial sums, once: dC B^T at (i, j), i >= j, and the state's part of dB
  float* part = scratch + (bc * gridDim.x + blockIdx.x) * Q * (Q + N);
  for (int kk = js; kk < mt; ++kk) {
    const int b = block_index(js, kk);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float4 o = dcbs[(2 * b + nt) * 32 + lane];
      const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * js + g + 8 * (e >> 1), i = 16 * kk + 8 * nt + 2 * t + (e & 1);
        if (i >= j && i < Q) part[i * Q + j] = ov[e];
      }
    }
  }
  const int rn = 64 * cw + 16 * warp + g;
#pragma unroll
  for (int np = 0; np < NP; ++np)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int j = rn + 8 * ((e >> 1) & 1), n = kPC * np + 8 * (e >> 2) + 2 * t + (e & 1);
      if (j < Q && n < N) part[Q * Q + j * N + n] = dbs[np][e];
    }
}

// dC = dCB B and dB = dCB^T C + dBs, with dCB and dBs summed over the groups
// in order, by float32 FMAs. One block per (b, c, 16-row strip of the output);
// blockIdx.x: the strips of dC, then those of dB. The strip of dCB (dC: rows
// i, columns j <= i; dB: columns j, rows i >= j) is summed into shared memory,
// B or C beside it; each thread forms 4 rows by up to 4 columns 32 apart.
constexpr int kBcThreads = 128;

__global__ void __launch_bounds__(kBcThreads) ssd_bwd_bc_kernel(
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ scratch, float* __restrict__ dbm, float* __restrict__ dcm, int nc,
    int Q, int N, int groups) {
  extern __shared__ __align__(16) float bc_smem[];
  const int mt = (Q + 15) / 16;
  constexpr int AP = kQT + 1;
  float* as = bc_smem;               // [16][AP]: the strip of dCB, k along the row
  float* os = bc_smem + 16 * AP;     // [Q][N]: B or C
  const int tid = threadIdx.x;
  const bool is_db = blockIdx.x >= mt;
  const int m0 = 16 * (is_db ? blockIdx.x - mt : blockIdx.x);
  const int64_t bc = static_cast<int64_t>(blockIdx.z) * nc + blockIdx.y;
  const float* part = scratch + bc * groups * Q * (Q + N);
  const int64_t stride = static_cast<int64_t>(Q) * (Q + N);  // between groups
  // k runs over j <= i for dC_i, over i >= j for dB_j
  const int k_lo = is_db ? m0 : 0, k_hi = is_db ? Q : min(Q, m0 + 16);
  const float* op = (is_db ? cm : bm) + bc * Q * N;
  for (int e = tid; e < (k_hi - k_lo) * N; e += kBcThreads) os[k_lo * N + e] = op[k_lo * N + e];
  for (int e = tid; e < 16 * (k_hi - k_lo); e += kBcThreads) {  // 0 above the diagonal
    const int r = e / (k_hi - k_lo), k = k_lo + e % (k_hi - k_lo);
    const int i = is_db ? k : m0 + r, j = is_db ? m0 + r : k;
    float v = 0.0f;
    if (i < Q && j <= i)
      for (int gr = 0; gr < groups; ++gr) v += part[gr * stride + i * Q + j];
    as[r * AP + k] = v;
  }
  __syncthreads();
  const int r0 = 4 * (tid / 32), n0 = tid % 32;
  float v[4][4] = {};
  for (int k = k_lo; k < k_hi; ++k) {
    float a[4], o[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = as[(r0 + r) * AP + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = n0 + 32 * c < N ? os[k * N + n0 + 32 * c] : 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) v[r][c] = fmaf(a[r], o[c], v[r][c]);
  }
  float* out = (is_db ? dbm : dcm) + bc * Q * N;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = m0 + r0 + r, n = n0 + 32 * c;
      if (m < Q && n < N) {
        float s = v[r][c];
        if (is_db)
          for (int gr = 0; gr < groups; ++gr) s += part[gr * stride + Q * Q + m * N + n];
        out[m * N + n] = s;
      }
    }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const T* x, const float* dt, const float* seg, const float* bm, const float* cm,
           const float* dy, const float* dstate, const float* ddecay, T* dx, float* ddt,
           float* dseg, float* dbm, float* dcm, float* scratch, int batch, int nc, int Q, int nh,
           int hp, int N, int G, int limit, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const uint64_t chunks = static_cast<uint64_t>(batch) * nc;
  const uint64_t Qu = Q, nhu = nh, hpu = hp, Nu = N;
  // maps TMA cannot take stay unused (zero): their tensors go by ordinary loads
  CUtensorMap tx{}, tdy{}, tds{};
  int mask = 0;
  if (kBf16 && hp % 8 == 0 && aligned16(x) &&
      make_map_sw128(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, {hpu, nhu, Qu, chunks},
                     {64, 1, 64, 1}) == 0)
    mask |= 1;
  if (hp % 4 == 0 && aligned16(dy) &&
      make_map_sw128(&tdy, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dy, {hpu, nhu, Qu, chunks},
                     {32, 1, 64, 1}) == 0)
    mask |= 2;
  if (N % 4 == 0 && aligned16(dstate) &&
      make_map_sw128(&tds, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dstate, {Nu, hpu, nhu, chunks},
                     {32, 64, 1, 1}) == 0)
    mask |= 4;
  const int bytes = Layout(kBf16).total;
  if (bytes > limit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = N > kPC ? ssd_bwd_heads_kernel<T, 2> : ssd_bwd_heads_kernel<T, 1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (nh + G - 1) / G;
  kernel<<<dim3(groups, nc, batch), kThreads, bytes, stream>>>(
      tx, tdy, tds, x, dt, seg, bm, cm, dy, dstate, ddecay, dx, ddt, dseg, scratch, nc, Q, nh,
      hp, N, G, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bc_bytes = (16 * (kQT + 1) + Q * N) * 4;
  err = cudaFuncSetAttribute(ssd_bwd_bc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bc_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mt = (Q + 15) / 16;
  ssd_bwd_bc_kernel<<<dim3(2 * mt, nc, batch), kBcThreads, bc_bytes, stream>>>(
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
    return launch(static_cast<const bf16*>(x), dt, seg, bm, cm, dy, dstate, ddecay,
                  static_cast<bf16*>(dx), ddt, dseg, dbm, dcm, scratch, batch, nc, Q, nh, hp, N,
                  heads_per_block, limit, s);
  return launch(static_cast<const float*>(x), dt, seg, bm, cm, dy, dstate, ddecay,
                static_cast<float*>(dx), ddt, dseg, dbm, dcm, scratch, batch, nc, Q, nh, hp, N,
                heads_per_block, limit, s);
}

// The registers setmaxnreg gives a thread of the producer (role 0) and of a
// consumer (role 1) warpgroup of the heads kernel.
extern "C" int ssd_intra_chunk_bwd_registers(int role) {
  return role == 0 ? kProducerRegs : kConsumerRegs;
}
