// K3 on Hopper: the Mamba-2 SSD intra-chunk block, forward. Its backward is
// ssd_scan_bwd.cu.
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
// (bf16 products: 6 for each of C B^T's, 3 for each of M x's and the
// state's) 5.3e10 at 989 TFLOP/s, 0.054 ms.
//
// What the design does:
//   * Float32 accuracy from bf16 wgmma. PTX's wgmma takes .tf32 operands
//     only K-major from shared memory, and x, the B operand of M x and of the
//     state product, is MN-major there (its rows j are the reduction). A bf16
//     x tile as TMA lands it is wgmma's MN-major ("transposed") bf16 B
//     operand as it stands, so x stays bf16 and the float32 side of each
//     product is split into three bf16 parts (hopper.cuh, split3_bf16: two
//     truncations and a rounding, to 2^-23): M x is M2 x + M1 x + M0 x, three
//     bf16 products that at twice TF32's rate take the time of 1.5 TF32
//     products, where TF32 would take two (M_hi, M_lo against an exact x) and
//     a pass through shared memory to lay x^T out K-major. Two parts of M
//     miss the float32 contract of 1e-4, three hold it
//     (tests/test_torch_kernel_numerics.py emulates the products as issued).
//     Products whose both sides are float32 (C B^T, and M x and the state
//     with a float32 x) take the six pairs of parts (p, q) with p + q <= 2.
//   * Warp specialisation: a producer warpgroup and two consumer warpgroups
//     of 64 chunk rows each (384 threads; setmaxnreg 40 and 232). One
//     producer thread keeps a ring of x tiles (128 rows x 64 columns, bf16;
//     2 stages at Q 128, hp 64, N 64, up to 4 where shared memory allows) in
//     flight by TMA on mbarriers (full: the bytes and w have landed; empty:
//     every consumer warp is done); TMA's zero fill covers rows past Q and
//     columns past hp. The producer warpgroup also writes each stage's
//     w_j = dt_j exp(seg_{Q-1} - seg_j), one exp a row, which every warp of
//     the state product reads.
//   * A block owns one (b, c) chunk and G heads (the wrapper's
//     HEADS_PER_BLOCK, 16, at most kMaxHeads): a grid of 512 blocks at the
//     serving shape and 256 at the training shape (B 4), one block an SM, so
//     that every SM is busy at both (3.9 and 1.9 waves of 132). C B^T is
//     formed once a block on the tensor cores, each consumer's 64 rows
//     against all 128 columns (m64n128; C's parts as the register A operand,
//     B's parts K-major in shared memory), and kept in shared memory in the
//     accumulator layout, a float4 a thread and 8-column chunk (48 KB).
//   * Per head, each consumer forms its rows of M once per entry, in
//     registers, from C B^T, seg and dt (one exp an entry, no branch: a
//     masked entry's exponent is -inf), splits it and hands it to wgmma as
//     the register A operand of m64n64k16 products: the accumulator layout of
//     two 8-column chunks is the A fragment of one k step. Entries above the
//     diagonal or past Q are 0, so an exp that would overflow there never
//     meets a product. Only the triangle's k steps are issued (4 for rows
//     0-63, 8 for rows 64-127): all of a product's steps are formed into
//     registers of their own, then issued back to back as one wgmma group.
//   * The state comes out transposed: state^T = (w B)^T x, A = (w B)^T
//     formed in registers from w and a float32 copy of B in shared memory
//     and split, x again the MN-major B operand. Consumer 0 takes state
//     columns 0-63 and forms them while its y products run, consumer 1 columns
//     64-127 (N > 64): with the triangle's 4 and 8 k steps of y, the two
//     consumers' work is even at N 64.
//   * y and the state are staged in shared memory (128-byte swizzled float32
//     panels, the state written transposed) and written by TMA stores, which
//     clip rows and columns past Q, hp and N. Two output stages where they
//     fit: one head's stores drain while the next head's products run; one
//     thread of each consumer waits for its stores of two heads back before
//     its stage is written again.
//   * hp above 64 runs as two halves of 64 columns (x's box, y's columns,
//     the state's rows), each forming M again; N above 64 as two state tiles
//     and two 64-column panels of C B^T's reduction.
//   * Any Q, hp and N from 1 to 128, x bf16 or float32. Where TMA cannot take
//     x (a row not a multiple of 16 bytes, a misaligned base) and for a
//     float32 x, which is split into parts anyway, the consumers load each
//     head's tile with ordinary loads into the same swizzled tiles (and write
//     w); where y's or the state's rows are not a multiple of 16 bytes, they
//     store from registers. Shared memory is sized at launch (the most x
//     and output stages that fit, then fewer heads a block): 226 KB at Q 128,
//     hp 64, N 64 with a bf16 x.
//   * Fixed numerics: no atomics, each output element written once, every
//     sum in a fixed order; two calls give the same bits.
//   * What ptxas needs to keep wgmma asynchronous (it otherwise serialises
//     every wgmma of the kernel, C7511/C7512): a wgmma group never spans the
//     branches of a runtime trip count (so the triangle's 4 and 8 k steps are
//     compile-time cases), and the thread-index arithmetic is not hoisted out
//     of the head loop (see `tq`). Registers: chip_smoke.py's
//     {"resource_usage": ...} line (ptxas reports the launch count, 168).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kQT = 128;                  // rows of a chunk's tiles (Q padded)
constexpr int kPC = 64;                   // x columns one pass takes (hp in halves)
constexpr int kConsumers = 2;             // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kProducerRegs = 40;         // setmaxnreg: 128 x 40 + 256 x 232 = 384 x 168
constexpr int kConsumerRegs = 232;
constexpr int kMaxStages = 4;
constexpr int kMaxHeads = 16;             // heads a block takes at most
constexpr int kTile = kQT * kPC * 2;      // bytes of a (128, 64) bf16 tile
constexpr int kTileElems = kQT * kPC;
constexpr int kOutTile = 64 * 64 * 4;     // bytes of a (64, 64) float32 staging tile
constexpr int kSegPitch = kQT + 1;        // floats of a head's seg (or dt) row in shared memory
// C B^T in the consumers' accumulator layout: consumer 0's 8 column chunks
// (its rows need columns 0-63 only), then consumer 1's 16, each chunk a
// float4 a thread
constexpr int kCBBytes = (8 + 16) * 128 * 16;
constexpr float kLog2e = 1.4426950408889634f;

// pair i of the products of two split operands, smallest first: (A part, B part)
__host__ __device__ constexpr int pair_a(int i) {
  constexpr int a[6] = {2, 1, 0, 1, 0, 0};
  return a[i];
}
__host__ __device__ constexpr int pair_b(int i) {
  constexpr int b[6] = {0, 1, 2, 0, 1, 0};
  return b[i];
}

__host__ __device__ constexpr int max_int(int a, int b) { return a > b ? a : b; }

// shared-memory carve-up, in bytes from the 1024-aligned start
struct Layout {
  int ntiles;   // 64-column tiles of N: the state's tiles and C B^T's panels
  int bpitch;   // floats of a row of B's float32 copy
  int out;      // one output stage: each consumer's y, then the state tiles
  int scratch, bf, cbs, sd, ws, bar, total;
  // stages: TMA stages of x (0: the consumers load x, as `parts` tiles);
  // outs: output stages (0: stores from registers)
  __host__ __device__ Layout(int N, int G, int stages, int parts, int outs) {
    const int xtiles = stages > 0 ? stages : parts;
    ntiles = (N + 63) / 64;
    bpitch = 64 * ntiles;
    out = (kConsumers + ntiles) * kOutTile;
    scratch = xtiles * kTile;  // B's three parts while C B^T is formed, then the outputs
    bf = scratch + max_int(3 * kTile, outs * out);
    cbs = bf + kQT * bpitch * 4;
    sd = cbs + kCBBytes;
    ws = sd + 2 * G * kSegPitch * 4;  // w of the head in each x stage
    bar = ws + (stages > 0 ? stages : 1) * kQT * 4;
    total = 1024 + bar + 2 * kMaxStages * 8;
  }
};

// x's (128, 64) tile of head h, columns p0.., by the consumers' ordinary
// loads: a bf16 x as it is, a float32 x as its three bf16 parts (tiles one
// after another), zero past Q and hp; swizzled as TMA would land it
template <typename T>
__device__ __forceinline__ void load_x(bf16* xt, const T* __restrict__ x, int64_t bc, int Q,
                                       int nh, int hp, int h, int p0, int tid) {
  for (int e = tid; e < kTileElems; e += kConsumerThreads) {
    const int j = e / kPC, c = e % kPC, p = p0 + c;
    const bool in = j < Q && p < hp;
    const int at = tile_offset<kPC>(kQT, j, c) / 2;
    const int64_t src = ((bc * Q + j) * nh + h) * hp + p;
    if constexpr (sizeof(T) == 2) {
      xt[at] = in ? x[src] : __float2bfloat16_rn(0.0f);
    } else {
      bf16 part[3];
      split3_bf16(in ? to_float(x[src]) : 0.0f, part);
#pragma unroll
      for (int q = 0; q < 3; ++q) xt[q * kTileElems + at] = part[q];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_intra_chunk_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap ty,
    const __grid_constant__ CUtensorMap ts, const T* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ seg, const float* __restrict__ bm,
    const float* __restrict__ cm, float* __restrict__ y, float* __restrict__ state,
    float* __restrict__ decay, int nc, int Q, int nh, int hp, int N, int G, int stages,
    int outs) {
  constexpr bool kExact = sizeof(T) == 2;  // a bf16 x is one exact part
  constexpr int kPairs = kExact ? 3 : 6;
  const bool tma_x = stages > 0, tma_out = outs > 0;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const Layout lay(N, G, stages, kExact ? 1 : 3, outs);
  bf16* xt = reinterpret_cast<bf16*>(smem);                    // [stage or part][kTileElems]
  uint8_t* scratch = smem + lay.scratch;
  float* bs = reinterpret_cast<float*>(smem + lay.bf);         // [kQT][bpitch], swizzled
  float4* cbs = reinterpret_cast<float4*>(smem + lay.cbs);     // [chunk][thread]
  float* seg_s = reinterpret_cast<float*>(smem + lay.sd);      // [G][kSegPitch]
  float* dt_s = seg_s + G * kSegPitch;                         // [G][kSegPitch]
  float* w_s = reinterpret_cast<float*>(smem + lay.ws);        // [stage][kQT]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);  // [kMaxStages]
  uint64_t* empty = full + kMaxStages;                           // [kMaxStages]

  const int64_t bc = static_cast<int64_t>(blockIdx.z) * nc + blockIdx.y;
  const int h0 = blockIdx.x * G;
  const int heads = min(G, nh - h0);
  const int halves = (hp + kPC - 1) / kPC;
  const int items = heads * halves;  // (head, half of hp) in order
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1 + 4);  // the TMA bytes' arrival, then one from each producer warp
      mbar_init(&empty[s], 4 * kConsumers);  // one arrival from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring of x tiles full; the warpgroup
    // also writes each stage's w_j = dt_j exp(seg_{Q-1} - seg_j), which all
    // of the state product's warps read (one exp a row instead of one for
    // each of a consumer's 32 lanes that need it)
    regs_dec<kProducerRegs>();
    if (tma_x) {
      if (threadIdx.x == 0) prefetch_map(&tx);
      named_sync(4, kThreads);  // the consumers have loaded seg and dt
      const int j = threadIdx.x, lane = threadIdx.x % 32;
      // item it: stage s, its phase, head hh, half (counted, not divided)
      for (int it = 0, s = 0, phase = 0, hh = 0, half = 0; it < items; ++it) {
        if (lane == 0) mbar_wait(&empty[s], phase ^ 1);
        __syncwarp();
        if (j == 0) {
          bf16* dst = xt + s * kTileElems;
          mbar_arrive_tx(&full[s], kTile);
          for (int r = 0; r < kQT; r += 64)  // a box is 64 rows
            tma_load(dst + r * kPC, &tx, &full[s], kPC * half, h0 + hh, r, static_cast<int>(bc));
        }
        const float* sg = seg_s + hh * kSegPitch;
        w_s[s * kQT + j] =
            j < Q ? dt_s[hh * kSegPitch + j] * exp2_ftz((sg[Q - 1] - sg[j]) * kLog2e) : 0.0f;
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
        if (++half == halves) {
          half = 0;
          ++hh;
        }
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: consumer cw owns chunk rows 64 cw .. 64 cw + 63 of C B^T, M
  // and y, and state tile cw (columns 64 cw ..) where N has one
  regs_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int tid = threadIdx.x - 128;  // 0 .. 255 over both consumers
  const int ltid = tid % 128;
  const int warp = ltid / 32, lane = ltid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 64 * cw + 16 * warp + g;  // the thread's rows r0 and r0 + 8 of C B^T
  // B's float32 copy: element (j, n) at row j, column n with bits 3-4 XORed
  // with bits 1-2 of j, so that a warp's A-fragment reads (j = 2 t + c,
  // n = g + c') hit 32 banks
  auto b_at = [&](int j, int n) __attribute__((always_inline)) {
    return j * lay.bpitch + (n ^ (((j >> 1) & 3) << 3));
  };

  // seg and dt of the block's heads, 0 past Q
  for (int e = tid; e < heads * kQT; e += kConsumerThreads) {
    const int j = e / heads, hh = e % heads;
    const int64_t at = (bc * Q + j) * nh + h0 + hh;
    seg_s[hh * kSegPitch + j] = j < Q ? seg[at] : 0.0f;
    dt_s[hh * kSegPitch + j] = j < Q ? dt[at] : 0.0f;
  }
  if (tma_x) named_arrive(4, kThreads);  // the producer computes w from them

  // C B^T, rows r0 and r0 + 8 against all 128 columns, in the m64n128
  // accumulator layout: cb[4 jc + e] is row r0 + 8 (e >> 1), column
  // 8 jc + 2 t + (e & 1). One 64-column panel of N at a time: B's rows into
  // the float32 copy and, as three bf16 parts, into K-major swizzled tiles in
  // the scratch space; C's parts as the register A operand.
  float cb[64];
  const int npanels = lay.ntiles;
  for (int np = 0; np < npanels; ++np) {
    if (np > 0) named_sync(1, kConsumerThreads);  // the last panel's products have read its parts
    for (int e0 = tid; e0 < kQT * 64; e0 += 16 * kConsumerThreads) {
      float v[16];  // 16 loads in flight, then their stores
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int e = e0 + u * kConsumerThreads, j = e / 64, n = 64 * np + e % 64;
        v[u] = j < Q && n < N ? bm[(bc * Q + j) * N + n] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int e = e0 + u * kConsumerThreads, j = e / 64, c = e % 64;
        bs[b_at(j, 64 * np + c)] = v[u];
        bf16 part[3];
        split3_bf16(v[u], part);
        const int at = tile_offset<64>(kQT, j, c);
#pragma unroll
        for (int q = 0; q < 3; ++q) *reinterpret_cast<bf16*>(scratch + q * kTile + at) = part[q];
      }
    }
    fence_proxy_async();
    named_sync(1, kConsumerThreads);
    const int nk = min(4, (N - 64 * np + 15) / 16);
    // C's parts of k step kk as the register A operand
    auto c_frag = [&](int kk, uint32_t (&a)[3][4]) __attribute__((always_inline)) {
      const int n = 64 * np + 16 * kk + 2 * t;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = r0 + 8 * ((e >> 1) & 1), nn = n + 8 * (e >> 2) + (e & 1);
        v[e] = i < Q && nn < N ? cm[(bc * Q + i) * N + nn] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) split3_bf16(v[2 * r], v[2 * r + 1], a[0][r], a[1][r], a[2][r]);
    };
    auto c_issue = [&](int kk, const uint32_t (&a)[3][4]) __attribute__((always_inline)) {
#pragma unroll
      for (int pr = 0; pr < 6; ++pr)
        wgmma_rs_k<128>(cb, a[pair_a(pr)],
                        desc_k<64>(reinterpret_cast<const bf16*>(scratch + pair_b(pr) * kTile),
                                   kQT, kk),
                        np > 0 || kk > 0 || pr > 0);
    };
    if (nk == 4) {  // a full panel: every k step's parts formed, then all issued
      uint32_t a[4][3][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) c_frag(kk, a[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) c_issue(kk, a[kk]);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
    } else {
      for (int kk = 0; kk < nk; ++kk) {
        uint32_t a[3][4];
        c_frag(kk, a);
        wgmma_fence();
        c_issue(kk, a);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(a);
      }
    }
    fence_regs(cb);
  }
  {  // this consumer's chunks of C B^T, one float4 a thread each
    float4* mine = cbs + cw * 8 * 128 + ltid;
#pragma unroll
    for (int jc = 0; jc < 16; ++jc)
      if (jc < 8 * (1 + cw))
        mine[jc * 128] = make_float4(cb[4 * jc], cb[4 * jc + 1], cb[4 * jc + 2], cb[4 * jc + 3]);
  }
  named_sync(1, kConsumerThreads);  // B's parts are read: the scratch space holds outputs now
  const float4* cb_mine = cbs + cw * 8 * 128 + ltid;

  const int rows_end = min(64 * cw + 64, Q);
  const int ky = rows_end > 64 * cw ? (rows_end + 15) / 16 : 0;  // k steps of this consumer's M x
  const int ks = (Q + 15) / 16;                                   // k steps of the state product
  const bool has_state = cw < lay.ntiles;
  float acc[32];  // y's rows, then the state tile (one at a time: registers)

  for (int it = 0; it < items; ++it) {
    const int hh = it / halves, h = h0 + hh, p0 = kPC * (it % halves);
    const float* seg_h = seg_s + hh * kSegPitch;
    const float* dt_h = dt_s + hh * kSegPitch;
    const int s = tma_x ? it % stages : 0;
    const bf16* xs = xt + s * kTileElems;  // x's tile; a float32 x's parts follow it
    if (tma_x) {
      mbar_wait(&full[s], (it / stages) & 1);
    } else {
      named_sync(1, kConsumerThreads);  // both consumers are done with the last tile
      load_x<T>(xt, x, bc, Q, nh, hp, h, p0, tid);
      if (tid < kQT)  // w as the producer writes it in the TMA mode
        w_s[tid] = tid < Q ? dt_h[tid] * exp2_ftz((seg_h[Q - 1] - seg_h[tid]) * kLog2e) : 0.0f;
      fence_proxy_async();
      named_sync(1, kConsumerThreads);
    }

    // The thread's indices pass through an empty asm at each head, so that
    // the addresses and masks below are computed inside the loop: hoisted
    // out of it, a few hundred of them held in registers across heads left
    // too few for wgmma's pipeline, and ptxas then serialises every wgmma.
    int tq = t, gq = g, wq = warp;
    asm volatile("" : "+r"(tq), "+r"(gq), "+r"(wq));
    const int i0 = 64 * cw + 16 * wq + gq;   // rows i0, i0 + 8 (and state columns)
    // entry (i, j) of M is formed where j <= i < Q: j - 2 t <= lim[i's half]
    const int lim[2] = {i0 < Q ? i0 - 2 * tq : -1, i0 + 8 < Q ? i0 + 8 - 2 * tq : -1};
    const float si[2] = {seg_h[i0], seg_h[i0 + 8]};
    const float seg_last = seg_h[Q - 1];
    const float* seg_t = seg_h + 2 * tq;     // seg and dt at column 2 t of a k step
    const float* dt_t = dt_h + 2 * tq;
    const float* w_t = w_s + s * kQT + 2 * tq;  // w at row 2 t of a k step
    // B's copy at rows 2 t (+ 16 kk + 8 (r >> 1) + q) and columns i0, i0 + 8:
    // b_at's XOR term is t << 3 for every row a thread reads
    const float* b_t[2] = {bs + 2 * tq * lay.bpitch + (i0 ^ (tq << 3)),
                           bs + 2 * tq * lay.bpitch + ((i0 + 8) ^ (tq << 3))};

    // k step kk of M: A fragment register r holds row i0 + 8 (r & 1),
    // columns 16 kk + 8 (r >> 1) + 2 t, + 1, from C B^T's chunk 2 kk + (r >> 1)
    auto form_m = [&](int kk, uint32_t (&f)[3][4]) __attribute__((always_inline)) {
      const float4 ck[2] = {cb_mine[2 * kk * 128], cb_mine[(2 * kk + 1) * 128]};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4& c = ck[r >> 1];
        const float cbv[2] = {r & 1 ? c.z : c.x, r & 1 ? c.w : c.y};
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          // no branch and no predicated load: a masked entry's exponent is
          // -inf, whose exp is 0 (an overflowing exp never meets a product)
          const int jj = 16 * kk + 8 * (r >> 1) + q;  // j - 2 t
          const float arg = jj <= lim[r & 1] ? (si[r & 1] - seg_t[jj]) * kLog2e : -INFINITY;
          v[q] = cbv[q] * exp2_ftz(arg) * dt_t[jj];
        }
        split3_bf16(v[0], v[1], f[0][r], f[1][r], f[2][r]);
      }
    };
    // k step kk of (w B)^T: register r holds state column i0 + 8 (r & 1),
    // rows j = 16 kk + 8 (r >> 1) + 2 t, + 1
    auto form_s = [&](int kk, uint32_t (&f)[3][4]) __attribute__((always_inline)) {
      float w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = w_t[16 * kk + 8 * (c >> 1) + (c & 1)];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int jj = 16 * kk + 8 * (r >> 1);
        const float* b = b_t[r & 1] + jj * lay.bpitch;
        split3_bf16(w[2 * (r >> 1)] * b[0], w[2 * (r >> 1) + 1] * b[lay.bpitch], f[0][r], f[1][r],
                    f[2][r]);
      }
    };
    // acc (+)= f x over k step kk: the pairs of parts, smallest first
    auto issue = [&](int kk, const uint32_t (&f)[3][4], bool first) __attribute__((always_inline)) {
#pragma unroll
      for (int pr = 0; pr < kPairs; ++pr) {
        const int pa = kExact ? 2 - pr : pair_a(pr), pb = kExact ? 0 : pair_b(pr);
        wgmma_rs<64>(acc, f[pa], desc_mn<64>(xs + pb * kTileElems, kQT, kk), !(first && pr == 0));
      }
    };
    // A product's k steps: at a step count known when compiling (4 and 8:
    // Q 64 and 128), every step's parts are formed in registers of their
    // own and the products issued back to back, one wgmma group; a group
    // that spanned the branches of a runtime count would make ptxas
    // serialise every wgmma of the kernel. Other counts go a step at a time.
    auto form_all = [&](auto form, auto& f) __attribute__((always_inline)) {
#pragma unroll
      for (int kk = 0; kk < int(sizeof(f) / sizeof(f[0])); ++kk) form(kk, f[kk]);
    };
    auto issue_all = [&](auto& f) __attribute__((always_inline)) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < int(sizeof(f) / sizeof(f[0])); ++kk) issue(kk, f[kk], kk == 0);
      wgmma_commit();
    };
    auto done = [&](auto& f) __attribute__((always_inline)) {
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < int(sizeof(f) / sizeof(f[0])); ++kk) fence_regs(f[kk]);
    };
    auto run = [&](auto form, int steps) __attribute__((always_inline)) {
      if (steps == 8) {
        uint32_t f[8][3][4];
        form_all(form, f);
        issue_all(f);
        done(f);
      } else if (steps == 4) {
        uint32_t f[4][3][4];
        form_all(form, f);
        issue_all(f);
        done(f);
      } else {
        for (int kk = 0; kk < steps; ++kk) {
          uint32_t f[1][3][4];
          form(kk, f[0]);
          wgmma_fence();
          issue(kk, f[0], kk == 0);
          wgmma_commit();
          done(f);
        }
      }
    };

    // the output stage: its stores of `outs` heads back have read it
    uint8_t* ob = scratch + (tma_out ? it % outs : 0) * lay.out;
    if (tma_out) {
      if (ltid == 0) {
        if (outs == 2) bulk_wait_read<1>();
        else bulk_wait_read<0>();
      }
      named_sync(2 + cw, 128);
    }

    // The staging tiles are laid out as a TMA store with 128-byte swizzle
    // reads them: float32 panels of 32 columns (8 KB a 64-row panel), rows of
    // 128 bytes, the 16-byte chunk c of row r at chunk c ^ (r % 8).
    // y staged (or stored): row i0 % 64 at 128 bytes a row, column
    // 8 jc + 2 t at byte 32 ((jc & 3) ^ (g >> 1)) + (8 t ^ 16 (g & 1)) of it,
    // in panel jc / 4
    auto put_y = [&]() __attribute__((always_inline)) {
      uint8_t* ys = ob + cw * kOutTile + (16 * wq + gq) * 128 + ((8 * tq) ^ ((gq & 1) << 4));
#pragma unroll
      for (int jc = 0; jc < 8; ++jc) {
        if (tma_out) {
          float* at = reinterpret_cast<float*>(ys + (jc >> 2) * 8192 + (((jc & 3) ^ (gq >> 1)) << 5));
          *reinterpret_cast<float2*>(at) = make_float2(acc[4 * jc], acc[4 * jc + 1]);
          *reinterpret_cast<float2*>(at + 256) = make_float2(acc[4 * jc + 2], acc[4 * jc + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + 8 * (e >> 1), pc = p0 + 8 * jc + 2 * tq + (e & 1);
            if (i < Q && pc < hp) y[((bc * Q + i) * nh + h) * hp + pc] = acc[4 * jc + e];
          }
        }
      }
    };
    // the state's (column n, row p) staged at row p, column n: row
    // p = 8 jc + 2 t + e1 at 128 bytes a row, column n = i0 % 64 + 8 h2 at
    // byte (64 (w & 1) + 4 g + 32 h2) ^ 16 (2 t + e1), in panel w / 2
    auto put_s = [&]() __attribute__((always_inline)) {
      uint8_t* ss = ob + (kConsumers + cw) * kOutTile + (wq >> 1) * 8192 + 2 * tq * 128;
      float* sat[2][2];  // [h2][e1]
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1)
          sat[h2][e1] = reinterpret_cast<float*>(
              ss + e1 * 128 + ((64 * (wq & 1) + 4 * gq + 32 * h2) ^ (32 * tq + 16 * e1)));
#pragma unroll
      for (int jc = 0; jc < 8; ++jc) {
        if (tma_out) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sat[e >> 1][e & 1][jc * 256] = acc[4 * jc + e];
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = i0 + 8 * (e >> 1), pc = p0 + 8 * jc + 2 * tq + (e & 1);
            if (n < N && pc < hp) state[((bc * nh + h) * hp + pc) * N + n] = acc[4 * jc + e];
          }
        }
      }
    };

    if (kExact && ky == 4 && ks == 8 && has_state) {
      // consumer 0 at Q 128: the state's parts are formed while y's
      // products run
      uint32_t fy[4][3][4], fs[8][3][4];
      form_all(form_m, fy);
      issue_all(fy);
      form_all(form_s, fs);
      done(fy);
      put_y();
      issue_all(fs);
      done(fs);
    } else {
      if (ky > 0) {
        run(form_m, ky);
        put_y();
      }
      if (has_state) run(form_s, ks);  // state^T = (w B)^T x
    }
    if (tma_x) {  // the x stage is done with
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (has_state) put_s();
    if (tma_out) {  // one thread stores the consumer's tiles
      fence_proxy_async();
      named_sync(2 + cw, 128);
      if (ltid == 0) {
        const uint8_t* ys = ob + cw * kOutTile;
        const uint8_t* ss = ob + (kConsumers + cw) * kOutTile;
        for (int pn = 0; pn < 2; ++pn) {
          if (ky > 0 && p0 + 32 * pn < hp)
            tma_store(&ty, ys + pn * 64 * 128, p0 + 32 * pn, h, 64 * cw, static_cast<int>(bc));
          if (has_state && 64 * cw + 32 * pn < N)
            tma_store(&ts, ss + pn * 64 * 128, 64 * cw + 32 * pn, p0, h, static_cast<int>(bc));
        }
        bulk_commit();
      }
    }
    if (cw == 0 && ltid == 0 && p0 == 0) decay[bc * nh + h] = expf(seg_last);
  }
  if (tma_out && ltid == 0) bulk_wait_read<0>();  // the stores have read shared memory
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const T* x, const float* dt, const float* seg, const float* bm, const float* cm,
           float* y, float* state, float* decay, int batch, int nc, int Q, int nh, int hp,
           int N, int G, int limit, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const uint64_t chunks = static_cast<uint64_t>(batch) * nc;
  const uint64_t Qu = Q, nhu = nh, hpu = hp, Nu = N;
  // maps TMA cannot take stay unused (zero): their tensors go by ordinary
  // loads and stores
  CUtensorMap tx{}, ty{}, ts{};
  const bool tma_x = kBf16 && hp % 8 == 0 && aligned16(x) &&
                     make_map_sw128(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
                                    {hpu, nhu, Qu, chunks}, {64, 1, 64, 1}) == 0;
  const bool tma_out = hp % 4 == 0 && N % 4 == 0 && aligned16(y) && aligned16(state) &&
                       make_map_sw128(&ty, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, y,
                                      {hpu, nhu, Qu, chunks}, {32, 1, 64, 1}) == 0 &&
                       make_map_sw128(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, state,
                                      {Nu, hpu, nhu, chunks}, {32, 64, 1, 1}) == 0;
  // the most x stages and output stages that fit: two outputs and two or
  // more stages first, then one output; one stage last; and where even that
  // does not fit (Q = hp = N = 128 with a float32 x), fewer heads a block
  const int parts = kBf16 ? 1 : 3;
  int stages = -1, outs = 0, bytes = 0, heads = G;
  for (int g = min(G, kMaxHeads); g >= 1 && stages < 0; g /= 2)
    for (int min_stages = 2; min_stages >= 1 && stages < 0; --min_stages)
      for (int o = tma_out ? 2 : 0; o >= (tma_out ? 1 : 0) && stages < 0; --o)
        for (int s = tma_x ? kMaxStages : 0; s >= (tma_x ? min_stages : 0); --s) {
          const int need = Layout(N, g, s, parts, o).total;
          if (need <= limit) {
            stages = s;
            outs = o;
            bytes = need;
            heads = g;
            break;
          }
        }
  if (stages < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ssd_intra_chunk_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nh + heads - 1) / heads, nc, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(tx, ty, ts, x, dt, seg, bm, cm, y, state, decay, nc,
                                            Q, nh, hp, N, heads, stages, outs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for sizes the kernel does not take (Q, hp or N
// outside 1..128, or a shared-memory need above the card's opt-in limit).
// The wrapper has checked shapes, dtypes and contiguity; B * nc >= 1.
extern "C" int ssd_intra_chunk_launch(
    const void* x, int x_is_bf16, const float* dt, const float* seg,
    const float* bm, const float* cm, float* y, float* state, float* decay,
    int batch, int nc, int Q, int nh, int hp, int N, int heads_per_block,
    void* stream) {
  if (Q < 1 || Q > kQT || hp < 1 || hp > 2 * kPC || N < 1 || N > 128 || nh < 1 ||
      heads_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch(static_cast<const bf16*>(x), dt, seg, bm, cm, y, state, decay, batch, nc, Q,
                  nh, hp, N, heads_per_block, limit, s);
  return launch(static_cast<const float*>(x), dt, seg, bm, cm, y, state, decay, batch, nc, Q,
                nh, hp, N, heads_per_block, limit, s);
}

// The registers setmaxnreg gives a thread of the producer (role 0) and of a
// consumer (role 1) warpgroup.
extern "C" int ssd_intra_chunk_registers(int role) {
  return role == 0 ? kProducerRegs : kConsumerRegs;
}
