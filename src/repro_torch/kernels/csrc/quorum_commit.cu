// K1 on Hopper: the earliest strict weighted-quorum crossing for a batch of
// operations.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/quorum_commit.py,
// `_kernel` and the sorting network it calls, `_bitonic_by_time`. The plain
// PyTorch version of the same function is `quorum_commit_plain` in
// src/repro_torch/kernels/quorum_commit.py.
//
// Per op row (arrivals t[0..n), weights w[0..n), threshold T, by default
// sum(w)/2 over all n replicas, voters or not, summed in double and rounded to
// float32 before the halving): order the votes in stable arrival order
// (ascending t, ties by replica index, NaN last with NaNs tied, -0.0 tied with
// +0.0: the order of torch.sort(stable=True) and of jnp.argsort), add the
// weight of each finite vote in that order, in double, and take the first
// position k where the sum, rounded to float32, strictly exceeds T. The op
// commits when a finite vote sits at or after k; then commit_time = t at k,
// quorum_size = k + 1, weight_sum = the rounded sum at k, and members marks the
// finite votes at stable positions <= k. Otherwise inf, 0, false, 0 and no
// members.
//
// Bound: memory bytes. A row reads 8*n bytes and writes 13 (plus n for the
// members mask); at n = 9 and 65,536 ops that is 6.16 MB, 1.84 us at 3.35 TB/s.
// Its operations (about n compares a replica, a log-depth scan) stay in
// registers and shared memory, far below the operations per byte at which the
// card becomes compute bound.
//
// It replaces a kernel of one thread per row that read its row with stride n
// (no load coalesced), found the order by selection (O(n*k) dependent
// compares, O(n^2) for a row that does not commit) and wrote the members mask
// byte by byte with stride n: 13x its bound at (65536, 9), and slower than
// torch.sort at n = 32. What this design does instead:
//
//   * Staging. A block owns a contiguous tile of rows, so its arrivals, its
//     weights and its members are each one contiguous span. The spans go to
//     shared memory by cp.async, 16 bytes a copy, all issued before any is
//     waited for. A span that does not start on 16 bytes (a slice such as
//     arrivals[1:]) is placed in shared memory at the same offset modulo 16,
//     so its aligned middle still moves in 16-byte copies and only the few
//     floats before and after it in 4-byte ones. The members tile is built in
//     shared memory and stored the same way, 16 bytes a store; the four (ops,)
//     outputs are stored by consecutive rows of a warp, coalesced.
//   * The order as a key. Each vote becomes the key (order bits of t, replica
//     index), where the order bits map float32 monotonically to uint32 after
//     -0.0 becomes +0.0 and every NaN one NaN above +inf. Keys are distinct
//     and their order is the stable order. Without the canonicalisation a raw
//     bit map puts -0.0 before +0.0 and breaks the tie rule
//     (tests/test_torch_kernel_numerics.py shows it).
//   * n <= 32: one thread a row, the kernel instantiated for each n, so every
//     loop over the row unrolls and the row's arrivals, order bits and ranks
//     live in registers. A vote's position is its rank, counted over the
//     n(n-1)/2 pairs of the row with one 32-bit compare a pair (the index
//     breaks ties, and is known when the loop is unrolled): 36 compares at
//     n = 9, no dependent chain. The thread scatters each arrival and counted
//     weight to its position in a row of shared memory, then walks the
//     positions with a sequential double sum, as a sorted loop would. Rows sit
//     in shared memory at an odd stride, so a warp's 32 rows fall in distinct
//     banks; for odd n that is the layout of device memory itself, staged by
//     16-byte copies, for even n each float is copied to a row of n + 1.
//     The first version gave each row g = next_pow2(n) lanes (rank by g
//     shuffles, scans by shuffles): chip_smoke.py timed it at 12.7 us at
//     (65536, 9) with members, against 4.7 us for this one on an H100 SXM
//     (PERF.md). The lanes spend a warp instruction on each step for 32/g
//     rows where a thread a row spends it on 32; only at (8192, 32), 2 warps
//     an SM, were the lanes faster (6.0 us against 7.8 us).
//   * 33 <= n <= 1024: a bitonic network on the keys of a row padded to
//     P = next_pow2(n), P/2 threads a row (several rows a block up to
//     P = 512), each thread holding positions 2i and 2i + 1 in registers:
//     exchanges at distance 1 stay in the thread, at 2 to 32 positions
//     they go by warp shuffles, and only the 10 stages at distance 64 or more
//     (P = 1024) pass through shared memory, with one barrier each. Keys are
//     distinct, so the unstable network gives the stable order. Then a double
//     scan of the pairs by warp shuffles plus the warp totals, a ballot for
//     the first crossing in each warp and a shared-memory atomicMin for the
//     row's.
//   * Sums run in double and each prefix is rounded to float32: a float32
//     running sum over a thousand votes drifts by more than 1e-6 relative.
//     For n > 32 the tree order of the scans rounds to the same float32 as a
//     sequential double sum everywhere but in rows whose prefix lies next to T.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowThreads = 64;     // n <= 32: one thread a row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Floats from a global address to its 16-byte boundary: the shift at which a
// span is placed in shared memory so that the two share their alignment.
__device__ __forceinline__ int float_shift(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Copies src[0, count) to dst[shift, shift + count), where dst is 16-byte
// aligned shared memory and shift = float_shift(src).
__device__ __forceinline__ void stage(float* dst, const float* src, int count,
                                      int shift) {
  const int head = min(count, (4 - shift) & 3);
  const int nvec = (count - head) >> 2;
  float* d = dst + shift;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x)
    cp_async16(d + head + 4 * v, src + head + 4 * v);
  for (int e = threadIdx.x; e < head; e += blockDim.x) cp_async4(d + e, src + e);
  for (int e = head + 4 * nvec + threadIdx.x; e < count; e += blockDim.x)
    cp_async4(d + e, src + e);
}

// Stores src[shift, shift + count) of 16-byte aligned shared memory to
// dst[0, count), where shift = dst's address modulo 16.
__device__ __forceinline__ void store_bytes(bool* dst, const unsigned char* src,
                                            int count, int shift) {
  const int head = min(count, (16 - shift) & 15);
  const int nvec = (count - head) >> 4;
  const unsigned char* s = src + shift;
  unsigned char* d = reinterpret_cast<unsigned char*>(dst);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x)
    *reinterpret_cast<uint4*>(d + head + 16 * v) =
        *reinterpret_cast<const uint4*>(s + head + 16 * v);
  for (int e = threadIdx.x; e < head; e += blockDim.x) d[e] = s[e];
  for (int e = head + 16 * nvec + threadIdx.x; e < count; e += blockDim.x) d[e] = s[e];
}

// float32 -> uint32 whose unsigned order is torch.sort's ascending order,
// with -0.0 tied to +0.0 and all NaNs tied above +inf.
__device__ __forceinline__ uint32_t order_bits(float t) {
  uint32_t b = __float_as_uint(t);
  if (isnan(t)) b = 0x7fc00000u;
  else if (t == 0.0f) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ uint64_t vote_key(float t, int j) {
  return (static_cast<uint64_t>(order_bits(t)) << 32) | static_cast<uint32_t>(j);
}

__device__ __forceinline__ void write_row(int64_t row, bool commit, float t,
                                          int k, float sum, float* commit_time,
                                          int32_t* quorum_size, bool* committed,
                                          float* weight_sum) {
  commit_time[row] = commit ? t : __int_as_float(0x7f800000);  // +inf
  quorum_size[row] = commit ? k + 1 : 0;
  committed[row] = commit;
  weight_sum[row] = commit ? sum : 0.0f;
}

// n <= 32: one thread a row, the kernel instantiated for each n = N.
template <int N>
__global__ void __launch_bounds__(kRowThreads) quorum_commit_row_kernel(
    const float* __restrict__ arrivals, const float* __restrict__ weights,
    const float* __restrict__ threshold, int64_t ops, int n,
    float* __restrict__ commit_time, int32_t* __restrict__ quorum_size,
    bool* __restrict__ committed, float* __restrict__ weight_sum,
    bool* __restrict__ members) {
  constexpr int S = N | 1;    // odd row stride: a warp's rows in distinct banks
  __shared__ __align__(16) float s_t[kRowThreads * S + 4];
  __shared__ __align__(16) float s_w[kRowThreads * S + 4];
  __shared__ float s_pt[kRowThreads * S];   // arrival at each position
  __shared__ float s_pw[kRowThreads * S];   // counted weight at each position
  __shared__ __align__(16) unsigned char s_m[kRowThreads * N + 16];

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowThreads;
  const int rows = ops - row0 < kRowThreads ? static_cast<int>(ops - row0) : kRowThreads;
  const int count = rows * N;
  const float* t_in = arrivals + row0 * N;
  const float* w_in = weights + row0 * N;
  int tshift = 0, wshift = 0;
  if constexpr (S == N) {       // odd n: the rows lie in shared memory as in device memory
    tshift = float_shift(t_in);
    wshift = float_shift(w_in);
    stage(s_t, t_in, count, tshift);
    stage(s_w, w_in, count, wshift);
  } else {                      // even n: one float a copy, to rows of N + 1
    for (int e = threadIdx.x; e < count; e += kRowThreads) {
      const int r = e / N, c = e - r * N;
      cp_async4(s_t + r * S + c, t_in + e);
      cp_async4(s_w + r * S + c, w_in + e);
    }
  }
  bool* m_out = members != nullptr ? members + row0 * N : nullptr;
  const int mshift = static_cast<int>(reinterpret_cast<uintptr_t>(m_out) & 15);
  cp_async_wait_all();
  __syncthreads();

  const int r = threadIdx.x;
  if (r < rows) {
    const float* t = s_t + tshift + r * S;
    const float* w = s_w + wshift + r * S;
    float tj[N];
    uint32_t bj[N];
    int rank[N];
    double total = 0.0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      tj[j] = t[j];
      bj[j] = order_bits(tj[j]);
      rank[j] = 0;
      total += w[j];
    }
    // rank: the votes whose key (order bits, index) is below one's own; of a
    // pair i < j, i comes first unless its order bits are greater
#pragma unroll
    for (int j = 1; j < N; ++j) {
#pragma unroll
      for (int i = 0; i < j; ++i) {
        const bool i_first = bj[i] <= bj[j];
        rank[j] += i_first;
        rank[i] += !i_first;
      }
    }
    float* pt = s_pt + r * S;
    float* pw = s_pw + r * S;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      pt[rank[j]] = tj[j];
      pw[rank[j]] = isfinite(tj[j]) ? w[j] : 0.0f;
    }
    float T = static_cast<float>(total) / 2.0f;
    if (threshold != nullptr) T = threshold[row0 + r];
    double sum = 0.0;
    int k = -1;
    bool commit = false;
    float tk = 0.0f, sk = 0.0f;
#pragma unroll
    for (int p = 0; p < N; ++p) {
      const float tp = pt[p];
      sum += pw[p];
      const float prefix = static_cast<float>(sum);
      const bool crossed = prefix > T;
      if (crossed && k < 0) {
        k = p;
        tk = tp;
        sk = prefix;
      }
      commit |= crossed && isfinite(tp);
    }
    write_row(row0 + r, commit, tk, k, sk, commit_time, quorum_size, committed,
              weight_sum);
    if (m_out != nullptr) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        s_m[mshift + r * N + j] = commit && isfinite(tj[j]) && rank[j] <= k;
    }
  }
  if (m_out != nullptr) {
    __syncthreads();
    store_bytes(m_out, s_m, count, mshift);
  }
}

template <int P>
struct Large {
  static constexpr int kThreads = P >= 1024 ? 512 : 256;
  static constexpr int kPerRow = P / 2;               // threads a row
  static constexpr int kRows = kThreads / kPerRow;    // rows a block
  static constexpr int kWarpsPerRow = kPerRow / 32;
};

// 33 <= n <= 1024: a row padded to P = next_pow2(n) keys, P/2 threads a row.
template <int P>
__global__ void __launch_bounds__(Large<P>::kThreads) quorum_commit_large_kernel(
    const float* __restrict__ arrivals, const float* __restrict__ weights,
    const float* __restrict__ threshold, int64_t ops, int n,
    float* __restrict__ commit_time, int32_t* __restrict__ quorum_size,
    bool* __restrict__ committed, float* __restrict__ weight_sum,
    bool* __restrict__ members) {
  using L = Large<P>;
  // exchanges at distance 64 or more go through shared memory, two buffers
  constexpr int kShared = P > 64 ? L::kRows * P : 1;
  __shared__ __align__(16) float s_t[L::kRows * P + 4];
  __shared__ __align__(16) float s_w[L::kRows * P + 4];
  __shared__ __align__(16) unsigned char s_m[L::kRows * P + 16];
  __shared__ uint64_t s_key[2][kShared];
  __shared__ double s_tot[L::kThreads / 32][2];     // each warp's votes, all
  __shared__ int s_k[L::kRows];
  __shared__ int s_c[L::kRows];

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * L::kRows;
  const int rows = ops - row0 < L::kRows ? static_cast<int>(ops - row0) : L::kRows;
  const int count = rows * n;
  const float* t_in = arrivals + row0 * n;
  const float* w_in = weights + row0 * n;
  const int tshift = float_shift(t_in), wshift = float_shift(w_in);
  stage(s_t, t_in, count, tshift);
  stage(s_w, w_in, count, wshift);
  bool* m_out = members != nullptr ? members + row0 * n : nullptr;
  const int mshift = static_cast<int>(reinterpret_cast<uintptr_t>(m_out) & 15);

  const int r = threadIdx.x / L::kPerRow;
  const int i = threadIdx.x % L::kPerRow;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool live = r < rows;
  const float* t = s_t + tshift + r * n;
  const float* w = s_w + wshift + r * n;
  if (i == 0) {
    s_k[r] = P;
    s_c[r] = 0;
  }
  cp_async_wait_all();
  __syncthreads();

  // positions q0 = 2i and q0 + 1, first holding replicas q0 and q0 + 1
  const int q0 = 2 * i;
  const bool in0 = live && q0 < n, in1 = live && q0 + 1 < n;
  uint64_t k0 = in0 ? vote_key(t[q0], q0) : ~0ull;
  uint64_t k1 = in1 ? vote_key(t[q0 + 1], q0 + 1) : ~0ull;
  double all = 0.0;                  // weights of all n replicas, for T
  if (in0) all += w[q0];
  if (in1) all += w[q0 + 1];

  int buf = 0;
#pragma unroll
  for (int size = 2; size <= P; size <<= 1) {
    const bool up = (q0 & size) == 0;
#pragma unroll
    for (int dist = size >> 1; dist > 0; dist >>= 1) {
      if (dist == 1) {
        if ((k0 > k1) == up) {
          const uint64_t x = k0;
          k0 = k1;
          k1 = x;
        }
        continue;
      }
      uint64_t o0, o1;                // the keys at q0 ^ dist and q0 + 1 ^ dist
      if (dist < 64) {
        o0 = __shfl_xor_sync(kFull, k0, dist >> 1);
        o1 = __shfl_xor_sync(kFull, k1, dist >> 1);
      } else {
        uint64_t* key = s_key[buf] + r * P;
        key[q0] = k0;
        key[q0 + 1] = k1;
        __syncthreads();
        o0 = key[q0 ^ dist];
        o1 = key[(q0 + 1) ^ dist];
        buf ^= 1;
      }
      const bool keep_min = ((q0 & dist) == 0) == up;
      if (keep_min ? o0 < k0 : o0 > k0) k0 = o0;
      if (keep_min ? o1 < k1 : o1 > k1) k1 = o1;
    }
  }

  const uint32_t j0 = static_cast<uint32_t>(k0), j1 = static_cast<uint32_t>(k1);
  const float t0 = in0 ? t[j0] : 0.0f;
  const float t1 = in1 ? t[j1] : 0.0f;
  const float v0 = (in0 && isfinite(t0)) ? w[j0] : 0.0f;
  const float v1 = (in1 && isfinite(t1)) ? w[j1] : 0.0f;
  const double pair = static_cast<double>(v0) + static_cast<double>(v1);
  double incl = pair;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double below = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += below;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) all += __shfl_xor_sync(kFull, all, o);
  double excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0;
  if (lane == 31) {
    s_tot[warp][0] = incl;
    s_tot[warp][1] = all;
  }
  __syncthreads();
  const int first = r * L::kWarpsPerRow;
  double offset = 0.0, total = 0.0;
  for (int v = first; v < first + L::kWarpsPerRow; ++v) {
    if (v < warp) offset += s_tot[v][0];
    total += s_tot[v][1];
  }
  const double base = offset + excl;
  const float p0 = static_cast<float>(base + v0);
  const float p1 = static_cast<float>(base + pair);
  float T = static_cast<float>(total) / 2.0f;
  if (threshold != nullptr && live) T = threshold[row0 + r];
  const bool c0 = in0 && p0 > T, c1 = in1 && p1 > T;
  const int cand = c0 ? q0 : (c1 ? q0 + 1 : P);
  const unsigned any = __ballot_sync(kFull, c0 || c1);
  const int warp_k = __shfl_sync(kFull, cand, any != 0u ? __ffs(any) - 1 : 0);
  const bool vote = (c0 && isfinite(t0)) || (c1 && isfinite(t1));
  const bool warp_commit = __ballot_sync(kFull, vote) != 0u;
  if (lane == 0 && any != 0u) atomicMin(&s_k[r], warp_k);
  if (lane == 0 && warp_commit) s_c[r] = 1;
  __syncthreads();

  const int k = s_k[r];
  const bool commit = s_c[r] != 0;
  if (live && (commit ? (k == q0 || k == q0 + 1) : i == 0))
    write_row(row0 + r, commit, k == q0 ? t0 : t1, k, k == q0 ? p0 : p1,
              commit_time, quorum_size, committed, weight_sum);
  if (m_out != nullptr) {
    // the replica at each position: a member when finite and at or before k
    unsigned char* m = s_m + mshift + r * n;
    if (in0) m[j0] = commit && isfinite(t0) && q0 <= k;
    if (in1) m[j1] = commit && isfinite(t1) && q0 + 1 <= k;
    __syncthreads();
    store_bytes(m_out, s_m, count, mshift);
  }
}

struct Args {
  const float* arrivals;
  const float* weights;
  const float* threshold;
  int64_t ops;
  int n;
  float* commit_time;
  int32_t* quorum_size;
  bool* committed;
  float* weight_sum;
  bool* members;
};

template <int N>
void launch_rows(const Args& a, cudaStream_t stream) {
  if (a.n != N) {
    if constexpr (N < 32) launch_rows<N + 1>(a, stream);
    return;
  }
  const auto blocks = static_cast<unsigned>((a.ops + kRowThreads - 1) / kRowThreads);
  quorum_commit_row_kernel<N><<<blocks, kRowThreads, 0, stream>>>(
      a.arrivals, a.weights, a.threshold, a.ops, a.n, a.commit_time,
      a.quorum_size, a.committed, a.weight_sum, a.members);
}

template <int P>
void launch_large(const Args& a, cudaStream_t stream) {
  constexpr int64_t rows = Large<P>::kRows;
  const auto blocks = static_cast<unsigned>((a.ops + rows - 1) / rows);
  quorum_commit_large_kernel<P><<<blocks, Large<P>::kThreads, 0, stream>>>(
      a.arrivals, a.weights, a.threshold, a.ops, a.n, a.commit_time,
      a.quorum_size, a.committed, a.weight_sum, a.members);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); `threshold` and
// `members` may be null (threshold = sum(w)/2, no members mask). Any pointer
// need only be aligned to its element; 1 <= n <= 1024.
extern "C" int quorum_commit_launch(
    const float* arrivals, const float* weights, const float* threshold,
    int64_t ops, int n, float* commit_time, int32_t* quorum_size,
    bool* committed, float* weight_sum, bool* members, cudaStream_t stream) {
  if (n < 1 || n > 1024 || ops < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (ops == 0) return static_cast<int>(cudaSuccess);
  const Args a{arrivals, weights, threshold, ops, n, commit_time, quorum_size,
               committed, weight_sum, members};
  if (n <= 32) {
    launch_rows<1>(a, stream);
  } else if (n <= 64) {
    launch_large<64>(a, stream);
  } else if (n <= 128) {
    launch_large<128>(a, stream);
  } else if (n <= 256) {
    launch_large<256>(a, stream);
  } else if (n <= 512) {
    launch_large<512>(a, stream);
  } else {
    launch_large<1024>(a, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
