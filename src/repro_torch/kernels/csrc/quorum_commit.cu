// K1 on Hopper: the earliest strict weighted-quorum crossing for a batch of
// operations.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/quorum_commit.py,
// `_kernel` and the sorting network it calls, `_bitonic_by_time`. The plain
// PyTorch version of the same function is `quorum_commit_plain` in
// src/repro_torch/kernels/quorum_commit.py.
//
// Per op row (arrivals t[0..n), weights w[0..n), threshold T, by default
// sum(w)/2 over all n replicas, voters or not): walk the votes in stable
// arrival order (ascending t, ties by replica index, NaN last, the order of
// torch.sort(stable=True) and of jnp.argsort), add the weight of each finite
// vote to a running sum, and take the first position k where the sum, rounded
// to float32, strictly exceeds T. The op commits when a finite vote sits at or
// after k; then commit_time = t at k, quorum_size = k + 1, weight_sum = the
// rounded sum at k, and members marks the finite votes at or before k.
// Otherwise inf, 0, 0, false and no members.
//
// Bound: memory bytes. A row reads 8*n bytes and writes 13 (plus n for the
// members mask) and does a few comparisons per byte in registers, far below
// the operations per byte at which the card becomes compute bound.
//
// What the design does about that bound:
//   * One thread per row, and a block's rows are contiguous, so a warp's 32
//     rows are one contiguous span of each input: every byte comes from
//     device memory once, and the walk's re-reads of the row hit L1.
//   * The ragged edges (ops not a multiple of the block, any n) are masked in
//     place: there is no padded copy, which the TPU version writes and reads
//     again.
//   * Threshold, order, scan and membership are one pass: no intermediate (a
//     sorted copy, a prefix sum) goes to device memory.
//   * Sums run in double and each prefix is rounded to float32, as torch's
//     CPU cumsum does: a float32 running sum over a thousand votes drifts
//     by more than 1e-6 relative, which the double sum does not.
//   * The order is found by selection (the next vote after the previous one
//     in (t, index) order), which needs no scratch memory and stops at the
//     crossing where a sorting network sorts the whole row. Being stable, it
//     gives the plain version's quorum_size, weight_sum and members even under
//     tied arrivals, which the unstable bitonic network does not.
//
// The walk costs O(n * k) comparisons for a crossing at position k, O(n^2)
// for a row that does not commit; the wrapper admits n up to 1024.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// a before b in torch.sort's ascending order: NaN after everything, NaNs tie
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (isnan(b) && !isnan(a));
}

// vote (ta, a) strictly before vote (tb, b) in the stable order
__device__ __forceinline__ bool precedes(float ta, int a, float tb, int b) {
  return before(ta, tb) || (!before(tb, ta) && a < b);
}

__global__ void __launch_bounds__(kThreads) quorum_commit_kernel(
    const float* __restrict__ arrivals, const float* __restrict__ weights,
    const float* __restrict__ threshold, int64_t ops, int n,
    float* __restrict__ commit_time, int32_t* __restrict__ quorum_size,
    bool* __restrict__ committed, float* __restrict__ weight_sum,
    bool* __restrict__ members) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= ops) return;
  const float* t = arrivals + row * n;
  const float* w = weights + row * n;

  float T;
  if (threshold != nullptr) {
    T = threshold[row];
  } else {
    double total = 0.0;
    for (int j = 0; j < n; ++j) total += w[j];
    T = static_cast<float>(total) / 2.0f;
  }

  double sum = 0.0;
  bool commit = false;
  int iq = -1;               // the vote at the first crossing, position k
  int k = -1;
  float tq = 0.0f, sq = 0.0f;
  int ip = -1;               // the previous vote in the order, (tp, ip)
  float tp = 0.0f;
  for (int p = 0; p < n; ++p) {
    int iv = -1;
    float tv = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float tj = t[j];
      if (ip >= 0 && !precedes(tp, ip, tj, j)) continue;
      if (iv < 0 || precedes(tj, j, tv, iv)) {
        iv = j;
        tv = tj;
      }
    }
    tp = tv;
    ip = iv;
    const bool finite = isfinite(tv);
    if (finite) sum += w[iv];
    const float prefix = static_cast<float>(sum);
    const bool crossed = prefix > T;
    if (crossed && k < 0) {
      k = p;
      iq = iv;
      tq = tv;
      sq = prefix;
    }
    if (crossed && finite) {
      commit = true;
      break;
    }
  }

  commit_time[row] = commit ? tq : __int_as_float(0x7f800000);  // +inf
  quorum_size[row] = commit ? k + 1 : 0;
  committed[row] = commit;
  weight_sum[row] = commit ? sq : 0.0f;
  if (members != nullptr) {
    bool* m = members + row * n;
    for (int j = 0; j < n; ++j) {
      const float tj = t[j];
      m[j] = commit && isfinite(tj) && (j == iq || precedes(tj, j, tq, iq));
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); `threshold` and
// `members` may be null (threshold = sum(w)/2, no members mask).
extern "C" int quorum_commit_launch(
    const float* arrivals, const float* weights, const float* threshold,
    int64_t ops, int n, float* commit_time, int32_t* quorum_size,
    bool* committed, float* weight_sum, bool* members, cudaStream_t stream) {
  const int64_t blocks = (ops + kThreads - 1) / kThreads;
  quorum_commit_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      arrivals, weights, threshold, ops, n, commit_time, quorum_size,
      committed, weight_sum, members);
  return static_cast<int>(cudaGetLastError());
}
