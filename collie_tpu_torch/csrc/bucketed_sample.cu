// The degree-bucketed complement sampler's pass, hand-written for Hopper
// (sm_90a): every grouped slot's negatives drawn, counted and deduplicated
// in one launch.
//
// No Pallas kernel is replaced: the JAX package's
// ``complement_sample_negatives_bucketed_grouped_impl``
// (collie_tpu/ops/device_sampling.py:237-325) is jnp code under XLA.  The
// port's plain version (``complement_sample_negatives_bucketed_grouped_plain``
// in ops/device_sampling.py) runs it as some fifteen torch passes: the
// product and clamp of the uniforms, a copy of each slot's whole table row
// for ``searchsorted``, and a dedup built on an ``[N_g, K, K]`` compare and an
// int64 ``cumsum``.  This kernel gives the same values for every slot.
//
// What each grouped slot s computes (W = K + 2 * rounds uniforms a slot):
//   size = max(num_items - row_counts[users_g[s]], 1)
//   r_j  = min(trunc(u01[s, j] * (float)size), size - 1)   float32, rounded
//          to nearest, no FMA (the torch product, then ``.to(int32)``)
//   d_j  = r_j + |{i : row[i] <= r_j}|  over the slot's table row, all P_b
//          entries (the shifted positives, then the sentinel num_items)
// then, for each dedup round, on the first K values as they stand: the
// m-th value equal to an earlier one (m = 0, 1) takes the round's m-th
// spare, d_{K + 2 round + m}; later duplicates stay.  Bucket-pad slots take
// user 0 and row 0 of their bucket, as the plain version does, and a user
// who holds every item gets the sentinel num_items.
//
// Bound: bytes.  Each slot reads 4 W bytes of uniforms, its user, its row
// index and its user's count, and writes 4 K bytes; the tables (41.2 MB at
// MovieLens-10M) are read at least once.  At the ML-10M cell (N_g ~ 5.6M,
// W = 12, K = 10: 100 bytes a slot) that is ~0.60 GB, 0.18 ms at 3.35
// TB/s.  What sets the
// pace is the probes: W binary searches of log2(P_b) + 1 dependent loads a
// slot.  The design:
//   * one thread a slot, 128 a block, over all buckets in one grid: the
//     buckets' tables, row indices, first slots and widths come by value in
//     a ``__grid_constant__`` parameter, so nothing is built on the card for
//     a launch;
//   * the block's uniforms are staged into shared memory by coalesced loads
//     (rows padded to an odd stride against bank conflicts), and its
//     negatives leave the same way;
//   * the W searches of a slot advance together, one level at a time
//     (branchless, the same number of levels for every row of a bucket), so
//     a thread keeps W independent loads in flight;
//   * the tables fit in the 50 MB L2, and neighbouring slots mostly share a
//     user (grouped order is user-sorted within a bucket), so a warp's
//     probes fall on one or a few rows, most of them L1 hits;
//   * the values live in registers, unrolled to a compile-time bound on W
//     (8, 16, 32 or 64), and the dedup runs there on a bit mask.
// Wider rows (W > 64, far from any configuration the port trains) take a
// second kernel, one thread a slot and nothing staged: the slot's values
// live in its row of ``out``, each round's two spares are drawn when the
// round comes, and a round finds its first two duplicates by a scan of the
// row as the round found it (K^2 / 2 compares) before it puts the spares in
// their places.
//
// C interface (loaded with ctypes): collie_bucketed_sample(...) returns the
// cudaError_t of its launch, 0 on success; it launches on the given stream,
// does not synchronise and allocates nothing.  The bucket arrays are host
// arrays, read before the launch.  collie_bucketed_sample_abi() names the
// interface's version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
// The bucketed tables' widths double from their lane (128) until one holds
// num_items < 2^31: at most 25 buckets, and 32 at a lane of 1.
constexpr int kMaxBuckets = 32;
// The widest row of uniforms the register kernel takes.
constexpr int kMaxWidth = 64;

struct Bucket {
  const int* table;     // [rows, width] int32, row-major
  const int* row_idx;   // [slots of the bucket] int32
  long long start;      // the bucket's first grouped slot
  int width;
};

struct Buckets {
  Bucket b[kMaxBuckets];
  long long end;        // the number of grouped slots
  int count;
};

// Slot s's table row; its width and its user's complement size.
__device__ __forceinline__ const int* slot_row(const Buckets& buckets, long long s,
                                               const int* users_g, const int* row_counts,
                                               int num_items, int* width, int* size) {
  int b = 0;
  while (b + 1 < buckets.count && s >= buckets.b[b + 1].start) ++b;
  const Bucket& bucket = buckets.b[b];
  const int count = __ldg(row_counts + __ldg(users_g + s));
  *width = bucket.width;
  *size = num_items - count > 1 ? num_items - count : 1;
  return bucket.table +
         static_cast<long long>(__ldg(bucket.row_idx + (s - bucket.start))) * bucket.width;
}

// The torch composition's draw: the float32 product rounded to nearest (no
// FMA contraction), truncated, at most size - 1.
__device__ __forceinline__ int draw(float u, int size) {
  return min(__float2int_rz(__fmul_rn(u, __int2float_rn(size))), size - 1);
}

template <int MAXW>
__global__ void __launch_bounds__(kThreads)
    bucketed_sample_kernel(const __grid_constant__ Buckets buckets,
                           const float* __restrict__ u01, const int* __restrict__ users_g,
                           const int* __restrict__ row_counts, int num_items, int K, int rounds,
                           int* __restrict__ out) {
  extern __shared__ int stage[];
  const int W = K + 2 * rounds;
  const int in_stride = W | 1;
  const int out_stride = K | 1;
  const int t = threadIdx.x;
  const long long s0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long left = buckets.end - s0;
  const int here = left < kThreads ? static_cast<int>(left) : kThreads;

  const float* src = u01 + s0 * W;
  float* stage_f = reinterpret_cast<float*>(stage);
  for (int e = t; e < here * W; e += kThreads) {
    const int row = e / W;
    stage_f[row * in_stride + (e - row * W)] = __ldg(src + e);
  }
  __syncthreads();

  int d[MAXW];
  if (t < here) {
    int width, size;
    const int* row = slot_row(buckets, s0 + t, users_g, row_counts, num_items, &width, &size);
    const float* mine = stage_f + t * in_stride;
#pragma unroll
    for (int j = 0; j < MAXW; ++j) {
      d[j] = 0;
      if (j < W) d[j] = draw(mine[j], size);
    }
    // |{i : row[i] <= r}| for the W values at once: the answer lies in
    // [base, base + len]; each level halves len, and a last probe settles it
    int base[MAXW];
#pragma unroll
    for (int j = 0; j < MAXW; ++j) base[j] = 0;
    for (int len = width; len > 1;) {
      const int half = len >> 1;
#pragma unroll
      for (int j = 0; j < MAXW; ++j) {
        if (j < W && __ldg(row + base[j] + half) <= d[j]) base[j] += half;
      }
      len -= half;
    }
#pragma unroll
    for (int j = 0; j < MAXW; ++j) {
      if (j < W) d[j] += base[j] + (__ldg(row + base[j]) <= d[j] ? 1 : 0);
    }

    for (int round = 0; round < rounds; ++round) {
      int spare0 = 0, spare1 = 0;
#pragma unroll
      for (int j = 0; j < MAXW; ++j) {
        if (j == K + 2 * round) spare0 = d[j];
        if (j == K + 2 * round + 1) spare1 = d[j];
      }
      unsigned long long dup = 0;
#pragma unroll
      for (int j = 1; j < MAXW; ++j) {
        bool seen = false;
#pragma unroll
        for (int i = 0; i < j; ++i) seen |= d[i] == d[j];
        if (j < K && seen) dup |= 1ull << j;
      }
      int taken = 0;
#pragma unroll
      for (int j = 1; j < MAXW; ++j) {
        if ((dup >> j) & 1ull) {
          if (taken == 0) d[j] = spare0;
          if (taken == 1) d[j] = spare1;
          ++taken;
        }
      }
    }
  }
  __syncthreads();

  if (t < here) {
#pragma unroll
    for (int j = 0; j < MAXW; ++j) {
      if (j < K) stage[t * out_stride + j] = d[j];
    }
  }
  __syncthreads();
  int* dst = out + s0 * K;
  for (int e = t; e < here * K; e += kThreads) {
    const int row = e / K;
    dst[e] = stage[row * out_stride + (e - row * K)];
  }
}

// r + |{i : row[i] <= r}| by the register kernel's search, one value.
__device__ __forceinline__ int complement_value(const int* row, int width, int r) {
  int base = 0;
  for (int len = width; len > 1;) {
    const int half = len >> 1;
    if (__ldg(row + base + half) <= r) base += half;
    len -= half;
  }
  return r + base + (__ldg(row + base) <= r ? 1 : 0);
}

__global__ void __launch_bounds__(kThreads)
    bucketed_sample_wide_kernel(const __grid_constant__ Buckets buckets,
                                const float* __restrict__ u01, const int* __restrict__ users_g,
                                const int* __restrict__ row_counts, int num_items, int K,
                                int rounds, int* __restrict__ out) {
  const long long s = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= buckets.end) return;
  int width, size;
  const int* row = slot_row(buckets, s, users_g, row_counts, num_items, &width, &size);
  const float* mine = u01 + s * (K + 2ll * rounds);
  int* d = out + s * K;
  for (int j = 0; j < K; ++j) d[j] = complement_value(row, width, draw(__ldg(mine + j), size));
  for (int round = 0; round < rounds; ++round) {
    int first = -1, second = -1;
    for (int j = 1; j < K && second < 0; ++j) {
      bool seen = false;
      for (int i = 0; i < j && !seen; ++i) seen = d[i] == d[j];
      if (seen && first < 0) {
        first = j;
      } else if (seen) {
        second = j;
      }
    }
    const float* spares = mine + K + 2 * round;
    if (first >= 0) d[first] = complement_value(row, width, draw(__ldg(spares), size));
    if (second >= 0) d[second] = complement_value(row, width, draw(__ldg(spares + 1), size));
  }
}

template <int MAXW>
cudaError_t launch(const Buckets& buckets, const float* u01, const int* users_g,
                   const int* row_counts, int num_items, int K, int rounds, int* out,
                   cudaStream_t stream) {
  const int W = K + 2 * rounds;
  const int stride = (W | 1) > (K | 1) ? (W | 1) : (K | 1);
  const size_t shared = static_cast<size_t>(kThreads) * stride * sizeof(int);
  const long long blocks = (buckets.end + kThreads - 1) / kThreads;
  bucketed_sample_kernel<MAXW><<<static_cast<unsigned>(blocks), kThreads, shared, stream>>>(
      buckets, u01, users_g, row_counts, num_items, K, rounds, out);
  return cudaGetLastError();
}

cudaError_t launch_wide(const Buckets& buckets, const float* u01, const int* users_g,
                        const int* row_counts, int num_items, int K, int rounds, int* out,
                        cudaStream_t stream) {
  const long long blocks = (buckets.end + kThreads - 1) / kThreads;
  bucketed_sample_wide_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      buckets, u01, users_g, row_counts, num_items, K, rounds, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int collie_bucketed_sample_abi() { return 2; }

extern "C" int collie_bucketed_sample(const float* u01,         // [n_slots, K + 2 rounds]
                                      const int* users_g,       // [n_slots]
                                      const int* row_counts,    // [num_users]
                                      long long n_slots, int num_items, int K, int rounds,
                                      int n_buckets,
                                      const long long* tables,  // host: [n_buckets] pointers
                                      const long long* row_idx, // host: [n_buckets] pointers
                                      const long long* starts,  // host: [n_buckets] first slots
                                      const int* widths,        // host: [n_buckets]
                                      int* out,                 // [n_slots, K]
                                      void* stream_ptr) {
  const long long W = static_cast<long long>(K) + 2ll * rounds;
  if (u01 == nullptr || users_g == nullptr || row_counts == nullptr || out == nullptr ||
      n_slots < 1 || (n_slots + kThreads - 1) / kThreads > 2147483647ll || K < 1 ||
      rounds < 0 || W > 2147483647ll || n_buckets < 1 || n_buckets > kMaxBuckets ||
      starts[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Buckets buckets{};
  for (int b = 0; b < n_buckets; ++b) {
    if (widths[b] < 1 || starts[b] > n_slots || (b > 0 && starts[b] < starts[b - 1]))
      return static_cast<int>(cudaErrorInvalidValue);
    buckets.b[b] = Bucket{reinterpret_cast<const int*>(tables[b]),
                          reinterpret_cast<const int*>(row_idx[b]), starts[b], widths[b]};
  }
  buckets.end = n_slots;
  buckets.count = n_buckets;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (W > kMaxWidth)
    return launch_wide(buckets, u01, users_g, row_counts, num_items, K, rounds, out, stream);
  if (W <= 8) return launch<8>(buckets, u01, users_g, row_counts, num_items, K, rounds, out, stream);
  if (W <= 16) return launch<16>(buckets, u01, users_g, row_counts, num_items, K, rounds, out, stream);
  if (W <= 32) return launch<32>(buckets, u01, users_g, row_counts, num_items, K, rounds, out, stream);
  return launch<64>(buckets, u01, users_g, row_counts, num_items, K, rounds, out, stream);
}
