// Binned gather and scatter-add of embedding rows, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel ``pk`` of benchmarks/microbench_gather.py
// (:151, launched by ``pallas_binned`` at :185-201), the experiment that
// framed the at-scale fused-epoch design: ITERS rounds of gathering the rows
// of B example ids from a transposed table ``[D, UPAD]`` and scatter-adding
// one gradient column ``[D]`` per example back into them.  The TPU kernel
// sorts the ids by bin (N_BINS bins of UB rows), keeps the table in VMEM and
// "gathers" and "scatters" with one-hot MXU matmuls over a window of C_PAD
// sorted examples per bin; an example whose position inside its bin is
// >= C_PAD falls outside the window and is dropped, and so is one whose id
// lies outside its bin.  Each bin gathers before it scatters, so every
// gather of a round sees the table as it stood at the start of that round.
//
// A kept example of bin j touches bin j's rows and nothing else, so bins
// are independent for all rounds: only the blocks that serve one bin need
// to agree on round boundaries.  The kernel gives each bin one thread-block
// cluster (at most 8 blocks, launched with cudaLaunchKernelEx; clusters loop
// over bins when more bins than resident clusters):
//   * the bin's rows live in the cluster's distributed shared memory for
//     all rounds, split across its blocks, row-major with an odd row stride
//     (one example's D values contiguous, a transposing copy without bank
//     conflicts).  They are copied in once from ``tab`` and written out once
//     to ``out``;
//   * the bin's window of examples is split into contiguous shares, one per
//     block; a block caches its share's local rows and gradient columns in
//     its own shared memory once per bin;
//   * a round is a gather phase and a scatter phase, each closed by
//     ``cluster.sync()``.  A warp takes an example, its lanes the dims: the
//     gather reads the row through ``cluster.map_shared_rank`` and sums it
//     into registers, then into the block's ``[D]`` partial sums, which one
//     atomicAdd per (round, d) adds to ``gathered``; the scatter atomicAdds
//     the gradient column into the row where it lives.  Duplicate ids sum in
//     a run-dependent order;
//   * where a bin's rows do not fit the shared memory of a cluster of 8, the
//     same kernel keeps them in ``out`` (device memory, read with ``__ldcg``,
//     scatter-added with global atomics) and still syncs per cluster; where
//     the example cache does not fit, ids and gradients are read from device
//     memory each round.  ``collie_gather_scatter_plan`` picks the mode, and
//     ``collie_binned_gather_scatter`` reports the one it launched.
// There is no grid barrier and no cooperative launch.  Nothing past B is
// read: a window that would run past the arrays (the TPU kernel's
// ``pl.ds(o, C_PAD)`` near the end) only keeps the examples that exist.
//
// Bound: the function must read the table, the gradients and the ids once
// and write ``out`` once, 8 D UPAD + 4 D B + 4 B bytes; about 2 ITERS B D
// operations.  At the microbench's shape (D = 32, UPAD = 73,728, B = 8,192,
// ITERS = 50) that is about 20 MB, 6 us at 3.35 TB/s: bytes-bound.  Rows in
// shared memory cross HBM once each way; what the bound does not count is
// the 2 ITERS cluster barriers and the shared-memory atomics.
//
// C interface (loaded with ctypes): collie_binned_gather_scatter(...) returns
// the cudaError_t of its launch, 0 on success.  It launches on the given
// stream, does not synchronise and allocates nothing; ``gathered`` must be
// zeroed by the caller.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;                 // the portable cluster size
constexpr long long kTargetBytes = 98304;      // smallest cluster whose blocks stay under this
constexpr long long kMaxSharedBytes = 232448;  // 227 KB a block may use on sm_90

struct Plan {
  int shared_rows;     // 1: bin rows in distributed shared memory; 0: in ``out``
  int cache;           // 1: each block caches its share's rows and gradients
  int cluster;         // blocks a bin
  int rows_per_block;  // of a bin's rows, in shared-rows mode
  int row_stride;      // floats a row in shared memory (odd)
  int max_share;       // examples a block's share holds at most
  long long shared_bytes;
};

Plan make_plan(int D, int upad, int n_bins, int B, int c_pad) {
  Plan p{};
  const int ub = upad / n_bins;
  p.row_stride = D | 1;
  const long long window = c_pad < B ? c_pad : B;
  const long long sums = 4LL * D;
  auto rows_bytes = [&](int cs) { return 4LL * ((ub + cs - 1) / cs) * p.row_stride; };
  auto cache_bytes = [&](int cs) { return 4LL * ((window + cs - 1) / cs) * (p.row_stride + 1); };
  int cs = 1;
  while (cs < kMaxCluster && rows_bytes(cs) + cache_bytes(cs) + sums > kTargetBytes) cs *= 2;
  p.cluster = cs;
  p.rows_per_block = (ub + cs - 1) / cs;
  p.max_share = static_cast<int>((window + cs - 1) / cs);
  if (rows_bytes(cs) + cache_bytes(cs) + sums <= kMaxSharedBytes) {
    p.shared_rows = 1, p.cache = 1;
  } else if (rows_bytes(cs) + sums <= kMaxSharedBytes) {
    p.shared_rows = 1, p.cache = 0;
  } else if (cache_bytes(cs) + sums <= kMaxSharedBytes) {
    p.shared_rows = 0, p.cache = 1;
  } else {
    p.shared_rows = 0, p.cache = 0;
  }
  p.shared_bytes = sums + (p.shared_rows ? rows_bytes(cs) : 0) + (p.cache ? cache_bytes(cs) : 0);
  return p;
}

struct Params {
  const float* tab;  // [D, UPAD]
  const int* sids;   // [B], stably sorted by bin
  const int* offs;   // [n_bins + 1]
  const float* g;    // [D, B]
  float* out;        // [D, UPAD]
  float* gathered;   // [iters, D], zeroed
  int D, upad, B, n_bins, iters, c_pad;
  int shared_rows, cache, rows_per_block, row_stride, max_share;
};

__global__ void __launch_bounds__(kThreads) binned_gather_scatter_kernel(const Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_clusters = gridDim.x / cs;
  const int cluster_id = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int D = p.D;
  const int DP = p.row_stride;
  const int ub = p.upad / p.n_bins;

  extern __shared__ __align__(16) float smem[];
  float* sums = smem;                                          // [D]
  float* rows = sums + D;                                      // [rows_per_block, DP]
  float* cache_g = rows + (p.shared_rows ? p.rows_per_block * DP : 0);  // [max_share, DP]
  int* cache_row = reinterpret_cast<int*>(cache_g + (p.cache ? p.max_share * DP : 0));
  for (int d = tid; d < D; d += kThreads) sums[d] = 0.f;

  for (int j = cluster_id; j < p.n_bins; j += n_clusters) {
    const size_t col0 = static_cast<size_t>(j) * ub;  // the bin's first row
    // this block's slice of the bin's rows
    const int r0 = rank * p.rows_per_block;
    const int nr = max(0, min(p.rows_per_block, ub - r0));
    // the bin's window of examples [o, o + n), and this block's share
    const int o = __ldg(p.offs + j);
    const int n = max(0, min(min(__ldg(p.offs + j + 1) - o, p.c_pad), p.B - o));
    const int per = (n + cs - 1) / cs;
    const int e0 = min(n, rank * per);
    const int mine = min(per, n - e0);

    // the local row of share example i, or -1 when its id is outside the bin
    auto row_of = [&](int i) {
      const int local = __ldg(p.sids + o + e0 + i) - j * ub;
      return (local >= 0 && local < ub) ? local : -1;
    };
#pragma unroll 8
    for (int i = tid; i < nr * D; i += kThreads) {
      const int d = i / nr;
      const int r = i - d * nr;
      const size_t at = static_cast<size_t>(d) * p.upad + col0 + r0 + r;
      if (p.shared_rows) {
        rows[r * DP + d] = __ldg(p.tab + at);
      } else {
        p.out[at] = __ldg(p.tab + at);
      }
    }
    if (p.cache) {
      for (int i = tid; i < mine; i += kThreads) cache_row[i] = row_of(i);
#pragma unroll 8
      for (int i = tid; i < mine * D; i += kThreads) {
        const int d = i / mine;
        const int e = i - d * mine;
        cache_g[e * DP + d] = __ldg(p.g + static_cast<size_t>(d) * p.B + o + e0 + e);
      }
    }
    cluster.sync();  // every block's rows are in place

    // element d of local row r: in the owning block's shared memory, or in out
    auto element = [&](int r, int d) -> float* {
      if (p.shared_rows) {
        const int owner = r / p.rows_per_block;
        float* base = cluster.map_shared_rank(rows, owner);
        return base + (r - owner * p.rows_per_block) * DP + d;
      }
      return p.out + static_cast<size_t>(d) * p.upad + col0 + r;
    };

    for (int round = 0; round < p.iters; ++round) {
      // gather: every kept example's row as it stood at the start of the round
      for (int d0 = 0; d0 < D; d0 += 32) {
        const int d = d0 + lane;
        float acc = 0.f;
#pragma unroll 4
        for (int i = warp; i < mine; i += kWarps) {
          const int r = p.cache ? cache_row[i] : row_of(i);
          if (r >= 0 && d < D) {
            const float* at = element(r, d);
            acc += p.shared_rows ? *at : __ldcg(at);
          }
        }
        if (d < D && acc != 0.f) atomicAdd(sums + d, acc);
      }
      cluster.sync();  // the round's gathers are done everywhere
      for (int d = tid; d < D; d += kThreads) {
        if (sums[d] != 0.f) atomicAdd(p.gathered + static_cast<size_t>(round) * D + d, sums[d]);
        sums[d] = 0.f;
      }
      // scatter-add the gradient columns
      for (int i = warp; i < mine; i += kWarps) {
        const int r = p.cache ? cache_row[i] : row_of(i);
        if (r < 0) continue;
        for (int d = lane; d < D; d += 32) {
          const float v = p.cache ? cache_g[i * DP + d]
                                  : __ldg(p.g + static_cast<size_t>(d) * p.B + o + e0 + i);
          atomicAdd(element(r, d), v);
        }
      }
      cluster.sync();  // the round's scatters are done everywhere
    }

    if (p.shared_rows) {
  #pragma unroll 8
    for (int i = tid; i < nr * D; i += kThreads) {
        const int d = i / nr;
        const int r = i - d * nr;
        p.out[static_cast<size_t>(d) * p.upad + col0 + r0 + r] = rows[r * DP + d];
      }
      __syncthreads();  // the slice is out before the next bin's rows come in
    }
  }
}

}  // namespace

// The launch plan for these shapes: writes the cluster size, whether the
// bin rows live in shared memory and whether the example cache is used,
// and returns the shared bytes of a block (-1 for shapes the kernel does
// not take).
extern "C" long long collie_gather_scatter_plan(int D, int upad, int n_bins, int B, int c_pad,
                                                int* shared_rows, int* cache, int* cluster) {
  if (D < 1 || upad < 1 || B < 1 || n_bins < 1 || upad % n_bins != 0 || c_pad < 0) return -1;
  const Plan plan = make_plan(D, upad, n_bins, B, c_pad);
  *shared_rows = plan.shared_rows;
  *cache = plan.cache;
  *cluster = plan.cluster;
  return plan.shared_bytes;
}

// ``launched`` (3 ints) receives (shared_rows, cache, cluster) of the launch.
extern "C" int collie_binned_gather_scatter(const float* tab, const int* sids, const int* offs,
                                            const float* g, float* out, float* gathered, int D,
                                            int upad, int B, int n_bins, int iters, int c_pad,
                                            int* launched, void* stream_ptr) {
  if (D < 1 || upad < 1 || B < 1 || n_bins < 1 || upad % n_bins != 0 || iters < 0 || c_pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = make_plan(D, upad, n_bins, B, c_pad);
  if (plan.shared_bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const Params params{tab, sids, offs, g, out, gathered, D, upad, B, n_bins, iters, c_pad,
                      plan.shared_rows, plan.cache, plan.rows_per_block, plan.row_stride,
                      plan.max_share};
  cudaError_t err = cudaFuncSetAttribute(binned_gather_scatter_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(plan.shared_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(plan.cluster * n_bins);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = plan.shared_bytes;
  config.stream = static_cast<cudaStream_t>(stream_ptr);
  config.attrs = attr;
  config.numAttrs = 1;
  // one cluster a bin, or as many as are resident at once, looping over bins
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, binned_gather_scatter_kernel, &config);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int clusters = n_bins < resident ? n_bins : resident;
  config.gridDim = dim3(plan.cluster * clusters);
  launched[0] = plan.shared_rows;
  launched[1] = plan.cache;
  launched[2] = plan.cluster;
  err = cudaLaunchKernelEx(&config, binned_gather_scatter_kernel, params);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
