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
// >= C_PAD falls outside the window and is dropped.  Bins partition the rows
// and each bin gathers before it scatters, so every gather of a round sees
// the table as it stood at the start of that round.
//
// Hopper gathers and scatters natively, so the port computes the same
// function directly, from one persistent cooperative launch:
//   * the table is copied to ``out`` (float4 stream), then every round is a
//     gather phase and a scatter phase, each closed by the grid barrier of
//     grid_barrier.cuh (2 ITERS + 1 barriers, one launch);
//   * a work item is (example position p, group of kDimsPerThread dims),
//     consecutive threads on consecutive positions, so the ``g[d, p]`` reads
//     are coalesced and a warp's gathers and atomics stay inside one bin's
//     span of row d.  An item finds its bin by a binary search of the
//     bin offsets and its kept flag from its place in the bin;
//   * gather: ``__ldcg`` loads (the rows change during the launch, so no
//     read-only cache), summed per d over the warp with shuffles and added
//     to ``gathered[round, d]`` by lane 0.  The sum stands for the TPU
//     kernel's discarded loop carry: it keeps the loads live;
//   * scatter: one ``atomicAdd`` per element (duplicate ids sum in a
//     run-dependent order).
// It reads nothing past B: a bin window that would run past the arrays (the
// TPU kernel's ``pl.ds(o, C_PAD)`` near the end) only keeps the examples
// that exist.
//
// Bound: the function must read the table, the gradients and the ids once
// and write ``out`` once, 8 D UPAD + 4 D B + 4 B bytes; about 2 ITERS B D
// operations.  At the microbench's shape (D = 32, UPAD = 73,728, B = 8,192,
// ITERS = 50) that is about 20 MB, 6 us at 3.35 TB/s: bytes-bound.  The
// rounds are a chain of dependent passes over 1 MB of rows that stay in the
// 50 MB L2; the barriers and the atomics are what the bound does not count.
//
// C interface (loaded with ctypes): collie_binned_gather_scatter(...) returns
// the cudaError_t of its launch, 0 on success.  It launches on the given
// stream, does not synchronise and allocates nothing; ``gathered`` and the
// barrier word must be zeroed by the caller.

#include <cuda_runtime.h>

#include <cstdint>

#include "grid_barrier.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDimsPerThread = 8;

struct Params {
  const float* tab;       // [D, UPAD]
  const int* sids;        // [B], stably sorted by bin
  const int* offs;        // [n_bins + 1]
  const float* g;         // [D, B]
  float* out;             // [D, UPAD]
  float* gathered;        // [iters, D], zeroed
  unsigned int* barrier;  // one word, zeroed
  int D, upad, B, n_bins, iters, c_pad;
  int vec;                // copy the table as float4
};

// the bin of sorted position p: the last j with offs[j] <= p
__device__ __forceinline__ int bin_of(const int* __restrict__ offs, int n_bins, int p) {
  int lo = 0, hi = n_bins;  // offs[lo] <= p < offs[hi] when p < offs[n_bins]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(offs + mid) <= p) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) binned_gather_scatter_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const size_t n_tab = static_cast<size_t>(p.D) * p.upad;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;

  // out = tab
  if (p.vec) {
    const float4* src = reinterpret_cast<const float4*>(p.tab);
    float4* dst = reinterpret_cast<float4*>(p.out);
    for (size_t i = tid; i < n_tab / 4; i += stride) dst[i] = __ldg(src + i);
  } else {
    for (size_t i = tid; i < n_tab; i += stride) p.out[i] = __ldg(p.tab + i);
  }
  collie::grid_sync(p.barrier);

  // work items: (dim group, position) with positions padded to whole warps,
  // so every warp sums one dim group
  const int b_warps = (p.B + 31) & ~31;
  const int groups = (p.D + kDimsPerThread - 1) / kDimsPerThread;
  const size_t items = static_cast<size_t>(groups) * b_warps;
  const int n_bins = p.n_bins;
  const int ub = p.upad / n_bins;

  for (int round = 0; round < p.iters; ++round) {
    // gather: every kept example's row as it stood at the start of the round
    for (size_t w = tid - lane; w < items; w += stride) {  // warp-uniform trip count
      const size_t item = w + lane;
      const int pos = static_cast<int>(item % b_warps);
      const int d0 = static_cast<int>(item / b_warps) * kDimsPerThread;
      bool kept = false;
      int id = 0;
      if (item < items && pos < p.B && pos < __ldg(p.offs + n_bins)) {
        const int j = bin_of(p.offs, n_bins, pos);
        const int local = __ldg(p.sids + pos) - j * ub;
        kept = pos - __ldg(p.offs + j) < p.c_pad && local >= 0 && local < ub;
        id = j * ub + local;
      }
#pragma unroll
      for (int k = 0; k < kDimsPerThread; ++k) {
        const int d = d0 + k;
        float v = (kept && d < p.D) ? __ldcg(p.out + static_cast<size_t>(d) * p.upad + id) : 0.0f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0 && d < p.D && v != 0.0f)
          atomicAdd(p.gathered + static_cast<size_t>(round) * p.D + d, v);
      }
    }
    collie::grid_sync(p.barrier);
    // scatter-add the gradient columns
    for (size_t item = tid; item < items; item += stride) {
      const int pos = static_cast<int>(item % b_warps);
      const int d0 = static_cast<int>(item / b_warps) * kDimsPerThread;
      if (pos >= p.B || pos >= __ldg(p.offs + n_bins)) continue;
      const int j = bin_of(p.offs, n_bins, pos);
      const int local = __ldg(p.sids + pos) - j * ub;
      if (pos - __ldg(p.offs + j) >= p.c_pad || local < 0 || local >= ub) continue;
      const int id = j * ub + local;
#pragma unroll
      for (int k = 0; k < kDimsPerThread; ++k) {
        const int d = d0 + k;
        if (d < p.D)
          atomicAdd(p.out + static_cast<size_t>(d) * p.upad + id,
                    __ldg(p.g + static_cast<size_t>(d) * p.B + pos));
      }
    }
    collie::grid_sync(p.barrier);
  }
}

}  // namespace

extern "C" int collie_binned_gather_scatter(const float* tab, const int* sids, const int* offs,
                                            const float* g, float* out, float* gathered,
                                            unsigned int* barrier, int D, int upad, int B,
                                            int n_bins, int iters, int c_pad, void* stream_ptr) {
  if (D < 1 || upad < 1 || B < 1 || n_bins < 1 || upad % n_bins != 0 || iters < 0 || c_pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n_tab = static_cast<size_t>(D) * upad;
  const int vec = n_tab % 4 == 0 && reinterpret_cast<uintptr_t>(tab) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  Params params{tab, sids, offs, g, out, gathered, barrier, D, upad, B, n_bins, iters, c_pad,
                vec};
  const int groups = (D + kDimsPerThread - 1) / kDimsPerThread;
  const long long items = static_cast<long long>(groups) * ((B + 31) & ~31);
  int grid = 0;
  const cudaError_t err = collie::cooperative_grid(binned_gather_scatter_kernel, kThreads,
                                                   (items + kThreads - 1) / kThreads, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&params};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(binned_gather_scatter_kernel), dim3(grid), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream_ptr)));
}
