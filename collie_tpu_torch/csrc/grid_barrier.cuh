// A grid-wide barrier for kernels launched with cudaLaunchCooperativeKernel.
//
// Cooperative launch guarantees that every block of the grid is resident at
// once (or refuses the launch), which is what makes spinning on other blocks
// safe.  Without it this barrier can deadlock: never call it from a kernel
// launched with <<<...>>>.
//
// One 32-bit word in device memory, zeroed before the launch, serves every
// barrier of the launch.  Block 0 adds 0x80000000 - (gridDim.x - 1), every
// other block adds 1, so the word's top bit flips exactly when the last
// block arrives and its low bits return to where they were: the word needs
// no reset between barriers.  Each block's thread 0 fences its block's
// writes (ordered before it by __syncthreads), arrives, spins on a volatile
// read (which does not stop in L1) until the bit flips, and fences again
// before releasing its block.  Data that other blocks wrote before the
// barrier must be read after it with loads that do not hit a stale L1 line:
// __ldcg, atomics or volatile, never __ldg.
#pragma once

#include <cuda_runtime.h>

namespace collie {

__device__ __forceinline__ void grid_sync(unsigned int* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(arrived, add);
    const volatile unsigned int* word = arrived;
    while (((old ^ *word) & 0x80000000u) == 0) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// Sets *grid to the largest grid of `threads`-thread blocks of `kernel`
// that can be resident at once (what a cooperative launch accepts), capped
// at `want` and at least 1; returns the error of the occupancy query.
template <typename Kernel>
cudaError_t cooperative_grid(Kernel kernel, int threads, long long want, int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return err;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long n = want < resident ? want : resident;
  *grid = static_cast<int>(n < 1 ? 1 : n);
  return cudaSuccess;
}

}  // namespace collie
