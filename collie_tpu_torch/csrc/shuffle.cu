// The epoch shuffle's cycle-walked Feistel permutation, hand-written for
// Hopper (sm_90a).
//
// No Pallas kernel is replaced: this is the port's form of the JAX
// package's ``lax.while_loop`` cycle-walk (collie_tpu/ops/shuffle.py:65-75),
// which never leaves the device.  The whole-array torch loop it stands in
// for asks the host after every pass whether any value is still out of
// range; here each index walks alone.
//
// For each i < n: e = encrypt(i); while (e >= n) e = encrypt(e); out[i] = e.
// ``encrypt`` is the 4-round unbalanced Feistel network of
// collie_tpu/ops/shuffle.py:25-63 over bits = max(ceil(log2 n), 2) index
// bits (lo_bits = bits / 2 low bits, the rest high), with the murmur3-style
// uint32 mix under four keys.  Each element's walk depends on nothing but its
// own value, so the per-thread loop gives the whole-array masked loop's
// values bit for bit.  The Feistel domain [0, 2^bits) is below 2n, so the
// expected walk is under two encryptions, and it ends because encrypt is a
// bijection of the domain (the orbit of i returns to i, which is below n).
//
// Design: one thread per index, grid-stride, all arithmetic in 32-bit
// registers; the keys (four int64 words on the device, low 32 bits used)
// are read once per thread through the read-only path.  The only memory
// traffic is the 4n-byte write, coalesced.  Bound: 4 n bytes over the HBM
// rate (n = 8,932,941: 10.7 us at 3.35 TB/s).
//
// C interface (loaded with ctypes): collie_feistel_cycle_walk(...) returns
// the cudaError_t of its launch, 0 on success; it launches on the given
// stream, does not synchronise and allocates nothing.  collie_shuffle_abi()
// names the interface's version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix(uint32_t x, uint32_t key) {
  uint32_t h = x + key;
  h *= 0x9E3779B9u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return h;
}

struct Feistel {
  uint32_t k0, k1, k2, k3;
  uint32_t lo_mask, hi_mask;
  int lo_bits;

  __device__ __forceinline__ uint32_t encrypt(uint32_t x) const {
    uint32_t lo = x & lo_mask;
    uint32_t hi = (x >> lo_bits) & hi_mask;
    // unbalanced Feistel: alternate which half is mixed so both widths diffuse
    lo = (lo ^ mix(hi, k0)) & lo_mask;
    hi = (hi ^ mix(lo, k1)) & hi_mask;
    lo = (lo ^ mix(hi, k2)) & lo_mask;
    hi = (hi ^ mix(lo, k3)) & hi_mask;
    return (hi << lo_bits) | lo;
  }
};

__global__ void __launch_bounds__(kThreads)
    feistel_cycle_walk_kernel(const long long* __restrict__ keys, int n, int lo_bits,
                              uint32_t lo_mask, uint32_t hi_mask, int* __restrict__ out) {
  const Feistel f{static_cast<uint32_t>(__ldg(keys)), static_cast<uint32_t>(__ldg(keys + 1)),
                  static_cast<uint32_t>(__ldg(keys + 2)), static_cast<uint32_t>(__ldg(keys + 3)),
                  lo_mask, hi_mask, lo_bits};
  const uint32_t un = static_cast<uint32_t>(n);
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < un; i += stride) {
    uint32_t e = f.encrypt(i);
    while (e >= un) e = f.encrypt(e);
    out[i] = static_cast<int>(e);
  }
}

}  // namespace

extern "C" int collie_shuffle_abi() { return 1; }

extern "C" int collie_feistel_cycle_walk(const long long* keys,  // [4] on the device
                                         int n, int* out,        // [n] on the device
                                         void* stream_ptr) {
  if (n < 2 || keys == nullptr || out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int bits = 0;
  while ((1ll << bits) < static_cast<long long>(n)) ++bits;   // bit length of n - 1
  if (bits < 2) bits = 2;
  const int lo_bits = bits / 2;
  const int hi_bits = bits - lo_bits;
  const uint32_t lo_mask = (1u << lo_bits) - 1u;
  const uint32_t hi_mask = (1u << hi_bits) - 1u;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one index a thread, capped at 32 blocks a SM (the grid-stride loop takes the rest)
  long long blocks = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 32;
  if (blocks > cap) blocks = cap;
  feistel_cycle_walk_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream_ptr)>>>(keys, n, lo_bits, lo_mask,
                                                                        hi_mask, out);
  return static_cast<int>(cudaGetLastError());
}
