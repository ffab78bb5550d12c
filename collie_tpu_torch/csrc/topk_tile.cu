// Per-tile MF scoring + top-k for batch retrieval, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ``_topk_tile_kernel``
// (collie_tpu/ops/pallas/retrieval_kernel.py:36, launched by
// ``mf_topk_retrieve``).  It computes the same function, not the same blocks:
// for each item tile, ``user_emb . item_emb + item_bias`` for every user of a
// user chunk, the catalog tail masked to finfo(float32).min, then the tile's
// top-k with ties going to the lowest item id.  The merge over tiles and the
// per-user bias stay outside, in PyTorch, as the JAX package leaves them to
// XLA.  The [B, num_items] score block never reaches device memory; only
// [n_tiles, B, k] candidates do.
//
// Bound at the serving shape (B = 256 users, I = 2,000,000 items, D = 64):
// B * I * D = 3.3e10 FMAs = 6.6e10 FP32 operations, ~1.0 ms at the H100 SXM's
// 67 TFLOP/s FP32 (non-tensor-core) peak; the item table plus bias,
// 2M * 65 * 4 B = 0.52 GB read once, ~0.16 ms at 3.35 TB/s.  The kernel is
// therefore bound by operations, and the design keeps FMAs fed:
//   * the grid walks user chunks fastest, so the blocks that share an item
//     tile run together and the tile is read from HBM about once (then L2);
//   * a chunk's user rows sit in shared memory and are read as broadcast
//     float4s (one shared load per four FMAs per user), the item row as a
//     read-only float4 stream; FP32 FMAs only, no tensor cores, no TF32;
//   * the tile's scores stay in shared memory; one warp per user then runs
//     k rounds of a warp-wide (max, lowest index) reduction, marking each
//     winner taken, exactly the selection the TPU kernel runs on its VPU.
// wgmma / TMA / 3xTF32 are not used here.
//
// C interface (loaded with ctypes): collie_topk_tile(...) returns the
// cudaError_t of the launch, 0 on success.  It launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -FLT_MAX;  // finfo(float32).min, the JAX sentinel
constexpr int kMaxSharedBytes = 232448;  // 227 KB a block may use on sm_90

template <int UB, bool VEC4>
__global__ void __launch_bounds__(kThreads)
topk_tile_kernel(const float* __restrict__ user_emb,   // [B, D]
                 const float* __restrict__ item_emb,   // [num_items, D]
                 const float* __restrict__ item_bias,  // [num_items]
                 int B, int D, int num_items, int tile, int k, int n_chunks,
                 float* __restrict__ out_scores,       // [n_tiles, B, k]
                 int* __restrict__ out_ids) {          // [n_tiles, B, k]
  extern __shared__ __align__(16) float smem[];
  float* users = smem;             // [UB, D]
  float* scores = smem + UB * D;   // [UB, tile]

  const int chunk = blockIdx.x % n_chunks;
  const int tile_idx = blockIdx.x / n_chunks;
  const int user0 = chunk * UB;
  const int nu = min(UB, B - user0);
  const int base = tile_idx * tile;

  for (int i = threadIdx.x; i < UB * D; i += kThreads) {
    const int u = i / D;
    users[i] = u < nu ? user_emb[(size_t)(user0 + u) * D + (i - u * D)] : 0.f;
  }
  __syncthreads();

  for (int c = threadIdx.x; c < tile; c += kThreads) {
    const int item = base + c;
    if (item >= num_items) {
#pragma unroll
      for (int u = 0; u < UB; ++u) scores[u * tile + c] = kMasked;
      continue;
    }
    float acc[UB];
#pragma unroll
    for (int u = 0; u < UB; ++u) acc[u] = 0.f;
    const float* row = item_emb + (size_t)item * D;
    if (VEC4) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      const int d4n = D >> 2;
      for (int d4 = 0; d4 < d4n; ++d4) {
        const float4 x = __ldg(row4 + d4);
#pragma unroll
        for (int u = 0; u < UB; ++u) {
          const float4 w = reinterpret_cast<const float4*>(users + u * D)[d4];
          acc[u] = fmaf(w.x, x.x, acc[u]);
          acc[u] = fmaf(w.y, x.y, acc[u]);
          acc[u] = fmaf(w.z, x.z, acc[u]);
          acc[u] = fmaf(w.w, x.w, acc[u]);
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const float x = __ldg(row + d);
#pragma unroll
        for (int u = 0; u < UB; ++u) acc[u] = fmaf(users[u * D + d], x, acc[u]);
      }
    }
    const float b = __ldg(item_bias + item);
#pragma unroll
    for (int u = 0; u < UB; ++u) scores[u * tile + c] = acc[u] + b;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int u = warp; u < nu; u += kWarps) {
    float* srow = scores + u * tile;
    const size_t out_base = ((size_t)tile_idx * B + user0 + u) * k;
    for (int j = 0; j < k; ++j) {
      // each lane scans its columns in increasing order; strict '>' keeps
      // the lowest column among its ties
      float best = -INFINITY;
      int best_c = INT_MAX;
      for (int c = lane; c < tile; c += 32) {
        const float v = srow[c];
        if (v > best) {
          best = v;
          best_c = c;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oc = __shfl_xor_sync(0xffffffffu, best_c, off);
        if (ov > best || (ov == best && oc < best_c)) {
          best = ov;
          best_c = oc;
        }
      }
      // taken entries become -inf, below the finfo.min of masked columns;
      // a tile with fewer than k columns pads with (finfo.min, tile base)
      const bool found = best_c != INT_MAX;
      if (lane == 0) {
        out_scores[out_base + j] = found ? best : kMasked;
        out_ids[out_base + j] = base + (found ? best_c : 0);
      }
      if (found && (best_c & 31) == lane) srow[best_c] = -INFINITY;
      __syncwarp();
    }
  }
}

struct LaunchArgs {
  const float* user_emb;
  const float* item_emb;
  const float* item_bias;
  int B, D, num_items, tile, k;
  float* out_scores;
  int* out_ids;
  size_t shared_bytes;
  cudaStream_t stream;
};

template <int UB, bool VEC4>
cudaError_t launch(const LaunchArgs& a) {
  auto kernel = topk_tile_kernel<UB, VEC4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.shared_bytes);
  if (err != cudaSuccess) return err;
  const int n_chunks = (a.B + UB - 1) / UB;
  const int n_tiles = (a.num_items + a.tile - 1) / a.tile;
  const long long blocks = (long long)n_chunks * n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, a.shared_bytes, a.stream>>>(
      a.user_emb, a.item_emb, a.item_bias, a.B, a.D, a.num_items, a.tile, a.k,
      n_chunks, a.out_scores, a.out_ids);
  return cudaGetLastError();
}

template <int UB>
cudaError_t launch_users(const LaunchArgs& a, bool vec4) {
  return vec4 ? launch<UB, true>(a) : launch<UB, false>(a);
}

size_t shared_bytes_for(int ub, int D, int tile) {
  return (size_t)ub * ((size_t)D + (size_t)tile) * sizeof(float);
}

}  // namespace

extern "C" {

// Users per block for a tile width and embedding dim: the largest of 8, 4,
// 2, 1 whose shared memory fits, or 0 when even one user does not fit.
int collie_topk_tile_users_per_block(int D, int tile) {
  for (int ub = 8; ub >= 1; ub >>= 1) {
    if (shared_bytes_for(ub, D, tile) <= (size_t)kMaxSharedBytes) return ub;
  }
  return 0;
}

int collie_topk_tile(const float* user_emb, const float* item_emb,
                     const float* item_bias, int B, int D, int num_items,
                     int tile, int k, float* out_scores, int* out_ids,
                     void* stream) {
  if (B <= 0 || D <= 0 || num_items <= 0 || tile <= 0 || k <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int ub = collie_topk_tile_users_per_block(D, tile);
  if (ub == 0) return (int)cudaErrorInvalidValue;
  const size_t shared = shared_bytes_for(ub, D, tile);
  // float4 item rows need 16-byte rows; user rows are read from shared memory
  const bool vec4 = (D % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(item_emb) % 16 == 0);
  const LaunchArgs args{user_emb, item_emb, item_bias, B, D, num_items, tile, k,
                        out_scores, out_ids, shared, static_cast<cudaStream_t>(stream)};
  switch (ub) {
    case 8: return (int)launch_users<8>(args, vec4);
    case 4: return (int)launch_users<4>(args, vec4);
    case 2: return (int)launch_users<2>(args, vec4);
    default: return (int)launch_users<1>(args, vec4);
  }
}

}  // extern "C"
