// MF scoring + running top-k for batch retrieval, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel ``_topk_tile_kernel``
// (collie_tpu/ops/pallas/retrieval_kernel.py:36, launched by
// ``mf_topk_retrieve``).  It computes the same function, not the same blocks:
// ``user_emb . item_emb + item_bias`` for every user and item, FP32 FMAs
// only (no tensor cores, no TF32), and for each user and each contiguous
// item range the range's top-k, ordered by (score descending, item id
// ascending), which is the stable top-k ``lax.top_k`` gives.  The merge over
// ranges and the per-user bias stay outside, in PyTorch, as the JAX package
// leaves them to XLA.  The [B, num_items] score block never reaches device
// memory; only [n_ranges, B, k] candidates do.
//
// Bound at the serving shape (B = 256 users, I = 2,000,000 items, D = 64):
// B * I * D = 3.3e10 FMAs, ~1.0 ms at the H100 SXM's 67 TFLOP/s FP32
// (non-tensor-core) peak; the item table read once is 0.52 GB, ~0.16 ms at
// 3.35 TB/s.  Operations bound it, so the design is that of an FP32 GEMM
// whose epilogue is a selection, with the selection kept small:
//   * persistent blocks over a grid of (user chunk, item range), the chunk
//     fastest, so the blocks that share a range run together and read it
//     from HBM about once.  The wrapper sizes the grid from the SM count
//     (``topk_plan`` in ops/kernels/retrieval_kernel.py);
//   * a block keeps its chunk of UC users in shared memory for its whole
//     life, transposed ([D, UC]), and walks its range in tiles of 128
//     items, each tile in stages of 32 dims.  cp.async copies stage s + 3
//     into a landing ring while stage s is scored (16-byte copies when rows
//     allow, else 4-byte; zero past D and past the range); each thread then
//     moves its own landed float4s, transposed ([32, 128], items
//     contiguous), into the free one of two compute buffers.  One barrier a
//     stage;
//   * each thread scores an 8 user x 8 item micro-tile in registers, the
//     inner loop of an FP32 GEMM: per dim, two float4s of users and two of
//     items (a warp reads 16 consecutive float4s of items and two of users:
//     no bank conflicts) feed 64 FMAs, and the next dim's four float4s load
//     while those FMAs run;
//   * after a tile the scores (bias added) go to a shared score tile, and
//     one warp per user keeps a running top-k over the range: the user's
//     k-th entry is a threshold.  The threads that scored a user reduce its
//     tile max across their 16 lanes and flag the user when the max reaches
//     the threshold; only flagged users are scanned: scores that do not
//     beat the threshold are dropped in registers (one ballot per 32 items),
//     and each survivor is inserted into the sorted list held one entry per
//     lane (a ballot counts the entries that beat it, a shuffle shifts the
//     rest).  The score tile holds a whole tile, so
//     no candidate is dropped, and every comparison is on (score, id), so
//     the arrival order does not matter.  The lists live in shared memory
//     where they fit beside the chunk, else in the wrapper's scratch;
//   * a range with fewer than k items pads with (finfo(float32).min, the
//     range's first id), as the plain version does.
// wgmma / TMA / 3xTF32 are not used: scores stay full FP32.
//
// C interface (loaded with ctypes): collie_topk_tile(...) returns the
// cudaError_t of the launch, 0 on success.  It launches on the given stream,
// does not synchronise and allocates nothing.  collie_topk_shared_bytes(...)
// gives the shared memory of a launch plan.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kTileItems = 128;             // items a tile
constexpr int kChunkDims = 32;              // embedding dims a ring stage holds
constexpr int kItemRow = kTileItems + 4;    // floats a transposed stage row and a score row take
constexpr int kLandingRow = kChunkDims + 4;  // a landing row: 9 float4s, an odd count
constexpr int kMicro = 8;                   // users and items a thread scores
constexpr int kItemGroups = kTileItems / kMicro;
constexpr int kMaxK = 128;
constexpr float kMasked = -FLT_MAX;         // finfo(float32).min, the JAX sentinel
constexpr int kEmptyId = INT_MAX;           // a list entry no item has filled yet
constexpr int kMaxSharedBytes = 232448;     // 227 KB a block may use on sm_90
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* user_emb;   // [B, D]
  const float* item_emb;   // [num_items, D]
  const float* item_bias;  // [num_items]
  float* out_scores;       // [n_ranges, B, k]
  int* out_ids;            // [n_ranges, B, k]
  float* list_scratch_s;   // [blocks, UC, k] running lists, or null: in shared memory
  int* list_scratch_id;    // [blocks, UC, k]
  int B, D, num_items, k;
  int n_chunks;            // user chunks
  int tiles_per_range;
  int vec;                 // 16-byte loads of item rows
};

__host__ __device__ inline int padded_dims(int D) {
  return (D + kChunkDims - 1) / kChunkDims * kChunkDims;
}

// user rows, the two item stages and their two landing slots, the score
// tile, each user's threshold and flag, and the running lists where they
// live in shared memory
size_t shared_bytes_for(int uc, int D, int k, bool lists_in_shared) {
  return sizeof(float) * ((size_t)uc * padded_dims(D) + 2 * (size_t)kChunkDims * kItemRow +
                          2 * (size_t)kTileItems * kLandingRow + (size_t)uc * kItemRow +
                          3 * (size_t)uc + (lists_in_shared ? 2 * (size_t)uc * k : 0));
}

__device__ __forceinline__ bool better(float s, int id, float t, int tid) {
  return s > t || (s == t && id < tid);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one of this thread's copy groups is in flight
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Insert (cs, cid) into the warp's sorted list, entry e = 32 r + lane in
// (L[r], Li[r]): a ballot counts the entries that beat it, a shuffle moves
// the rest one place down.  The caller has checked that it beats the k-th
// entry, so its place is below k; entries past k are never stored.
template <int KR>
__device__ __forceinline__ void insert(float (&L)[KR], int (&Li)[KR], float cs, int cid,
                                       int lane) {
  int pos = 0;
#pragma unroll
  for (int r = 0; r < KR; ++r) pos += __popc(__ballot_sync(kFull, better(L[r], Li[r], cs, cid)));
  float prev[KR];
  int prev_id[KR];
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const float up = __shfl_up_sync(kFull, L[r], 1);
    const int up_id = __shfl_up_sync(kFull, Li[r], 1);
    const float last = __shfl_sync(kFull, L[r > 0 ? r - 1 : 0], 31);
    const int last_id = __shfl_sync(kFull, Li[r > 0 ? r - 1 : 0], 31);
    prev[r] = lane == 0 ? last : up;
    prev_id[r] = lane == 0 ? last_id : up_id;
  }
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int e = 32 * r + lane;
    if (e == pos) {
      L[r] = cs;
      Li[r] = cid;
    } else if (e > pos) {
      L[r] = prev[r];
      Li[r] = prev_id[r];
    }
  }
}

// acc[i][4 h + c] += b.c: the bias of the thread's items 64 h + 4 ti + c
__device__ __forceinline__ void acc_add_bias(float (&acc)[kMicro][kMicro], float4 b, int h) {
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    acc[i][4 * h] += b.x;
    acc[i][4 * h + 1] += b.y;
    acc[i][4 * h + 2] += b.z;
    acc[i][4 * h + 3] += b.w;
  }
}

// One block: UC users against one item range, 256 threads for a chunk of
// 128 users (UC / 8 user groups x 16 item groups).  Thread (tu, ti) scores
// users {4 tu + c, UC / 2 + 4 tu + c} x items {4 ti + c, 64 + 4 ti + c},
// c < 4, of each 128-item tile.  KR = list entries a lane holds (k <= 32 KR).
template <int UC, int KR>
__global__ void __launch_bounds__(2 * UC) topk_range_kernel(const Params p) {
  constexpr int kThreads = 2 * UC;
  constexpr int kWarps = kThreads / 32;
  constexpr int kSlots = kTileItems * kChunkDims / 4 / kThreads;  // float4s a thread stages
  extern __shared__ __align__(16) float smem[];
  const int dps = padded_dims(p.D);
  const int n_dim_chunks = dps / kChunkDims;
  const int k = p.k;
  float* users_t = smem;                                   // [dps, UC]
  float* items_t = users_t + dps * UC;                     // [2][32, kItemRow]
  float* landing = items_t + 2 * kChunkDims * kItemRow;    // [2][128, kLandingRow]
  float* scores = landing + 2 * kTileItems * kLandingRow;  // [UC, kItemRow]
  float* th_s = scores + UC * kItemRow;                    // [UC] each list's k-th entry
  int* th_id = reinterpret_cast<int*>(th_s + UC);          // [UC]
  int* flagged = th_id + UC;                               // [UC] the tile's max reached th_s
  float* list_s;                                           // [UC, k]
  int* list_id;
  if (p.list_scratch_s == nullptr) {
    list_s = reinterpret_cast<float*>(flagged + UC);
    list_id = reinterpret_cast<int*>(list_s + UC * k);
  } else {
    list_s = p.list_scratch_s + (size_t)blockIdx.x * UC * k;
    list_id = p.list_scratch_id + (size_t)blockIdx.x * UC * k;
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ti = tid % kItemGroups;
  const int tu = tid / kItemGroups;
  const int chunk = blockIdx.x % p.n_chunks;
  const int range = blockIdx.x / p.n_chunks;
  const int user0 = chunk * UC;
  const int nu = min(UC, p.B - user0);
  const int n_tiles_all = (p.num_items + kTileItems - 1) / kTileItems;
  const int tile0 = range * p.tiles_per_range;
  const int tile_end = min(tile0 + p.tiles_per_range, n_tiles_all);
  const int range_base = tile0 * kTileItems;
  const int range_stop = min(tile_end * kTileItems, p.num_items);
  const int total = (tile_end - tile0) * n_dim_chunks;

  // users, transposed: a thread's 4 + 4 users at one dim are two float4s
  for (int i = tid; i < UC * dps; i += kThreads) {
    const int d = i / UC;
    const int u = i - d * UC;
    users_t[d * UC + u] = (u < nu && d < p.D) ? p.user_emb[(size_t)(user0 + u) * p.D + d] : 0.f;
  }
  for (int i = tid; i < UC * k; i += kThreads) {
    list_s[i] = -INFINITY;
    list_id[i] = kEmptyId;
  }
  for (int u = tid; u < UC; u += kThreads) {
    th_s[u] = -INFINITY;
    th_id[u] = kEmptyId;
    flagged[u] = 0;
  }

  // stage s = tile tile0 + s / n_dim_chunks, dims [32 c, 32 c + 32) with
  // c = s % n_dim_chunks.  A thread copies kSlots float4s of it (items
  // slot % 128, dims 4 (slot / 128) .. + 3; zero past D and past the range)
  // with cp.async into the landing ring ([128, 36] row-major, two slots),
  // three stages ahead of the FMAs and with no registers held; once its
  // copies have landed it moves those same float4s, transposed
  // (items_t[d][item], items contiguous), into the free compute buffer.  A
  // warp's 32 slots are 32 consecutive items: its landing reads (rows 9
  // float4s apart) and transposed stores (consecutive floats) are free of
  // bank conflicts, and no barrier is needed between copy and move.
  auto issue = [&](int s) {
    if (s >= total) {
      cp_async_commit();
      return;
    }
    float* dst = landing + (s & 1) * kTileItems * kLandingRow;
    const int item_base = (tile0 + s / n_dim_chunks) * kTileItems;
    const int col0 = (s % n_dim_chunks) * kChunkDims;
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      const int slot = tid + kThreads * m;
      const int row = slot % kTileItems;
      const int q = slot / kTileItems;
      const int item = item_base + row;
      const int col = col0 + 4 * q;
      const float* src = p.item_emb + (size_t)min(item, p.num_items - 1) * p.D;
      float* at = dst + row * kLandingRow + 4 * q;
      if (p.vec) {
        const bool ok = item < range_stop && col < p.D;
        cp_async16(at, ok ? src + col : p.item_emb, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = item < range_stop && col + e < p.D;
          cp_async4(at + e, ok ? src + col + e : p.item_emb, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
  auto move = [&](int s) {
    const float* from = landing + (s & 1) * kTileItems * kLandingRow;
    float* to = items_t + (s & 1) * kChunkDims * kItemRow;
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      const int slot = tid + kThreads * m;
      const int row = slot % kTileItems;
      const int q = slot / kTileItems;
      const float4 v = *reinterpret_cast<const float4*>(from + row * kLandingRow + 4 * q);
      float* at = to + 4 * q * kItemRow + row;
      at[0] = v.x;
      at[kItemRow] = v.y;
      at[2 * kItemRow] = v.z;
      at[3 * kItemRow] = v.w;
    }
  };

  // groups committed before iteration s: stages 0 .. s + 2 (empty past the
  // range), so waiting until one is pending means stage s + 1 has landed
  issue(0);
  issue(1);
  cp_async_wait_1();
  if (total > 0) move(0);
  issue(2);
  __syncthreads();

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  float4 bias[2];
  float user_th[kMicro];
  for (int s = 0; s < total; ++s) {
    const int c = s % n_dim_chunks;
    const int tile_base = (tile0 + s / n_dim_chunks) * kTileItems;
    if (c == 0) {
      // the tile's item biases, a tile ahead of their use
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int item = tile_base + 64 * h + 4 * ti;
        float b[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          b[e] = item + e < range_stop ? __ldg(p.item_bias + item + e) : 0.f;
        bias[h] = make_float4(b[0], b[1], b[2], b[3]);
      }
      // the thread's users' threshold scores, a tile ahead of their use.
      // One may be raised meanwhile: a stale one only flags a user for
      // nothing
#pragma unroll
      for (int i = 0; i < kMicro; ++i) user_th[i] = th_s[4 * tu + (i & 3) + (i >> 2) * (UC / 2)];
    }
    const float* it = items_t + (s & 1) * kChunkDims * kItemRow + 4 * ti;
    const float* ut = users_t + c * kChunkDims * UC + 4 * tu;
    // per dim: two float4s of users, two of items, 64 FMAs; the next dim's
    // four float4s load while this one's FMAs run
    float4 u0 = *reinterpret_cast<const float4*>(ut);
    float4 u1 = *reinterpret_cast<const float4*>(ut + UC / 2);
    float4 x0 = *reinterpret_cast<const float4*>(it);
    float4 x1 = *reinterpret_cast<const float4*>(it + 64);
#pragma unroll
    for (int d = 0; d < kChunkDims; ++d) {
      float4 nu0 = u0, nu1 = u1, nx0 = x0, nx1 = x1;
      if (d + 1 < kChunkDims) {
        nu0 = *reinterpret_cast<const float4*>(ut + (d + 1) * UC);
        nu1 = *reinterpret_cast<const float4*>(ut + (d + 1) * UC + UC / 2);
        nx0 = *reinterpret_cast<const float4*>(it + (d + 1) * kItemRow);
        nx1 = *reinterpret_cast<const float4*>(it + (d + 1) * kItemRow + 64);
      }
      const float uv[kMicro] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
      const float xv[kMicro] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(uv[i], xv[j], acc[i][j]);
      u0 = nu0, u1 = nu1, x0 = nx0, x1 = nx1;
    }
    cp_async_wait_1();
    if (s + 1 < total) move(s + 1);    // into the buffer stage s - 1 used
    issue(s + 3);                      // into the landing slot stage s + 1 used
    const bool last = c == n_dim_chunks - 1;
    if (last) {
      // the tile's scores, bias added, to shared memory (with one dim chunk
      // a tile, the barrier ahead is the only one since the last scan).
      // Each thread flags its users with a score that beats their
      // threshold, so the scan below visits those users only.
      if (n_dim_chunks == 1) __syncthreads();
      acc_add_bias(acc, bias[0], 0);
      acc_add_bias(acc, bias[1], 1);
      // each user's max over the tile: the 16 lanes of a warp that share tu
      // hold its 128 scores.  A max that reaches the threshold flags the
      // user (items past the range score 0 here: a flag for nothing).  The
      // eight users' reductions run side by side
      float top[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
        top[i] = fmaxf(fmaxf(fmaxf(acc[i][0], acc[i][1]), fmaxf(acc[i][2], acc[i][3])),
                       fmaxf(fmaxf(acc[i][4], acc[i][5]), fmaxf(acc[i][6], acc[i][7])));
#pragma unroll
      for (int off = kItemGroups / 2; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
          top[i] = fmaxf(top[i], __shfl_xor_sync(kFull, top[i], off));
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
        const int u = 4 * tu + (i & 3) + (i >> 2) * (UC / 2);
        if (ti == 0 && u < nu && top[i] >= user_th[i]) flagged[u] = 1;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(scores + u * kItemRow + 64 * h + 4 * ti) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;
    }
    __syncthreads();  // stage s + 1 is in place; the scores are complete
    if (!last) continue;

    // one warp per flagged user folds the tile into the user's running
    // top-k: the k-th entry of the user's list is the threshold, a ballot
    // per 32 items drops what does not beat it, each survivor is inserted
    // into the sorted list.  Warp w owns users w + kWarps i.  The next write
    // of the score tile and of the flags comes after the next barrier.
    constexpr int kUsersPerWarp = UC / kWarps;
    const int own = warp + kWarps * min(lane, kUsersPerWarp - 1);
    unsigned todo = __ballot_sync(kFull, lane < kUsersPerWarp && own < nu && flagged[own]);
    while (todo) {
      const int u = warp + kWarps * (__ffs(todo) - 1);
      todo &= todo - 1u;
      float th = th_s[u];
      int t_id = th_id[u];
      unsigned mask[kTileItems / 32];
      float sv[kTileItems / 32];
#pragma unroll
      for (int m = 0; m < kTileItems / 32; ++m) {
        const int id = tile_base + 32 * m + lane;
        sv[m] = scores[u * kItemRow + 32 * m + lane];
        mask[m] = __ballot_sync(kFull, id < range_stop && better(sv[m], id, th, t_id));
      }
      float* ls = list_s + u * k;
      int* li = list_id + u * k;
      float L[KR];
      int Li[KR];
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        const int e = 32 * r + lane;
        L[r] = e < k ? ls[e] : -INFINITY;
        Li[r] = e < k ? li[e] : kEmptyId;
      }
#pragma unroll
      for (int m = 0; m < kTileItems / 32; ++m) {
        while (mask[m]) {
          const int src = __ffs(mask[m]) - 1;
          mask[m] &= mask[m] - 1;
          const float cs = __shfl_sync(kFull, sv[m], src);
          const int cid = tile_base + 32 * m + src;
          if (!better(cs, cid, th, t_id)) continue;
          insert<KR>(L, Li, cs, cid, lane);
#pragma unroll
          for (int r = 0; r < KR; ++r) {
            if (r == (k - 1) >> 5) {
              th = __shfl_sync(kFull, L[r], (k - 1) & 31);
              t_id = __shfl_sync(kFull, Li[r], (k - 1) & 31);
            }
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        const int e = 32 * r + lane;
        if (e < k) {
          ls[e] = L[r];
          li[e] = Li[r];
        }
      }
      if (lane == 0) {
        th_s[u] = th;
        th_id[u] = t_id;
        flagged[u] = 0;
      }
      __syncwarp();
    }
  }

  // the range's candidates; entries no item filled pad with (finfo.min,
  // the range's first id)
  __syncthreads();
  for (int u = warp; u < nu; u += kWarps) {
    const size_t out = ((size_t)range * p.B + user0 + u) * k;
    for (int e = lane; e < k; e += 32) {
      const bool empty = list_id[u * k + e] == kEmptyId;
      p.out_scores[out + e] = empty ? kMasked : list_s[u * k + e];
      p.out_ids[out + e] = empty ? range_base : list_id[u * k + e];
    }
  }
}

template <int UC, int KR>
cudaError_t launch(const Params& p, size_t shared, int grid, cudaStream_t stream) {
  auto kernel = topk_range_kernel<UC, KR>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 2 * UC, shared, stream>>>(p);
  return cudaGetLastError();
}

template <int UC>
cudaError_t launch_chunk(const Params& p, size_t shared, int grid, cudaStream_t stream) {
  if (p.k <= 32) return launch<UC, 1>(p, shared, grid, stream);
  if (p.k <= 64) return launch<UC, 2>(p, shared, grid, stream);
  return launch<UC, 4>(p, shared, grid, stream);
}

}  // namespace

extern "C" {

// Shared memory of one block: what topk_plan in the wrapper computes.
long long collie_topk_shared_bytes(int user_chunk, int D, int k, int lists_in_shared) {
  return (long long)shared_bytes_for(user_chunk, D, k, lists_in_shared != 0);
}

// list_scratch_s / list_scratch_id: null to keep the running lists in
// shared memory, else [n_ranges * n_chunks, user_chunk, k] each.
int collie_topk_tile(const float* user_emb, const float* item_emb, const float* item_bias, int B,
                     int D, int num_items, int k, int user_chunk, int tiles_per_range,
                     float* list_scratch_s, int* list_scratch_id, float* out_scores,
                     int* out_ids, void* stream) {
  if (B <= 0 || D <= 0 || num_items <= 0 || k <= 0 || k > kMaxK || k > num_items ||
      tiles_per_range <= 0 || (list_scratch_s == nullptr) != (list_scratch_id == nullptr))
    return (int)cudaErrorInvalidValue;
  if (user_chunk != 32 && user_chunk != 64 && user_chunk != 128)
    return (int)cudaErrorInvalidValue;
  const size_t shared = shared_bytes_for(user_chunk, D, k, list_scratch_s == nullptr);
  if (shared > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  const int n_chunks = (B + user_chunk - 1) / user_chunk;
  const long long n_tiles = ((long long)num_items + kTileItems - 1) / kTileItems;
  const long long n_ranges = (n_tiles + tiles_per_range - 1) / tiles_per_range;
  const long long blocks = n_ranges * n_chunks;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  // 16-byte loads need 16-byte rows and a 16-byte aligned table
  const int vec = (D % 4 == 0) && (reinterpret_cast<uintptr_t>(item_emb) % 16 == 0);
  const Params p{user_emb, item_emb, item_bias, out_scores, out_ids, list_scratch_s,
                 list_scratch_id, B, D, num_items, k, n_chunks, tiles_per_range, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (user_chunk) {
    case 128: return (int)launch_chunk<128>(p, shared, (int)blocks, s);
    case 64: return (int)launch_chunk<64>(p, shared, (int)blocks, s);
    default: return (int)launch_chunk<32>(p, shared, (int)blocks, s);
  }
}

}  // extern "C"
