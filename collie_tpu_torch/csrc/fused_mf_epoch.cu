// One epoch of implicit MF training, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ``_epoch_kernel``
// (collie_tpu/ops/pallas/fused_mf_epoch.py:148, launched by ``fused_mf_epoch``
// at :563).  It computes the same function, not the same blocks.  For each
// step s of the epoch, on the tables as they stood at the start of the step:
// scores ``u . i + item_bias`` of each example's positive and K sampled
// negatives; the loss (hinge or collie's modified BPR over all K pairs, over
// the first-max hardest negative when adaptive, or WARP's first violation in
// sample order weighted log(I / (k + 1))), with the partial-credit ideal gap
// ``1 - sum_f w_f [meta_f(pos) == meta_f(neg)]``; the composite reduction
// ``(sum l + l^2) w / max(sum w, 1)``; gradients to user rows, item rows and
// item biases; then, after the whole batch, optax-exact dense Adam on both
// tables (every row moves every step, bias corrections 1 - b^t with
// t = count + 1 + s) and SGD with torch-coupled decay on the item bias.
// User biases get no gradient from pairwise losses; the caller applies their
// decay in closed form.
//
// The TPU design keeps the tables in VMEM across a sequential grid and
// "gathers" with one-hot MXU matmuls against a [C, I] all-item score block.
// Hopper gathers and scatters natively, so here:
//   * mf_step_kernel: one warp per example (grid-stride over the batch),
//     lanes over D.  The warp loads the user row and the positive row once,
//     then each negative row in sample order; dots reduce with shuffles and
//     lane 0's sum is broadcast so every lane takes the same branch.  The
//     gradients go to [U,D], [I,D], [I] accumulators with atomicAdd
//     (duplicate ids sum; the order of the sum changes from run to run), the
//     loss to one atomicAdd per block.
//   * mf_update_kernel: elementwise over (U + I) * D and I; Adam and SGD for
//     step s with optax's rounding (no FMA contraction), and it zeroes each
//     accumulator as it reads it.
//   * collie_fused_mf_epoch: loops over the S steps launching both kernels on
//     the caller's stream; one call per epoch.
// Full FP32 arithmetic, no tensor cores and no TF32.
//
// Bound: the dense update is the least a step must move:
// 32 (U + I) D bytes for the tables, both moments and the accumulator (read
// and written) plus 16 I for the bias and its gradient, plus 4 B (K + 3) of
// ids and mask; the gathered rows, 4 B (K + 2) D, mostly hit the 50 MB L2 at
// these table sizes.  Operations are about 6 B (K + 1) D.  At the ML-10M
// shape (U = 72,000, I = 10,000, D = 32, B = 65,536, K = 10) that is about
// 85 MB a step against 0.14 GFLOP: bytes-bound, about 25 us a step at
// 3.35 TB/s.  The design streams each table once per step in the update
// kernel and keeps the step kernel's gathers cache-friendly; the atomics on
// item rows are the part the bound does not count.
//
// C interface (loaded with ctypes): collie_fused_mf_epoch(...) returns the
// first nonzero cudaError_t of its launches, 0 on success.  It updates the
// tables and moments in place, launches on the given stream, does not
// synchronise and allocates nothing.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxDim = 256;
constexpr int kUpdateThreads = 256;

// loss_kind: 0 hinge, 1 bpr (collie's modified BPR), 2 warp
constexpr int kHinge = 0;
constexpr int kWarp = 2;

// optax's constants as the JAX package rounds them: each Python double
// expression becomes float32 once
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kEps = 1e-8f;

__device__ __forceinline__ int clamp_id(int id, int n) {
  return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

// warp sum, lane 0's value broadcast so every lane holds the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

template <int PL>
__device__ __forceinline__ void load_row(const float* __restrict__ table, int row, int D,
                                         int lane, float (&out)[PL]) {
  const float* base = table + static_cast<size_t>(row) * D;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int d = lane + 32 * j;
    out[j] = d < D ? __ldg(base + d) : 0.0f;
  }
}

template <int PL>
__device__ __forceinline__ float dot(const float (&a)[PL], const float (&b)[PL]) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < PL; ++j) acc = fmaf(a[j], b[j], acc);
  return warp_sum(acc);
}

template <int PL>
__device__ __forceinline__ void scatter_row(float* __restrict__ acc, int row, int D, int lane,
                                            float scale, const float (&v)[PL]) {
  float* base = acc + static_cast<size_t>(row) * D;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int d = lane + 32 * j;
    if (d < D) atomicAdd(base + d, scale * v[j]);
  }
}

// ideal gap of the (pos, neg) pair, the JAX kernel's ``ideal_for``
__device__ __forceinline__ float ideal_gap(const int* __restrict__ meta,
                                           const float* __restrict__ meta_w, int F, int I,
                                           int p, int n) {
  float ideal = 1.0f;
  for (int f = 0; f < F; ++f) {
    const int* row = meta + static_cast<size_t>(f) * I;
    if (__ldg(row + p) == __ldg(row + n)) ideal = ideal - meta_w[f];
  }
  return ideal;
}

// loss element l and score-gradient magnitude g of one pair, d = pos - neg
__device__ __forceinline__ void pair_loss(int loss_kind, float d, float ideal, float w,
                                          float denom, float& l, float& g) {
  float dfac;
  if (loss_kind == kHinge) {
    l = fmaxf(ideal - d, 0.0f);
    dfac = l > 0.0f ? 1.0f : 0.0f;
  } else {
    const float s = 1.0f / (1.0f + expf(-d));
    l = ideal - s;
    dfac = s * (1.0f - s);
  }
  g = w * (1.0f + 2.0f * l) * dfac / denom;
}

template <int PL>
__global__ void __launch_bounds__(kThreads)
mf_step_kernel(const float* __restrict__ user_emb,   // [U, D]
               const float* __restrict__ item_emb,   // [I, D]
               const float* __restrict__ item_bias,  // [I]
               const int* __restrict__ users,        // [B] of step s
               const int* __restrict__ pos,          // [B]
               const int* __restrict__ negs,         // [B, K]
               const float* __restrict__ mask,       // [B]
               const int* __restrict__ meta,         // [F, I]
               const float* __restrict__ meta_w,     // [F]
               int F, const float* __restrict__ denom_ptr, int U, int I, int D, int B, int K,
               int loss_kind, int adaptive,
               float* __restrict__ du, float* __restrict__ di, float* __restrict__ db,
               float* __restrict__ loss_out) {
  __shared__ float block_loss[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float denom = *denom_ptr;
  float loss_acc = 0.0f;

  for (int b = blockIdx.x * kWarpsPerBlock + warp; b < B; b += gridDim.x * kWarpsPerBlock) {
    const float w = mask[b];
    const int u = clamp_id(users[b], U);
    const int p = clamp_id(pos[b], I);
    const int* neg_b = negs + static_cast<size_t>(b) * K;
    float ur[PL], pr[PL], nr[PL], du_acc[PL];
    load_row<PL>(user_emb, u, D, lane, ur);
    load_row<PL>(item_emb, p, D, lane, pr);
    const float pos_score = dot<PL>(ur, pr) + __ldg(item_bias + p);
#pragma unroll
    for (int j = 0; j < PL; ++j) du_acc[j] = 0.0f;
    float G = 0.0f;  // sum of the pairs' g: the positive's score gradient is -G

    if (loss_kind == kWarp) {
      // first violation in sample order; none -> zero loss and gradient
      for (int k = 0; k < K; ++k) {
        const int n = clamp_id(neg_b[k], I);
        load_row<PL>(item_emb, n, D, lane, nr);
        const float sk = dot<PL>(ur, nr) + __ldg(item_bias + n);
        const float h = ideal_gap(meta, meta_w, F, I, p, n) - pos_score + sk;
        if (h > 0.0f) {
          const float weight = static_cast<float>(log(static_cast<double>(I) / (k + 1)));
          const float l = weight * h;
          const float g = w * (1.0f + 2.0f * l) * weight / denom;
          loss_acc += (l + l * l) * w;
          G = g;
#pragma unroll
          for (int j = 0; j < PL; ++j) du_acc[j] = g * nr[j];
          scatter_row<PL>(di, n, D, lane, g, ur);
          if (lane == 0) atomicAdd(db + n, g);
          break;
        }
      }
    } else if (adaptive) {
      // first maximum wins: strict > from -1e30, as jnp.argmax
      float best = -1e30f;
      int best_item = 0;
      float br[PL];
#pragma unroll
      for (int j = 0; j < PL; ++j) br[j] = 0.0f;
      bool loaded = false;
      for (int k = 0; k < K; ++k) {
        const int n = clamp_id(neg_b[k], I);
        load_row<PL>(item_emb, n, D, lane, nr);
        const float sk = dot<PL>(ur, nr) + __ldg(item_bias + n);
        if (sk > best) {
          best = sk;
          best_item = n;
          loaded = true;
#pragma unroll
          for (int j = 0; j < PL; ++j) br[j] = nr[j];
        }
      }
      if (!loaded) load_row<PL>(item_emb, best_item, D, lane, br);
      float l, g;
      pair_loss(loss_kind, pos_score - best, ideal_gap(meta, meta_w, F, I, p, best_item), w,
                denom, l, g);
      loss_acc += (l + l * l) * w;
      if (g != 0.0f) {
        G = g;
#pragma unroll
        for (int j = 0; j < PL; ++j) du_acc[j] = g * br[j];
        scatter_row<PL>(di, best_item, D, lane, g, ur);
        if (lane == 0) atomicAdd(db + best_item, g);
      }
    } else {
      for (int k = 0; k < K; ++k) {
        const int n = clamp_id(neg_b[k], I);
        load_row<PL>(item_emb, n, D, lane, nr);
        const float sk = dot<PL>(ur, nr) + __ldg(item_bias + n);
        float l, g;
        pair_loss(loss_kind, pos_score - sk, ideal_gap(meta, meta_w, F, I, p, n), w, denom,
                  l, g);
        loss_acc += (l + l * l) * w;
        if (g != 0.0f) {
          G += g;
#pragma unroll
          for (int j = 0; j < PL; ++j) du_acc[j] = fmaf(g, nr[j], du_acc[j]);
          scatter_row<PL>(di, n, D, lane, g, ur);
          if (lane == 0) atomicAdd(db + n, g);
        }
      }
    }

    if (G != 0.0f) {
#pragma unroll
      for (int j = 0; j < PL; ++j) du_acc[j] = fmaf(-G, pr[j], du_acc[j]);
      scatter_row<PL>(du, u, D, lane, 1.0f, du_acc);
      scatter_row<PL>(di, p, D, lane, -G, ur);
      if (lane == 0) atomicAdd(db + p, -G);
    }
  }

  if (lane == 0) block_loss[warp] = loss_acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int i = 0; i < kWarpsPerBlock; ++i) total += block_loss[i];
    if (total != 0.0f) atomicAdd(loss_out, total);
  }
}

__device__ __forceinline__ void adam_elem(float* __restrict__ emb, float* __restrict__ mu,
                                          float* __restrict__ nu, float* __restrict__ grad,
                                          size_t i, float bc1, float bc2, float lr,
                                          float wd) {
  float g = grad[i];
  grad[i] = 0.0f;
  const float p = emb[i];
  if (wd != 0.0f) g = __fadd_rn(g, __fmul_rn(wd, p));
  const float m = __fadd_rn(__fmul_rn(kOneMinusB1, g), __fmul_rn(kB1, mu[i]));
  const float v = __fadd_rn(__fmul_rn(kOneMinusB2, __fmul_rn(g, g)), __fmul_rn(kB2, nu[i]));
  mu[i] = m;
  nu[i] = v;
  const float step = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), kEps));
  emb[i] = __fsub_rn(p, __fmul_rn(lr, step));
}

__global__ void __launch_bounds__(kUpdateThreads)
mf_update_kernel(float* __restrict__ user_emb, float* __restrict__ mu_u,
                 float* __restrict__ nu_u, float* __restrict__ du, size_t n_user,
                 float* __restrict__ item_emb, float* __restrict__ mu_i,
                 float* __restrict__ nu_i, float* __restrict__ di, size_t n_item,
                 float* __restrict__ item_bias, float* __restrict__ db, size_t n_bias,
                 const float* __restrict__ bc1s, const float* __restrict__ bc2s, int s,
                 float lr_emb, float lr_bias, float wd_emb, float wd_bias,
                 float* __restrict__ losses, const float* __restrict__ denoms) {
  const float bc1 = bc1s[s];
  const float bc2 = bc2s[s];
  const size_t total = n_user + n_item + n_bias;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    if (i < n_user) {
      adam_elem(user_emb, mu_u, nu_u, du, i, bc1, bc2, lr_emb, wd_emb);
    } else if (i < n_user + n_item) {
      adam_elem(item_emb, mu_i, nu_i, di, i - n_user, bc1, bc2, lr_emb, wd_emb);
    } else {
      const size_t j = i - n_user - n_item;
      float g = db[j];
      db[j] = 0.0f;
      const float b = item_bias[j];
      if (wd_bias != 0.0f) g = __fadd_rn(g, __fmul_rn(wd_bias, b));
      item_bias[j] = __fsub_rn(b, __fmul_rn(lr_bias, g));
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) losses[s] = losses[s] / denoms[s];
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int device = 0;
    cudaGetDevice(&device);
    if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        count <= 0)
      count = 132;
  }
  return count;
}

template <int PL>
cudaError_t launch_step(int grid, cudaStream_t stream, const float* user_emb,
                        const float* item_emb, const float* item_bias, const int* users,
                        const int* pos, const int* negs, const float* mask, const int* meta,
                        const float* meta_w, int F, const float* denom, int U, int I, int D, int B,
                        int K, int loss_kind, int adaptive, float* du, float* di, float* db,
                        float* loss_out) {
  mf_step_kernel<PL><<<grid, kThreads, 0, stream>>>(user_emb, item_emb, item_bias, users, pos,
                                                    negs, mask, meta, meta_w, F, denom, U, I,
                                                    D, B, K, loss_kind, adaptive, du, di, db,
                                                    loss_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int collie_fused_mf_epoch_max_dim() { return kMaxDim; }

extern "C" int collie_fused_mf_epoch(
    float* user_emb, float* item_emb, float* item_bias,      // state, updated in place
    float* mu_u, float* nu_u, float* mu_i, float* nu_i,
    const int* users, const int* pos, const int* negs,       // [S, B], [S, B], [S, B, K]
    const float* mask,                                       // [S, B]
    const int* meta, const float* meta_w, int F,             // [F, I], [F]
    const float* denoms, const float* bc1s, const float* bc2s,  // [S] each, on the device
    float* du, float* di, float* db,                         // zeroed accumulators
    float* losses,                                           // [S], zeroed
    int U, int I, int D, int S, int B, int K, int loss_kind, int adaptive,
    float lr_emb, float lr_bias, float wd_emb, float wd_bias, void* stream_ptr) {
  if (D < 1 || D > kMaxDim || K < 1 || B < 1 || U < 1 || I < 1 || S < 0 || F < 0 ||
      loss_kind < kHinge || loss_kind > kWarp)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int step_grid = std::min((B + kWarpsPerBlock - 1) / kWarpsPerBlock, sm_count() * 8);
  const size_t n_user = static_cast<size_t>(U) * D;
  const size_t n_item = static_cast<size_t>(I) * D;
  const size_t total = n_user + n_item + static_cast<size_t>(I);
  const int update_grid = static_cast<int>(std::min<size_t>(
      (total + kUpdateThreads - 1) / kUpdateThreads, static_cast<size_t>(sm_count()) * 16));
  const int pl = D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : 8;

  for (int s = 0; s < S; ++s) {
    const size_t off = static_cast<size_t>(s) * B;
    const int* u_s = users + off;
    const int* p_s = pos + off;
    const int* n_s = negs + off * K;
    const float* m_s = mask + off;
    cudaError_t err;
    switch (pl) {
      case 1:
        err = launch_step<1>(step_grid, stream, user_emb, item_emb, item_bias, u_s, p_s, n_s,
                             m_s, meta, meta_w, F, denoms + s, U, I, D, B, K, loss_kind,
                             adaptive, du, di, db, losses + s);
        break;
      case 2:
        err = launch_step<2>(step_grid, stream, user_emb, item_emb, item_bias, u_s, p_s, n_s,
                             m_s, meta, meta_w, F, denoms + s, U, I, D, B, K, loss_kind,
                             adaptive, du, di, db, losses + s);
        break;
      case 4:
        err = launch_step<4>(step_grid, stream, user_emb, item_emb, item_bias, u_s, p_s, n_s,
                             m_s, meta, meta_w, F, denoms + s, U, I, D, B, K, loss_kind,
                             adaptive, du, di, db, losses + s);
        break;
      default:
        err = launch_step<8>(step_grid, stream, user_emb, item_emb, item_bias, u_s, p_s, n_s,
                             m_s, meta, meta_w, F, denoms + s, U, I, D, B, K, loss_kind,
                             adaptive, du, di, db, losses + s);
        break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    mf_update_kernel<<<update_grid, kUpdateThreads, 0, stream>>>(
        user_emb, mu_u, nu_u, du, n_user, item_emb, mu_i, nu_i, di, n_item, item_bias, db,
        static_cast<size_t>(I), bc1s, bc2s, s, lr_emb, lr_bias, wd_emb, wd_bias, losses, denoms);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
