// One epoch of MF training, implicit or explicit, hand-written for Hopper
// (sm_90a): one persistent cooperative launch per epoch call.
//
// Implicit: replaces the Pallas TPU kernel ``_epoch_kernel``
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
// Explicit: replaces the Pallas TPU kernel ``_explicit_epoch_kernel``
// (collie_tpu/ops/pallas/fused_mf_epoch.py:337, launched by
// ``fused_mf_explicit_epoch`` at :501).  For each step s, on the tables as
// they stood at the start of the step: ``raw = u . i + b_i + b_u``; under
// ``y_range`` ``pred = lo + span sigma(raw)`` with the chain factor
// ``span sigma (1 - sigma)``, else ``pred = raw``; ``err = pred - r``; MSE
// (``err^2``, derivative ``2 err``) or MAE (``|err|``, derivative
// ``sign(err)`` with sign(0) = 0); ``g = w dl chain / max(sum w, 1)``; the
// gradient ``g i`` to the user row, ``g u`` to the item row and ``g`` to both
// biases.  Then Adam on both tables and SGD with coupled decay on BOTH bias
// vectors (pointwise losses give the user bias a gradient, which pairwise
// losses cancel).
//
// The TPU design keeps the tables in VMEM across a sequential grid and
// "gathers" with one-hot MXU matmuls against a [C, I] all-item score block.
// Hopper gathers and scatters natively.  The design here:
//   * One launch per epoch call (cudaLaunchCooperativeKernel, the co-resident
//     grid from the occupancy query).  For each step: the step phase
//     (grid-stride over the batch), the grid barrier of grid_barrier.cuh,
//     the update phase (grid-stride over (U + I) D and the biases), the
//     barrier again: 2 S barriers where S launch pairs used to be.  Tables,
//     biases, moments and gradients change during the launch, so they are
//     read with __ldcg (L2, never a stale L1 line); ids, masks and the
//     per-step constants with __ldg.
//   * Step phase: a group of G lanes per example (G = 8 for D <= 32 with
//     D % 4 == 0, 16 for D <= 16, else up to 32), each lane holding its share
//     of a row as float4 chunks (D % 4 == 0) or strided floats.  The group's
//     lanes load the example's negative ids in one coalesced read and
//     broadcast them with shuffles, issue all the row loads of a chunk of
//     negatives before reducing any dot, then reduce the chunk's dots
//     together (xor shuffles: every lane of a group ends with the same bits,
//     so discrete choices are group-uniform).  Hardest negative: the first
//     maximum, strict > from -1e30; WARP: the first violation in sample
//     order.  Gradient rows go to [U,D], [I,D], [I] (and [U]) accumulators
//     in 64-bit fixed point (below), so duplicate ids sum to the same bits
//     whatever order the adds land in; each block writes its loss partial
//     to its own slot, and block 0 sums the slots in block order.
//   * Fixed point.  A float v is added as the integer c = v 2^56 (a
//     quantum of 1.4e-17), split as hi = trunc(c / 2^P) and
//     lo = c - hi 2^P, each added to its own int64 word with an integer
//     atomic (associative: the sum is a function of the adds alone).  The
//     launch bounds the adds one word can take in a step, n (B (K + 1)
//     implicit, B explicit), and with L = ceil(log2 n) takes P = 62 - L:
//     n lo words of at most 2^P in magnitude sum below 2^62, and every add
//     with |v| < 2^(68 - 2L) (2^28 at the ML-10M shape) keeps the hi sum
//     below 2^62 too, so no word can wrap.  An add out of that range (or
//     NaN, or inf) is not made: it sets the launch's overflow word, and
//     from the next update phase on every gradient reads as NaN and every
//     step's loss is NaN, which the host sees at its next sync as the NaN
//     trip.  The update phase reads a word pair back as
//     float((hi 2^P + lo) 2^-56): one rounding in double, one to float.
//   * Update phase: Adam and SGD for step s with optax's rounding
//     (__fmul_rn/__fadd_rn, no FMA contraction), each table's four arrays
//     streamed as float4 where they are 16-byte aligned, two units a thread
//     with all their loads in flight before either is stored, zeroing each
//     accumulator as it reads it; block 0 sums the step's loss partials and
//     divides by the denominator after the barrier that follows the step
//     phase.
//   * Optionally, block 0 stamps the device clock after every phase into a
//     caller's timeline, which shows where the one launch spends its time.
// Full FP32 arithmetic, no tensor cores and no TF32.
//
// Bound: the dense update is the least a step must move: 24 (U + I) D bytes
// for the tables and both moments (read and written) plus 8 I (implicit)
// or 8 (U + I) (explicit) for the biases (read and written), plus the
// step's ids, mask and ratings; the gathered rows mostly hit the 50 MB L2
// at these table sizes.  At the ML-10M shape (U = 72,000, I = 10,000,
// D = 32, B = 65,536, K = 10) that is about 66 MB a step (63 MB of it the
// tables and moments): 20 us at 3.35 TB/s, bytes-bound (operations:
// 6 B (K + 1) D implicit, 8 B D explicit).  The fixed-point accumulators
// (16 bytes an element, read and zeroed every step), their atomics and the
// barriers are what the bound does not count.  At the small gate shapes
// the whole epoch is a few tens of microseconds of work and one launch.
//
// C interface (loaded with ctypes): collie_fused_mf_epoch(...) and
// collie_fused_mf_explicit_epoch(...) return the cudaError_t of their launch
// (a cooperative launch that does not fit is refused, not run), 0 on
// success.  They update the tables, biases and moments in place, launch on
// the given stream, do not synchronise and allocate nothing: the
// accumulators (2 n int64 words for an n-element gradient, the lo words
// then the hi words, 16-byte aligned), the losses, the loss partials
// (collie_fused_mf_epoch_max_grid() floats), the overflow word and the
// barrier word come zeroed from the caller.
// Two words come from device memory, so that a whole fit decides them on the
// card without a host sync: lr[2] (the embeddings' and the biases' learning
// rates, read once per launch) and *live.  When *live is 0 the launch is a
// skipped epoch (the JAX whole fit's lax.cond skip branch): every block
// returns before touching a table, a moment or an accumulator, and the
// losses are NaN.  collie_fused_mf_epoch_abi() names this interface's
// version; the wrapper refuses a library that answers another.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "grid_barrier.cuh"

namespace {

constexpr int kWarpsPerBlock = 16;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxDim = 256;
// the C interface's version (2: lr and live in device memory; 3: fixed-point
// accumulators, loss partials and the overflow word)
constexpr int kAbi = 3;
// the largest grid a launch takes: the loss partials hold one float a block
constexpr int kMaxGrid = 1024;
// fractional bits of the fixed-point accumulators
constexpr int kFracBits = 56;

// loss_kind: 0 hinge, 1 bpr (collie's modified BPR), 2 warp
constexpr int kHinge = 0;
constexpr int kWarp = 2;
// explicit loss_kind: 0 mse, 1 mae
constexpr int kMse = 0;
constexpr int kMae = 1;

// optax's constants as the JAX package rounds them: each Python double
// expression becomes float32 once
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kEps = 1e-8f;

constexpr unsigned kFull = 0xffffffffu;

// How a group of G lanes holds one embedding row: NV chunks per lane, each
// a float4 (VEC, for D % 4 == 0) or one float; chunk j of lane `sub` starts
// at dim W (sub + G j).
template <int G_, int NV_, bool VEC_>
struct Layout {
  static constexpr int G = G_;
  static constexpr int NV = NV_;
  static constexpr bool VEC = VEC_;
  static constexpr int W = VEC ? 4 : 1;
  static constexpr int E = NV * W;  // floats per lane
  // negatives whose rows a lane holds at once
  static constexpr int C = E <= 2 ? 16 : (E <= 4 ? 8 : 4);
  static_assert(C <= G, "a group's lanes load a chunk's negative ids in one read");
  __device__ static int dim(int sub, int j) { return W * (sub + G * j); }
};

__device__ __forceinline__ int clamp_id(int id, int n) {
  return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

template <class L>
__device__ __forceinline__ void load_row(const float* __restrict__ table, int row, int D, int sub,
                                         float (&out)[L::E]) {
  const float* base = table + static_cast<size_t>(row) * D;
#pragma unroll
  for (int j = 0; j < L::NV; ++j) {
    const int d = L::dim(sub, j);
    if constexpr (L::VEC) {
      const float4 v = d < D ? __ldcg(reinterpret_cast<const float4*>(base + d))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      out[4 * j] = v.x;
      out[4 * j + 1] = v.y;
      out[4 * j + 2] = v.z;
      out[4 * j + 3] = v.w;
    } else {
      out[j] = d < D ? __ldcg(base + d) : 0.0f;
    }
  }
}

template <class L>
__device__ __forceinline__ void zero_row(float (&r)[L::E]) {
#pragma unroll
  for (int e = 0; e < L::E; ++e) r[e] = 0.0f;
}

template <class L>
__device__ __forceinline__ float partial_dot(const float (&a)[L::E], const float (&b)[L::E]) {
  float acc = 0.0f;
#pragma unroll
  for (int e = 0; e < L::E; ++e) acc = fmaf(a[e], b[e], acc);
  return acc;
}

// sum over the G lanes of each group; every lane of a group ends with the
// same bits (each xor step adds the same two values on both lanes)
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// A fixed-point accumulator: n lo words, then n hi words (header).
struct Acc {
  long long* w;
  long long n;
};

// The launch's fixed-point scale: P (lo_unit = 2^P), the bound on one add
// and the overflow word.
struct Fixed {
  double lo_unit, inv_lo_unit;
  float limit;
  int* overflow;
};

__device__ __forceinline__ void add_word(long long* p, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p), static_cast<unsigned long long>(v));
}

// acc[i] += v in fixed point; an add out of range sets the overflow word
// instead (NaN fails the compare too)
__device__ __forceinline__ void fixed_add(const Fixed& fx, const Acc& acc, size_t i, float v) {
  if (v == 0.0f) return;
  if (!(fabsf(v) < fx.limit)) {
    atomicExch(fx.overflow, 1);
    return;
  }
  const double c = static_cast<double>(v) * 0x1p56;   // exact
  const double hi = trunc(c * fx.inv_lo_unit);       // exact: a power of two
  const long long lo = __double2ll_rn(c - hi * fx.lo_unit);  // the difference is exact
  if (lo != 0) add_word(acc.w + i, lo);
  if (hi != 0.0) add_word(acc.w + acc.n + i, static_cast<long long>(hi));
}

// one word pair's sum as a float (header); NaN once the launch overflowed
__device__ __forceinline__ float fixed_value(long long lo, long long hi, double lo_unit,
                                             bool poisoned) {
  if (poisoned) return __int_as_float(0x7fc00000);
  return static_cast<float>(fma(static_cast<double>(hi), lo_unit, static_cast<double>(lo)) *
                            0x1p-56);
}

// acc[row] += scale * v
template <class L>
__device__ __forceinline__ void scatter_row(const Fixed& fx, const Acc& acc, int row, int D,
                                            int sub, float scale, const float (&v)[L::E]) {
  const size_t base = static_cast<size_t>(row) * D;
#pragma unroll
  for (int j = 0; j < L::NV; ++j) {
    const int d = L::dim(sub, j);
    if (d >= D) continue;
#pragma unroll
    for (int w = 0; w < L::W; ++w) fixed_add(fx, acc, base + d + w, scale * v[L::W * j + w]);
  }
}

// the block's loss into its slot of the partials: lane `sub == 0` of each
// group holds its group's sum, summed in a fixed order
__device__ __forceinline__ void add_block_loss(float (&block_loss)[kWarpsPerBlock],
                                               float loss_acc, int sub,
                                               float* __restrict__ partials) {
  float v = sub == 0 ? loss_acc : 0.0f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) block_loss[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int i = 0; i < kWarpsPerBlock; ++i) total += block_loss[i];
    partials[blockIdx.x] = total;
  }
}

// ideal gap of the (pos, neg) pair, the JAX kernel's ``ideal_for``
__device__ __forceinline__ float ideal_gap(const int* __restrict__ meta,
                                           const float* __restrict__ meta_w, int F, int I,
                                           int p, int n) {
  float ideal = 1.0f;
  for (int f = 0; f < F; ++f) {
    const int* row = meta + static_cast<size_t>(f) * I;
    if (__ldg(row + p) == __ldg(row + n)) ideal = ideal - __ldg(meta_w + f);
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

// ------------------------------------------------------------------ update

struct Update {
  float *user_emb, *mu_u, *nu_u;
  Acc du;
  float *item_emb, *mu_i, *nu_i;
  Acc di;
  float* user_bias;  // explicit only; n_ubias = 0 for the implicit epoch
  Acc dbu;
  float* item_bias;
  Acc dbi;
  long long n_user, n_item, n_ubias, n_ibias;  // elements
  int vec_user, vec_item;                // the table's arrays are 16-byte aligned
  float wd_emb, wd_bias;
  Fixed fx;
};

// optax adam on one element, with torch-coupled decay
__device__ __forceinline__ void adam_math(float g, float& p, float& m, float& v, float bc1,
                                          float bc2, float lr, float wd) {
  if (wd != 0.0f) g = __fadd_rn(g, __fmul_rn(wd, p));
  m = __fadd_rn(__fmul_rn(kOneMinusB1, g), __fmul_rn(kB1, m));
  v = __fadd_rn(__fmul_rn(kOneMinusB2, __fmul_rn(g, g)), __fmul_rn(kB2, v));
  const float step = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), kEps));
  p = __fsub_rn(p, __fmul_rn(lr, step));
}

// element i's gradient, its two words zeroed
__device__ __forceinline__ float take_grad(const Acc& acc, size_t i, double lo_unit,
                                           bool poisoned) {
  const long long lo = __ldcg(acc.w + i), hi = __ldcg(acc.w + acc.n + i);
  acc.w[i] = 0;
  acc.w[acc.n + i] = 0;
  return fixed_value(lo, hi, lo_unit, poisoned);
}

__device__ __forceinline__ void adam_elem(float* __restrict__ emb, float* __restrict__ mu,
                                          float* __restrict__ nu, const Acc& grad, size_t i,
                                          double lo_unit, bool poisoned, float bc1, float bc2,
                                          float lr, float wd) {
  const float g = take_grad(grad, i, lo_unit, poisoned);
  float p = __ldcg(emb + i), m = __ldcg(mu + i), v = __ldcg(nu + i);
  adam_math(g, p, m, v, bc1, bc2, lr, wd);
  mu[i] = m;
  nu[i] = v;
  emb[i] = p;
}

// sgd with torch-coupled decay on one bias element
__device__ __forceinline__ void sgd_elem(float* __restrict__ bias, const Acc& grad, size_t i,
                                         double lo_unit, bool poisoned, float lr, float wd) {
  float g = take_grad(grad, i, lo_unit, poisoned);
  const float b = __ldcg(bias + i);
  if (wd != 0.0f) g = __fadd_rn(g, __fmul_rn(wd, b));
  bias[i] = __fsub_rn(b, __fmul_rn(lr, g));
}

// the words of four elements (a float4 unit): lo and hi, two 16-byte loads each
struct Words4 {
  longlong2 lo_a, lo_b, hi_a, hi_b;
};

__device__ __forceinline__ Words4 load_words4(const Acc& acc, size_t i4) {
  const longlong2* lo = reinterpret_cast<const longlong2*>(acc.w) + 2 * i4;
  const longlong2* hi = reinterpret_cast<const longlong2*>(acc.w + acc.n) + 2 * i4;
  return Words4{__ldcg(lo), __ldcg(lo + 1), __ldcg(hi), __ldcg(hi + 1)};
}

__device__ __forceinline__ void zero_words4(const Acc& acc, size_t i4) {
  longlong2* lo = reinterpret_cast<longlong2*>(acc.w) + 2 * i4;
  longlong2* hi = reinterpret_cast<longlong2*>(acc.w + acc.n) + 2 * i4;
  const longlong2 z = make_longlong2(0, 0);
  lo[0] = z;
  lo[1] = z;
  hi[0] = z;
  hi[1] = z;
}

__device__ __forceinline__ float4 words4_value(const Words4& q, double lo_unit, bool poisoned) {
  return make_float4(fixed_value(q.lo_a.x, q.hi_a.x, lo_unit, poisoned),
                     fixed_value(q.lo_a.y, q.hi_a.y, lo_unit, poisoned),
                     fixed_value(q.lo_b.x, q.hi_b.x, lo_unit, poisoned),
                     fixed_value(q.lo_b.y, q.hi_b.y, lo_unit, poisoned));
}

// Adam over one table's n elements, grid-stride; two float4 units a thread
// an iteration, all their loads issued before either unit is stored
__device__ __forceinline__ void adam_range(float* __restrict__ emb, float* __restrict__ mu,
                                           float* __restrict__ nu, const Acc& grad, long long n,
                                           int vec, double lo_unit, bool poisoned, float bc1,
                                           float bc2, float lr, float wd) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (!vec) {
    for (size_t i = tid; i < static_cast<size_t>(n); i += stride)
      adam_elem(emb, mu, nu, grad, i, lo_unit, poisoned, bc1, bc2, lr, wd);
    return;
  }
  const size_t n4 = static_cast<size_t>(n) / 4;
  float4* p4 = reinterpret_cast<float4*>(emb);
  float4* m4 = reinterpret_cast<float4*>(mu);
  float4* v4 = reinterpret_cast<float4*>(nu);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const longlong2 zw = make_longlong2(0, 0);
  for (size_t i = tid; i < n4; i += 2 * stride) {
    const size_t j = i + stride;
    const bool two = j < n4;
    const Words4 wa = load_words4(grad, i);
    float4 pa = __ldcg(p4 + i), ma = __ldcg(m4 + i), va = __ldcg(v4 + i);
    Words4 wb{zw, zw, zw, zw};
    float4 pb = zero, mb = zero, vb = zero;
    if (two) {
      wb = load_words4(grad, j);
      pb = __ldcg(p4 + j);
      mb = __ldcg(m4 + j);
      vb = __ldcg(v4 + j);
    }
    const float4 ga = words4_value(wa, lo_unit, poisoned);
    adam_math(ga.x, pa.x, ma.x, va.x, bc1, bc2, lr, wd);
    adam_math(ga.y, pa.y, ma.y, va.y, bc1, bc2, lr, wd);
    adam_math(ga.z, pa.z, ma.z, va.z, bc1, bc2, lr, wd);
    adam_math(ga.w, pa.w, ma.w, va.w, bc1, bc2, lr, wd);
    zero_words4(grad, i);
    m4[i] = ma;
    v4[i] = va;
    p4[i] = pa;
    if (two) {
      const float4 gb = words4_value(wb, lo_unit, poisoned);
      adam_math(gb.x, pb.x, mb.x, vb.x, bc1, bc2, lr, wd);
      adam_math(gb.y, pb.y, mb.y, vb.y, bc1, bc2, lr, wd);
      adam_math(gb.z, pb.z, mb.z, vb.z, bc1, bc2, lr, wd);
      adam_math(gb.w, pb.w, mb.w, vb.w, bc1, bc2, lr, wd);
      zero_words4(grad, j);
      m4[j] = mb;
      v4[j] = vb;
      p4[j] = pb;
    }
  }
}

// Step s's update: Adam on both tables, sgd on the biases (the implicit
// epoch passes n_ubias = 0: its user biases get no data gradient).  After
// the barrier that follows the step phase, so the overflow word is final.
__device__ void update_phase(const Update& u, float bc1, float bc2, float lr_emb,
                             float lr_bias) {
  const bool poisoned = *reinterpret_cast<volatile int*>(u.fx.overflow) != 0;
  const double lo_unit = u.fx.lo_unit;
  adam_range(u.user_emb, u.mu_u, u.nu_u, u.du, u.n_user, u.vec_user, lo_unit, poisoned, bc1,
             bc2, lr_emb, u.wd_emb);
  adam_range(u.item_emb, u.mu_i, u.nu_i, u.di, u.n_item, u.vec_item, lo_unit, poisoned, bc1,
             bc2, lr_emb, u.wd_emb);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t n_biases = static_cast<size_t>(u.n_ubias + u.n_ibias);
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_biases;
       i += stride) {
    if (i < static_cast<size_t>(u.n_ubias))
      sgd_elem(u.user_bias, u.dbu, i, lo_unit, poisoned, lr_bias, u.wd_bias);
    else
      sgd_elem(u.item_bias, u.dbi, i - u.n_ubias, lo_unit, poisoned, lr_bias, u.wd_bias);
  }
}

// block 0's thread 0 stamps the device clock (ns) into timeline[k], when the
// caller asked for the phases' times
__device__ __forceinline__ void stamp(unsigned long long* timeline, int k) {
  if (timeline != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    timeline[k] = t;
  }
}

// a skipped epoch (*live == 0): NaN for every step's loss, nothing else
// written.  Every block takes the same branch, so no block waits at a barrier.
__device__ __forceinline__ bool skipped(const int* live, float* losses, int S) {
  if (__ldg(live) != 0) return false;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < S; s += gridDim.x * blockDim.x)
    losses[s] = __int_as_float(0x7fc00000);
  return true;
}

// after the barrier that follows step s's step phase: the blocks' loss
// partials summed in block order, NaN once the launch overflowed
__device__ __forceinline__ void finish_loss(float* losses, const float* partials,
                                            const int* overflow, const float* denoms, int s) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float total = 0.0f;
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b) total += __ldcg(partials + b);
    losses[s] = *reinterpret_cast<const volatile int*>(overflow) != 0
                    ? __int_as_float(0x7fc00000)
                    : total / __ldg(denoms + s);
  }
}

// ---------------------------------------------------------------- implicit

struct ImplicitEpoch {
  Update up;
  const int *users, *pos, *negs;  // [S, B], [S, B], [S, B, K]
  const float* mask;              // [S, B]
  const int* meta;                // [F, I]
  const float* meta_w;            // [F]
  const float *denoms, *bc1s, *bc2s;  // [S]
  float* losses;                      // [S]
  float* partials;                    // [kMaxGrid]: one loss partial a block
  unsigned int* barrier;
  unsigned long long* timeline;       // [2 S + 1] or null
  const float* lr;                    // [2]: embeddings, biases
  const int* live;                    // 0: a skipped epoch
  int F, U, I, D, S, B, K, loss_kind, adaptive;
};

template <class L>
__device__ void implicit_step(const ImplicitEpoch& e, int s,
                              float (&block_loss)[kWarpsPerBlock]) {
  constexpr int G = L::G, E = L::E, C = L::C, GPW = 32 / G;
  const float* user_emb = e.up.user_emb;
  const float* item_emb = e.up.item_emb;
  const float* item_bias = e.up.item_bias;
  const Acc du = e.up.du;
  const Acc di = e.up.di;
  const Acc db = e.up.dbi;
  const Fixed fx = e.up.fx;
  const int D = e.D, K = e.K, I = e.I, B = e.B;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;
  const int group_lane0 = lane - sub;
  const size_t off = static_cast<size_t>(s) * B;
  const float denom = __ldg(e.denoms + s);
  float loss_acc = 0.0f;

  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * kWarpsPerBlock;
  for (int first = warp * GPW; first < B; first += n_warps * GPW) {  // warp-uniform
    const int b = first + lane / G;
    const bool valid = b < B;
    const size_t ex = off + (valid ? b : B - 1);
    const float w = valid ? __ldg(e.mask + ex) : 0.0f;
    const int u = clamp_id(__ldg(e.users + ex), e.U);
    const int p = clamp_id(__ldg(e.pos + ex), I);
    const int* neg_b = e.negs + ex * K;
    float ur[E], pr[E], du_acc[E], sel[E];
    load_row<L>(user_emb, u, D, sub, ur);
    load_row<L>(item_emb, p, D, sub, pr);
    const float pos_bias = __ldcg(item_bias + p);
    const float pos_score = group_sum<G>(partial_dot<L>(ur, pr)) + pos_bias;
    zero_row<L>(du_acc);
    zero_row<L>(sel);
    float gsum = 0.0f;  // sum of the pairs' g: the positive's score gradient is -gsum
    // adaptive: the first maximum; warp: the first violation
    float best = -1e30f;
    int best_item = 0;
    bool found = false;

    for (int k0 = 0; k0 < K; k0 += C) {  // warp-uniform
      // the chunk's negative ids: one coalesced read per group, then shuffles
      const int my_k = k0 + sub;
      const int my_id = (sub < C && my_k < K) ? clamp_id(__ldg(neg_b + my_k), I) : 0;
      int nid[C];
#pragma unroll
      for (int c = 0; c < C; ++c) nid[c] = __shfl_sync(kFull, my_id, group_lane0 + c);
      // every row of the chunk in flight before any dot is reduced
      float nr[C][E];
      float nb[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (k0 + c < K) {
          load_row<L>(item_emb, nid[c], D, sub, nr[c]);
          nb[c] = __ldcg(item_bias + nid[c]);
        } else {
          zero_row<L>(nr[c]);
          nb[c] = 0.0f;
        }
      }
      float sc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) sc[c] = partial_dot<L>(ur, nr[c]);
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int c = 0; c < C; ++c) sc[c] += __shfl_xor_sync(kFull, sc[c], o);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = k0 + c;
        if (k >= K) continue;
        const int n = nid[c];
        const float sk = sc[c] + nb[c];
        if (e.loss_kind == kWarp) {
          if (found) continue;
          const float h = ideal_gap(e.meta, e.meta_w, e.F, I, p, n) - pos_score + sk;
          if (h > 0.0f) {
            const float weight = static_cast<float>(log(static_cast<double>(I) / (k + 1)));
            const float l = weight * h;
            const float g = w * (1.0f + 2.0f * l) * weight / denom;
            loss_acc += (l + l * l) * w;
            gsum = g;
            found = true;
#pragma unroll
            for (int j = 0; j < E; ++j) du_acc[j] = g * nr[c][j];
            if (valid) {
              scatter_row<L>(fx, di, n, D, sub, g, ur);
              if (sub == 0) fixed_add(fx, db, n, g);
            }
          }
        } else if (e.adaptive) {
          if (sk > best) {
            best = sk;
            best_item = n;
            found = true;
#pragma unroll
            for (int j = 0; j < E; ++j) sel[j] = nr[c][j];
          }
        } else {
          float l, g;
          pair_loss(e.loss_kind, pos_score - sk, ideal_gap(e.meta, e.meta_w, e.F, I, p, n), w,
                    denom, l, g);
          loss_acc += (l + l * l) * w;
          if (g != 0.0f) {
            gsum += g;
#pragma unroll
            for (int j = 0; j < E; ++j) du_acc[j] = fmaf(g, nr[c][j], du_acc[j]);
            if (valid) {
              scatter_row<L>(fx, di, n, D, sub, g, ur);
              if (sub == 0) fixed_add(fx, db, n, g);
            }
          }
        }
      }
      // WARP: no more rows once every group of the warp has its violation
      if (e.loss_kind == kWarp && __all_sync(kFull, found)) break;
    }

    if (e.loss_kind != kWarp && e.adaptive) {
      if (!found) load_row<L>(item_emb, best_item, D, sub, sel);
      float l, g;
      pair_loss(e.loss_kind, pos_score - best, ideal_gap(e.meta, e.meta_w, e.F, I, p, best_item),
                w, denom, l, g);
      loss_acc += (l + l * l) * w;
      if (g != 0.0f) {
        gsum = g;
#pragma unroll
        for (int j = 0; j < E; ++j) du_acc[j] = g * sel[j];
        if (valid) {
          scatter_row<L>(fx, di, best_item, D, sub, g, ur);
          if (sub == 0) fixed_add(fx, db, best_item, g);
        }
      }
    }

    if (gsum != 0.0f && valid) {
#pragma unroll
      for (int j = 0; j < E; ++j) du_acc[j] = fmaf(-gsum, pr[j], du_acc[j]);
      scatter_row<L>(fx, du, u, D, sub, 1.0f, du_acc);
      scatter_row<L>(fx, di, p, D, sub, -gsum, ur);
      if (sub == 0) fixed_add(fx, db, p, -gsum);
    }
  }
  add_block_loss(block_loss, loss_acc, sub, e.partials);
}

template <class L>
__global__ void __launch_bounds__(kThreads) mf_epoch_kernel(const ImplicitEpoch e) {
  __shared__ float block_loss[kWarpsPerBlock];
  if (skipped(e.live, e.losses, e.S)) return;
  const float lr_emb = __ldg(e.lr), lr_bias = __ldg(e.lr + 1);
  stamp(e.timeline, 0);
  for (int s = 0; s < e.S; ++s) {
    implicit_step<L>(e, s, block_loss);
    collie::grid_sync(e.barrier);
    stamp(e.timeline, 2 * s + 1);
    finish_loss(e.losses, e.partials, e.up.fx.overflow, e.denoms, s);
    update_phase(e.up, __ldg(e.bc1s + s), __ldg(e.bc2s + s), lr_emb, lr_bias);
    collie::grid_sync(e.barrier);
    stamp(e.timeline, 2 * s + 2);
  }
}

// ---------------------------------------------------------------- explicit

struct ExplicitEpoch {
  Update up;
  const int *users, *items;       // [S, B]
  const float *ratings, *mask;    // [S, B]
  const float *denoms, *bc1s, *bc2s;  // [S]
  float* losses;                      // [S]
  float* partials;                    // [kMaxGrid]: one loss partial a block
  unsigned int* barrier;
  unsigned long long* timeline;       // [2 S + 1] or null
  const float* lr;                    // [2]: embeddings, biases
  const int* live;                    // 0: a skipped epoch
  int U, I, D, S, B, loss_kind, y_range;
  float y_lo, y_span;
};

template <class L>
__device__ void explicit_step(const ExplicitEpoch& e, int s,
                              float (&block_loss)[kWarpsPerBlock]) {
  constexpr int G = L::G, E = L::E, GPW = 32 / G;
  const int D = e.D, B = e.B;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;
  const size_t off = static_cast<size_t>(s) * B;
  const float denom = __ldg(e.denoms + s);
  float loss_acc = 0.0f;

  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * kWarpsPerBlock;
  for (int first = warp * GPW; first < B; first += n_warps * GPW) {  // warp-uniform
    const int b = first + lane / G;
    const bool valid = b < B;
    const size_t ex = off + (valid ? b : B - 1);
    const float w = valid ? __ldg(e.mask + ex) : 0.0f;
    const int u = clamp_id(__ldg(e.users + ex), e.U);
    const int it = clamp_id(__ldg(e.items + ex), e.I);
    float ur[E], ir[E];
    load_row<L>(e.up.user_emb, u, D, sub, ur);
    load_row<L>(e.up.item_emb, it, D, sub, ir);
    const float ib = __ldcg(e.up.item_bias + it);
    const float ub = __ldcg(e.up.user_bias + u);
    // every lane of the group holds the same dot, so the same g
    const float raw = group_sum<G>(partial_dot<L>(ur, ir)) + ib + ub;
    float pred = raw;
    float chain = 1.0f;
    if (e.y_range) {
      const float sig = 1.0f / (1.0f + expf(-raw));
      pred = e.y_lo + e.y_span * sig;
      chain = e.y_span * sig * (1.0f - sig);
    }
    const float err = pred - __ldg(e.ratings + ex);
    float l, dl;
    if (e.loss_kind == kMse) {
      l = err * err;
      dl = 2.0f * err;
    } else {
      l = fabsf(err);
      dl = static_cast<float>((err > 0.0f) - (err < 0.0f));  // jnp.sign: sign(0) = 0
    }
    loss_acc += l * w;
    const float g = w * dl * chain / denom;
    if (g != 0.0f && valid) {
      scatter_row<L>(e.up.fx, e.up.du, u, D, sub, g, ir);
      scatter_row<L>(e.up.fx, e.up.di, it, D, sub, g, ur);
      if (sub == 0) {
        fixed_add(e.up.fx, e.up.dbu, u, g);
        fixed_add(e.up.fx, e.up.dbi, it, g);
      }
    }
  }
  add_block_loss(block_loss, loss_acc, sub, e.partials);
}

template <class L>
__global__ void __launch_bounds__(kThreads) mf_explicit_epoch_kernel(const ExplicitEpoch e) {
  __shared__ float block_loss[kWarpsPerBlock];
  if (skipped(e.live, e.losses, e.S)) return;
  const float lr_emb = __ldg(e.lr), lr_bias = __ldg(e.lr + 1);
  stamp(e.timeline, 0);
  for (int s = 0; s < e.S; ++s) {
    explicit_step<L>(e, s, block_loss);
    collie::grid_sync(e.barrier);
    stamp(e.timeline, 2 * s + 1);
    finish_loss(e.losses, e.partials, e.up.fx.overflow, e.denoms, s);
    update_phase(e.up, __ldg(e.bc1s + s), __ldg(e.bc2s + s), lr_emb, lr_bias);
    collie::grid_sync(e.barrier);
    stamp(e.timeline, 2 * s + 2);
  }
}

// ------------------------------------------------------------------ launch

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// a [rows, D] table, its moments and its accumulator can be updated as float4
int vec_ok(int rows, int D, const float* a, const float* b, const float* c, const void* acc) {
  return static_cast<long long>(rows) * D % 4 == 0 && aligned16(a) && aligned16(b) &&
         aligned16(c) && aligned16(acc);
}

// The fixed-point scale for at most `n_adds` adds to one word in a step
// (header): P = 62 - L, |v| < 2^(68 - 2 L), L = ceil(log2 n_adds).  false
// when the bound leaves no useful range.
bool fixed_scale(long long n_adds, int* overflow, Fixed* fx) {
  int L = 0;
  while ((1LL << L) < n_adds) ++L;
  if (L > 40) return false;
  *fx = Fixed{ldexp(1.0, 62 - L), ldexp(1.0, L - 62), ldexpf(1.0f, 68 - 2 * L), overflow};
  return true;
}

// Calls ``launch`` with the Layout type for D (1 <= D <= kMaxDim) and
// returns its error.
template <typename Launch>
cudaError_t with_layout(int D, bool rows_aligned, Launch&& launch) {
  if (D % 4 == 0 && rows_aligned) {
    if (D <= 32) return launch(Layout<8, 1, true>{});
    if (D <= 64) return launch(Layout<16, 1, true>{});
    if (D <= 128) return launch(Layout<32, 1, true>{});
    return launch(Layout<32, 2, true>{});
  }
  if (D <= 16) return launch(Layout<16, 1, false>{});
  if (D <= 32) return launch(Layout<32, 1, false>{});
  if (D <= 64) return launch(Layout<32, 2, false>{});
  if (D <= 128) return launch(Layout<32, 4, false>{});
  return launch(Layout<32, 8, false>{});
}

// one cooperative launch of `kernel<L>` over the co-resident grid, capped at
// the blocks either phase can use
template <class L, class Params>
cudaError_t launch_epoch(void (*kernel)(Params), Params& params, int B, const Update& up,
                         cudaStream_t stream) {
  constexpr int examples_per_block = kWarpsPerBlock * (32 / L::G);
  const long long step_blocks = (B + examples_per_block - 1) / examples_per_block;
  const long long units = (up.vec_user ? up.n_user / 8 : up.n_user) +
                          (up.vec_item ? up.n_item / 8 : up.n_item) + up.n_ubias + up.n_ibias;
  const long long update_blocks = (units + kThreads - 1) / kThreads;
  long long want = step_blocks > update_blocks ? step_blocks : update_blocks;
  if (want > kMaxGrid) want = kMaxGrid;
  int grid = 0;
  const cudaError_t err = collie::cooperative_grid(kernel, kThreads, want, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {&params};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                     dim3(kThreads), args, 0, stream);
}

}  // namespace

extern "C" int collie_fused_mf_epoch_max_dim() { return kMaxDim; }

extern "C" int collie_fused_mf_epoch_abi() { return kAbi; }

extern "C" int collie_fused_mf_epoch_max_grid() { return kMaxGrid; }

extern "C" int collie_fused_mf_epoch(
    float* user_emb, float* item_emb, float* item_bias,      // state, updated in place
    float* mu_u, float* nu_u, float* mu_i, float* nu_i,
    const int* users, const int* pos, const int* negs,       // [S, B], [S, B], [S, B, K]
    const float* mask,                                       // [S, B]
    const int* meta, const float* meta_w, int F,             // [F, I], [F]
    const float* denoms, const float* bc1s, const float* bc2s,  // [S] each, on the device
    long long* du, long long* di, long long* db,             // zeroed, 2 n words each
    float* losses, float* partials,                          // [S], [kMaxGrid]
    int* overflow, unsigned int* barrier,                    // one word each, zeroed
    unsigned long long* timeline,                            // [2 S + 1] or null
    int U, int I, int D, int S, int B, int K, int loss_kind, int adaptive,
    const float* lr, const int* live,                        // [2] and one word, on the device
    float wd_emb, float wd_bias, void* stream_ptr) {
  if (D < 1 || D > kMaxDim || K < 1 || B < 1 || U < 1 || I < 1 || S < 0 || F < 0 ||
      loss_kind < kHinge || loss_kind > kWarp || lr == nullptr || live == nullptr ||
      partials == nullptr || overflow == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // an item word takes at most K + 1 adds an example, a user word one
  Fixed fx;
  if (!fixed_scale(static_cast<long long>(B) * (K + 1), overflow, &fx))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nu = static_cast<long long>(U) * D, ni = static_cast<long long>(I) * D;
  ImplicitEpoch e{};
  e.up = Update{user_emb, mu_u, nu_u, Acc{du, nu}, item_emb, mu_i, nu_i, Acc{di, ni},
                nullptr, Acc{nullptr, 0}, item_bias, Acc{db, I}, nu, ni, 0, I,
                vec_ok(U, D, user_emb, mu_u, nu_u, du), vec_ok(I, D, item_emb, mu_i, nu_i, di),
                wd_emb, wd_bias, fx};
  e.users = users;
  e.pos = pos;
  e.negs = negs;
  e.mask = mask;
  e.meta = meta;
  e.meta_w = meta_w;
  e.denoms = denoms;
  e.bc1s = bc1s;
  e.bc2s = bc2s;
  e.losses = losses;
  e.partials = partials;
  e.barrier = barrier;
  e.timeline = timeline;
  e.lr = lr;
  e.live = live;
  e.F = F;
  e.U = U;
  e.I = I;
  e.D = D;
  e.S = S;
  e.B = B;
  e.K = K;
  e.loss_kind = loss_kind;
  e.adaptive = adaptive;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool rows_aligned = aligned16(user_emb) && aligned16(item_emb);
  return static_cast<int>(with_layout(D, rows_aligned, [&](auto layout) {
    using L = decltype(layout);
    return launch_epoch<L>(mf_epoch_kernel<L>, e, B, e.up, stream);
  }));
}

extern "C" int collie_fused_mf_explicit_epoch(
    float* user_emb, float* item_emb,                        // state, updated in place
    float* user_bias, float* item_bias,
    float* mu_u, float* nu_u, float* mu_i, float* nu_i,
    const int* users, const int* items,                      // [S, B] each
    const float* ratings, const float* mask,                 // [S, B] each
    const float* denoms, const float* bc1s, const float* bc2s,  // [S] each, on the device
    long long* du, long long* di,                            // zeroed, 2 n words each
    long long* dbu, long long* dbi,
    float* losses, float* partials,                          // [S], [kMaxGrid]
    int* overflow, unsigned int* barrier,                    // one word each, zeroed
    unsigned long long* timeline,                            // [2 S + 1] or null
    int U, int I, int D, int S, int B, int loss_kind, int y_range, float y_lo, float y_span,
    const float* lr, const int* live,                        // [2] and one word, on the device
    float wd_emb, float wd_bias, void* stream_ptr) {
  if (D < 1 || D > kMaxDim || B < 1 || U < 1 || I < 1 || S < 0 || loss_kind < kMse ||
      loss_kind > kMae || lr == nullptr || live == nullptr || partials == nullptr ||
      overflow == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // every word takes at most one add an example
  Fixed fx;
  if (!fixed_scale(B, overflow, &fx)) return static_cast<int>(cudaErrorInvalidValue);
  const long long nu = static_cast<long long>(U) * D, ni = static_cast<long long>(I) * D;
  ExplicitEpoch e{};
  e.up = Update{user_emb, mu_u, nu_u, Acc{du, nu}, item_emb, mu_i, nu_i, Acc{di, ni},
                user_bias, Acc{dbu, U}, item_bias, Acc{dbi, I}, nu, ni, U, I,
                vec_ok(U, D, user_emb, mu_u, nu_u, du), vec_ok(I, D, item_emb, mu_i, nu_i, di),
                wd_emb, wd_bias, fx};
  e.users = users;
  e.items = items;
  e.ratings = ratings;
  e.mask = mask;
  e.denoms = denoms;
  e.bc1s = bc1s;
  e.bc2s = bc2s;
  e.losses = losses;
  e.partials = partials;
  e.barrier = barrier;
  e.timeline = timeline;
  e.lr = lr;
  e.live = live;
  e.U = U;
  e.I = I;
  e.D = D;
  e.S = S;
  e.B = B;
  e.loss_kind = loss_kind;
  e.y_range = y_range;
  e.y_lo = y_lo;
  e.y_span = y_span;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool rows_aligned = aligned16(user_emb) && aligned16(item_emb);
  return static_cast<int>(with_layout(D, rows_aligned, [&](auto layout) {
    using L = decltype(layout);
    return launch_epoch<L>(mf_explicit_epoch_kernel<L>, e, B, e.up, stream);
  }));
}
