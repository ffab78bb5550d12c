// Exact stable top-k selection along the last axis of a float32, float16 or
// bfloat16 block, hand-written for Hopper (sm_90a).
//
// No Pallas kernel is replaced: the JAX package takes its top-k with
// ``lax.top_k`` under XLA.  The port's ``stable_topk``
// (ops/kernels/retrieval_kernel.py) gave it a full stable descending
// ``torch.sort`` of every row and kept k entries; this kernel gives the same
// k entries without ordering the rest.  Every caller of ``stable_topk`` on
// the card takes it, at any k: the dense serving path, MAP@k, the blockwise
// and mesh merges and the kernel path's range merge.
//
// What it returns, bit for bit what the stable sort returns: the k largest
// entries of each row in descending order, equal values in ascending index
// order, each value's bits read back from the input at its index (so a NaN
// keeps its payload).  Each element becomes one 64-bit key: the high 32 bits
// are its float's order-preserving bits, the low 32 bits
// ``0xFFFFFFFF - index``.  Keys are distinct, and the k largest keys, in
// descending order, are the answer with its tie rule.  The order bits are
// those of the sort on CUDA, as tests/test_torch_kernels_cuda.py finds them
// on the card at row lengths from 2 to 384,546, for 32- and 16-bit floats
// alike: the float's bits with the sign bit flipped, all bits flipped where
// it is set, so a NaN orders by its bits (+NaN above +inf, -NaN below -inf,
// payloads apart); -0.0 is taken as +0.0, so the two tie.  The kernel reads
// raw bits (``uint32_t`` or ``uint16_t``) and never does float arithmetic.
//
// Bound: the bytes of the scores, read once.  At the serving cell's shape
// (128 rows of 384,546 float32) that is 196.9 MB, 0.059 ms at 3.35 TB/s; a
// full radix sort reads them several times and writes sorted values and
// int64 indices.  The design reads each score once and keeps the rest on
// chip:
//   * pass 1 (topk_select_segments_kernel) runs a grid of rows x segments,
//     as many segments a row as fill the card once with resident blocks
//     (``make_plan``, from the occupancy the runtime reports); short rows
//     and large k take one segment.  A block streams its segment with
//     vector loads of 4 elements, kDepth rounds in flight, and keeps a
//     threshold key: an element whose key is not above it is dropped after
//     one compare, the rest go to a candidate buffer in dynamic shared
//     memory through one ballot and one shared atomic a warp;
//   * the threshold starts from the first round: the k-th largest of the
//     threads' maxima of their first four elements (those are k distinct
//     elements; for k up to kThreads), so the first round does not flood
//     the buffer.  When the buffer passes the plan's flush mark the block
//     sorts it with its current k best (a bitonic sort in shared memory)
//     and the new k-th key becomes the threshold;
//   * a row of one segment writes its answer at once; otherwise each segment
//     writes its k best keys and pass 2 (topk_select_merge_kernel) sorts a
//     row's segments x k keys in shared memory and writes the row's answer;
//   * a k above kRoundK (what one block's buffer holds beside its
//     candidates) is taken in rounds of at most kRoundK: each round selects
//     the next keys below a ceiling, the key of the last entry the round
//     before wrote, so each round reads the scores once more.
//
// C interface (loaded with ctypes): collie_topk_select_plan(...) gives a
// selection's rounds, the first round's segments and the scratch it needs;
// collie_topk_select(...) returns the cudaError_t of its launches, 0 on
// success.  It launches on the given stream, does not synchronise and
// allocates nothing.  collie_topk_select_abi() gives the interface's version.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kVec = 4;                      // elements a vector load
constexpr int kRound = kThreads * kVec;      // elements a block reads a round
constexpr int kDepth = 2;                    // rounds of loads in flight
constexpr int kEdges = 2 * (kVec - 1);       // unaligned elements of a segment, at most
constexpr int kFlushAt = 256;                // the least fill that starts a sort
constexpr int kMinKeys = 2048;               // pass 1's buffer at least (16 KB)
constexpr int kMaxKeys = 16384;              // and at most (128 KB of dynamic shared memory)
// the largest k a round takes: its k best, a flush mark of k and a round of
// candidates with the edges fill kMaxKeys
constexpr int kRoundK = (kMaxKeys - kRound - kEdges) / 2;
constexpr int kMergeKeys = 2048;             // keys pass 2 sorts a row (a power of 2)
constexpr int kMinSegment = 4096;            // the shortest segment of a row of several
constexpr int kStaticShared = 48 * 1024;     // dynamic shared memory without opting in
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRoundK >= kFlushAt, "a round takes at least kFlushAt");

// raw bits of 4 elements
template <typename U>
struct Vector;
template <>
struct Vector<uint32_t> {
  typedef uint4 type;
};
template <>
struct Vector<uint16_t> {
  typedef ushort4 type;
};

template <typename U>
__device__ __forceinline__ u64 order_key(U raw, uint32_t index) {
  constexpr uint32_t kSign = 1u << (8 * sizeof(U) - 1);
  constexpr uint32_t kMask = sizeof(U) == 4 ? 0xffffffffu : 0xffffu;
  uint32_t u = raw;
  if (u == kSign) u = 0u;
  const uint32_t bits = (u & kSign) ? (~u & kMask) : (u | kSign);
  return (static_cast<u64>(bits) << 32) | static_cast<u64>(0xffffffffu - index);
}

__device__ __forceinline__ uint32_t key_index(u64 key) {
  return 0xffffffffu - static_cast<uint32_t>(key);
}

// Sort s[0, n) descending, n a power of 2; every thread of the block calls it
// after a barrier, and it ends with one.
__device__ void bitonic_desc(u64* s, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const u64 a = s[lo], b = s[hi];
        if ((a < b) == ((lo & size) == 0)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// A block's selection state: keys[0, k) its k best so far, in descending
// order (0, below every real key, where it has fewer), keys[k, k + count)
// the candidates since.  Offer one key a thread (``take`` false: nothing);
// every lane of the warp calls it.  ``reach`` becomes at least the buffer's
// fill after this warp's append.
__device__ __forceinline__ void offer(u64* keys, int& count, int k, u64 key, bool take,
                                      int& reach) {
  const unsigned mask = __ballot_sync(kFull, take);
  if (mask == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&count, __popc(mask));
  base = __shfl_sync(kFull, base, leader);
  if (take) keys[k + base + __popc(mask & ((1u << lane) - 1u))] = key;
  reach = max(reach, base + __popc(mask));
}

// Sort the candidates into the k best; returns the new threshold (the k-th
// key, 0 while fewer than k keys were seen).  Every thread calls it after a
// barrier.
__device__ u64 merge_candidates(u64* keys, int& count, int k) {
  const int n = k + count;
  const int p = pow2_at_least(n);
  for (int i = n + threadIdx.x; i < p; i += kThreads) keys[i] = 0;
  __syncthreads();
  bitonic_desc(keys, p);
  const u64 threshold = keys[k - 1];
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  return threshold;
}

template <typename V>
__device__ __forceinline__ V load_vec(const V* x, int v, int nvec) {
  V zero;
  zero.x = zero.y = zero.z = zero.w = 0;
  return v < nvec ? __ldg(x + v) : zero;
}

// One block: the k best keys of row ``blockIdx.x / segs``'s segment
// ``blockIdx.x % segs`` ([seg * seg_len, (seg + 1) * seg_len), seg_len a
// multiple of 4), among the keys below the ceiling where kCeiled (the key of
// the row's entry ``offset - 1``).  kFinal (segs == 1): the row's values and
// indices from entry ``offset`` of rows ``ldo`` long; otherwise the
// segment's keys in seg_keys.  Its dynamic shared memory holds ``cap`` keys.
template <typename U, bool kFinal, bool kCeiled>
__global__ void __launch_bounds__(kThreads)
    topk_select_segments_kernel(const U* __restrict__ scores, int n, int k, int segs,
                                int seg_len, int flush_at, int ldo, int offset,
                                u64* __restrict__ seg_keys, U* values, long long* indices) {
  typedef typename Vector<U>::type V;
  extern __shared__ u64 keys[];
  __shared__ int count;
  const long long row = blockIdx.x / segs;
  const int seg = blockIdx.x - static_cast<int>(row * segs);
  const U* x = scores + row * n;
  const int start = static_cast<int>(min(static_cast<long long>(n),
                                          static_cast<long long>(seg) * seg_len));
  const int stop = static_cast<int>(min(static_cast<long long>(n),
                                        static_cast<long long>(start) + seg_len));
  // [va, ve): the part aligned to the vector; at most 3 elements either side
  const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(x) / sizeof(U)) & (kVec - 1));
  const int va = min(stop, start + ((kVec - ((phase + start) & (kVec - 1))) & (kVec - 1)));
  const int ve = va + ((stop - va) & ~(kVec - 1));
  const V* xv = reinterpret_cast<const V*>(x + va);
  const int nvec = (ve - va) / kVec;
  const int rounds = (nvec + kThreads - 1) / kThreads;
  u64 ceiling = ~0ull;
  if (kCeiled) {
    const long long last = indices[row * ldo + offset - 1];
    ceiling = order_key<U>(__ldg(x + last), static_cast<uint32_t>(last));
  }

  for (int i = threadIdx.x; i < k; i += kThreads) keys[i] = 0;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();

  u64 threshold = 0;
  int reach = 0;
  // a ring of the next kDepth rounds' loads, indexed by constants once the
  // loop is unrolled, so it stays in registers
  V ring[kDepth];
#pragma unroll
  for (int j = 0; j < kDepth; ++j) ring[j] = load_vec(xv, j * kThreads + threadIdx.x, nvec);
  for (int r0 = 0; r0 < rounds; r0 += kDepth) {
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      const int r = r0 + j;
      if (r >= rounds) break;
      const int v = r * kThreads + threadIdx.x;
      const V cur = ring[j];
      ring[j] = load_vec(xv, v + kDepth * kThreads, nvec);
      const bool valid = v < nvec;
      const uint32_t base = static_cast<uint32_t>(va + kVec * v);
      // a key not admitted is 0, below every real key and every threshold
      u64 k0 = valid ? order_key<U>(cur.x, base) : 0;
      u64 k1 = valid ? order_key<U>(cur.y, base + 1) : 0;
      u64 k2 = valid ? order_key<U>(cur.z, base + 2) : 0;
      u64 k3 = valid ? order_key<U>(cur.w, base + 3) : 0;
      if (kCeiled) {
        k0 = k0 < ceiling ? k0 : 0;
        k1 = k1 < ceiling ? k1 : 0;
        k2 = k2 < ceiling ? k2 : 0;
        k3 = k3 < ceiling ? k3 : 0;
      }
      if (r == 0 && k <= kThreads) {
        // seed the threshold: the k-th largest of the threads' maxima, less one
        keys[threadIdx.x] = max(max(k0, k1), max(k2, k3));
        __syncthreads();
        bitonic_desc(keys, kThreads);
        const u64 seed = keys[k - 1];
        __syncthreads();
        for (int i = threadIdx.x; i < k; i += kThreads) keys[i] = 0;
        __syncthreads();
        threshold = seed ? seed - 1 : 0;
      }
      offer(keys, count, k, k0, k0 > threshold, reach);
      offer(keys, count, k, k1, k1 > threshold, reach);
      offer(keys, count, k, k2, k2 > threshold, reach);
      offer(keys, count, k, k3, k3 > threshold, reach);
      if (__syncthreads_or(reach > flush_at)) threshold = merge_candidates(keys, count, k);
      reach = 0;
    }
  }
  // the unaligned edges: threads 0-2 the head, 4-6 the tail
  {
    const int t = threadIdx.x;
    int i = -1;
    if (t < va - start) i = start + t;
    else if (t >= kVec && t - kVec < stop - ve) i = ve + t - kVec;
    u64 key = i >= 0 ? order_key<U>(__ldg(x + i), static_cast<uint32_t>(i)) : 0;
    if (kCeiled && key >= ceiling) key = 0;
    if (t < 32) offer(keys, count, k, key, key > threshold, reach);
  }
  __syncthreads();
  if (count > 0) merge_candidates(keys, count, k);

  if (kFinal) {
    for (int j = threadIdx.x; j < k; j += kThreads) {
      const uint32_t index = key_index(keys[j]);
      values[row * ldo + offset + j] = __ldg(x + index);
      indices[row * ldo + offset + j] = index;
    }
  } else {
    for (int j = threadIdx.x; j < k; j += kThreads)
      seg_keys[(row * segs + seg) * k + j] = keys[j];
  }
}

// One block a row: the k best of its segs x k segment keys, written from
// entry ``offset`` of rows ``ldo`` long.
template <typename U>
__global__ void __launch_bounds__(kThreads)
    topk_select_merge_kernel(const U* __restrict__ scores, int n, int k, int segs, int ldo,
                             int offset, const u64* __restrict__ seg_keys, U* values,
                             long long* indices) {
  __shared__ u64 keys[kMergeKeys];
  const long long row = blockIdx.x;
  const int m = segs * k;
  const int p = pow2_at_least(m);
  for (int i = threadIdx.x; i < p; i += kThreads) keys[i] = i < m ? seg_keys[row * m + i] : 0;
  __syncthreads();
  bitonic_desc(keys, p);
  const U* x = scores + row * n;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const uint32_t index = key_index(keys[j]);
    values[row * ldo + offset + j] = __ldg(x + index);
    indices[row * ldo + offset + j] = index;
  }
}

// One round of a selection: its k, pass 1's buffer (keys) and flush mark,
// and the row's segments.
struct Plan {
  int k;
  int cap;
  int flush_at;
  int segs;
  int seg_len;
};

constexpr int kCachedDevices = 64;
constexpr int kCachedCaps = 2;               // pass 1's buffer of 2,048 or 4,096 keys

// Blocks of pass 1 (several segments a row, buffer of ``cap`` keys) the card
// holds at once: its SMs times the blocks an SM keeps resident; cached.
template <typename U>
cudaError_t capacity(int cap, int* out) {
  static int cache[kCachedDevices][kCachedCaps];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int slot = cap == kMinKeys ? 0 : 1;
  if (device < kCachedDevices && cache[device][slot] > 0) {
    *out = cache[device][slot];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, topk_select_segments_kernel<U, false, false>, kThreads, cap * sizeof(u64));
  if (err != cudaSuccess) return err;
  *out = sms * per_sm > 0 ? sms * per_sm : 1;
  if (device < kCachedDevices) cache[device][slot] = *out;
  return cudaSuccess;
}

// The round that selects ``k`` (at most kRoundK) of ``rows`` rows of n: a
// buffer for its k best, a flush mark of max(kFlushAt, k) and a round of
// candidates; as many segments a row as fill the card's resident blocks
// once, none shorter than kMinSegment and no more than pass 2 sorts; each
// segment a multiple of 4 elements.
template <typename U>
cudaError_t make_plan(long long rows, int n, int k, Plan* plan) {
  plan->k = k;
  plan->flush_at = k > kFlushAt ? k : kFlushAt;
  const int cap = pow2_at_least(k + plan->flush_at + kRound + kEdges);
  plan->cap = cap > kMinKeys ? cap : kMinKeys;
  long long segs = 1;
  if (2 * k <= kMergeKeys && n / kMinSegment > 1) {
    int blocks = 0;
    const cudaError_t err = capacity<U>(plan->cap, &blocks);
    if (err != cudaSuccess) return err;
    segs = blocks / rows;
    segs = segs < n / kMinSegment ? segs : n / kMinSegment;
    segs = segs < kMergeKeys / k ? segs : kMergeKeys / k;
    segs = segs > 1 ? segs : 1;
  }
  const long long per_seg = (n + segs - 1) / segs;
  plan->seg_len = static_cast<int>((per_seg + kVec - 1) / kVec * kVec);
  plan->segs = static_cast<int>((static_cast<long long>(n) + plan->seg_len - 1) / plan->seg_len);
  return cudaSuccess;
}

// The scratch keys of the whole selection (the widest round of several
// segments), its rounds and its first round's plan.
template <typename U>
cudaError_t plan_all(long long rows, int n, int k, long long* scratch, int* rounds,
                     Plan* first) {
  if (rows <= 0 || n <= 0 || k <= 0 || k > n) return cudaErrorInvalidValue;
  *scratch = 0;
  *rounds = 0;
  for (int done = 0; done < k; done += kRoundK) {
    Plan plan;
    const cudaError_t err =
        make_plan<U>(rows, n, k - done < kRoundK ? k - done : kRoundK, &plan);
    if (err != cudaSuccess) return err;
    if (rows * plan.segs > INT_MAX) return cudaErrorInvalidConfiguration;
    if (*rounds == 0) *first = plan;
    const long long keys = plan.segs > 1 ? rows * plan.segs * plan.k : 0;
    *scratch = keys > *scratch ? keys : *scratch;
    ++*rounds;
  }
  return cudaSuccess;
}

template <typename U, bool kFinal, bool kCeiled>
cudaError_t launch_pass_1(const Plan& plan, long long rows, const U* scores, int n, int ldo,
                          int offset, u64* seg_keys, U* values, long long* indices,
                          cudaStream_t stream) {
  const size_t shared = plan.cap * sizeof(u64);
  auto kernel = topk_select_segments_kernel<U, kFinal, kCeiled>;
  if (shared > kStaticShared) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(rows * plan.segs), kThreads, shared, stream>>>(
      scores, n, plan.k, plan.segs, plan.seg_len, plan.flush_at, ldo, offset, seg_keys, values,
      indices);
  return cudaGetLastError();
}

template <typename U>
cudaError_t run_selection(const U* scores, long long rows, int n, int k, u64* seg_keys,
                          long long scratch_keys, U* values, long long* indices,
                          cudaStream_t stream) {
  long long scratch = 0;
  int rounds = 0;
  Plan first;
  cudaError_t err = plan_all<U>(rows, n, k, &scratch, &rounds, &first);
  if (err != cudaSuccess) return err;
  if (scratch > scratch_keys || (scratch > 0 && seg_keys == nullptr)) return cudaErrorInvalidValue;
  for (int done = 0; done < k; done += kRoundK) {
    Plan plan;
    err = make_plan<U>(rows, n, k - done < kRoundK ? k - done : kRoundK, &plan);
    if (err != cudaSuccess) return err;
    const bool ceiled = done > 0;
    if (plan.segs == 1) {
      err = ceiled ? launch_pass_1<U, true, true>(plan, rows, scores, n, k, done, nullptr,
                                                  values, indices, stream)
                   : launch_pass_1<U, true, false>(plan, rows, scores, n, k, done, nullptr,
                                                   values, indices, stream);
      if (err != cudaSuccess) return err;
      continue;
    }
    err = ceiled ? launch_pass_1<U, false, true>(plan, rows, scores, n, k, done, seg_keys,
                                                 values, indices, stream)
                 : launch_pass_1<U, false, false>(plan, rows, scores, n, k, done, seg_keys,
                                                  values, indices, stream);
    if (err != cudaSuccess) return err;
    topk_select_merge_kernel<U><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
        scores, n, plan.k, plan.segs, k, done, seg_keys, values, indices);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

int collie_topk_select_abi() { return 2; }

// The plan of the top ``k`` of ``rows`` rows of ``n`` elements of
// ``elem_bytes`` (4: float32, 2: float16 or bfloat16) on the current card:
// ``first`` (4 ints) receives the rounds, the first round's segments a row,
// their length and the first round's k.  Returns the scratch keys
// (``unsigned long long``) collie_topk_select needs, or a negative
// cudaError_t.
long long collie_topk_select_plan(long long rows, int n, int k, int elem_bytes, int* first) {
  long long scratch = 0;
  int rounds = 0;
  Plan plan;
  cudaError_t err = cudaErrorInvalidValue;
  if (first != nullptr && elem_bytes == 4)
    err = plan_all<uint32_t>(rows, n, k, &scratch, &rounds, &plan);
  else if (first != nullptr && elem_bytes == 2)
    err = plan_all<uint16_t>(rows, n, k, &scratch, &rounds, &plan);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  first[0] = rounds;
  first[1] = plan.segs;
  first[2] = plan.seg_len;
  first[3] = plan.k;
  return scratch;
}

// scores [rows, n] contiguous, of ``elem_bytes`` an element; values [rows, k]
// of the same type and indices [rows, k] int64 out; seg_keys scratch of
// ``scratch_keys`` keys (collie_topk_select_plan's), null where that is 0.
int collie_topk_select(const void* scores, int elem_bytes, long long rows, int n, int k,
                       u64* seg_keys, long long scratch_keys, void* values, long long* indices,
                       void* stream) {
  if (scores == nullptr || values == nullptr || indices == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (elem_bytes == 4)
    err = run_selection<uint32_t>(static_cast<const uint32_t*>(scores), rows, n, k, seg_keys,
                                  scratch_keys, static_cast<uint32_t*>(values), indices, s);
  else if (elem_bytes == 2)
    err = run_selection<uint16_t>(static_cast<const uint16_t*>(scores), rows, n, k, seg_keys,
                                  scratch_keys, static_cast<uint16_t*>(values), indices, s);
  return static_cast<int>(err);
}

}  // extern "C"
