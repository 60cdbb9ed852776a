// Exact row top-k of a [Q, N] f32 score block on the card, in one read of
// the block.
//
//   values[q, :k], positions[q, :k] = the k best entries of scores[q, :],
//   best first: larger score first, equal scores in ascending position
//
// NaN ranks above +inf (as torch.topk ranks it) and -0.0 ties with +0.0. A row
// with fewer than k entries above -inf returns its -inf entries at the lowest
// remaining positions, which is the same order. values are the selected
// entries' own bits, read back from the block.
//
// Replaces no TPU kernel: the JAX package leaves the flat scan's top-k to XLA
// (jax.lax.top_k / approx_max_k in lantern_tpu/flat.py), and the port's select
// was torch.topk, a radix select that reads the block several times
// (computeBlockDigitCounts, gatherTopK) and leaves ties in no fixed order.
//
// Bound. The select is a pass over memory: at the flat scan's shape (Q = 1024,
// N = 1M) the block is 4.19e9 bytes, 1.25 ms at 3.35 TB/s; the output is
// negligible. So the design reads each entry once, with 16-byte loads, and
// spends as little as it can on the rest:
//
// Design. Each entry maps to an order-preserving u32 key (NaN at the top), and
// a candidate is the u64 (key << 32 | ~position): larger is better, and no two
// candidates of a row are equal. Kernel 1 gives each block one slice of one
// row (a whole number of kChunk-entry steps; consecutive blocks read
// consecutive memory). Each step a thread loads kUnroll 16-byte vectors and
// drops every entry that does not beat the block's threshold, the k-th best
// candidate it holds so far (the key decides; only a tie with it looks at the
// position). The few survivors go to a buffer of `cap` candidates in shared
// memory, a slot for each from one shared counter (one atomic a warp, through
// a ballot). When the buffer fills, the block sorts it (bitonic, descending),
// keeps the k best and raises the threshold to the k-th, and the entries of
// the step that found no slot try again. Ascending input, where every entry
// survives, stays exact and only fills the buffer more often. At the end the
// block writes its kp best (kp >= k, a power of two; sorted when it holds
// more than kp, padded with the empty candidate 0). Kernel 2 gives each row
// one block, which sorts the row's slices * kp candidates in shared memory
// and writes the first k, reading each value back from the block by its
// position. Kernel 1 is held to 40 registers (6 blocks of 256 threads an SM):
// with more it ran 3-6% slower.
//
// Large k. One launch selects at most the k the shared buffers hold (the
// caller's plan keeps it to 1024). A larger k is a run of launches, each
// selecting the next piece of the row below a per-row ceiling: kernel 1 then
// also drops every candidate at or above the row's ceiling, and kernel 2
// writes its piece at a column offset of the output and leaves its last
// candidate as the next launch's ceiling. Each launch reads the block once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                     // floats a 16-byte load
constexpr int kUnroll = 4;                  // loads a thread has in flight a step
constexpr int kPer = kVec * kUnroll;        // entries a thread a step
constexpr int kChunk = kThreads * kPer;     // entries a block a step
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ uint32_t order_key(float f) {
  if (f != f) return 0xffffffffu;  // NaN above +inf
  const uint32_t x = f == 0.0f ? 0u : __float_as_uint(f);  // -0.0 ties with +0.0
  return (x & 0x80000000u) ? ~x : (x | 0x80000000u);
}

__device__ __forceinline__ uint64_t candidate(uint32_t key, uint32_t pos) {
  return (static_cast<uint64_t>(key) << 32) | static_cast<uint32_t>(~pos);
}

// The column of a thread's j-th entry of the step at column c.
__device__ __forceinline__ uint32_t position(int64_t c, int j, int tid) {
  return static_cast<uint32_t>(c + static_cast<int64_t>((j / kVec) * kThreads + tid) * kVec +
                               j % kVec);
}

// Sorts buf[0, n) descending, n a power of two, with the block's threads.
__device__ void sort_desc(uint64_t* buf, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const uint64_t a = buf[lo], b = buf[hi];
        if ((a < b) == ((lo & size) == 0)) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The buffer's k best to its front, sorted; the threshold raised to the k-th.
// Called by every thread when the buffer has overflowed (count >= cap).
__device__ void keep_best(uint64_t* buf, int cap, int k, int* count, uint64_t* thr) {
  const int n = min(*count, cap);
  for (int i = n + threadIdx.x; i < cap; i += blockDim.x) buf[i] = 0;
  __syncthreads();
  sort_desc(buf, cap);
  if (threadIdx.x == 0) {
    *count = min(n, k);
    if (n >= k) *thr = buf[k - 1];
  }
  __syncthreads();
}

// kBelow: keep only candidates below the row's ceiling below[row].
template <bool kAligned, bool kBelow>
__global__ void __launch_bounds__(kThreads, 6) slice_topk_kernel(
    const float* __restrict__ scores, int64_t cols, int k, int kp, int cap,
    int64_t slice_len, int slices, const uint64_t* __restrict__ below,
    uint64_t* __restrict__ cand) {
  extern __shared__ uint64_t buf[];
  __shared__ int count;
  __shared__ uint64_t thr;  // the k-th best candidate held
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t row = blockIdx.x / slices;
  const int64_t slice = blockIdx.x - row * slices;
  const float* __restrict__ p = scores + row * cols;
  const int64_t c0 = slice * slice_len;
  const int64_t c1 = min(c0 + slice_len, cols);
  const uint64_t ceiling = kBelow ? below[row] : 0;
  const uint32_t ck = static_cast<uint32_t>(ceiling >> 32);
  const uint32_t cpos = ~static_cast<uint32_t>(ceiling);
  if (tid == 0) {
    count = 0;
    thr = 0;  // below every candidate: the first entries all survive
  }
  __syncthreads();

  for (int64_t c = c0; c < c1; c += kChunk) {
    float f[kPer] = {};
    uint32_t pending = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = c + static_cast<int64_t>(u * kThreads + tid) * kVec;
      if (kAligned) {
        if (e < c1) {  // c1 is a multiple of 4 here: the vector is whole
          const float4 v = __ldcs(reinterpret_cast<const float4*>(p + e));
          f[u * kVec + 0] = v.x;
          f[u * kVec + 1] = v.y;
          f[u * kVec + 2] = v.z;
          f[u * kVec + 3] = v.w;
          pending |= 0xfu << (u * kVec);
        }
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          if (e + v < c1) {
            f[u * kVec + v] = __ldcs(p + e + v);
            pending |= 1u << (u * kVec + v);
          }
        }
      }
    }
    uint32_t key[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) key[j] = order_key(f[j]);

    for (;;) {
      const uint64_t t = thr;
      const uint32_t tk = static_cast<uint32_t>(t >> 32);
      const uint32_t tpos = ~static_cast<uint32_t>(t);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        // the key decides but for a tie with the threshold, where the lower
        // position wins (rare: an entry of a later step always loses it)
        bool drop = key[j] < tk || (key[j] == tk && position(c, j, tid) >= tpos);
        if (kBelow) drop = drop || key[j] > ck || (key[j] == ck && position(c, j, tid) <= cpos);
        if (drop) pending &= ~(1u << j);
      }
      if (__any_sync(0xffffffffu, pending != 0)) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const bool want = (pending >> j) & 1u;
          const uint32_t m = __ballot_sync(0xffffffffu, want);
          if (m == 0) continue;
          int base = 0;
          if (lane == 0) base = atomicAdd(&count, __popc(m));
          base = __shfl_sync(0xffffffffu, base, 0);
          if (want) {
            const int slot = base + __popc(m & ((1u << lane) - 1u));
            if (slot < cap) {
              buf[slot] = candidate(key[j], position(c, j, tid));
              pending &= ~(1u << j);
            }
          }
        }
      }
      // entries that found no slot wait for the buffer's k best
      if (!__syncthreads_or(pending != 0)) break;
      keep_best(buf, cap, k, &count, &thr);
    }
  }

  const int n = min(count, cap);
  if (n > kp) {
    int n2 = kp;  // a power of two
    while (n2 < n) n2 <<= 1;
    for (int i = n + tid; i < n2; i += kThreads) buf[i] = 0;
    __syncthreads();
    sort_desc(buf, n2);
  } else {
    for (int i = n + tid; i < kp; i += kThreads) buf[i] = 0;
    __syncthreads();
  }
  uint64_t* out = cand + static_cast<int64_t>(blockIdx.x) * kp;
  for (int i = tid; i < kp; i += kThreads) out[i] = buf[i];
}

// values and positions: rows of ld entries; below, where given: each row's
// k-th candidate, the next launch's ceiling.
__global__ void merge_kernel(const uint64_t* __restrict__ cand, int per_row, int m,
                             const float* __restrict__ scores, int64_t cols, int k,
                             int64_t ld, float* __restrict__ values,
                             int64_t* __restrict__ positions, uint64_t* __restrict__ below) {
  extern __shared__ uint64_t buf[];
  const int64_t row = blockIdx.x;
  const uint64_t* c = cand + row * per_row;
  for (int i = threadIdx.x; i < m; i += blockDim.x) buf[i] = i < per_row ? c[i] : 0;
  __syncthreads();
  sort_desc(buf, m);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const uint32_t pos = ~static_cast<uint32_t>(buf[i]);
    positions[row * ld + i] = pos;
    values[row * ld + i] = scores[row * cols + pos];
  }
  if (below != nullptr && threadIdx.x == 0) below[row] = buf[k - 1];
}

bool pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// Entries a block of kernel 1 reads a step: ops/row_topk.py plans slices in
// whole steps of it.
extern "C" int ldb_row_topk_step() { return kChunk; }

// One launch: the k best of each row below its ceiling, written to values and
// positions (rows of ld >= k entries, at the caller's column offset). The
// launch plan comes from ops/row_topk.py::plan: kp and cap powers of two with
// k <= kp and 2 kp <= cap; slices of slice_len entries (a multiple of kChunk)
// covering the row; m a power of two >= slices * kp; cand [rows, slices * kp]
// u64 scratch. below: null, or [rows] u64, read as the ceilings where
// has_below and left holding each row's k-th candidate. Returns a CUDA error
// code, 0 on success.
extern "C" int ldb_row_topk(const void* scores, int64_t rows, int64_t cols, int k, int kp,
                            int cap, int64_t slice_len, int slices, int m, int merge_threads,
                            void* cand, void* values, void* positions, int64_t ld,
                            void* below, int has_below, void* stream) {
  if (rows <= 0 || cols <= 0 || k <= 0 || k > kp || !pow2(kp) || !pow2(cap) || 2 * kp > cap ||
      ld < k || (has_below && below == nullptr) ||
      slices <= 0 || slice_len <= 0 || slice_len % kChunk != 0 || !pow2(m) ||
      m < static_cast<int64_t>(slices) * kp || merge_threads <= 0 || merge_threads > 1024)
    return (int)cudaErrorInvalidValue;
  if (cols > 0xffffffffLL || k > cols || (slices - 1) * slice_len >= cols ||
      static_cast<int64_t>(slices) * slice_len < cols || rows * slices > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int64_t merge_smem = static_cast<int64_t>(m) * 8;
  if (cap * 8 > kDefaultSmem || merge_smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);

  // per device: the merge's opt-in to over 48 KiB of shared memory
  constexpr int kMaxDevices = 64;
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (merge_smem > kDefaultSmem && !opted[dev]) {
    e = cudaFuncSetAttribute(merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             227 * 1024);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }

  const float* x = static_cast<const float*>(scores);
  auto* c = static_cast<uint64_t*>(cand);
  auto* ceilings = static_cast<uint64_t*>(below);
  const bool aligned = cols % kVec == 0 && (reinterpret_cast<uintptr_t>(scores) & 15) == 0;
  const unsigned blocks = static_cast<unsigned>(rows * slices);
  const size_t smem = static_cast<size_t>(cap) * 8;
  if (aligned && !has_below)
    slice_topk_kernel<true, false><<<blocks, kThreads, smem, s>>>(x, cols, k, kp, cap,
                                                                 slice_len, slices, ceilings, c);
  else if (aligned)
    slice_topk_kernel<true, true><<<blocks, kThreads, smem, s>>>(x, cols, k, kp, cap,
                                                                slice_len, slices, ceilings, c);
  else if (!has_below)
    slice_topk_kernel<false, false><<<blocks, kThreads, smem, s>>>(x, cols, k, kp, cap,
                                                                  slice_len, slices, ceilings, c);
  else
    slice_topk_kernel<false, true><<<blocks, kThreads, smem, s>>>(x, cols, k, kp, cap,
                                                                 slice_len, slices, ceilings, c);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_kernel<<<static_cast<unsigned>(rows), merge_threads, static_cast<size_t>(merge_smem), s>>>(
      c, slices * kp, m, x, cols, k, ld, static_cast<float*>(values),
      static_cast<int64_t*>(positions), ceilings);
  return (int)cudaGetLastError();
}
