// PQ decode, written for Hopper (sm_90a): kernels K2, K3, K5 and K6 in one.
//
// Replaces four TPU kernels that compute the same function:
//   lantern_tpu/ops/pallas_kernels.py::pq_decode_mxu_hilo  (K2, K = 256)
//   lantern_tpu/ops/pallas_kernels.py::pq_decode_mxu       (K3, any K <= 256)
//   benchmarks/exp_hilo_v2.py::pq_decode_hilo_v2            (K5, K2's variant)
//   benchmarks/exp_hilo_v3.py::pq_decode_hilo_v3            (K6, + |x|^2 output)
//
//   out[n, s*dsub + j] = cent[s, codes[n, s], j]          (bf16, bit-exact)
//   xsq[n]             = sum over the row of f32(out)^2    (optional)
//
// codes [N, S] u8, cent [S, K, dsub] bf16 (the f32 codebook rounded once by
// the caller), out [N, S*dsub] bf16, xsq [N] f32 or NULL. A code >= K decodes
// to zeros, as the one-hot formulations do.
//
// The TPU kernels build one-hot matrices and a select tree because a TPU core
// cannot gather from VMEM. A GPU can: this is a table lookup.
//
// Bound: bytes. Each code byte is read once and each output element written
// once: N*S + N*dim*2 (+ 4N) bytes and no arithmetic to speak of. At 1M rows,
// S = 32, dim = 128 that is ~292 MB, ~0.087 ms at 3.35 TB/s.
//
// Design: one warp per row (grid-stride over rows). The row is copied in
// accesses of the widest size that dsub*2 allows (16, 8, 4 or 2 bytes): lane
// l takes accesses l, l+32, ..., so a warp's stores of one pass are
// contiguous whatever dsub is. Access c belongs to subspace c / per (per =
// accesses per entry): the lane reads that code byte (lanes of one subspace
// read the same byte), copies its slice of the centroid entry, and
// accumulates |x|^2 in f32, reduced across the warp with __shfl_xor_sync (a
// fixed order, so xsq is the same on every run). The codebook is staged in
// shared memory when it fits the block's opt-in limit (64 KiB at dim 128,
// K = 256); beyond it (480 KiB at dim 960) the lookups read it through L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float sq_word(uint32_t w) {
  const float lo = __uint_as_float(w << 16);
  const float hi = __uint_as_float(w & 0xffff0000u);
  return lo * lo + hi * hi;
}

template <typename V>
__device__ __forceinline__ float sq_vec(const V& v);
template <>
__device__ __forceinline__ float sq_vec<uint4>(const uint4& v) {
  return sq_word(v.x) + sq_word(v.y) + sq_word(v.z) + sq_word(v.w);
}
template <>
__device__ __forceinline__ float sq_vec<uint2>(const uint2& v) {
  return sq_word(v.x) + sq_word(v.y);
}
template <>
__device__ __forceinline__ float sq_vec<uint32_t>(const uint32_t& v) {
  return sq_word(v);
}
template <>
__device__ __forceinline__ float sq_vec<uint16_t>(const uint16_t& v) {
  const float x = __uint_as_float((uint32_t)v << 16);
  return x * x;
}

// V: the access type (uint4 / uint2 / uint32_t / uint16_t); an entry of dsub
// bf16 values is `per` of them.
template <typename V, bool kSmem, bool kXsq>
__global__ void __launch_bounds__(kThreads)
pq_decode_kernel(const uint8_t* __restrict__ codes, const V* __restrict__ cent,
                 V* __restrict__ out, float* __restrict__ xsq, int64_t n, int s,
                 int k, int per, int64_t cb_vecs) {
  extern __shared__ uint4 smem4[];
  const V* cb = cent;
  if (kSmem) {
    V* dst = reinterpret_cast<V*>(smem4);
    for (int64_t i = threadIdx.x; i < cb_vecs; i += kThreads) dst[i] = cent[i];
    __syncthreads();
    cb = dst;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_vecs = s * per;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + warp; row < n;
       row += (int64_t)gridDim.x * kWarps) {
    const uint8_t* crow = codes + row * s;
    V* orow = out + row * row_vecs;
    float sq = 0.f;
    for (int c = lane; c < row_vecs; c += 32) {
      int j = c, v = 0;
      if (per != 1) {  // uniform across the warp; no division for dsub*2 <= 16
        j = c / per;
        v = c - j * per;
      }
      const int code = crow[j];
      V x = V{};
      if (code < k) x = cb[((int64_t)j * k + code) * per + v];
      orow[c] = x;
      if (kXsq) sq += sq_vec<V>(x);
    }
    if (kXsq) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
      if (lane == 0) xsq[row] = sq;
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

int smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (bytes <= 0) bytes = 48 * 1024;
  }
  return bytes;
}

template <typename V, bool kSmem, bool kXsq>
cudaError_t launch_one(const uint8_t* codes, const void* cent, void* out, float* xsq,
                       int64_t n, int s, int k, int dsub, cudaStream_t stream) {
  auto kernel = pq_decode_kernel<V, kSmem, kXsq>;
  const int per = dsub * 2 / (int)sizeof(V);
  const int64_t cb_vecs = (int64_t)s * k * per;
  const size_t smem = kSmem ? (size_t)cb_vecs * sizeof(V) : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t want = (n + kWarps - 1) / kWarps;
  const int64_t full = (int64_t)per_sm * sm_count();
  const int grid = (int)(want < full ? want : full);
  kernel<<<grid, kThreads, smem, stream>>>(
      codes, static_cast<const V*>(cent), static_cast<V*>(out), xsq, n, s, k, per,
      cb_vecs);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch(const uint8_t* codes, const void* cent, void* out, float* xsq,
                   int64_t n, int s, int k, int dsub, bool use_smem, cudaStream_t st) {
  if (use_smem) {
    return xsq ? launch_one<V, true, true>(codes, cent, out, xsq, n, s, k, dsub, st)
               : launch_one<V, true, false>(codes, cent, out, xsq, n, s, k, dsub, st);
  }
  return xsq ? launch_one<V, false, true>(codes, cent, out, xsq, n, s, k, dsub, st)
             : launch_one<V, false, false>(codes, cent, out, xsq, n, s, k, dsub, st);
}

}  // namespace

// Plain C entry point (bound with ctypes). codes [n, s] u8, cent [s, k, dsub]
// bf16, out [n, s*dsub] bf16, xsq [n] f32 or NULL; all contiguous. Launches on
// `stream`, does not synchronise, and returns the launch's cudaError_t
// (0 = success). K > 256 is refused: codes are bytes.
extern "C" int ldb_pq_decode(const void* codes, const void* cent, void* out, void* xsq,
                             int64_t n, int s, int k, int dsub, void* stream) {
  if (n <= 0 || s <= 0 || k <= 0 || k > 256 || dsub <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(cent) | reinterpret_cast<uintptr_t>(out);
  const int entry = dsub * 2;
  int width = 2;
  for (int w = 16; w > 2; w >>= 1) {
    if (entry % w == 0 && align % w == 0) {
      width = w;
      break;
    }
  }
  const size_t cb_bytes = (size_t)s * k * entry;
  const bool use_smem = cb_bytes <= (size_t)smem_optin();
  const auto* c = static_cast<const uint8_t*>(codes);
  auto* x = static_cast<float*>(xsq);
  auto st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 16: return (int)launch<uint4>(c, cent, out, x, n, s, k, dsub, use_smem, st);
    case 8: return (int)launch<uint2>(c, cent, out, x, n, s, k, dsub, use_smem, st);
    case 4: return (int)launch<uint32_t>(c, cent, out, x, n, s, k, dsub, use_smem, st);
    default: return (int)launch<uint16_t>(c, cent, out, x, n, s, k, dsub, use_smem, st);
  }
}
