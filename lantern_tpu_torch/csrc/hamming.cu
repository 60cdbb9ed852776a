// K4: all-pairs hamming distances over packed bit words, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel lantern_tpu/ops/pallas_kernels.py::hamming_block
// (kernel body `_hamming_kernel`), which also serves that file's exact
// top-k wrapper `hamming_exact_topk`. Same function:
//
//   out[q, n] = sum_w popcount(queries[q, w] ^ base[n, w])   (f32, exact)
//
// queries [Q, W] and base [N, W] hold 32-bit words (int32 tensors carrying the
// uint32 bits) -> out [Q, N] f32. Counts are <= 32 W, exact in f32.
//
// Bound. Counting each input byte read once and each output byte written
// once, the work at the flat scan's shape (Q = 1024, N = 1M, W = 32) is
// 4.1 GB of output against 0.13 GB of input: 1.26 ms at 3.35 TB/s. Counted as
// the +-1 product tensor cores could do (hamming = (32 W - <+-a, +-b>) / 2) it
// is 2.1e12 operations, 1.06 ms at the int8 peak: so the card's bound is
// bytes. This kernel runs on the CUDA cores instead, one __popc per word
// pair: Q N W = 3.3e10 of them at 16 per clock per SM is ~7.9 ms at 1.98 GHz,
// the floor of this design. Tensor cores (b1 mma.sync, or the +-1 product in
// int8 wgmma) and a fused top-k are later work.
//
// Design: the Pallas kernel broadcasts a [QB, NB, W] XOR block inside VMEM.
// Here a block owns a tile of 64 queries x 128 base rows, like a GEMM tile
// without tensor cores. Both operands' words are staged through shared
// memory in chunks of 32 words (W = 128 takes four chunks), rows padded to
// 33 words so that lanes reading one word of different rows hit distinct
// banks. Each warp owns 8 queries and each lane 4 base rows (lane, lane + 32,
// ...): the query word is a shared-memory broadcast, and every output row a
// warp writes is 32 consecutive floats. The 32 counts of a thread stay in
// registers as integers and are written once as f32. Rows are loaded with
// 16-byte loads where W % 4 == 0 and the pointers are aligned, else word by
// word; rows past Q or N read as zeros and are never written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                          // 8 warps
constexpr int kBQ = 64;                                // queries per block
constexpr int kBN = 128;                               // base rows per block
constexpr int kKW = 32;                                // words per chunk
constexpr int kStride = kKW + 1;                       // padded shared row
constexpr int kRowsPerWarp = kBQ / (kThreads / 32);    // 8 queries per thread
constexpr int kColsPerLane = kBN / 32;                 // 4 base rows per thread

// Copy words [w0, w0 + kw) of rows [row0, row0 + rows) of a [nrows, w] word
// matrix into tile[rows][kStride]; rows at or past nrows read as zeros.
template <bool kVec>
__device__ __forceinline__ void load_tile(uint32_t* tile, const uint32_t* __restrict__ src,
                                          int64_t nrows, int w, int64_t row0, int rows,
                                          int w0, int kw) {
  if (kVec) {  // w % 4 == 0, 16-byte aligned rows: 4 words per thread per pass
    const int kv = kw / 4;
    for (int e = threadIdx.x; e < rows * kv; e += kThreads) {
      const int r = e / kv;
      const int c = (e - r * kv) * 4;
      const int64_t row = row0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < nrows) v = __ldg(reinterpret_cast<const uint4*>(src + row * w + w0 + c));
      uint32_t* t = tile + r * kStride + c;
      t[0] = v.x;
      t[1] = v.y;
      t[2] = v.z;
      t[3] = v.w;
    }
  } else {
    for (int e = threadIdx.x; e < rows * kw; e += kThreads) {
      const int r = e / kw;
      const int c = e - r * kw;
      const int64_t row = row0 + r;
      tile[r * kStride + c] = row < nrows ? __ldg(src + row * w + w0 + c) : 0u;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
hamming_kernel(const uint32_t* __restrict__ queries, const uint32_t* __restrict__ base,
               float* __restrict__ out, int64_t nq, int64_t n, int w) {
  __shared__ uint32_t sq[kBQ * kStride];
  __shared__ uint32_t sb[kBN * kStride];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t q0 = (int64_t)blockIdx.y * kBQ;
  const int64_t n0 = (int64_t)blockIdx.x * kBN;

  int acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = 0;

  for (int w0 = 0; w0 < w; w0 += kKW) {
    const int kw = min(kKW, w - w0);
    load_tile<kVec>(sq, queries, nq, w, q0, kBQ, w0, kw);
    load_tile<kVec>(sb, base, n, w, n0, kBN, w0, kw);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kw; ++c) {
      uint32_t b[kColsPerLane];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) b[j] = sb[(lane + 32 * j) * kStride + c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const uint32_t a = sq[(warp * kRowsPerWarp + i) * kStride + c];
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) acc[i][j] += __popc(a ^ b[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int64_t q = q0 + warp * kRowsPerWarp + i;
    if (q >= nq) break;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int64_t col = n0 + lane + 32 * j;
      if (col < n) out[q * n + col] = (float)acc[i][j];
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). vec: 1 when w % 4 == 0 and both
// word arrays start on a 16-byte boundary. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch (0 = success).
extern "C" int ldb_hamming_block(const void* queries, const void* base, void* out,
                                 int64_t nq, int64_t n, int w, int vec, void* stream) {
  if (nq <= 0 || n <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const int64_t gx = (n + kBN - 1) / kBN;
  const int64_t gy = (nq + kBQ - 1) / kBQ;
  if (gy > 65535 || gx > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  const auto* q = static_cast<const uint32_t*>(queries);
  const auto* b = static_cast<const uint32_t*>(base);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    hamming_kernel<true><<<grid, kThreads, 0, s>>>(q, b, o, nq, n, w);
  } else {
    hamming_kernel<false><<<grid, kThreads, 0, s>>>(q, b, o, nq, n, w);
  }
  return (int)cudaGetLastError();
}
