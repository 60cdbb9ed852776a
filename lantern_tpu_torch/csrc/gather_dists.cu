// K1: the HNSW beam's fused gather + distance, written for Hopper (sm_90a).
//
// Replaces the TPU kernel lantern_tpu/ops/pallas_gather.py::gather_dists_pallas
// (kernel body `_kernel`). Same function:
//
//   out[q, c] = dist(queries[q], vectors[ids[q, c]])
//   l2sq: q_sq[q] - 2 q.x + |x|^2        (|x|^2 from the gathered row itself)
//   cos:  1 - q.x / max(|q| |x|, 1e-30)   (|q| = sqrt(q_sq[q]))
//
// vectors [N, d] f32 or bf16, ids [Q, C] int32 pre-clipped to [0, N),
// queries [Q, d] f32, q_sq [Q] f32 -> out [Q, C] f32.
//
// Bound: bytes. Each candidate row is read once and meets one query, so the
// work is Q*C*(d*itemsize + 4) + Q*d*4 + Q*C*4 bytes against 4*Q*C*d flops:
// ~1 flop per byte, far below the card's ~20 f32 flops per byte. At the beam's
// shape (Q=1024, C=32, d=128 f32) that is ~17 MB, ~5 us at 3.35 TB/s. No tensor
// cores: a row is never reused by a second query, so there is no product to
// tile; the dot is a warp-wide reduction instead.
//
// Design: the TPU kernel double-buffers per-query row DMAs into VMEM. Here the
// memory system does that job: one block per query loads the query row once
// into shared memory, and each of its warps takes one candidate at a time,
// reading the row with 16-byte loads (one float4, or 8 bf16, per lane per
// pass; a scalar loop when d does not allow 16-byte rows). The dot and |x|^2
// accumulate in f32 in the same pass and reduce with __shfl_xor_sync. Many
// warps in flight on every SM keep enough row reads outstanding to cover the
// latency. An id outside [0, N) breaks the caller's contract: the kernel never
// reads that row and writes NaN instead.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMetricCos = 1;  // lantern_tpu_torch.config.Metric wire codes
constexpr int kMetricL2sq = 3;

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <bool kBf16, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
gather_dists_kernel(const void* __restrict__ vectors, const int32_t* __restrict__ ids,
                    const float* __restrict__ queries, const float* __restrict__ q_sq,
                    float* __restrict__ out, int64_t n, int d, int c, int metric) {
  extern __shared__ float4 qs4[];
  float* qs = reinterpret_cast<float*>(qs4);
  const int q = blockIdx.x;
  const float* qrow = queries + (int64_t)q * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) qs[i] = qrow[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float qsq = q_sq[q];
  for (int ci = warp; ci < c; ci += kWarps) {
    const int64_t o = (int64_t)q * c + ci;
    const int64_t id = ids[o];
    if (id < 0 || id >= n) {  // uniform across the warp
      if (lane == 0) out[o] = NAN;
      continue;
    }
    float dot = 0.f, sq = 0.f;
    if (kBf16) {
      const uint16_t* row = static_cast<const uint16_t*>(vectors) + id * d;
      if (kVec) {  // d % 8 == 0: 8 bf16 per lane per pass, masked tail pass
        for (int j = lane * 8; j < d; j += 32 * 8) {
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(row + j));
          const float4 a = qs4[j / 4];
          const float4 b = qs4[j / 4 + 1];
          const float x0 = bf16_lo(w.x), x1 = bf16_hi(w.x);
          const float x2 = bf16_lo(w.y), x3 = bf16_hi(w.y);
          const float x4 = bf16_lo(w.z), x5 = bf16_hi(w.z);
          const float x6 = bf16_lo(w.w), x7 = bf16_hi(w.w);
          dot += x0 * a.x + x1 * a.y + x2 * a.z + x3 * a.w
               + x4 * b.x + x5 * b.y + x6 * b.z + x7 * b.w;
          sq += x0 * x0 + x1 * x1 + x2 * x2 + x3 * x3
              + x4 * x4 + x5 * x5 + x6 * x6 + x7 * x7;
        }
      } else {
        for (int j = lane; j < d; j += 32) {
          const float x = __uint_as_float((uint32_t)__ldg(row + j) << 16);
          dot += x * qs[j];
          sq += x * x;
        }
      }
    } else {
      const float* row = static_cast<const float*>(vectors) + id * d;
      if (kVec) {  // d % 4 == 0: one float4 per lane per pass, masked tail pass
        for (int j = lane * 4; j < d; j += 32 * 4) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(row + j));
          const float4 a = qs4[j / 4];
          dot += x.x * a.x + x.y * a.y + x.z * a.z + x.w * a.w;
          sq += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
        }
      } else {
        for (int j = lane; j < d; j += 32) {
          const float x = __ldg(row + j);
          dot += x * qs[j];
          sq += x * x;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    if (lane == 0) {
      out[o] = metric == kMetricL2sq
                   ? qsq - 2.0f * dot + sq
                   : 1.0f - dot / fmaxf(sqrtf(qsq) * sqrtf(sq), 1e-30f);
    }
  }
}

template <bool kBf16, bool kVec>
cudaError_t launch(const void* vectors, const int32_t* ids, const float* queries,
                   const float* q_sq, float* out, int64_t n, int d, int q, int c,
                   int metric, cudaStream_t stream) {
  const size_t smem = (size_t)((d + 3) / 4) * sizeof(float4);
  gather_dists_kernel<kBf16, kVec><<<q, kWarps * 32, smem, stream>>>(
      vectors, ids, queries, q_sq, out, n, d, c, metric);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = f32, 1 = bf16.
// vec: 1 when every row starts on a 16-byte boundary (d % 4 == 0 for f32,
// d % 8 == 0 for bf16, aligned base). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch (0 = success).
extern "C" int ldb_gather_dists(const void* vectors, const void* ids, const void* queries,
                                const void* q_sq, void* out, int64_t n, int d, int q, int c,
                                int dtype, int metric, int vec, void* stream) {
  if (q <= 0 || c <= 0 || d <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (metric != kMetricL2sq && metric != kMetricCos) return (int)cudaErrorInvalidValue;
  if ((size_t)d * sizeof(float) > 48 * 1024) return (int)cudaErrorInvalidValue;
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* qq = static_cast<const float*>(queries);
  const auto* qs = static_cast<const float*>(q_sq);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)(vec ? launch<false, true>(vectors, i, qq, qs, o, n, d, q, c, metric, s)
                     : launch<false, false>(vectors, i, qq, qs, o, n, d, q, c, metric, s));
  }
  if (dtype == 1) {
    return (int)(vec ? launch<true, true>(vectors, i, qq, qs, o, n, d, q, c, metric, s)
                     : launch<true, false>(vectors, i, qq, qs, o, n, d, q, c, metric, s));
  }
  return (int)cudaErrorInvalidValue;
}
