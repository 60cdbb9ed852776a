// K4: all-pairs hamming distances over packed bit words on Hopper's int8
// tensor cores (sm_90a, wgmma).
//
// Replaces the TPU kernel lantern_tpu/ops/pallas_kernels.py:45 hamming_block
// (kernel body `_hamming_kernel`), which also serves that file's exact top-k
// wrapper `hamming_exact_topk`. Same function:
//
//   out[q, n] = sum_w popcount(queries[q, w] ^ base[n, w])   (f32, exact)
//
// queries [Q, W] and base [N, W] hold 32-bit words (int32 tensors carrying the
// uint32 bits) -> out [Q, N] f32. With `scores` set, the same launch writes the
// flat scan's score instead: -out[q, n], and -inf where deleted[n] (an [N]
// bool mask read as bytes), so the scan makes one pass over its [Q, N] block.
//
// Arithmetic. Each bit becomes +1 (set) or -1 (clear) as an int8. Then
//   hamming(q, b) = (32 W' - <+-q, +-b>) / 2,
// exact in the int32 accumulator (|dot| <= 32 W'). W' is W rounded up to 4
// words: the padding words are zero in both operands, add +32 each to the dot
// and nothing to the distance. One 32-bit word is one k-step of
// wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 (32 int8 along K). Any
// permutation of K serves as long as both operands use the same one: byte i of
// the 16-byte K half h, at column 4c + i (c = 0..3), carries bit 2c + h + 8i
// of the word, so that the 4 bytes of one register come from one word with a
// shift, a mask and a multiply (`pm1`).
//
// Bound. At the flat scan's shape (Q = 1024, N = 1M, W = 32) each input byte
// read once and each output byte written once is 4.1 GB of f32 out and 0.13 GB
// of packed words in: 1.26 ms at 3.35 TB/s. The +-1 product is 2.1e12 int8
// operations: 1.06 ms at the 1,979 TOP/s int8 peak. So the card's bound is the
// output's bytes. The CUDA-core design this replaces (one __popc per word pair,
// 64 x 128 tiles) read 8.19-8.25 ms there on an H100 80GB HBM3 at 700 W: 95% of
// its own popcount floor, and slower than one +-1 bf16 torch.matmul (2.64 ms).
//
// Design. A block owns 128 base rows (wgmma N = 128) and two warpgroups. The
// base rows are read from device memory packed, once, and expanded to +-1
// int8 straight into shared memory as wgmma's B operand: per k-step a 4 KiB
// K-major tile of 8-row x 16-byte core matrices, no swizzle (8-row groups 256
// bytes apart = SBO, the two K halves 128 bytes apart = LBO). Up to 32 words
// (128 KiB) stay expanded; wider rows are expanded again per 32-word chunk.
// Each warpgroup walks query tiles of 128 (tile wg, wg + 2, ...) in groups of
// four words: it loads the packed query words two groups ahead (Q W 4 bytes
// in all: L2-resident), expands them into one of two 16 KiB A buffers in
// shared memory, in the same layout, and issues eight wgmmas, four k-steps
// for each 64-row half of the tile: two independent accumulator chains over
// one B tile. The other buffer's group runs meanwhile (wait_group 1). A
// register A operand would cut the shared-memory traffic, but its rewrite
// per group makes ptxas serialise the wgmmas, and two chains of it spill.
// Nothing is unpacked in device memory and the call is one launch.
//
// Epilogue. The int32 accumulators (128 a thread) become the distance, or the
// score (negated, -inf at deleted columns, whose flags the block reads once
// into shared memory), in registers, then go to shared memory in row order
// over the warpgroup's A buffers; each whole 512-byte row segment leaves as
// one bulk copy by the tensor memory accelerator (cp.async.bulk), one lane a
// row. Stores straight from the fragments (8 rows x 32 bytes a warp
// instruction) wrote the same block far more slowly than 512-byte row runs.
// Rows past Q or N are read as zeros and never stored; a ragged last block
// and N % 4 != 0 store lane by lane.
//
// What limits it. Of the card's three floors (output bytes, int8 tensor
// work, and the shared-memory traffic of this design: the expanded A and B
// operands each wgmma reads, the A expansion and the staging) none is
// reached: the warpgroups issue no wgmma while they expand, stage and store,
// and two warpgroups cover only part of that. chip_smoke.py phase 8 prints
// its time beside the bound and both yardsticks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBM = 128;                     // queries per warpgroup tile: two m64 halves
constexpr int kBN = 128;                     // base rows per block
constexpr int kChunk = 32;                   // words kept expanded in shared memory
constexpr int kStepB = kBN * 32;             // one k-step of the base tile: 4 KiB
constexpr int kStepA = kBM * 32;             // one k-step of a query tile: 4 KiB
constexpr int kGroupA = 4 * kStepA;          // one group of four k-steps: 16 KiB
// A staged output row: 128 floats padded to 132 (16-byte aligned rows; the
// fragment stores of 4 rows a half-warp spread over the banks).
constexpr int kStageStride = kBN + 4;
constexpr int kStageFloats = 16 * kStageStride;  // one warp's 16 staged rows
constexpr int kSmemB = kChunk * kStepB;      // 128 KiB
// a warpgroup's region: its two A buffers, which its staging overlaps
constexpr int kRegion = 4 * kStageFloats * 4 > 2 * kGroupA ? 4 * kStageFloats * 4 : 2 * kGroupA;
constexpr int kSmemBytes = kSmemB + kWarpgroups * kRegion;

// +-1 int8 bytes from bits shift, shift + 8, shift + 16, shift + 24 of x: a set
// bit gives 0x01, a clear one 0xFF. ~(254 s) is per-byte since 254 s has no
// carries between bytes.
__device__ __forceinline__ uint32_t pm1(uint32_t x, int shift) {
  const uint32_t s = (x >> shift) & 0x01010101u;
  return ~(s * 254u);
}

// One word as one row of one k-step of a K-major operand tile: K half 0 (16
// bytes) at p, K half 1 at p + 128. Byte 4c + i of half h is bit 2c + h + 8i.
__device__ __forceinline__ void expand_word(uint8_t* p, uint32_t x) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pm1(x, 0), pm1(x, 2), pm1(x, 4), pm1(x, 6));
  *reinterpret_cast<uint4*>(p + 128) = make_uint4(pm1(x, 1), pm1(x, 3), pm1(x, 5), pm1(x, 7));
}

// Offset of row r in a k-step tile of 8-row x 16-byte core matrices: 8-row
// groups 256 bytes apart (the descriptors' SBO), K halves 128 apart (LBO).
__device__ __forceinline__ int tile_offset(int r) { return (r / 8) * 256 + (r % 8) * 16; }

// Words [w0, w0 + 4) of row `row` of a [rows, w] word matrix; words past the
// row's end or rows at or past `rows` read as zeros. Branch-free (clamped
// addresses, selects): a divergent branch near the wgmmas makes ptxas
// serialise them.
__device__ __forceinline__ void load_words(uint32_t (&x)[4], const uint32_t* __restrict__ src,
                                           int64_t row, int64_t rows, int w, int w0, bool vec) {
  const bool in = row < rows;
  const uint32_t* p = src + (in ? row : 0) * w;
  if (vec) {  // w % 4 == 0 and a 16-byte aligned matrix
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + w0));
    x[0] = in ? v.x : 0u;
    x[1] = in ? v.y : 0u;
    x[2] = in ? v.z : 0u;
    x[3] = in ? v.w : 0u;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t v = __ldg(p + min(w0 + i, w - 1));
      x[i] = in && w0 + i < w ? v : 0u;
    }
  }
}

// Expand words [w0, w0 + steps) of base rows [n0, n0 + kBN) into the shared
// B tiles (k-step s at s * kStepB). Consecutive threads take consecutive
// rows, so each 8-lane phase of a 16-byte store fills one core matrix.
__device__ __forceinline__ void expand_base(uint8_t* sb, const uint32_t* __restrict__ base,
                                            int64_t n, int w, int64_t n0, int w0, int steps,
                                            bool vec) {
  for (int e = threadIdx.x; e < kBN * (steps / 4); e += kThreads) {
    const int r = e % kBN;
    const int s0 = (e / kBN) * 4;
    uint32_t x[4];
    load_words(x, base, n0 + r, n, w, w0 + s0, vec);
#pragma unroll
    for (int i = 0; i < 4; ++i) expand_word(sb + (s0 + i) * kStepB + tile_offset(r), x[i]);
  }
}

// Shared-memory matrix descriptor of a K-major tile: no swizzle, LBO = 128
// bytes (K halves), SBO = 256 bytes (8-row groups).
__device__ __forceinline__ uint64_t desc(const uint8_t* tile) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64] (+)= A (64 query rows) x B (128 base rows) over one k-step, both
// +-1 int8 tiles in shared memory (wgmma .m64n128k32 .s32.s8.s8); scale_d = 0
// starts from zero.
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Everything a step of the walk needs beside its registers.
struct Walk {
  const uint32_t* __restrict__ queries;
  const uint32_t* __restrict__ base;
  float* __restrict__ out;
  uint8_t* sb;     // the expanded base chunk
  uint8_t* sa;     // this warpgroup's two A group buffers
  float* stage;    // this warp's 16 staged rows (over the A buffers)
  int64_t nq, n, n0;
  int64_t rounds;  // tiles per warpgroup
  int w, groups;   // groups of four words a row: ceil(w / 4)
  int nchunks, kbits, wg, t, warp, lane, g, c;
  uint32_t del;    // bit 2 j + e: column n0 + 8 j + 2 c + e is deleted
  bool vec;
};

// The step after (r, j): word group j + 1, or the next round's first.
// (Carried counters: a 64-bit division a step would cost more than the step.)
__device__ __forceinline__ void advance(const Walk& k, int64_t& r, int& j) {
  if (++j == k.groups) {
    j = 0;
    ++r;
  }
}

// This thread's share of step (r, j)'s query words: words 4 j .. 4 j + 3 of
// row t of the tile.
__device__ __forceinline__ void load_step(const Walk& k, uint32_t (&x)[4], int64_t r, int j) {
  if (r >= k.rounds) return;
  const int64_t q = (r * kWarpgroups + k.wg) * kBM + k.t;
  load_words(x, k.queries, q, k.nq, k.w, 4 * j, k.vec);
}

// Write this warp's 16 rows of accumulator half d (final values as float
// bits): rows q0 + g + 8 h. They go to shared memory in row order; each whole
// row then leaves as one 512-byte bulk copy by the tensor memory accelerator
// (one lane a row), so the warps issue no global stores. Ragged rows (the
// last block, or N % 4 != 0) are stored by the lanes instead.
__device__ __forceinline__ void store_rows(const Walk& k, const uint32_t (&d)[64], int64_t q0) {
  // d[4 j + 2 h + e] is row g + 8 h, column 8 j + 2 c + e
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint2*>(k.stage + (k.g + 8 * h) * kStageStride + 8 * j + 2 * k.c) =
          make_uint2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  const bool full = (k.n & 3) == 0 && k.n0 + kBN <= k.n;  // aligned whole rows
  if (full) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (k.lane < 16 && q0 + k.lane < k.nq) {
      const uint32_t src =
          static_cast<uint32_t>(__cvta_generic_to_shared(k.stage + k.lane * kStageStride));
      float* dst = k.out + (q0 + k.lane) * k.n + k.n0;
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                   ::"l"(dst), "r"(src), "n"(kBN * 4) : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  } else {
    __syncwarp();
    const int64_t col = k.n0 + 4 * k.lane;
    for (int i = 0; i < 16 && q0 + i < k.nq; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (col + u < k.n) k.out[(q0 + i) * k.n + col + u] = k.stage[i * kStageStride + 4 * k.lane + u];
  }
  __syncwarp();  // the rows are read before the next ones overwrite them
}

// The tile's values in place (outside any divergent branch), then its rows.
// The staging overlaps the warpgroup's A buffers, which its finished wgmmas
// no longer read; a warpgroup barrier keeps the next expansion off them until
// every warp's rows have left.
template <bool kScores>
__device__ __forceinline__ void finish_tile(const Walk& k, uint32_t (&d0)[64],
                                           uint32_t (&d1)[64], int64_t r) {
  wgmma_wait<0>();
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float v0 = static_cast<float>((k.kbits - static_cast<int>(d0[i])) >> 1);
    const float v1 = static_cast<float>((k.kbits - static_cast<int>(d1[i])) >> 1);
    const bool del = kScores && (k.del >> (2 * (i / 4) + i % 2)) & 1;
    d0[i] = __float_as_uint(kScores ? (del ? neg_inf : -v0) : v0);
    d1[i] = __float_as_uint(kScores ? (del ? neg_inf : -v1) : v1);
  }
  const int64_t q0 = (r * kWarpgroups + k.wg) * kBM + 16 * k.warp;
  store_rows(k, d0, q0);
  store_rows(k, d1, q0 + 64);
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + k.wg) : "memory");
}

// Step (r, j) of the walk: round r, word group j, A buffer `buf`. Expands the
// words in x (loaded two steps ahead) into the buffer, which the group two
// steps back read, issues the group's wgmmas without waiting for them (four
// k-steps, each for both 64-row halves: two independent accumulator chains),
// and loads the words of the step two ahead into x.
template <bool kScores>
__device__ __forceinline__ void step(const Walk& k, uint32_t (&d0)[64], uint32_t (&d1)[64],
                                     uint32_t (&x)[4], uint8_t* buf, int64_t r, int j) {
  if (k.nchunks > 1 && j % (kChunk / 4) == 0) {  // the next chunk of every row
    wgmma_wait<0>();
    __syncthreads();
    const int w0 = j * 4;
    expand_base(k.sb, k.base, k.n, k.w, k.n0, w0, (min(kChunk, k.w - w0) + 3) / 4 * 4, k.vec);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
  wgmma_wait<1>();  // the group that read `buf` is done
#pragma unroll
  for (int s = 0; s < 4; ++s) expand_word(buf + s * kStepA + tile_offset(k.t), x[s]);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + k.wg) : "memory");  // the warpgroup's tile
  const uint64_t da = desc(buf);
  const uint64_t db = desc(k.sb + (j % (kChunk / 4)) * 4 * kStepB);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) {  // start addresses count 16-byte units
    const int scale = j == 0 && s == 0 ? 0 : 1;
    wgmma_s8(d0, da + s * (kStepA >> 4), db + s * (kStepB >> 4), scale);
    wgmma_s8(d1, da + (s * kStepA + 8 * 256) / 16, db + s * (kStepB >> 4), scale);
  }
  wgmma_commit();
  int64_t r2 = r;
  int j2 = j;
  advance(k, r2, j2);
  advance(k, r2, j2);
  load_step(k, x, r2, j2);
  if (j == k.groups - 1) finish_tile<kScores>(k, d0, d1, r);
}

template <bool kScores>
__global__ void __launch_bounds__(kThreads, 1)
hamming_kernel(const uint32_t* __restrict__ queries, const uint32_t* __restrict__ base,
               const uint8_t* __restrict__ deleted, float* __restrict__ out, int64_t nq,
               int64_t n, int w, bool vec) {
  extern __shared__ __align__(128) uint8_t smem[];
  Walk k;
  k.queries = queries;
  k.base = base;
  k.out = out;
  k.nq = nq;
  k.n = n;
  k.n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  k.w = w;
  k.groups = (w + 3) / 4;
  k.nchunks = (w + kChunk - 1) / kChunk;
  k.kbits = 128 * k.groups;
  k.wg = threadIdx.x / 128;
  k.t = threadIdx.x % 128;
  k.warp = k.t / 32;
  k.lane = threadIdx.x % 32;
  k.g = k.lane / 4;
  k.c = k.lane % 4;
  k.vec = vec;
  k.sb = smem;
  k.sa = smem + kSmemB + k.wg * kRegion;
  k.stage = reinterpret_cast<float*>(k.sa) + k.warp * kStageFloats;
  k.rounds = ((nq + kBM - 1) / kBM + kWarpgroups - 1) / kWarpgroups;
  __shared__ uint8_t sdel[kBN];  // the block's deleted flags, one load a thread
  if (kScores && threadIdx.x < kBN) {
    const int64_t col = k.n0 + threadIdx.x;
    sdel[threadIdx.x] = deleted != nullptr && col < n ? deleted[col] : 0;
  }
  if (k.nchunks == 1) {  // the whole row width stays expanded for every tile
    expand_base(k.sb, base, n, w, k.n0, 0, 4 * k.groups, vec);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  k.del = 0;
  if (kScores) {
#pragma unroll
    for (int i = 0; i < 32; ++i) k.del |= (sdel[8 * (i / 2) + 2 * k.c + i % 2] != 0) << i;
  }

  // One walk over (round, word group): every warpgroup runs every round, a
  // tile past Q reads zero words and stores nothing (a branch on it would be
  // divergent to ptxas). Even steps use word registers x0 and A buffer 0,
  // odd ones x1 and buffer 1.
  uint32_t d0[64], d1[64], x0[4], x1[4];
#pragma unroll
  for (int i = 0; i < 64; ++i) d0[i] = d1[i] = 0u;
  int64_t r = 0;
  int j = 0;
  load_step(k, x0, 0, 0);
  advance(k, r, j);
  load_step(k, x1, r, j);
  r = 0;
  j = 0;
  while (r < k.rounds) {
    step<kScores>(k, d0, d1, x0, k.sa, r, j);
    advance(k, r, j);
    if (r == k.rounds) break;
    step<kScores>(k, d0, d1, x1, k.sa + kGroupA, r, j);
    advance(k, r, j);
  }
}

template <bool kScores>
int launch(const uint32_t* q, const uint32_t* b, const uint8_t* del, float* o, int64_t nq,
           int64_t n, int w, bool vec, cudaStream_t s) {
  static bool configured = false;  // over 48 KiB of shared memory needs opting in
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        hamming_kernel<kScores>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int64_t blocks = (n + kBN - 1) / kBN;
  hamming_kernel<kScores><<<(unsigned)blocks, kThreads, kSmemBytes, s>>>(q, b, del, o, nq, n, w,
                                                                         vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). vec: 1 when w % 4 == 0 and both
// word arrays start on a 16-byte boundary. scores: 0 writes distances, 1 the
// negated distances with -inf at the rows `deleted` (nullable, [n] bytes)
// marks. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch (0 = success).
extern "C" int ldb_hamming_block(const void* queries, const void* base, const void* deleted,
                                 void* out, int64_t nq, int64_t n, int w, int vec, int scores,
                                 void* stream) {
  if (nq <= 0 || n <= 0 || w <= 0 || w > (1 << 20)) return (int)cudaErrorInvalidValue;
  if ((n + kBN - 1) / kBN > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const auto* q = static_cast<const uint32_t*>(queries);
  const auto* b = static_cast<const uint32_t*>(base);
  const auto* del = static_cast<const uint8_t*>(deleted);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return scores ? launch<true>(q, b, del, o, nq, n, w, vec != 0, s)
                : launch<false>(q, b, del, o, nq, n, w, vec != 0, s);
}
