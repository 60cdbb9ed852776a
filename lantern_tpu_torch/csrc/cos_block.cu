// The flat scan's f32 cosine score block on Hopper's TF32 tensor cores
// (sm_90a, wgmma), accurate to f32 by splitting each operand in two.
//
//   out[q, n] = <queries[q], rows[n]> / max(sqrt(sq_norms[n]), 1e-30),
//   -inf where excluded[n]
//
// queries [Q, d] and rows [N, d] are f32 (d % 4 == 0, rows 16-byte aligned),
// sq_norms [N] f32, excluded an optional [N] bool mask read as bytes, out
// [Q, N] f32. The divide and the mask are IEEE sqrt and division, so for the
// same dots the block is bit-equal to flat.py's `_scaled` (the product, then
// the column divide, then masked_fill) that it replaces on the card.
//
// Replaces no TPU kernel: the JAX package leaves this product to XLA
// (lantern_tpu/flat.py), and the port's block was cuBLAS's FFMA SGEMM
// followed by two elementwise passes over the [Q, N] block. It was written
// because that GEMM runs on the CUDA cores: TF32 alone keeps 10 mantissa
// bits of each operand, too coarse for the distances a cosine scan returns.
//
// Arithmetic (split TF32, the scheme of CUTLASS's 3xTF32 "fast f32" GEMMs).
// Each operand is split as x = hi + lo with hi = rna_tf32(x) and lo =
// rna_tf32(x - hi) (`cvt.rna.tf32.f32`: round to nearest, ties away; the
// tensor cores alone would truncate). The block is
//   lo_x hi_q + hi_x lo_q + hi_x hi_q,
// three TF32 products summed in f32; the dropped lo_x lo_q term and the
// residual of the split are about 2^-22 of each product. The small terms go
// first. The tensor cores add each product into the accumulator with
// truncation, and over 3 x d / 8 such additions the error would build up on
// one side, so every kChunk stages the accumulator is added into a second
// f32 sum with ordinary rounding and restarted.
//
// Bound. At the flat scan's shape (Q = 1024, N = 1M, d = 1536) the three
// products are 9.44e12 operations: 19.1 ms at the 495 TFLOP/s TF32 peak
// (one product alone, 2 Q N d, is 6.36 ms: what flat.score_roofline counts).
// Bytes, each read once: the 6.14 GB table and the 4.1 GB block, 3.06 ms.
// So the operations bound it, and the design feeds the tensor cores:
//
// Design. A persistent grid, one block per SM, walks output tiles of 128
// table rows x 128 queries, the 8 query tiles of a row tile one after
// another, so the table is read from device memory about once and the
// queries stay in the L2 cache. A first kernel splits the queries into
// [2, Q, d] hi and lo halves (12.6 MB at Q = 1024). In the main kernel one
// lane of a producer warpgroup issues TMA loads of 32-column stages (one
// 128-byte swizzled row each: the row tile, the query tile's hi and lo) into
// a ring of kStages in shared memory; two consumer warpgroups own 64 table
// rows each, with the registers the producer gives up (setmaxnreg). A
// consumer loads its rows' fragments with ldmatrix straight from the
// swizzled tile into registers and splits them there (the wgmma A operand
// is the table, from registers), so the table is never split in memory; it
// issues the three m64n128k8 wgmmas of each k-step against the query halves
// in shared memory (the B operand) and, while they run, loads and splits
// the next stage's fragments into a second set of registers. The epilogue reads each of its
// rows' norm and mask flag once and stores the divided tile straight from
// the registers: the block is written once and never passed over again;
// the output's 4.1 GB are a small share of the time, and each warp store
// fills whole 32-byte sectors.
//
// Measured on an H100 80GB HBM3 at 700 W at the flat scan's shape: 26.2-26.9
// ms, 71-73% of the three products' TF32 bound (the FFMA SGEMM alone took
// 62-66 ms). Its error against float64 on unit rows reads 2.8e-7 of |q|
// (the FFMA SGEMM 8.9e-7; TF32 alone 4.1e-5); with the accumulator summed
// once a tile it read 5.6e-6. What limits it is the gaps between a
// warpgroup's products, not the tensor cores or the L2 alone: two products
// instead of three took 85% of the time, and not loading the queries' lo
// half 95%. chip_smoke.py times it beside its bound, its plain version and
// two library products.

#include <cuda.h>  // CUtensorMap and the CUDA driver API enums: types only, no libcuda link
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                  // table rows a tile: 64 a consumer warpgroup
constexpr int kBN = 128;                  // queries a tile: the wgmma N
constexpr int kBK = 32;                   // columns of d a stage: one 128-byte row
constexpr int kStages = 4;                // the shared-memory ring
constexpr int kChunk = 2;                 // stages between the rounded f32 sums
constexpr int kConsumers = 2;             // warpgroups
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 128;  // and the producer warpgroup
constexpr int kRowsBytes = kBM * kBK * 4;        // 16 KiB
constexpr int kQBytes = kBN * kBK * 4;           // 16 KiB, each of hi and lo
constexpr int kStageBytes = kRowsBytes + 2 * kQBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, alignment
constexpr uint32_t kTf32Mask = 0xffffe000u;      // the bits a TF32 value keeps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA load of the box at (c0 along d, c1 along rows) of `map` into
// shared address `dst`, completing on `bar`. Rows and columns outside the
// tensor read as 0.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// x rounded to TF32, to nearest with ties away from zero, as f32 bits.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & kTf32Mask;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Descriptor of a K-major tile of 128-byte rows under the 128-byte swizzle
// (what the TMA wrote): 8-row groups 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
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

// d[64] (+)= A (64 table rows, TF32 fragments in registers) x B (128
// queries, a K-major TF32 tile in shared memory) over one k-step of 8
// (wgmma .m64n128k8 .f32.tf32.tf32); scale_d = 0 starts from zero.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// One stage of a warp's 16 table rows as wgmma A fragments, split: for
// k-step k, hi[k] and lo[k] hold rows g and g + 8, columns c and c + 4.
struct Frags {
  uint32_t hi[4][4], lo[4][4];
};

// The fragments from the stage's swizzled row tile (`rows`: this lane's
// ldmatrix row), split into TF32 halves in registers.
__device__ __forceinline__ void load_frags(Frags& f, uint32_t rows, int a_half, int lane) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ldmatrix_x4(f.hi[k], rows + (((2 * k + a_half) ^ (lane % 8)) << 4));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = __uint_as_float(f.hi[k][i]);
      f.hi[k][i] = rna_tf32(x);
      f.lo[k][i] = rna_tf32(x - __uint_as_float(f.hi[k][i]));
    }
  }
}

// The stage's twelve products: for each k-step (32 bytes along the query
// tile's rows: +2 in the descriptors' 16-byte units) the two small terms,
// then the large one.
__device__ __forceinline__ void issue(float (&acc)[64], const Frags& f, uint64_t dhi,
                                      uint64_t dlo, int& scale) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wgmma_tf32(acc, f.lo[k], dhi + 2 * k, scale);
    scale = 1;
    wgmma_tf32(acc, f.hi[k], dlo + 2 * k, 1);
    wgmma_tf32(acc, f.hi[k], dhi + 2 * k, 1);
  }
}

// The queries' split: hi[i] = rna_tf32(q[i]), lo[i] = rna_tf32(q[i] - hi[i]).
__global__ void split_kernel(const float* __restrict__ q, float* __restrict__ hi,
                             float* __restrict__ lo, int64_t count) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float x = q[i];
    const float h = __uint_as_float(rna_tf32(x));
    hi[i] = h;
    lo[i] = __uint_as_float(rna_tf32(x - h));
  }
}

struct Shape {
  int64_t nq, n;
  int64_t qtiles, tiles;  // query tiles a row tile; tiles in all
  int ktiles;             // stages a tile: ceil(d / kBK)
};

// The tile's scores from this thread's accumulators: row 16 warp + g + 8 h of
// the warpgroup's 64, query 8 j + 2 c + e, in acc[4 j + 2 h + e]. Each row's
// norm and flag are read once; rows past N and queries past Q are not stored.
__device__ __forceinline__ void store_tile(const float (&acc)[64], const Shape& s,
                                           const float* __restrict__ sq_norms,
                                           const uint8_t* __restrict__ excluded,
                                           float* __restrict__ out, int64_t r0, int64_t q0,
                                           int g, int c) {
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t n = r0 + g + 8 * h;
    if (n >= s.n) continue;
    float norm = __fsqrt_rn(sq_norms[n]);
    norm = norm < 1e-30f ? 1e-30f : norm;  // torch.clamp(min=1e-30): NaN stays NaN
    const bool del = excluded != nullptr && excluded[n] != 0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t q = q0 + 8 * j + 2 * c + e;
        if (q < s.nq) out[q * s.n + n] = del ? neg_inf : __fdiv_rn(acc[4 * j + 2 * h + e], norm);
      }
    }
  }
}

// The shared-memory ring as the producer fills it and a consumer walks it:
// stage `st` of `phase`.
struct Ring {
  uint8_t* smem;  // kStages stages: the row tile, the query tile's hi, its lo
  uint64_t* full;
  uint64_t* empty;
  int st;
  uint32_t phase;
  __device__ __forceinline__ uint32_t rows(int i) const {
    return smem_addr(smem + i * kStageBytes);
  }
  __device__ __forceinline__ uint32_t qhi(int i) const { return rows(i) + kRowsBytes; }
  __device__ __forceinline__ uint32_t qlo(int i) const { return rows(i) + kRowsBytes + kQBytes; }
  __device__ __forceinline__ void advance() {
    if (++st == kStages) {
      st = 0;
      phase ^= 1;
    }
  }
};

// Stage kt of a tile: its products from `cur`, issued without waiting;
// then the stage before it released and the next stage's fragments loaded
// into `nxt` while they run. Every kChunk stages, and at the tile's last,
// the sum takes the accumulator, which restarts. `held`: the stage whose
// products may still be running (-1: none).
__device__ __forceinline__ void consume_stage(float (&acc)[64], float (&sum)[64], Frags& cur,
                                              Frags& nxt, Ring& ring, int& held, int& scale,
                                              int kt, int ktiles, uint32_t a_base, int a_half,
                                              int lane) {
  wgmma_fence();
  issue(acc, cur, desc_sw128(ring.qhi(ring.st)), desc_sw128(ring.qlo(ring.st)), scale);
  wgmma_commit();
  wgmma_wait<1>();
  if (held >= 0 && lane == 0) mbar_arrive(&ring.empty[held]);
  held = ring.st;
  ring.advance();
  if (kt + 1 < ktiles) {
    mbar_wait(&ring.full[ring.st], ring.phase);
    load_frags(nxt, ring.rows(ring.st) + a_base, a_half, lane);
  }
  if ((kt + 1) % kChunk == 0 || kt + 1 == ktiles) {
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&ring.empty[held]);
    held = -1;
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    scale = 0;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
cos_block_kernel(const __grid_constant__ CUtensorMap rows_map,
                 const __grid_constant__ CUtensorMap qhi_map,
                 const __grid_constant__ CUtensorMap qlo_map, const float* __restrict__ sq_norms,
                 const uint8_t* __restrict__ excluded, float* __restrict__ out, Shape s) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle wants 1024-byte aligned tiles
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  Ring ring{smem, full, empty, 0, 0};

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumerThreads / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // the producer: one lane issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumerThreads) {
      for (int64_t tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
        const int r0 = static_cast<int>((tile / s.qtiles) * kBM);
        const int q0 = static_cast<int>((tile % s.qtiles) * kBN);
        for (int kt = 0; kt < s.ktiles; ++kt) {
          const int st = ring.st;
          mbar_wait(&empty[st], ring.phase ^ 1);  // a fresh ring passes
          mbar_expect_tx(&full[st], kStageBytes);
          tma_load(ring.rows(st), &rows_map, kt * kBK, r0, &full[st]);
          tma_load(ring.qhi(st), &qhi_map, kt * kBK, q0, &full[st]);
          tma_load(ring.qlo(st), &qlo_map, kt * kBK, q0, &full[st]);
          ring.advance();
        }
      }
    }
    return;
  }

  // A consumer warpgroup: 64 table rows of each tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  // ldmatrix: lane l gives the address of row l % 8 of 8 x 16-byte matrix
  // l / 8: rows +0 / +8 (l / 8 odd), the k-step's first or second 4 columns
  // (l / 16). Swizzled: 16-byte chunk j of row r lies at j ^ (r % 8).
  const int a_row = 64 * wg + 16 * warp + (lane % 8) + 8 * ((lane / 8) % 2);
  const int a_half = lane / 16;
  const uint32_t a_base = static_cast<uint32_t>(a_row * 128);

  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;
  Frags f0, f1;
  for (int64_t tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
    const int64_t r0 = (tile / s.qtiles) * kBM;
    const int64_t q0 = (tile % s.qtiles) * kBN;
    int scale = 0, held = -1, kt = 0;
    mbar_wait(&full[ring.st], ring.phase);
    load_frags(f0, ring.rows(ring.st) + a_base, a_half, lane);
    while (true) {  // two stages a turn, so each set of fragments keeps its registers
      consume_stage(acc, sum, f0, f1, ring, held, scale, kt, s.ktiles, a_base, a_half, lane);
      if (++kt == s.ktiles) break;
      consume_stage(acc, sum, f1, f0, ring, held, scale, kt, s.ktiles, a_base, a_half, lane);
      if (++kt == s.ktiles) break;
    }
    store_tile(sum, s, sq_norms, excluded, out, r0 + 64 * wg + 16 * warp, q0, g, c);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The CUDA driver API call cuTensorMapEncodeTiled, found through the runtime
// (no libcuda link).
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [rows, d] f32 matrix read in boxes of kBK columns x `box_rows` rows,
// 128-byte swizzled. Returns false where CUDA refuses it.
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* base, int64_t rows, int d,
              int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 4};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Plain C entry point (bound with ctypes). queries [nq, d], rows [n, d] and
// sq_norms [n] f32, excluded [n] bytes or null, out [nq, n] f32, split
// [2, nq, d] f32 scratch for the queries' hi and lo halves. d % 4 == 0 and
// rows and split 16-byte aligned. Launches the split and the block on
// `stream`, does not synchronise, and returns cudaGetLastError() of the
// launches (0 = success); cudaErrorInvalidValue for a shape or alignment it
// does not take or a tensor map the driver refuses.
extern "C" int ldb_cos_block(const void* queries, const void* rows, const void* sq_norms,
                             const void* excluded, void* out, void* split, int64_t nq, int64_t n,
                             int d, void* stream) {
  if (nq <= 0 || n <= 0 || d <= 0 || d % 4 != 0) return (int)cudaErrorInvalidValue;
  if (nq > 0x7fffffff || n > 0x7fffffff) return (int)cudaErrorInvalidValue;  // TMA coordinates
  if ((reinterpret_cast<uintptr_t>(rows) | reinterpret_cast<uintptr_t>(split)) & 15)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  float* hi = static_cast<float*>(split);
  float* lo = hi + nq * d;

  // per device: its SM count, and the opt-in to over 48 KiB of shared memory
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    int n_sm = 0;
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(cos_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    sms_of[dev] = n_sm;
  }
  const int sms = sms_of[dev];

  CUtensorMap rows_map, qhi_map, qlo_map;
  if (!make_map(&rows_map, encode, rows, n, d, kBM) ||
      !make_map(&qhi_map, encode, hi, nq, d, kBN) || !make_map(&qlo_map, encode, lo, nq, d, kBN))
    return (int)cudaErrorInvalidValue;

  const int64_t count = nq * d;
  const int64_t split_blocks = (count + 255) / 256 < 4 * sms ? (count + 255) / 256 : 4 * sms;
  split_kernel<<<(unsigned)split_blocks, 256, 0, s>>>(static_cast<const float*>(queries), hi, lo,
                                                      count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Shape shape;
  shape.nq = nq;
  shape.n = n;
  shape.qtiles = (nq + kBN - 1) / kBN;
  shape.tiles = (n + kBM - 1) / kBM * shape.qtiles;
  shape.ktiles = (d + kBK - 1) / kBK;
  const int64_t grid = shape.tiles < sms ? shape.tiles : sms;
  cos_block_kernel<<<(unsigned)grid, kThreads, kSmemBytes, s>>>(
      rows_map, qhi_map, qlo_map, static_cast<const float*>(sq_norms),
      static_cast<const uint8_t*>(excluded), static_cast<float*>(out), shape);
  return (int)cudaGetLastError();
}
