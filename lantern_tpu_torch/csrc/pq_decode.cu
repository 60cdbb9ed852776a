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
// codes [N, S] u8 (any byte offset: views of a larger table are the rule),
// cent [S, K, dsub] bf16 (the f32 codebook rounded once by the caller), out
// [N, S*dsub] bf16, xsq [N] f32 or NULL. A code >= K decodes to zeros, as the
// one-hot formulations do.
//
// The TPU kernels build one-hot matrices and a select tree because a TPU core
// cannot gather from VMEM. A GPU can: this is a table lookup.
//
// Bound: bytes. Each code byte is read once and each output element written
// once: N*S + S*K*dsub*2 + N*dim*2 (+ 4N) bytes and no arithmetic to speak
// of. At 1M rows, S = 32, dim = 128 that is ~292 MB, ~0.087 ms at 3.35 TB/s.
// What keeps a plain lookup kernel from it is latency: a row's code bytes are
// a 32-byte read whose lookups wait on it, and a codebook beyond shared
// memory (480 KiB at dim 960) turns every lookup into a dependent L2 read.
//
// Design: a persistent grid of 512-thread blocks walks over tiles of T rows
// (T aims at 128 KiB of decoded bytes; smaller where the rows are few, so
// that every group of blocks gets a few tiles).
// - Code tiles ahead of use. Thread 0 copies a tile's T*S code bytes into a
//   ring of shared-memory stages with one bulk copy (cp.async.bulk), which
//   completes on the stage's `full` mbarrier; the ring keeps up to 3 tiles
//   in flight while the warps decode (2 where 3 stages would halve the
//   tile). A warp done with a stage arrives on its `empty` mbarrier, and
//   thread 0 refills the stage once all have. The copy runs from the
//   16-byte boundary below the tile to the one above it (bulk copies move
//   aligned 16-byte chunks), so code views at any row offset work: the
//   rows are indexed from the tile's offset in its first chunk. An aligned
//   16-byte chunk never straddles a page, so the few bytes read around a
//   view are mapped; they are never used.
// - The codebook in shared memory, in as few slices of whole subspaces as
//   fit beside the ring (one at S = 32, K = 256, dsub = 4: 64 KiB; three of
//   80 subspaces at S = 240: 160 KiB each, with 2 stages of 128 rows).
//   Slice r of a tile is decoded by block r of a group of `slices`
//   consecutive blocks, which writes only its slice's output columns; every
//   block copies the tile's whole rows of codes (L2 serves the repeats).
//   With |x|^2 asked for and more than one slice, the group is a
//   thread-block cluster: a row's partial sum of squares goes, by a store
//   to distributed shared memory, into slot r of the row's owner block
//   (row j: block j % slices); each block arrives on the cluster barrier
//   after a tile and waits on it only after decoding the next one, then
//   adds its rows' partials from its own shared memory in slot order. One
//   launch, no scratch buffer, no atomics: |x|^2 is the same on every run
//   (its order depends on the plan, which depends on S, K, dsub and the
//   output's alignment only).
// - Stores of 16 bytes a lane where the row allows, streaming (evict-first:
//   the decoded rows are written once and not read here): `lanes`
//   neighbouring lanes write a row's neighbouring vectors. At dsub = 4 a
//   vector holds two entries (EPV = 2), at dsub = 2 four, at dsub = 1
//   eight; an entry of a multiple of 16 bytes is several vectors (dsub =
//   40: five).
// - A second access width, picked by shape before the launch: where neither
//   the entry divides 16 bytes (with 16-byte rows) nor 16 divides the entry
//   (dsub = 3, or dsub = 4 at an odd S), a lane stores the widest of 8, 4
//   and 2 bytes that divides the entry, one part of one entry at a time.
// Limits: a shape with no plan is refused with cudaErrorInvalidValue: |x|^2
// over more than 16 slices (a codebook beyond ~3 MiB), or 2 stages of the
// fewest rows a block decodes at once beside one slice over the block's
// shared memory (S in the thousands).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;  // resident blocks an SM the registers allow
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 3;            // code tiles in flight (2 where 3 halve the tile)
constexpr int kPartBufs = 3;            // |x|^2 partials: tiles in flight
constexpr int kMaxClusterSlices = 16;   // non-portable cluster size above 8
constexpr int kTileOutBytes = 128 * 1024;  // decoded bytes a tile aims at
constexpr int kMinTilesPerGroup = 4;    // tiles a group gets when rows allow

struct Args {
  const uint8_t* codes;
  const uint8_t* cent;
  uint8_t* out;
  float* xsq;
  int64_t n, tiles;
  int s, k, entry;          // entry: bytes of one codebook entry (dsub * 2)
  int slices, slice_subs;   // blocks a group, subspaces a slice
  int lanes, per;           // lanes a row; vectors an entry (EPV == 1)
  int tile_rows, stages, stage_bytes, cb_bytes, part_rows;
};

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) { return x < y ? x : y; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
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

// one bulk copy global -> shared of `bytes` (a multiple of 16, both ends
// 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

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

// one vector of a decoded row: written once, never read here again
template <typename V>
__device__ __forceinline__ void put(V* p, const V& v) {
  __stcs(p, v);
}

// the type of one codebook entry when a 16-byte vector holds EPV of them
template <int EPV>
struct EntryOf;
template <>
struct EntryOf<2> { using T = uint2; };
template <>
struct EntryOf<4> { using T = uint32_t; };
template <>
struct EntryOf<8> { using T = uint16_t; };

// V: the store type (uint4 / uint2 / uint32_t / uint16_t). EPV > 1: a vector
// holds EPV entries (V = uint4); EPV = 1: an entry is `per` vectors.
template <typename V, int EPV, bool kXsq>
__global__ void __launch_bounds__(kThreads, kMinBlocks) pq_decode_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* cb_s = smem;
  uint8_t* ring = smem + a.cb_bytes;
  const int stages = a.stages;
  float* part = reinterpret_cast<float*>(ring + stages * a.stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(part + kPartBufs * a.slices * a.part_rows);
  uint64_t* empty = full + kMaxStages;

  const int tid = threadIdx.x, lane = tid & 31;
  const int R = a.slices;
  const int rank = blockIdx.x % R;  // a cluster's rank when clustered
  const int64_t gid = blockIdx.x / R, groups = gridDim.x / R;
  const bool reduce = kXsq && R > 1;
  const int s0 = rank * a.slice_subs;
  const int ns = min(a.slice_subs, a.s - s0);
  const int T = a.tile_rows;

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto load_tile = [&](int64_t tile, int st) {
    const int64_t r0 = tile * T, r1 = min64(a.n, r0 + T);
    const uintptr_t lo = reinterpret_cast<uintptr_t>(a.codes + r0 * a.s) & ~uintptr_t(15);
    const uintptr_t hi =
        (reinterpret_cast<uintptr_t>(a.codes + r1 * a.s) + 15) & ~uintptr_t(15);
    const uint32_t bytes = static_cast<uint32_t>(hi - lo);
    mbar_expect_tx(&full[st], bytes);
    bulk_load(ring + st * a.stage_bytes, reinterpret_cast<const void*>(lo), bytes,
              &full[st]);
  };
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      if (gid + st * groups < a.tiles) load_tile(gid + st * groups, st);
    }
  }
  {  // the slice's codebook, while the first tiles are in flight
    const uint8_t* src = a.cent + (int64_t)s0 * a.k * a.entry;
    const int bytes = ns * a.k * a.entry;
    if (((reinterpret_cast<uintptr_t>(src) | (uintptr_t)bytes) & 15) == 0) {
      for (int i = tid; i < bytes / 16; i += kThreads)
        reinterpret_cast<uint4*>(cb_s)[i] = reinterpret_cast<const uint4*>(src)[i];
    } else {
      for (int i = tid; i < bytes / 2; i += kThreads)
        reinterpret_cast<uint16_t*>(cb_s)[i] = reinterpret_cast<const uint16_t*>(src)[i];
    }
  }
  __syncthreads();

  const int L = a.lanes;
  const int gl = lane & (L - 1);
  const int G = kThreads / L;  // rows a block decodes at once
  const int row_first = tid / L;
  const int nvec = ns * a.entry / (int)sizeof(V);
  const int64_t row_vecs = (int64_t)a.s * a.entry / (int64_t)sizeof(V);
  V* out = reinterpret_cast<V*>(a.out) + (int64_t)s0 * a.entry / (int64_t)sizeof(V);
  // EPV == 1: vector c of the slice is part c % per of subspace c / per;
  // lane gl takes c = gl, gl + L, ...
  const int per = a.per;
  const int sub_first = gl / per, part_first = gl - sub_first * per;
  const int sub_step = L / per, part_step = L - sub_step * per;

  // |x|^2 of this block's rows of a tile (rows j with j % R == rank): the
  // slices' partials, pushed here by every block of the cluster, added in
  // rank order
  auto add_partials = [&](int64_t tile, int buf) {
    const float* mine = part + buf * R * a.part_rows;
    const int64_t r0 = tile * T;
    const int rows = (int)min64(T, a.n - r0);
    for (int j = tid * R + rank; j < rows; j += kThreads * R) {
      float t = 0.f;
      for (int q = 0; q < R; ++q) t += mine[q * a.part_rows + j];
      a.xsq[r0 + j] = t;
    }
  };

  int64_t pending = -1;  // the tile whose partials wait for the cluster
  int pending_buf = 0;
  int i = 0;
  for (int64_t tile = gid; tile < a.tiles; tile += groups, ++i) {
    const int st = i % stages;
    const uint32_t ph = (i / stages) & 1;
    const int64_t r0 = tile * T;
    const int rows = (int)min64(T, a.n - r0);
    const uint8_t* tc = ring + st * a.stage_bytes +
                        (reinterpret_cast<uintptr_t>(a.codes + r0 * a.s) & 15) + s0;
    float* tpart = part + ((i % kPartBufs) * R + rank) * a.part_rows;
    mbar_wait(&full[st], ph);
    // T is a multiple of G: every lane of a warp runs the same trip count
    for (int j = row_first; j < T; j += G) {
      float sq = 0.f;
      if (j < rows) {
        const uint8_t* cr = tc + j * a.s;
        V* orow = out + (r0 + j) * row_vecs;
        if constexpr (EPV == 1) {
          int sub = sub_first, pt = part_first;
          for (int c = gl; c < nvec; c += L) {
            const int code = cr[sub];
            V x{};
            if (code < a.k) x = reinterpret_cast<const V*>(cb_s)[(sub * a.k + code) * per + pt];
            put(orow + c, x);
            if (kXsq) sq += sq_vec<V>(x);
            sub += sub_step;
            pt += part_step;
            if (pt >= per) {
              pt -= per;
              ++sub;
            }
          }
        } else {
          using E = typename EntryOf<EPV>::T;
          const E* cbe = reinterpret_cast<const E*>(cb_s);
          for (int c = gl; c < nvec; c += L) {
            union {
              V v;
              E e[EPV];
            } x;
#pragma unroll
            for (int q = 0; q < EPV; ++q) {
              const int sub = c * EPV + q;
              const int code = cr[sub];
              x.e[q] = code < a.k ? cbe[sub * a.k + code] : E{};
            }
            put(orow + c, x.v);
            if (kXsq) sq += sq_vec<V>(x.v);
          }
        }
      }
      if (kXsq) {
        for (int off = L >> 1; off > 0; off >>= 1)
          sq += __shfl_xor_sync(0xffffffffu, sq, off);
        if (gl == 0 && j < rows) {
          if (reduce)  // into slot `rank` of the row's owner, block j % R
            cg::this_cluster().map_shared_rank(tpart, j % R)[j] = sq;
          else
            a.xsq[r0 + j] = sq;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (reduce) {
      if (pending >= 0) {
        cluster_wait();
        add_partials(pending, pending_buf);
      }
      cluster_arrive();
      pending = tile;
      pending_buf = i % kPartBufs;
    }
    if (tid == 0 && tile + stages * groups < a.tiles) {
      mbar_wait(&empty[st], ph);  // every warp is done with the stage
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_tile(tile + stages * groups, st);
    }
  }
  if (reduce) {
    if (pending >= 0) {
      cluster_wait();
      add_partials(pending, pending_buf);
    }
    // no block leaves while another still reads its partials
    cluster_arrive();
    cluster_wait();
  }
}

using KernelFn = void (*)(Args);

template <bool X>
KernelFn pick_kernel(int vec, int epv) {
  switch (vec) {
    case 16:
      switch (epv) {
        case 2: return pq_decode_kernel<uint4, 2, X>;
        case 4: return pq_decode_kernel<uint4, 4, X>;
        case 8: return pq_decode_kernel<uint4, 8, X>;
        default: return pq_decode_kernel<uint4, 1, X>;
      }
    case 8: return pq_decode_kernel<uint2, 1, X>;
    case 4: return pq_decode_kernel<uint32_t, 1, X>;
    default: return pq_decode_kernel<uint16_t, 1, X>;
  }
}

struct Plan {
  int vec, epv, per, slices, slice_subs, lanes, tile_rows, stages, stage_bytes;
  int cb_bytes, part_slices, part_rows, smem, blocks;
  int64_t tiles;
  bool cluster;
  KernelFn fn;
};

int round128(int64_t b) { return (int)((b + 127) / 128 * 128); }

// part_slices: the slices whose |x|^2 partials a block receives (0: none)
int smem_bytes(int cb, int t, int s, int part_slices, int stages) {
  return round128(cb) + stages * round128((int64_t)t * s + 32) +
         kPartBufs * part_slices * t * 4 + 2 * kMaxStages * 8;
}

// the most lanes a row whose slots (lanes * passes) stay within 8/7 of the
// row's vectors
int choose_lanes(int nvec) {
  int best = 1;
  for (int l = 2; l <= 32; l <<= 1) {
    const int slots = (nvec + l - 1) / l * l;
    if (slots * 7 <= nvec * 8) best = l;
  }
  return best;
}

struct Device {
  int sms = 0, optin = 0;
};

Device device_info(int dev) {
  static std::mutex mu;
  static std::map<int, Device> memo;
  std::lock_guard<std::mutex> lock(mu);
  auto it = memo.find(dev);
  if (it != memo.end()) return it->second;
  Device d;
  cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (d.sms <= 0) d.sms = 1;
  if (d.optin <= 0) d.optin = 48 * 1024;
  memo[dev] = d;
  return d;
}

// groups of `slices` blocks resident at once (0 if none fits)
cudaError_t resident_groups(int dev, const Device& d, KernelFn fn, int smem, int slices,
                            bool cluster, int* groups) {
  static std::mutex mu;
  static std::map<std::tuple<int, void*, int, int, bool>, int> memo;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, reinterpret_cast<void*>(fn), smem, slices, cluster);
  auto it = memo.find(key);
  if (it != memo.end()) {
    *groups = it->second;
    return cudaSuccess;
  }
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       d.optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && cluster && slices > 8)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  int n = 0;
  if (cluster) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = slices;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(slices);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  } else {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
    n = per_sm * d.sms / slices;
  }
  if (e != cudaSuccess) return e;
  memo[key] = n;
  *groups = n;
  return cudaSuccess;
}

cudaError_t make_plan(int64_t n, int s, int k, int dsub, bool xsq, uintptr_t out,
                      Plan* p) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const Device d = device_info(dev);
  const int entry = dsub * 2;
  if (entry % 16 == 0 && out % 16 == 0) {
    p->vec = 16, p->epv = 1;
  } else if (16 % entry == 0 && (s * entry) % 16 == 0 && out % 16 == 0) {
    p->vec = 16, p->epv = 16 / entry;
  } else {
    int w = 8;
    while (w > 2 && (entry % w != 0 || out % w != 0)) w >>= 1;
    p->vec = w, p->epv = 1;
  }
  p->per = p->epv == 1 ? entry / p->vec : 1;
  p->fn = xsq ? pick_kernel<true>(p->vec, p->epv) : pick_kernel<false>(p->vec, p->epv);
  // the fewest slices that fit beside a ring of code tiles: 3 stages, or 2
  // where 3 would halve the tile (the 960-d slices: 128 rows, not 64)
  int t_max = 0;
  for (int slices = 1; slices <= s && !t_max; ++slices) {
    int subs = (s + slices - 1) / slices;
    subs = (subs + p->epv - 1) / p->epv * p->epv;
    const int real = (s + subs - 1) / subs;
    if (real != slices) continue;  // the plan of a smaller count
    if (xsq && real > kMaxClusterSlices) break;
    const int64_t cb = (int64_t)subs * k * entry;
    if (cb > d.optin) continue;
    const int part = xsq && real > 1 ? real : 0;
    const int nvec = subs * entry / p->vec;
    for (int lanes = choose_lanes(nvec); lanes <= 32 && !t_max; lanes <<= 1) {
      const int g = kThreads / lanes;
      const int target =
          (int)std::max<int64_t>(1, kTileOutBytes / ((int64_t)subs * entry) / g) * g;
      int fit[kMaxStages + 1] = {0};  // the largest tile each ring depth fits
      for (int st = 2; st <= kMaxStages; ++st) {
        int t = target;
        while (smem_bytes((int)cb, t, s, part, st) > d.optin && t > g) t -= g;
        if (smem_bytes((int)cb, t, s, part, st) <= d.optin) fit[st] = t;
      }
      const int stages = fit[3] && fit[3] * 2 > fit[2] ? 3 : 2;
      if (!fit[stages]) continue;
      t_max = fit[stages];
      p->slices = real, p->slice_subs = subs, p->lanes = lanes, p->stages = stages;
      p->cb_bytes = round128(cb);
      p->smem = smem_bytes((int)cb, t_max, s, part, stages);
      p->part_slices = part;
    }
  }
  if (!t_max) return cudaErrorInvalidValue;
  p->cluster = xsq && p->slices > 1;
  int groups = 0;
  e = resident_groups(dev, d, p->fn, p->smem, p->slices, p->cluster, &groups);
  if (e != cudaSuccess) return e;
  if (groups < 1) return cudaErrorInvalidConfiguration;
  // tiles: as large as t_max, small enough that each group gets a few
  const int g = kThreads / p->lanes;
  const int64_t want = n / ((int64_t)kMinTilesPerGroup * groups) / g;
  p->tile_rows = (int)std::max<int64_t>(1, std::min<int64_t>(t_max / g, want)) * g;
  p->tiles = (n + p->tile_rows - 1) / p->tile_rows;
  // shared memory for this tile (the grid was sized for the largest)
  p->smem = smem_bytes(p->cb_bytes, p->tile_rows, s, p->part_slices, p->stages);
  p->stage_bytes = round128((int64_t)p->tile_rows * s + 32);
  p->part_rows = p->part_slices ? p->tile_rows : 0;
  p->blocks = (int)std::min<int64_t>(groups, p->tiles) * p->slices;
  return cudaSuccess;
}

}  // namespace

// Plain C entry point (bound with ctypes). codes [n, s] u8, cent [s, k, dsub]
// bf16, out [n, s*dsub] bf16, xsq [n] f32 or NULL; all contiguous (codes at
// any byte offset). Launches once on `stream`, does not synchronise, and
// returns the launch's cudaError_t (0 = success). K > 256 is refused: codes
// are bytes.
extern "C" int ldb_pq_decode(const void* codes, const void* cent, void* out, void* xsq,
                             int64_t n, int s, int k, int dsub, void* stream) {
  if (n <= 0 || s <= 0 || k <= 0 || k > 256 || dsub <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = make_plan(n, s, k, dsub, xsq != nullptr,
                            reinterpret_cast<uintptr_t>(out), &p);
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.codes = static_cast<const uint8_t*>(codes);
  a.cent = static_cast<const uint8_t*>(cent);
  a.out = static_cast<uint8_t*>(out);
  a.xsq = static_cast<float*>(xsq);
  a.n = n, a.tiles = p.tiles;
  a.s = s, a.k = k, a.entry = dsub * 2;
  a.slices = p.slices, a.slice_subs = p.slice_subs;
  a.lanes = p.lanes, a.per = p.per;
  a.tile_rows = p.tile_rows, a.stages = p.stages, a.stage_bytes = p.stage_bytes;
  a.cb_bytes = p.cb_bytes, a.part_rows = p.part_rows;
  auto st = static_cast<cudaStream_t>(stream);
  if (p.cluster) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.slices;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(p.blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, p.fn, a);
    if (e != cudaSuccess) return (int)e;
  } else {
    p.fn<<<p.blocks, kThreads, p.smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// The plan ldb_pq_decode launches for these shapes (a 16-byte aligned output),
// into plan[0..11]: access bytes, entries a vector, slices, subspaces a
// slice, lanes a row, tile rows, stages, threads a block, blocks, dynamic
// shared memory bytes, tiles, clustered (0/1). Returns a cudaError_t.
extern "C" int ldb_pq_decode_plan(int64_t n, int s, int k, int dsub, int want_xsq,
                                  int64_t* plan) {
  if (n <= 0 || s <= 0 || k <= 0 || k > 256 || dsub <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = make_plan(n, s, k, dsub, want_xsq != 0, 0, &p);
  if (e != cudaSuccess) return (int)e;
  const int64_t v[12] = {p.vec,    p.epv,    p.slices, p.slice_subs, p.lanes, p.tile_rows,
                         p.stages, kThreads, p.blocks, p.smem,      p.tiles, p.cluster};
  for (int i = 0; i < 12; ++i) plan[i] = v[i];
  return 0;
}
