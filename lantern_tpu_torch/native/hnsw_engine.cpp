// lantern-tpu native HNSW engine.
//
// The host-side graph construction engine: the role the vendored usearch
// fork plays in the reference (consumed via usearch.h C API — see SURVEY.md
// §0/L0; the fork itself is an empty submodule, this is an independent
// implementation of the HNSW algorithm) and the multicore hot path of the
// external indexing server (lantern_cli/src/external_index/server.rs:311-375:
// N threads pulling tuples from a channel into concurrent index.add_raw).
//
// Produces the exact padded-CSR array layout the TPU device search consumes
// (lantern_tpu/graph/device.py): neighbors0[cap][2M], compact upper-level
// adjacency, levels, labels, tombstones. seqid IS the index — no node tape,
// no neighbor-slot rewrite pass.
//
// Thread safety model (mirrors the reference server's RwLock<Index> + usearch
// per-node locks, server.rs:39-42): one 1-byte spinlock per node guarding its
// adjacency lists, a global mutex for entry-point/level updates, atomic node
// counter. Readers copy adjacency out under the node lock.
//
// Exposed as a plain C ABI consumed from Python via ctypes (no pybind11 in
// this environment).

#include <atomic>
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <unordered_set>
#include <vector>

namespace {

constexpr int LMAX = 16;  // must match lantern_tpu.graph.host_build.LMAX
// max adjacency row length: m <= 128 (options.h:17-25 bound) => m0 <= 256
constexpr int kMaxDegCap = 256;

enum Metric : int32_t {  // wire codes: external_index/cli.rs:56-69
  METRIC_COS = 1,
  METRIC_L2SQ = 3,
  METRIC_HAMMING = 8,
};

struct SpinLock {
  std::atomic_flag f = ATOMIC_FLAG_INIT;
  void lock() {
    while (f.test_and_set(std::memory_order_acquire)) {
#if defined(__x86_64__)
      __builtin_ia32_pause();
#endif
    }
  }
  void unlock() { f.clear(std::memory_order_release); }
};

struct Index {
  // params
  int32_t dim;      // logical dimension (bits for hamming)
  int32_t width;    // floats per vector, or u32 words for hamming
  int32_t m;
  int32_t m0;
  int32_t ef_construction;
  int32_t metric;
  int64_t cap;
  int64_t ucap;
  uint64_t seed;

  // arrays (padded CSR)
  std::vector<float> vectors;        // [cap * width] (bit-cast u32 for hamming)
  std::vector<int32_t> neighbors0;   // [cap * m0], -1 padded
  std::vector<int32_t> counts0;      // [cap]
  std::vector<int32_t> upper_nbrs;   // [ucap * LMAX * m], -1 padded
  std::vector<int32_t> upper_counts; // [ucap * LMAX]
  std::vector<int32_t> upper_slot;   // [cap], -1 default
  std::vector<int32_t> levels;       // [cap]
  std::vector<uint64_t> labels;      // [cap]
  std::vector<uint8_t> deleted;      // [cap]

  std::atomic<int64_t> n{0};
  std::atomic<int64_t> n_upper{0};
  int32_t entry = -1;
  int32_t max_level = -1;

  std::vector<SpinLock> node_locks;  // per node (adjacency)
  std::mutex entry_mutex;

  char err[256] = {0};
};

inline const float* vec(const Index& ix, int64_t i) {
  return ix.vectors.data() + i * ix.width;
}

inline float dist(const Index& ix, const float* a, const float* b) {
  const int w = ix.width;
  switch (ix.metric) {
    case METRIC_L2SQ: {
      float s = 0.f;
      for (int i = 0; i < w; i++) {
        float d = a[i] - b[i];
        s += d * d;
      }
      return s;
    }
    case METRIC_COS: {
      float dot = 0.f, na = 0.f, nb = 0.f;
      for (int i = 0; i < w; i++) {
        dot += a[i] * b[i];
        na += a[i] * a[i];
        nb += b[i] * b[i];
      }
      float den = std::sqrt(na * nb);
      return 1.0f - dot / (den > 1e-30f ? den : 1e-30f);
    }
    case METRIC_HAMMING: {
      const uint32_t* ua = reinterpret_cast<const uint32_t*>(a);
      const uint32_t* ub = reinterpret_cast<const uint32_t*>(b);
      int32_t c = 0;
      for (int i = 0; i < w; i++) c += __builtin_popcount(ua[i] ^ ub[i]);
      return static_cast<float>(c);
    }
  }
  return 0.f;
}

// per-thread visited set with epoch tagging (no clearing between searches)
struct Visited {
  std::vector<uint32_t> tag;
  uint32_t epoch = 0;
  void reset(int64_t cap) {
    if ((int64_t)tag.size() < cap) tag.assign(cap, 0);
    if (++epoch == 0) {  // overflow: clear
      std::fill(tag.begin(), tag.end(), 0);
      epoch = 1;
    }
  }
  bool test_and_set(int64_t i) {
    if (tag[i] == epoch) return true;
    tag[i] = epoch;
    return false;
  }
};

thread_local Visited g_visited;

// copy a node's adjacency at `level` out under its lock
inline int copy_nbrs(Index& ix, int32_t v, int level, int32_t* out) {
  ix.node_locks[v].lock();
  int cnt;
  if (level == 0) {
    cnt = ix.counts0[v];
    std::memcpy(out, ix.neighbors0.data() + (int64_t)v * ix.m0,
                cnt * sizeof(int32_t));
  } else {
    int32_t s = ix.upper_slot[v];
    if (s < 0) {
      cnt = 0;
    } else {
      cnt = ix.upper_counts[(int64_t)s * LMAX + level - 1];
      std::memcpy(out,
                  ix.upper_nbrs.data() + ((int64_t)s * LMAX + level - 1) * ix.m,
                  cnt * sizeof(int32_t));
    }
  }
  ix.node_locks[v].unlock();
  return cnt;
}

using DistId = std::pair<float, int32_t>;

// greedy 1-beam descent at one level
int32_t greedy_at(Index& ix, const float* q, int32_t curr, int level) {
  float curr_d = dist(ix, q, vec(ix, curr));
  std::vector<int32_t> nb(ix.m0);
  for (;;) {
    int cnt = copy_nbrs(ix, curr, level, nb.data());
    float best_d = curr_d;
    int32_t best = -1;
    for (int i = 0; i < cnt; i++) {
      float d = dist(ix, q, vec(ix, nb[i]));
      if (d < best_d) {
        best_d = d;
        best = nb[i];
      }
    }
    if (best < 0) return curr;
    curr = best;
    curr_d = best_d;
  }
}

// ef-bounded best-first search at one level; results ascending by distance
void search_layer(Index& ix, const float* q, int32_t ep, int ef, int level,
                  std::vector<DistId>& out) {
  g_visited.reset(ix.cap);
  std::priority_queue<DistId, std::vector<DistId>, std::greater<DistId>> cand;
  std::priority_queue<DistId> res;  // max-heap
  float d0 = dist(ix, q, vec(ix, ep));
  g_visited.test_and_set(ep);
  cand.emplace(d0, ep);
  res.emplace(d0, ep);
  std::vector<int32_t> nb(ix.m0);
  while (!cand.empty()) {
    auto [d, c] = cand.top();
    if ((int)res.size() >= ef && d > res.top().first) break;
    cand.pop();
    int cnt = copy_nbrs(ix, c, level, nb.data());
    for (int i = 0; i < cnt; i++) {
      int32_t nn = nb[i];
      if (g_visited.test_and_set(nn)) continue;
      float dn = dist(ix, q, vec(ix, nn));
      if ((int)res.size() < ef || dn < res.top().first) {
        cand.emplace(dn, nn);
        res.emplace(dn, nn);
        if ((int)res.size() > ef) res.pop();
      }
    }
  }
  out.resize(res.size());
  for (int i = (int)res.size() - 1; i >= 0; i--) {
    out[i] = res.top();
    res.pop();
  }
}

// classic HNSW selection heuristic: keep c iff closer to q than to all kept
void select_heuristic(Index& ix, std::vector<DistId>& cand_asc, int m,
                      std::vector<int32_t>& out) {
  out.clear();
  for (auto& [d, c] : cand_asc) {
    if ((int)out.size() >= m) break;
    bool ok = true;
    for (int32_t s : out) {
      if (dist(ix, vec(ix, c), vec(ix, s)) <= d) {
        ok = false;
        break;
      }
    }
    if (ok) out.push_back(c);
  }
}

// write new node's adjacency. The node IS visible to concurrent inserters
// before all levels are written (insert_one publishes it via add_link at
// higher levels first), so a reverse add_link can race this memcpy — take
// the node lock, matching add_link.
void set_nbrs(Index& ix, int32_t v, int level, const std::vector<int32_t>& ids) {
  ix.node_locks[v].lock();
  int32_t* row;
  int32_t* cnt_p;
  int maxdeg;
  if (level == 0) {
    row = ix.neighbors0.data() + (int64_t)v * ix.m0;
    cnt_p = &ix.counts0[v];
    maxdeg = ix.m0;
  } else {
    int32_t s = ix.upper_slot[v];
    row = ix.upper_nbrs.data() + ((int64_t)s * LMAX + level - 1) * ix.m;
    cnt_p = &ix.upper_counts[(int64_t)s * LMAX + level - 1];
    maxdeg = ix.m;
  }
  // preserve reverse links a concurrent add_link already placed here (the
  // node was published at higher levels first): save them, write the
  // selected ids, then re-append the survivors deduped against ids
  int old_cnt = std::min<int>(*cnt_p, maxdeg);
  int32_t saved[kMaxDegCap];
  std::memcpy(saved, row, old_cnt * sizeof(int32_t));
  int cnt = std::min<int>((int)ids.size(), maxdeg);
  std::memcpy(row, ids.data(), cnt * sizeof(int32_t));
  for (int i = 0; i < old_cnt && cnt < maxdeg; i++) {
    bool dup = false;
    for (int j = 0; j < cnt; j++)
      if (row[j] == saved[i]) { dup = true; break; }
    if (!dup) row[cnt++] = saved[i];
  }
  for (int i = cnt; i < maxdeg; i++) row[i] = -1;
  *cnt_p = cnt;
  ix.node_locks[v].unlock();
}

// add reverse link u into v's list at `level`, pruning on overflow
void add_link(Index& ix, int32_t v, int32_t u, int level) {
  int maxdeg = level == 0 ? ix.m0 : ix.m;
  ix.node_locks[v].lock();
  int32_t* row;
  int32_t* cnt_p;
  if (level == 0) {
    row = ix.neighbors0.data() + (int64_t)v * ix.m0;
    cnt_p = &ix.counts0[v];
  } else {
    int32_t s = ix.upper_slot[v];
    if (s < 0) {  // shouldn't happen; defensive
      ix.node_locks[v].unlock();
      return;
    }
    row = ix.upper_nbrs.data() + ((int64_t)s * LMAX + level - 1) * ix.m;
    cnt_p = &ix.upper_counts[(int64_t)s * LMAX + level - 1];
  }
  int cnt = *cnt_p;
  for (int i = 0; i < cnt; i++) {
    if (row[i] == u) {
      ix.node_locks[v].unlock();
      return;
    }
  }
  if (cnt < maxdeg) {
    row[cnt] = u;
    *cnt_p = cnt + 1;
    ix.node_locks[v].unlock();
    return;
  }
  // overflow: re-run heuristic over existing ∪ {u} wrt v
  std::vector<DistId> cand;
  cand.reserve(cnt + 1);
  const float* vv = vec(ix, v);
  for (int i = 0; i < cnt; i++) cand.emplace_back(dist(ix, vv, vec(ix, row[i])), row[i]);
  cand.emplace_back(dist(ix, vv, vec(ix, u)), u);
  std::sort(cand.begin(), cand.end());
  std::vector<int32_t> sel;
  select_heuristic(ix, cand, maxdeg, sel);
  int ncnt = (int)sel.size();
  std::memcpy(row, sel.data(), ncnt * sizeof(int32_t));
  for (int i = ncnt; i < maxdeg; i++) row[i] = -1;
  *cnt_p = ncnt;
  ix.node_locks[v].unlock();
}

// Insert row `nid` into the graph. Its payload (vector/label/level) was
// already written by ldb_index_add before workers started, so concurrent
// readers never observe a reserved-but-unwritten row.
void insert_one(Index& ix, int64_t nid, int level) {
  const float* v = vec(ix, nid);
  if (level >= 1) {
    int64_t s = ix.n_upper.fetch_add(1);
    if (s >= ix.ucap) {
      // ucap is a statistical bound on Binomial(cap, 1/m) upper-level draws
      // (+64 slack); if it is ever exceeded, degrade the node to level 0
      // instead of writing past upper_nbrs — the node stays fully reachable
      // through level 0, only its express lanes are lost
      ix.n_upper.fetch_sub(1);
      level = 0;
      ix.levels[nid] = 0;
    } else {
      ix.upper_slot[nid] = (int32_t)s;
    }
  }

  int32_t entry, max_level;
  {
    std::lock_guard<std::mutex> g(ix.entry_mutex);
    entry = ix.entry;
    max_level = ix.max_level;
    if (entry < 0) {  // first node
      ix.entry = (int32_t)nid;
      ix.max_level = level;
      return;
    }
  }

  int32_t curr = entry;
  for (int l = max_level; l > level; l--) curr = greedy_at(ix, v, curr, l);

  std::vector<DistId> cand;
  std::vector<int32_t> sel;
  int32_t ep = curr;
  for (int l = std::min(level, max_level); l >= 0; l--) {
    search_layer(ix, v, ep, ix.ef_construction, l, cand);
    // a concurrent inserter can have published THIS node already (its
    // reverse add_link runs before our set_nbrs at lower levels), so the
    // candidate search can reach nid at distance 0 — drop it or the
    // heuristic writes a self-edge and its d=0 skews the pruning
    cand.erase(std::remove_if(cand.begin(), cand.end(),
                              [&](const DistId& p) {
                                return p.second == (int32_t)nid;
                              }),
               cand.end());
    select_heuristic(ix, cand, ix.m, sel);
    set_nbrs(ix, (int32_t)nid, l, sel);
    for (int32_t s : sel) add_link(ix, s, (int32_t)nid, l);
    if (!cand.empty()) ep = cand[0].second;
  }

  if (level > max_level) {
    std::lock_guard<std::mutex> g(ix.entry_mutex);
    if (level > ix.max_level) {
      ix.entry = (int32_t)nid;
      ix.max_level = level;
    }
  }
}

}  // namespace

extern "C" {

void* ldb_index_new(int32_t dim, int32_t width, int32_t m, int32_t efc,
                    int32_t metric, int64_t cap, uint64_t seed) {
  auto* ix = new Index();
  ix->dim = dim;
  ix->width = width;
  ix->m = m;
  ix->m0 = 2 * m;
  ix->ef_construction = efc;
  ix->metric = metric;
  ix->cap = cap;
  ix->ucap = cap / m * 2 + 64;
  ix->seed = seed;
  ix->vectors.assign(cap * (int64_t)width, 0.f);
  ix->neighbors0.assign(cap * (int64_t)ix->m0, -1);
  ix->counts0.assign(cap, 0);
  ix->upper_nbrs.assign(ix->ucap * (int64_t)LMAX * m, -1);
  ix->upper_counts.assign(ix->ucap * (int64_t)LMAX, 0);
  ix->upper_slot.assign(cap, -1);
  ix->levels.assign(cap, 0);
  ix->labels.assign(cap, 0);
  ix->deleted.assign(cap, 0);
  ix->node_locks = std::vector<SpinLock>(cap);
  return ix;
}

void ldb_index_free(void* h) { delete static_cast<Index*>(h); }

// Insert a block of vectors with `nthreads` workers (0 = hardware cores).
// Returns number inserted, or -1 on capacity overflow (check ldb_index_error).
int64_t ldb_index_add(void* h, int64_t count, const float* vecs,
                      const uint64_t* labels, int32_t nthreads) {
  Index& ix = *static_cast<Index*>(h);
  // atomically reserve this call's id range so concurrent add() calls from
  // different host threads never overlap (the parallel-inserter pattern of
  // the reference's regression schedule, test/parallel_schedule.txt:7-9)
  int64_t start;
  for (;;) {
    start = ix.n.load();
    if (start + count > ix.cap) {
      snprintf(ix.err, sizeof(ix.err),
               "capacity overflow: n=%lld + add=%lld > cap=%lld",
               (long long)start, (long long)count, (long long)ix.cap);
      return -1;
    }
    int64_t expected = start;
    if (ix.n.compare_exchange_weak(expected, start + count)) break;
  }
  // pre-draw levels sequentially for determinism w.r.t. insertion order
  std::mt19937_64 rng(ix.seed + (uint64_t)start);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  std::vector<int32_t> levels(count);
  const double inv_log_m = 1.0 / std::log((double)ix.m);
  for (int64_t i = 0; i < count; i++) {
    double u = std::max(unif(rng), 1e-300);
    levels[i] = std::min((int)(-std::log(u) * inv_log_m), LMAX);
  }

  if (nthreads <= 0) nthreads = (int32_t)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  nthreads = std::min<int32_t>(nthreads, 64);

  // publish every row's payload BEFORE any graph insertion starts: n was
  // already bumped at reservation, so concurrent readers (mark_deleted's
  // label scan, array exports) can observe rows in [start, start+count) —
  // they must see real labels/vectors, never the calloc-zero label of a
  // reserved-but-unwritten row (label 0 is a legal user label)
  std::memcpy(ix.vectors.data() + start * (int64_t)ix.width, vecs,
              count * (int64_t)ix.width * sizeof(float));
  for (int64_t i = 0; i < count; i++) {
    ix.labels[start + i] = labels ? labels[i] : (uint64_t)(start + i);
    ix.levels[start + i] = levels[i];
  }

  std::atomic<int64_t> cursor{0};
  auto worker = [&]() {
    for (;;) {
      int64_t i = cursor.fetch_add(1);
      if (i >= count) break;
      // graph links become reachable as each insert publishes them;
      // traversal walks links (never n)
      insert_one(ix, start + i, levels[i]);
    }
  };
  if (nthreads == 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nthreads; t++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  // n was reserved up front; nodes in [start, start+count) become reachable
  // as their links are published (searches traverse links, never n)
  return count;
}

// Single-query search. Returns result count; ids/dists ascending by distance.
int32_t ldb_index_search(void* h, const float* q, int32_t k, int32_t ef,
                         int32_t* out_ids, float* out_dists) {
  Index& ix = *static_cast<Index*>(h);
  int32_t entry, max_level;
  {
    // consistent (entry, max_level) pair: insert_one updates both under
    // this mutex; an unlocked read racing a promotion could pair the old
    // entry with the new larger max_level (formal data race besides)
    std::lock_guard<std::mutex> g(ix.entry_mutex);
    entry = ix.entry;
    max_level = ix.max_level;
  }
  if (entry < 0) return 0;
  int32_t curr = entry;
  for (int l = max_level; l >= 1; l--) curr = greedy_at(ix, q, curr, l);
  std::vector<DistId> res;
  search_layer(ix, q, curr, std::max(ef, k), 0, res);
  int32_t cnt = 0;
  for (auto& [d, id] : res) {
    if (ix.deleted[id]) continue;  // tombstone filter (scan.c:296-300)
    out_ids[cnt] = id;
    out_dists[cnt] = d;
    if (++cnt >= k) break;
  }
  return cnt;
}

int64_t ldb_index_mark_deleted(void* h, const uint64_t* labels, int64_t count) {
  // one pass over the nodes with a hash set of dead labels — the shape of
  // the reference's bulk delete (delete.c walks every page exactly once)
  Index& ix = *static_cast<Index*>(h);
  std::unordered_set<uint64_t> dead(labels, labels + count);
  int64_t n = ix.n.load();
  int64_t killed = 0;
  for (int64_t i = 0; i < n; i++) {
    if (!ix.deleted[i] && dead.count(ix.labels[i])) {
      ix.deleted[i] = 1;
      killed++;
    }
  }
  return killed;
}

// Grow capacity in place (no concurrent adds/searches may be running — the
// reference grows under an RwLock write lock, server.rs:243-247; callers
// here are the serial ingest loops). Returns 0, or -1 on shrink attempts.
int32_t ldb_index_grow(void* h, int64_t new_cap) {
  Index& ix = *static_cast<Index*>(h);
  if (new_cap < ix.cap) {
    snprintf(ix.err, sizeof(ix.err), "grow: new_cap below current capacity");
    return -1;
  }
  if (new_cap == ix.cap) return 0;
  int64_t new_ucap = new_cap / ix.m * 2 + 64;
  ix.vectors.resize(new_cap * (int64_t)ix.width, 0.f);
  ix.neighbors0.resize(new_cap * (int64_t)ix.m0, -1);
  ix.counts0.resize(new_cap, 0);
  ix.upper_nbrs.resize(new_ucap * (int64_t)LMAX * ix.m, -1);
  ix.upper_counts.resize(new_ucap * (int64_t)LMAX, 0);
  ix.upper_slot.resize(new_cap, -1);
  ix.levels.resize(new_cap, 0);
  ix.labels.resize(new_cap, 0);
  ix.deleted.resize(new_cap, 0);
  ix.node_locks = std::vector<SpinLock>(new_cap);  // quiescent: safe to swap
  ix.cap = new_cap;
  ix.ucap = new_ucap;
  return 0;
}

// ---- array export (zero-copy pointers into the index) ----
void ldb_index_stats(void* h, int64_t* n, int64_t* n_upper, int32_t* entry,
                     int32_t* max_level, int64_t* cap, int64_t* ucap) {
  Index& ix = *static_cast<Index*>(h);
  *n = ix.n.load();
  *n_upper = ix.n_upper.load();
  {
    std::lock_guard<std::mutex> g(ix.entry_mutex);
    *entry = ix.entry;
    *max_level = ix.max_level;
  }
  *cap = ix.cap;
  *ucap = ix.ucap;
}

const float* ldb_index_vectors(void* h) { return static_cast<Index*>(h)->vectors.data(); }
const int32_t* ldb_index_neighbors0(void* h) { return static_cast<Index*>(h)->neighbors0.data(); }
const int32_t* ldb_index_counts0(void* h) { return static_cast<Index*>(h)->counts0.data(); }
const int32_t* ldb_index_upper_neighbors(void* h) { return static_cast<Index*>(h)->upper_nbrs.data(); }
const int32_t* ldb_index_upper_counts(void* h) { return static_cast<Index*>(h)->upper_counts.data(); }
const int32_t* ldb_index_upper_slot(void* h) { return static_cast<Index*>(h)->upper_slot.data(); }
const int32_t* ldb_index_levels(void* h) { return static_cast<Index*>(h)->levels.data(); }
const uint64_t* ldb_index_labels(void* h) { return static_cast<Index*>(h)->labels.data(); }
const uint8_t* ldb_index_deleted(void* h) { return static_cast<Index*>(h)->deleted.data(); }
const char* ldb_index_error(void* h) { return static_cast<Index*>(h)->err; }

// ---- import (load a snapshot back into an engine) ----
int32_t ldb_index_import(void* h, int64_t n, int64_t n_upper, int32_t entry,
                         int32_t max_level, const float* vectors,
                         const int32_t* neighbors0, const int32_t* counts0,
                         const int32_t* upper_nbrs, const int32_t* upper_counts,
                         const int32_t* upper_slot, const int32_t* levels,
                         const uint64_t* labels, const uint8_t* deleted) {
  Index& ix = *static_cast<Index*>(h);
  if (n > ix.cap || n_upper > ix.ucap) {
    snprintf(ix.err, sizeof(ix.err), "import exceeds capacity");
    return -1;
  }
  std::memcpy(ix.vectors.data(), vectors, n * (int64_t)ix.width * sizeof(float));
  std::memcpy(ix.neighbors0.data(), neighbors0, n * (int64_t)ix.m0 * sizeof(int32_t));
  std::memcpy(ix.counts0.data(), counts0, n * sizeof(int32_t));
  std::memcpy(ix.upper_nbrs.data(), upper_nbrs,
              n_upper * (int64_t)LMAX * ix.m * sizeof(int32_t));
  std::memcpy(ix.upper_counts.data(), upper_counts,
              n_upper * (int64_t)LMAX * sizeof(int32_t));
  std::memcpy(ix.upper_slot.data(), upper_slot, n * sizeof(int32_t));
  std::memcpy(ix.levels.data(), levels, n * sizeof(int32_t));
  std::memcpy(ix.labels.data(), labels, n * sizeof(uint64_t));
  std::memcpy(ix.deleted.data(), deleted, n * sizeof(uint8_t));
  ix.n.store(n);
  ix.n_upper.store(n_upper);
  ix.entry = entry;
  ix.max_level = max_level;
  return 0;
}

}  // extern "C"
