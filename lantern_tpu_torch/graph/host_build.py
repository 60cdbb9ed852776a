"""Host-side sequential HNSW builder (port of lantern_tpu/graph/host_build.py,
numpy only): the ``engine="python"`` engine of ``Index``.

This implements the HNSW algorithm itself (greedy upper-level descent +
ef_construction-bounded best-first search + the classic neighbor-selection
heuristic), matching the behavior of the usearch fork the reference consumes
through its C API (see SURVEY.md §0):

- level draw: floor(-ln(U) * 1/ln(M))         (lantern_hnsw/src/hnsw/insert.c:32-46)
- max degree: 2*M at level 0, M above          (validate_index.c:151)
- capacity doubling on overflow                (build.c:117-126 usearch_reserve)
- labels are arbitrary u64 external keys       (labels = heap TIDs in the reference)
- deletes are tombstones, no reclamation       (delete.c:24-70)

The graph uses the padded-array layout of the native engine (``vectors``,
``neighbors0``, ``counts0``, ``upper_*``, ``levels``, ``labels``,
``deleted``, ``n``, ``n_upper``, ``entry``, ``max_level``), so
``graph.device.to_device``, ``graph.validate`` and the snapshot writer read
either engine. The multicore C++ engine (``native``) is the fast host build.
"""

from __future__ import annotations

import heapq
import math

import numpy as np

from lantern_tpu_torch.config import HnswParams, Metric

# Hard bound on hierarchy height. P(level >= 16) = M^-16 — unreachable for
# any realistic index size, so a fixed bound keeps device arrays static.
LMAX = 16


def _popcount_rows(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x).sum(axis=-1).astype(np.float32)


class HostHnsw:
    """Sequential HNSW index over numpy arrays (padded CSR layout)."""

    def __init__(
        self,
        params: HnswParams,
        capacity: int = 1024,
        seed: int = 0,
    ):
        self.p = params
        self.rng = np.random.default_rng(seed)
        self.metric = Metric(params.metric)
        if self.metric == Metric.HAMMING:
            # vectors are packed uint32 words; dim counts bits
            self.words = -(-params.dim // 32)
            self._vec_dtype = np.uint32
            self._vec_width = self.words
        else:
            self._vec_dtype = np.float32
            self._vec_width = params.dim
        cap = max(capacity, 8)
        ucap = max(8, cap // params.m + 4)
        self.vectors = np.zeros((cap, self._vec_width), self._vec_dtype)
        self.levels = np.zeros(cap, np.int32)
        self.labels = np.zeros(cap, np.uint64)
        self.deleted = np.zeros(cap, bool)
        self.neighbors0 = np.full((cap, params.m0), -1, np.int32)
        self.counts0 = np.zeros(cap, np.int32)
        # upper levels: only nodes with level>=1 get a slot
        self.upper_neighbors = np.full((ucap, LMAX, params.m), -1, np.int32)
        self.upper_counts = np.zeros((ucap, LMAX), np.int32)
        self.upper_slot = np.full(cap, -1, np.int32)
        self.n = 0
        self.n_upper = 0
        self.entry = -1
        self.max_level = -1

    # -- capacity management (usearch_reserve doubling, build.c:117-126) ----
    def _reserve(self, want: int):
        cap = self.vectors.shape[0]
        if want <= cap:
            return
        new = cap
        while new < want:
            new *= 2
        grow = new - cap
        self.vectors = np.concatenate(
            [self.vectors, np.zeros((grow, self._vec_width), self._vec_dtype)]
        )
        self.levels = np.concatenate([self.levels, np.zeros(grow, np.int32)])
        self.labels = np.concatenate([self.labels, np.zeros(grow, np.uint64)])
        self.deleted = np.concatenate([self.deleted, np.zeros(grow, bool)])
        self.neighbors0 = np.concatenate(
            [self.neighbors0, np.full((grow, self.p.m0), -1, np.int32)]
        )
        self.counts0 = np.concatenate([self.counts0, np.zeros(grow, np.int32)])
        self.upper_slot = np.concatenate([self.upper_slot, np.full(grow, -1, np.int32)])

    def _reserve_upper(self, want: int):
        ucap = self.upper_neighbors.shape[0]
        if want <= ucap:
            return
        new = ucap
        while new < want:
            new *= 2
        grow = new - ucap
        self.upper_neighbors = np.concatenate(
            [self.upper_neighbors, np.full((grow, LMAX, self.p.m), -1, np.int32)]
        )
        self.upper_counts = np.concatenate(
            [self.upper_counts, np.zeros((grow, LMAX), np.int32)]
        )

    # -- distances ----------------------------------------------------------
    def _dist_many(self, q: np.ndarray, ids: np.ndarray) -> np.ndarray:
        x = self.vectors[ids]
        if self.metric == Metric.L2SQ:
            d = q[None, :] - x
            return np.einsum("nd,nd->n", d, d)
        if self.metric == Metric.COS:
            num = x @ q
            den = np.linalg.norm(q) * np.linalg.norm(x, axis=1)
            return 1.0 - num / np.maximum(den, 1e-30)
        return _popcount_rows(np.bitwise_xor(q[None, :], x))

    # -- adjacency accessors --------------------------------------------------
    def _nbrs(self, v: int, level: int) -> np.ndarray:
        if level == 0:
            return self.neighbors0[v, : self.counts0[v]]
        s = self.upper_slot[v]
        return self.upper_neighbors[s, level - 1, : self.upper_counts[s, level - 1]]

    def _set_nbrs(self, v: int, level: int, ids):
        ids = np.asarray(ids, np.int32)
        if level == 0:
            self.neighbors0[v, : len(ids)] = ids
            self.neighbors0[v, len(ids):] = -1
            self.counts0[v] = len(ids)
        else:
            s = self.upper_slot[v]
            self.upper_neighbors[s, level - 1, : len(ids)] = ids
            self.upper_neighbors[s, level - 1, len(ids):] = -1
            self.upper_counts[s, level - 1] = len(ids)

    def _maxdeg(self, level: int) -> int:
        return self.p.m0 if level == 0 else self.p.m

    # -- core HNSW routines ---------------------------------------------------
    def _draw_level(self) -> int:
        # floor(-ln(U) * 1/ln(M)), insert.c:32-46
        u = self.rng.random()
        return min(int(-math.log(max(u, 1e-300)) * self.p.level_lambda), LMAX)

    def _greedy_at(self, q: np.ndarray, curr: int, level: int) -> int:
        curr_d = self._dist_many(q, np.array([curr]))[0]
        while True:
            nbrs = self._nbrs(curr, level)
            if len(nbrs) == 0:
                return curr
            d = self._dist_many(q, nbrs)
            j = int(np.argmin(d))
            if d[j] < curr_d:
                curr, curr_d = int(nbrs[j]), float(d[j])
            else:
                return curr

    def _search_layer(self, q, eps, ef, level):
        """ef-bounded best-first search at one level; returns ids+dists asc."""
        eps = list(dict.fromkeys(eps))
        visited = set(eps)
        d0 = self._dist_many(q, np.array(eps))
        cand = [(float(d), int(e)) for d, e in zip(d0, eps)]
        heapq.heapify(cand)
        res = [(-float(d), int(e)) for d, e in zip(d0, eps)]
        heapq.heapify(res)
        while len(res) > ef:
            heapq.heappop(res)
        while cand:
            d, c = heapq.heappop(cand)
            if len(res) >= ef and d > -res[0][0]:
                break
            new = [int(x) for x in self._nbrs(c, level) if int(x) not in visited]
            if not new:
                continue
            visited.update(new)
            nd = self._dist_many(q, np.array(new))
            for dn, nn in zip(nd, new):
                dn = float(dn)
                if len(res) < ef or dn < -res[0][0]:
                    heapq.heappush(cand, (dn, nn))
                    heapq.heappush(res, (-dn, nn))
                    if len(res) > ef:
                        heapq.heappop(res)
        out = sorted((-d, e) for d, e in res)
        return [e for _, e in out], [d for d, _ in out]

    def _select_heuristic(self, ids, dists, m):
        """Classic HNSW neighbor-selection: keep c iff it is closer to the
        query than to every already-selected neighbor."""
        selected: list[int] = []
        for d, c in sorted(zip(dists, ids)):
            if len(selected) == m:
                break
            cv_d = self._dist_many(self.vectors[c], np.array(selected)) if selected else []
            if all(dc > d for dc in cv_d):
                selected.append(int(c))
        return selected

    def _add_link(self, v: int, u: int, level: int):
        nbrs = self._nbrs(v, level)
        maxdeg = self._maxdeg(level)
        if u in nbrs:
            return
        if len(nbrs) < maxdeg:
            self._set_nbrs(v, level, np.append(nbrs, u))
            return
        # overflow: re-run the selection heuristic over existing ∪ {u} wrt v
        cand = np.append(nbrs, u)
        d = self._dist_many(self.vectors[v], cand)
        self._set_nbrs(v, level, self._select_heuristic(cand.tolist(), d.tolist(), maxdeg))

    # -- public API -----------------------------------------------------------
    def add(self, vecs: np.ndarray, labels: np.ndarray | None = None):
        """Insert a batch of vectors (sequentially, reference semantics)."""
        vecs = np.ascontiguousarray(vecs, dtype=self._vec_dtype)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        if vecs.shape[1] != self._vec_width:
            raise ValueError(
                f"vector width {vecs.shape[1]} != expected {self._vec_width}"
            )
        if labels is None:
            labels = np.arange(self.n, self.n + len(vecs), dtype=np.uint64)
        labels = np.asarray(labels, np.uint64)
        if len(labels) != len(vecs):
            # zip would silently truncate — drop no data
            raise ValueError(f"{len(labels)} labels for {len(vecs)} vectors")
        self._reserve(self.n + len(vecs))
        for vec, label in zip(vecs, labels):
            self._insert(vec, label)

    def _insert(self, vec: np.ndarray, label: np.uint64):
        nid = self.n
        self.n += 1
        level = self._draw_level()
        self.vectors[nid] = vec
        self.labels[nid] = label
        self.levels[nid] = level
        if level >= 1:
            self._reserve_upper(self.n_upper + 1)
            self.upper_slot[nid] = self.n_upper
            self.n_upper += 1
        if self.entry < 0:
            self.entry = nid
            self.max_level = level
            return
        curr = self.entry
        for l in range(self.max_level, level, -1):
            curr = self._greedy_at(vec, curr, l)
        eps = [curr]
        for l in range(min(level, self.max_level), -1, -1):
            ids, dists = self._search_layer(vec, eps, self.p.ef_construction, l)
            # select M at insert time on every level; the 2M level-0 capacity
            # only bounds reverse-link growth (hnswlib/usearch semantics)
            sel = self._select_heuristic(ids, dists, self.p.m)
            self._set_nbrs(nid, l, sel)
            for s in sel:
                self._add_link(s, nid, l)
            eps = ids
        if level > self.max_level:
            self.entry = nid
            self.max_level = level

    def mark_deleted(self, labels: np.ndarray):
        """Tombstone nodes by label (reference: ldb_ambulkdelete, delete.c).
        Returns the count of NEWLY deleted nodes (a repeat delete is 0)."""
        dead = np.isin(self.labels[: self.n], np.asarray(labels, np.uint64))
        newly = dead & ~self.deleted[: self.n]
        self.deleted[: self.n] |= dead
        return int(newly.sum())

    def search(self, q: np.ndarray, k: int, ef: int | None = None):
        """Single-query reference search (scan.c semantics incl. tombstones)."""
        ef = ef or self.p.ef
        q = np.asarray(q, self._vec_dtype)
        if self.n == 0:
            return np.empty(0, np.int32), np.empty(0, np.float32)
        curr = self.entry
        for l in range(self.max_level, 0, -1):
            curr = self._greedy_at(q, curr, l)
        ids, dists = self._search_layer(q, [curr], max(ef, k), 0)
        keep = [(d, i) for d, i in zip(dists, ids) if not self.deleted[i]]
        keep = keep[:k]
        return (
            np.array([i for _, i in keep], np.int32),
            np.array([d for d, _ in keep], np.float32),
        )
