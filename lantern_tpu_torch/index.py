"""The user-facing Index facade (port of lantern_tpu/index.py).

One HNSW index: a host engine holds the graph (the native C++ engine, or
``engine="python"``: graph/host_build.py's ``HostHnsw``), and queries run
batched on the device against its mirror (``DeviceGraph``). The graph is
built by the engine on the host, or on the device (``add(build="device")``,
graph/build_device.py) and imported into the engine. Labels are arbitrary
u64 external keys. Every storage kind: f32, bf16 (``quant=F16``), i8
(``quant=I8``: int8 codes and per-row scales on the device), hamming over
packed bits (``metric=HAMMING, quant=B1``: uint32 rows as given, float rows
binarised by sign), and product-quantised indexes (``HnswParams(pq=True)``:
``train_pq``, ``search(rerank=L | "auto")``, ``calibrate_rerank``,
``set_rerank_source``).

The whole reference facade: ``add``, ``delete``, ``search`` (auto / flat /
graph, allow and deny filters, ``with_stats``), ``search_streaming``,
``search_cpu``, ``rows_for_labels``, ``size``, ``num_deleted``,
``validate``; persistence (storage/snapshot.py): ``save``, ``load``, the
insert log (``log_path=``, every ``add`` and ``delete`` appended before it
returns) and ``follow`` (storage/replica.py); maintenance: ``compact``,
``reindex`` and ``reindex_concurrent`` (a rebuild in a background thread
while searches go on, swapped in under ``_swap_lock``).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading

import numpy as np
import torch

from lantern_tpu_torch import resolve_device
from lantern_tpu_torch.config import (
    LDB_SCAN_K_MAX,
    HnswParams,
    Metric,
    QuantKind,
    SearchParams,
)
from lantern_tpu_torch.costmodel import choose_search_strategy, memory_budget
from lantern_tpu_torch.flat import (
    flat_search,
    flat_search_graph,
    flat_search_graph_rerank,
    flat_search_pq,
)
from lantern_tpu_torch.graph.build_device import build_on_device, device_insert
from lantern_tpu_torch.graph.device import to_device, with_aug_norms
from lantern_tpu_torch.graph.host_build import HostHnsw
from lantern_tpu_torch.graph.search import search_batched
from lantern_tpu_torch.graph.validate import validate
from lantern_tpu_torch.native import NativeHnsw
from lantern_tpu_torch.quant.pq import pq_decode, pq_encode, train_codebook
from lantern_tpu_torch.quant.scalar import binarize, dequantize_i8, quantize_i8
from lantern_tpu_torch.storage.snapshot import (
    InsertLog,
    load_snapshot,
    save_snapshot,
)
from lantern_tpu_torch.utils.bench import benched, span
from lantern_tpu_torch.utils.failpoints import failure_point

# the device builder's options that compact / reindex pass on
_DEVICE_BUILD_OPTS = ("candidates", "flat_until", "store")


def _new_engine(kind: str, params: HnswParams, capacity: int, seed: int):
    if kind == "native":
        return NativeHnsw(params, capacity=capacity, seed=seed)
    if kind == "python":
        return HostHnsw(params, capacity=capacity, seed=seed)
    raise ValueError(f"unknown engine {kind!r}")


def _reserve(eng, need: int) -> bool:
    """Grow a native engine's capacity by doubling until it holds ``need``
    rows (usearch_reserve); the python engine grows itself. True if it grew:
    the engine's array views then dangle."""
    if not isinstance(eng, NativeHnsw) or need <= eng._cap:
        return False
    new_cap = max(8, eng._cap)
    while new_cap < need:
        new_cap *= 2
    eng.grow(new_cap)  # realloc in place, no rebuild
    return True


class ReindexHandle:
    """Handle for an in-flight concurrent reindex (see
    Index.reindex_concurrent). ``join()`` waits for the background rebuild
    and re-raises any build error; ``done`` polls."""

    def __init__(self):
        self._done = threading.Event()
        self.exception: BaseException | None = None
        self.swapped = False

    def join(self, timeout: float | None = None) -> bool:
        self._done.wait(timeout)
        if self.exception is not None:
            raise self.exception
        return self.swapped

    @property
    def done(self) -> bool:
        return self._done.is_set()


class Index:
    """A single HNSW vector index: host engine + device mirror.

    >>> ix = Index(HnswParams(dim=128))      # on cuda; device="cpu" to test
    >>> ix.add(vectors)                      # host build (native engine)
    >>> ix.add(more, build="device")         # or insert rounds on the device
    >>> dists, labels = ix.search(queries)   # batched on the device

    PQ: ``Index(HnswParams(dim=128, pq=True))`` stores uint8 codes on the
    device. ``add`` trains the codebook on its first batch unless
    ``train_pq`` ran first, builds the host graph over the decoded rows, and
    (``keep_raw=True``) keeps the f32 rows on the host as the rerank source.

    Binary: ``Index(HnswParams(dim=1024, metric=Metric.HAMMING,
    quant=QuantKind.B1))`` takes rows and queries as packed uint32 words
    ([n, dim/32]) or as floats, which are binarised (bit = component > 0).
    """

    def __init__(self, params: HnswParams, capacity: int = 1024, seed: int = 0,
                 engine: str = "native", log_path: str | None = None,
                 keep_raw: bool = True,
                 device: str | torch.device | None = None):
        self._setup(params, resolve_device(device), engine, keep_raw)
        self._eng = _new_engine(engine, params, capacity, seed)
        if log_path:
            # a log without a snapshot: a crash BEFORE the first save(), so
            # the log is the only copy of its records; replay it all
            # (adopting its count unreplayed would let the next save()
            # stamp the records as folded and truncate them away)
            self._open_log(log_path)

    def _setup(self, params, device, engine, keep_raw):
        """The state every index starts with, but the engine."""
        self.device = device
        self.params = params
        self._engine_kind = engine
        # serialises engine swaps (reindex_concurrent) against add / delete;
        # searches read lock-free (the old graph until the swap)
        self._swap_lock = threading.Lock()
        self._graph = None  # cached device mirror
        self._graph_eng = None  # the engine the mirror was built from
        self._label_sort = None  # cached sorted-label lookup
        self._codebook = None  # PQCodebook when params.pq
        # host f32 rows, row-aligned with the engine, for PQ rerank (the
        # reference's heap table beside its PQ index); chunks append O(1)
        # and are joined at first use. A snapshot holds only the codes:
        # after load, set_rerank_source re-arms rerank
        self._keep_raw = keep_raw
        self._rerank_chunks: list[np.ndarray] = []
        self._rerank_rows = None  # cached concatenation of the chunks
        self._rerank_dev = None  # cached bf16 copy of the rows on the device
        # calibrated depth for rerank="auto": (depth, coverage, size then)
        self._rerank_auto = None
        self._log = None  # InsertLog when log_path is given
        self._loaded_log_state = None  # (generation, lsn) a loaded snapshot folds

    def _open_log(self, log_path: str, snapshot_state=None):
        """Replay the records of ``log_path`` that ``snapshot_state`` does not
        fold in, then append every later write to it."""
        width = self._eng.vectors.shape[1]
        dtype = self._eng.vectors.dtype
        if os.path.exists(log_path) and os.path.getsize(log_path) > 0:
            self._apply_log_ops(InsertLog.replay_ops(
                log_path, width, dtype, snapshot_state=snapshot_state))
        self._log = InsertLog(log_path, width, dtype)

    def _apply_log_ops(self, ops):
        """Apply logged ops in order: each run of adds as one batch, each run
        of deletes as one call (the engine's delete is one pass over all
        rows). Adds insert on one host thread, so every replay of the same
        ops onto the same snapshot (a follower's, a recovering writer's)
        builds the same graph. The log must be detached: nothing re-logs."""
        for kind, run in itertools.groupby(ops, key=lambda op: op[0]):
            run = list(run)
            labels = np.array([op[1] for op in run], np.uint64)
            if kind == "add":
                self.add(np.stack([op[2] for op in run]), labels, nthreads=1)
            else:
                self._eng.mark_deleted(labels)
        self._graph = None

    # ---- PQ ----
    def train_pq(self, training_data: np.ndarray, iters: int = 25,
                 seed: int = 0, rotate: bool = False, opq_iters: int = 16):
        """Train the PQ codebook on the device (before ``add``, or ``add``
        trains on its first batch). ``rotate=True`` learns an OPQ rotation."""
        if not self.params.pq:
            raise ValueError("index was not created with pq=True")
        self._codebook = train_codebook(
            np.asarray(training_data, np.float32),
            num_subvectors=self.params.effective_num_subvectors,
            num_centroids=self.params.num_centroids, iters=iters, seed=seed,
            rotate=rotate, opq_iters=opq_iters, device=self.device)
        return self._codebook

    def _preprocess(self, vectors: np.ndarray) -> np.ndarray:
        """Storage quantisation before the host build, so the graph is built
        over the representation the device searches: PQ decodes its codes,
        i8 quantises and dequantises, b1 binarises float rows (uint32 rows
        are already packed). The work runs on the index's device."""
        vectors = np.asarray(vectors)
        if self.params.pq:
            if self._codebook is None:
                self.train_pq(vectors)  # auto-train on the first batch
            return pq_decode(pq_encode(vectors, self._codebook,
                                       device=self.device), self._codebook)
        if self.params.quant == QuantKind.I8:
            x = torch.from_numpy(np.ascontiguousarray(vectors, np.float32))
            return dequantize_i8(*quantize_i8(x.to(self.device))).cpu().numpy()
        if self.params.quant == QuantKind.B1 and vectors.dtype != np.uint32:
            return self._binarized(vectors).cpu().numpy().view(np.uint32)
        return vectors

    def _binarized(self, x: np.ndarray) -> torch.Tensor:
        """Sign bits of float rows as int32 words, packed on the device."""
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return binarize(x.to(self.device))

    # ---- ingest ----
    def add(self, vectors: np.ndarray, labels: np.ndarray | None = None,
            build: str = "host", batch: int = 1024, seed: int = 0,
            nthreads: int = 0, **kw):
        """Insert rows. Labels default to consecutive row numbers.

        ``build="host"``: the engine inserts them, the native one with
        ``nthreads`` host threads (0 = all cores; the graph then depends on
        thread timing, 1 reproduces it). ``build="device"`` (native engine):
        an empty index takes ``build_on_device`` (rounds of ``batch`` rows,
        levels from ``seed``), a non-empty one ``device_insert`` against a
        device copy of the live graph; either way the result is imported
        back into the engine. Device builds pass ``candidates`` and
        ``flat_until`` on to the builder, and ``store`` too for the bulk
        build. With a log attached the stored rows are appended to it
        (fsync'd) before ``add`` returns.
        """
        self._check_build(build)
        opts = _DEVICE_BUILD_OPTS if build == "device" else ()
        unknown = set(kw) - set(opts)
        if unknown:
            raise TypeError(f"unexpected arguments for build={build!r}: "
                            f"{sorted(unknown)}")
        raw = (np.asarray(vectors, np.float32)
               if self.params.pq and self._keep_raw else None)
        vectors = self._preprocess(vectors)
        with self._swap_lock:
            self._add_locked(vectors, labels, build, batch, seed, nthreads,
                             raw, kw)
        return self

    def _add_locked(self, vectors, labels, build, batch, seed, nthreads, raw,
                    kw):
        if labels is None:
            labels = np.arange(self.size, self.size + len(vectors),
                               dtype=np.uint64)
        labels = np.asarray(labels, np.uint64)
        if build == "device":
            if self.size == 0:
                g = build_on_device(vectors, self.params, batch=batch,
                                    seed=seed, labels=labels,
                                    device=self.device, **kw)
            else:
                kw.pop("store", None)  # the engine's rows set the storage
                g = device_insert(
                    to_device(self._eng, device=self.device), vectors,
                    labels=labels, batch=batch, seed=seed,
                    ef_construction=self.params.ef_construction, **kw)
            self._grow(g.num_nodes)
            self._eng.import_graph(g)
        else:
            self._grow(self._eng.n + len(vectors))
            if isinstance(self._eng, NativeHnsw):
                self._eng.add(vectors, labels=labels, nthreads=nthreads)
            else:
                self._eng.add(vectors, labels=labels)
        if self._log is not None:
            self._log.append(np.asarray(vectors, self._eng.vectors.dtype),
                             labels)
        if raw is not None:
            self._rerank_chunks.append(raw)
            self._rerank_rows = None
            self._rerank_dev = None
        self._graph = None

    def set_rerank_source(self, rows: np.ndarray):
        """Supply the full-precision rows (row-aligned with the engine) that
        PQ rerank re-scores against."""
        rows = np.asarray(rows, np.float32)
        if len(rows) != self.size:
            raise ValueError(
                f"rerank source has {len(rows)} rows, index has {self.size}")
        self._rerank_chunks = [rows]
        self._rerank_rows = rows
        self._rerank_dev = None
        return self

    @property
    def _raw_rows(self) -> np.ndarray | None:
        """The concatenated rerank source (cached)."""
        if self._rerank_rows is None and self._rerank_chunks:
            self._rerank_rows = (
                self._rerank_chunks[0] if len(self._rerank_chunks) == 1
                else np.concatenate(self._rerank_chunks))
            self._rerank_chunks = [self._rerank_rows]
        return self._rerank_rows

    def _checked_raw_rows(self) -> np.ndarray:
        rows = self._raw_rows
        if rows is None:
            raise ValueError(
                "no rerank source: rows are captured by add(), or supply "
                "them via set_rerank_source()")
        return rows

    def _grow(self, need: int):
        """Rebuild-free capacity growth of the native engine."""
        if _reserve(self._eng, need):
            self._graph = None
            self._label_sort = None

    def delete(self, labels: np.ndarray) -> int:
        """Tombstone by label; no space reclamation (delete.c:24-25; compact()
        reclaims). With a log attached the tombstones are logged (the
        reference's delete runs under GenericXLog, delete.c:40-70), so they
        survive a crash before the next save(). Returns the count newly
        deleted."""
        labels = np.asarray(labels, np.uint64)
        with self._swap_lock:
            n = self._eng.mark_deleted(labels)
            if self._log is not None:
                self._log.append_delete(labels)
            self._graph = None
        return n

    # ---- query ----
    @property
    def device_graph(self):
        """The cached device mirror, rebuilt after any mutation. Keyed on the
        engine's identity too: a search that races a reindex_concurrent swap
        cannot keep a mirror of the retired engine. A rebuild copies the
        engine under the writers' lock: an add running meanwhile would hand
        the copy rows and links of two moments (a link past the copied
        rows); a search that finds the mirror current takes no lock."""
        eng, g = self._eng, self._graph  # a writer may reset _graph meanwhile
        if g is not None and self._graph_eng is eng:
            return g
        with self._swap_lock:
            eng, g = self._eng, self._graph
            if g is not None and self._graph_eng is eng:
                return g  # another search rebuilt it meanwhile
            if self.params.pq:
                g = to_device(eng, device=self.device,
                              pq_codebook=self._codebook)
            elif self.params.quant == QuantKind.I8:
                g = to_device(eng, device=self.device, quant=QuantKind.I8)
            else:
                dtype = (torch.bfloat16 if self.params.quant == QuantKind.F16
                         else None)
                g = to_device(eng, dtype=dtype, device=self.device)
            g = with_aug_norms(g)
            self._graph, self._graph_eng = g, eng
        return g

    @benched("search")
    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        ef: int | None = None,
        params: SearchParams | None = None,
        mode: str = "auto",
        recall_target: float = 0.95,
        rerank: int | str | None = None,
        with_stats: bool = False,
        allow_labels: np.ndarray | None = None,
        deny_labels: np.ndarray | None = None,
    ):
        """Batched device search -> (dists [Q, k] f32, labels [Q, k] u64).

        Missing results (unreachable/tombstoned) have dist=+inf, label=0.

        ``mode``: 'flat' = dense scan, 'graph' = batched HNSW beam search,
        'auto' = cost-model dispatch (costmodel.choose_search_strategy).
        ``recall_target`` stands where the reference takes it (sixth) and is
        ignored: the port's top-k is exact (``ops/row_topk.py``), where the
        reference's flat scan may take ``approx_max_k`` at that target.
        ``rerank`` (PQ indexes): keep an ADC shortlist of this size, then
        re-score it on the device against a bf16 copy of the full-precision
        rows; ``"auto"`` sizes the shortlist by ``calibrate_rerank``.
        ``with_stats=True`` appends a dict describing the executed plan: the
        mode, plus per-query visited / expanded counts for the graph.
        Hamming indexes take packed uint32 queries as they are; a b1 index
        binarises float queries.
        ``allow_labels`` / ``deny_labels``: predicate filters. The flat scan
        filters exactly; the graph drops filtered nodes at emit time like
        tombstones, so raise ``ef`` under heavy filtering.
        """
        if params is not None:
            k, ef = params.k, params.ef
        ef = ef or self.params.ef
        seeds = (params or SearchParams()).seeds
        del recall_target  # exact top-k everywhere
        with span("search.upload"):
            q = self._query_tensor(queries)
        graph = self.device_graph
        n = graph.num_nodes  # the mirror's, even across a concurrent swap
        exclude = None
        if allow_labels is not None or deny_labels is not None:
            with span("search.filter"):
                mask = np.zeros(graph.cap, bool)
                if allow_labels is not None:
                    rows = self.rows_for_labels(allow_labels)
                    mask[:] = True
                    mask[rows[rows >= 0]] = False
                if deny_labels is not None:
                    rows = self.rows_for_labels(deny_labels)
                    mask[rows[rows >= 0]] = True
                exclude = torch.from_numpy(mask).to(self.device)
        if rerank is not None:
            if rerank == "auto":
                rerank = self._auto_rerank_depth(k)
            with span("search.rerank"):
                d, labels = self._search_rerank(q, k, rerank, exclude)
            stats = {"mode": "flat_pq_rerank", "shortlist": rerank,
                     "rows_scanned": n}
        else:
            if mode == "auto":
                with span("search.dispatch"):
                    mode = choose_search_strategy(
                        n, graph.vectors.shape[1],
                        graph.vectors.element_size(),
                        memory_budget(self.device))
            stats = {"mode": mode}
            if mode == "flat":
                with span("search.flat"):
                    d, _, labels = flat_search_graph(graph, q, k=k,
                                                     exclude=exclude)
                stats.update(rows_scanned=n, exact_topk=True)
            elif mode == "graph":
                with span("search.graph"):
                    out = search_batched(graph, q, k=k, ef=max(ef, k),
                                         with_stats=with_stats,
                                         exclude=exclude, seeds=seeds)
                d, _, labels = out[:3]
                if with_stats:
                    stats.update({k2: v.cpu().numpy()
                                  for k2, v in out[3].items()}, ef=max(ef, k))
            else:
                raise ValueError(f"unknown search mode {mode!r}")
        with span("search.results"):  # the host waits for the device here
            res = d.cpu().numpy(), labels.cpu().numpy().view(np.uint64)
        return (*res, stats) if with_stats else res

    def _query_tensor(self, queries) -> torch.Tensor:
        """Queries on the device: f32 rows, or int32 words for hamming
        (packed uint32 rows as given; a b1 index binarises the rest)."""
        queries = np.atleast_2d(np.asarray(queries))
        if Metric(self.params.metric) != Metric.HAMMING:
            return torch.from_numpy(
                np.ascontiguousarray(queries, np.float32)).to(self.device)
        if self.params.quant == QuantKind.B1 and queries.dtype != np.uint32:
            return self._binarized(queries)
        words = np.ascontiguousarray(queries, np.uint32).view(np.int32)
        return torch.from_numpy(words).to(self.device)

    # the k tiers of the streaming scan: the reference's k-doubling ladder
    # (10 -> 20 -> ... -> 1000, scan.c:240-292) quantised to three
    STREAM_TIERS = (64, 256, 1000)

    def search_streaming(self, query: np.ndarray, ef: int | None = None,
                         init_k: int = 10):
        """Generator of (dist, label) in ascending order that searches again
        with a larger k whenever the consumer wants more rows: the
        reference's streaming scan (scan.c:240-292: start at init_k, grow on
        exhaustion, stop at 1000), with k from STREAM_TIERS. Each tier is a
        graph search at ef = max(ef, k); labels already yielded are skipped,
        so no row comes twice, and it ends at k = 1000 or when a tier
        returns fewer than k rows: the reachable live set is exhausted, or
        (the reference's fault F9, kept) tombstones in the beam dropped some.
        """
        tiers = [t for t in self.STREAM_TIERS if t >= init_k]
        if not tiers:
            tiers = [LDB_SCAN_K_MAX]
        seen: set[int] = set()
        for k in tiers:
            k = min(k, LDB_SCAN_K_MAX)
            d, labels = self.search(query, k=k,
                                    ef=max(ef or self.params.ef, k),
                                    mode="graph")
            rows = [(float(dd), int(ll)) for dd, ll in zip(d[0], labels[0])
                    if np.isfinite(dd)]
            for row in rows:
                if row[1] not in seen:
                    seen.add(row[1])
                    yield row
            if k >= LDB_SCAN_K_MAX or len(rows) < k:
                return

    def search_cpu(self, query: np.ndarray, k: int = 10, ef: int | None = None):
        """One query on the host engine (the reference's execution model)
        -> (dists [<=k], labels [<=k])."""
        ids, d = self._eng.search(np.asarray(query), k=k,
                                  ef=ef or self.params.ef)
        return d, self._eng.labels[ids] if len(ids) else np.empty(0, np.uint64)

    def rows_for_labels(self, labels: np.ndarray) -> np.ndarray:
        """Vectorized label -> internal-row resolution; -1 for unknown labels
        (a sorted-label array cached until the node count changes)."""
        n = self._eng.n
        if self._label_sort is None or self._label_sort[2] != n:
            with self._swap_lock:  # no writer grows the engine meanwhile
                n = self._eng.n
                lab = np.array(self._eng.labels[:n])
            order = np.argsort(lab, kind="stable").astype(np.int64)
            self._label_sort = (lab[order], order, n)
        slab, order, _ = self._label_sort
        labels = np.atleast_1d(np.asarray(labels, np.uint64))
        if len(slab) == 0:
            return np.full(len(labels), -1, np.int64)
        idx = np.minimum(np.searchsorted(slab, labels), len(slab) - 1)
        return np.where(slab[idx] == labels, order[idx], -1)

    @property
    def size(self) -> int:
        return self._eng.n

    @property
    def num_deleted(self) -> int:
        return int(np.asarray(self._eng.deleted[: self._eng.n]).sum())

    def validate(self, full: bool = True):
        """Structural validation of the engine's graph (graph/validate.py)."""
        return validate(self._eng, full=full)

    # ---- PQ rerank ----
    def _auto_rerank_depth(self, k: int) -> int:
        """rerank="auto": calibrate once, again after the index grew >2x."""
        if (self._rerank_auto is None
                or self.size > 2 * max(self._rerank_auto[2], 1)):
            self.calibrate_rerank(k=k)
        return self._rerank_auto[0]

    def calibrate_rerank(self, k: int = 10, sample: int = 256,
                         target: float = 0.99,
                         ladder: tuple[int, ...] = (100, 300, 600, 1200, 2400),
                         seed: int = 0) -> dict:
        """Size the PQ rerank shortlist from measured ADC coverage.

        ``sample`` stored rows serve as queries; their true top-k comes from
        an exact full-f32 scan of the rerank source, copied whole to the
        device for it (fault F3 of the reference, kept); coverage@L is the
        share of true ids inside the ADC top-L of the production scan. The
        smallest ladder depth with coverage >= ``target`` wins, else the
        deepest (with a warning). Returns {"depth", "coverage", "coverages",
        "sample", "k"} and caches the depth for ``search(rerank="auto")``.
        """
        if not self.params.pq:
            raise ValueError("calibrate_rerank applies to PQ indexes only")
        rows = self._checked_raw_rows()
        n = self.size
        sample = min(sample, n)
        ladder = tuple(s for s in ladder if s >= k) or (max(ladder),)
        smax = min(max(ladder), n)
        rng = np.random.default_rng(seed)
        q = torch.from_numpy(rows[rng.choice(n, size=sample, replace=False)])
        q = q.to(self.device)
        metric = int(self.params.metric)
        g = self.device_graph
        dele = g.deleted[:n] if bool(g.deleted[:n].any()) else None
        vecs = torch.from_numpy(rows).to(self.device)
        sqn = torch.from_numpy(
            np.einsum("nd,nd->n", rows, rows).astype(np.float32)).to(self.device)
        _, true_ids = flat_search(vecs, sqn, q, k=k, metric=metric, exact=True,
                                  deleted=dele)
        del vecs, sqn
        _, sl_ids = flat_search_pq(g.vectors[:n], g.pq_codebook, q, k=smax,
                                   metric=metric, deleted=dele,
                                   rotation=g.pq_rotation)
        true_np, sl_np = true_ids.cpu().numpy(), sl_ids.cpu().numpy()
        # rank of each true id within the shortlist (absent -> inf)
        match = (sl_np[:, None, :] == true_np[:, :, None]) & (
            sl_np[:, None, :] >= 0)
        pos = np.where(match.any(2), match.argmax(2), np.inf)
        coverages = {s: float((pos < min(s, smax)).mean()) for s in ladder}
        depth = next((s for s in ladder if coverages[s] >= target),
                     max(ladder))
        if coverages[depth] < target:
            logging.getLogger(__name__).warning(
                "rerank auto-calibration: coverage@%d = %.4f < target %s; "
                "recall will be capped", depth, coverages[depth], target)
        self._rerank_auto = (int(depth), coverages[depth], n)
        return {
            "depth": int(depth),
            "coverage": round(coverages[depth], 4),
            "coverages": {str(s): round(c, 4) for s, c in coverages.items()},
            "sample": sample,
            "k": k,
        }

    def _search_rerank(self, q, k: int, shortlist: int, exclude=None):
        """ADC shortlist + exact re-score on the device (see search); the
        rows are cached there as bf16. Returns (dists, labels) on the
        device."""
        if not self.params.pq:
            raise ValueError("rerank= applies to PQ indexes only")
        rows = self._checked_raw_rows()
        if len(rows) != self.size:
            raise ValueError(
                f"rerank source has {len(rows)} rows but the index has "
                f"{self.size}; supply the full slot-aligned rows via "
                "set_rerank_source()")
        if self._rerank_dev is None or self._rerank_dev.shape[0] != len(rows):
            self._rerank_dev = torch.from_numpy(rows).to(self.device).to(
                torch.bfloat16)
        d, _, labels = flat_search_graph_rerank(
            self.device_graph, self._rerank_dev, q, k=k,
            shortlist=max(shortlist, k), exclude=exclude)
        return d, labels

    # ---- maintenance ----
    def _checked_params(self, params: HnswParams | None, what: str):
        p = self.params if params is None else params
        for field in ("dim", "metric", "quant", "pq"):
            if getattr(p, field) != getattr(self.params, field):
                raise ValueError(
                    f"{what} cannot change {field} "
                    f"({getattr(self.params, field)!r} -> "
                    f"{getattr(p, field)!r}); stored vectors would need "
                    "re-quantization — rebuild from the raw rows instead")
        return p

    def _check_build(self, build: str):
        if build not in ("host", "device"):
            raise ValueError(f"unknown build {build!r}; expected host|device")
        if build == "device" and self._engine_kind != "native":
            raise ValueError("build='device' requires the native engine")

    def _rebuilt_engine(self, p, vecs, labs, build, batch, seed, kw):
        """A new engine of this index's kind holding the stored rows
        ``vecs`` (already quantised, so not preprocessed again) under
        ``labs``, built on the host or on the device."""
        eng = _new_engine(self._engine_kind, p, max(8, len(labs)), seed)
        if not len(labs):
            return eng
        if build == "device":
            g = build_on_device(
                vecs, p, batch=batch, seed=seed, labels=labs,
                device=self.device,
                **{k: kw[k] for k in _DEVICE_BUILD_OPTS if k in kw})
            eng.import_graph(g, labels=labs)
        else:
            eng.add(vecs, labels=labs, **kw)
        return eng

    def _publish(self, eng, params, keep: np.ndarray, n_old: int):
        """Make ``eng`` the live engine and drop what described the old one:
        the device mirror (freed once in-flight searches let go of it) and
        the label index. The PQ rerank rows follow the new slot order
        (``keep``: the old slot of each new row) when they covered all
        ``n_old`` old slots, and are dropped otherwise."""
        rows = self._raw_rows
        if rows is not None:
            rows = rows[keep] if len(rows) == n_old else None
            self._rerank_chunks = [] if rows is None else [rows]
            self._rerank_rows = rows
            self._rerank_dev = None
        self._eng = eng
        self.params = params
        self._graph = None
        self._label_sort = None

    def compact(self, params: HnswParams | None = None, build: str = "host",
                batch: int = 1024, seed: int = 0, **kw) -> "Index":
        """Rebuild the index without its tombstoned nodes, reclaiming their
        slots and device memory — the maintenance the reference lacks
        (delete.c:24-25 keeps tombstones until a full ``REINDEX``).

        ``params`` may change the graph (m / ef_construction / ef: REINDEX
        with new options); dim, metric and quantisation must match, since
        the stored rows are reused as they are. ``build``: the host engine,
        or the device builder (``"device"``, native engine; ``candidates``,
        ``flat_until`` and ``store`` pass on). The PQ rerank rows are
        realigned. In memory only: save() persists.
        """
        p = self._checked_params(params, "compact")
        self._check_build(build)
        n = self._eng.n
        live = ~np.asarray(self._eng.deleted[:n], bool)
        vecs = np.asarray(self._eng.vectors[:n])[live]
        labs = np.asarray(self._eng.labels[:n])[live].astype(np.uint64)
        eng = self._rebuilt_engine(p, vecs, labs, build, batch, seed, kw)
        self._publish(eng, p, np.nonzero(live)[0], n)
        return self

    def reindex(self, params: HnswParams, build: str = "host",
                **kw) -> "Index":
        """Rebuild with new graph parameters (REINDEX; drops tombstones too,
        see compact())."""
        return self.compact(params=params, build=build, **kw)

    def reindex_concurrent(self, params: HnswParams | None = None,
                           build: str = "host", batch: int = 1024,
                           seed: int = 0, **kw) -> ReindexHandle:
        """``REINDEX CONCURRENTLY`` (hnsw_concurrent.sql:1-15): rebuild
        without tombstones in a background thread and swap the new engine
        in.

        Searches go on against the old graph until the swap. add() and
        delete() calls that land during the rebuild are replayed into the
        new engine under the swap lock before it goes live, so no
        acknowledged write is lost. Any number of search threads; at most
        ONE writer thread (add / delete / save) beside the rebuild.

        On a card the rebuild's device work runs on a CUDA stream of its
        own, so the searches' kernels (on their threads' streams) do not
        queue behind the build's; its results reach the host through the
        import's copies, which wait for that stream alone.

        Returns a ReindexHandle; ``join()`` re-raises rebuild errors. In
        memory only: save() persists.
        """
        p = self._checked_params(params, "reindex_concurrent")
        self._check_build(build)
        old = self._eng
        with self._swap_lock:
            n0 = old.n
            live0 = ~np.asarray(old.deleted[:n0], bool)
            vecs0 = np.asarray(old.vectors[:n0])[live0].copy()
            labs0 = np.asarray(old.labels[:n0])[live0].astype(np.uint64)
        handle = ReindexHandle()
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)

        def work():
            try:
                with (torch.cuda.stream(stream) if stream is not None
                      else contextlib.nullcontext()):
                    eng = self._rebuilt_engine(p, vecs0, labs0, build, batch,
                                               seed, kw)
                with self._swap_lock:
                    # replay the writes that landed during the rebuild
                    n1 = old.n
                    dead1 = np.asarray(old.deleted[:n1], bool)
                    keep_delta = ~dead1[n0:n1]
                    add_l = np.asarray(old.labels[n0:n1])[keep_delta].astype(
                        np.uint64)
                    if len(add_l):
                        _reserve(eng, eng.n + len(add_l))
                        eng.add(np.asarray(old.vectors[n0:n1])[keep_delta],
                                labels=add_l)
                    newly_dead = labs0[dead1[:n0][live0]]
                    if len(newly_dead):
                        eng.mark_deleted(newly_dead)
                    # new slot order: the live rows, then the kept delta
                    keep = np.concatenate([np.nonzero(live0)[0],
                                           n0 + np.nonzero(keep_delta)[0]])
                    self._publish(eng, p, keep, n1)
                    handle.swapped = True
                # the retired engine stays alive with the handle: a search
                # in flight may still read its arrays
                handle._retired = old
            except Exception as e:  # surfaced by join()
                handle.exception = e
            finally:
                handle._done.set()

        threading.Thread(target=work, name="lantern-reindex",
                         daemon=True).start()
        return handle

    # ---- persistence ----
    def save(self, path: str):
        """Write a snapshot (storage/snapshot.py: fsync, then an atomic
        rename), stamped with the log's (generation, lsn), then truncate the
        log it folds in."""
        log_state = self._log.state if self._log is not None else None
        save_snapshot(self._eng, path, pq_codebook=self._codebook,
                      log_state=log_state)
        if self._log is not None:
            # crash site: snapshot durable, log not yet truncated — replay
            # skips the folded records by the header's (generation, lsn)
            failure_point("index_save", "before_log_truncate")
            self._log.truncate()

    @classmethod
    def load(cls, path: str, engine: str = "native", extra_capacity: int = 1024,
             log_path: str | None = None,
             device: str | torch.device | None = None) -> "Index":
        """Open a snapshot into a new engine (``extra_capacity`` free rows
        beyond its count). With ``log_path``, the log's records that the
        snapshot does not fold in are replayed, and later writes append to
        it. PQ indexes get their codebook (and rotation) back; the rerank
        rows are not in the snapshot (set_rerank_source)."""
        dev = resolve_device(device)
        eng, cb, log_state = load_snapshot(
            path, engine=engine, extra_capacity=extra_capacity,
            return_codebook=True, return_log_state=True)
        ix = cls.__new__(cls)
        ix._setup(eng.p, dev, engine, keep_raw=True)
        ix._eng = eng
        ix._codebook = cb
        ix._loaded_log_state = log_state
        if log_path:
            ix._open_log(log_path, snapshot_state=log_state)
        return ix

    @classmethod
    def follow(cls, path: str, log_path: str, engine: str = "native",
               params: HnswParams | None = None,
               device: str | torch.device | None = None):
        """A read-only replica that follows another process's index
        (snapshot + live insert log): an IndexFollower whose ``catchup()``
        applies the writer's newly durable records (storage/replica.py)."""
        from lantern_tpu_torch.storage.replica import IndexFollower

        return IndexFollower(path, log_path, engine=engine, params=params,
                             device=device)

    def __repr__(self):
        return (f"Index(dim={self.params.dim}, m={self.params.m}, "
                f"size={self.size}, engine={self._engine_kind}, "
                f"device={self.device})")
