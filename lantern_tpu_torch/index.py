"""The user-facing Index facade (port of lantern_tpu/index.py).

One HNSW index: the native C++ engine holds the graph, and queries run
batched on the device against its mirror (``DeviceGraph``). The graph is
built by the engine on the host, or on the device (``add(build="device")``,
graph/build_device.py) and imported into the engine. Labels are arbitrary
u64 external keys. Ported: ``add`` (host or device build), ``delete``,
``search`` (auto / flat / graph, allow and deny filters, ``with_stats``),
``rows_for_labels``, ``size``, ``validate``; every storage kind: f32,
bf16 (``quant=F16``), i8 (``quant=I8``: int8 codes and per-row scales on the
device), hamming over packed bits (``metric=HAMMING, quant=B1``: uint32 rows
as given, float rows binarised by sign), and product-quantised indexes
(``HnswParams(pq=True)``): ``train_pq``, ``search(rerank=L | "auto")``,
``calibrate_rerank``, ``set_rerank_source``. The rest of the reference facade
raises NotImplementedError naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from lantern_tpu_torch import resolve_device
from lantern_tpu_torch.config import HnswParams, Metric, QuantKind, SearchParams
from lantern_tpu_torch.costmodel import choose_search_strategy, memory_budget
from lantern_tpu_torch.flat import (
    flat_search,
    flat_search_graph,
    flat_search_graph_rerank,
    flat_search_pq,
)
from lantern_tpu_torch.graph.build_device import build_on_device, device_insert
from lantern_tpu_torch.graph.device import to_device, with_aug_norms
from lantern_tpu_torch.graph.search import search_batched
from lantern_tpu_torch.graph.validate import validate
from lantern_tpu_torch.native import NativeHnsw
from lantern_tpu_torch.quant.pq import pq_decode, pq_encode, train_codebook
from lantern_tpu_torch.quant.scalar import binarize, dequantize_i8, quantize_i8


def _later(what: str, item: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(f"Index.{what} is not ported yet ({item})")

    method.__name__ = what
    method.__doc__ = f"Not ported yet: {item}."
    return method


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
                 device: str | torch.device | None = None,
                 keep_raw: bool = True):
        self.device = resolve_device(device)
        self.params = params
        self._eng = NativeHnsw(params, capacity=capacity, seed=seed)
        self._graph = None  # cached device mirror
        self._label_sort = None  # cached sorted-label lookup
        self._codebook = None  # PQCodebook when params.pq
        # host f32 rows, row-aligned with the engine, for PQ rerank (the
        # reference's heap table beside its PQ index); chunks append O(1)
        # and are joined at first use
        self._keep_raw = keep_raw
        self._rerank_chunks: list[np.ndarray] = []
        self._rerank_rows = None  # cached concatenation of the chunks
        self._rerank_dev = None  # cached bf16 copy of the rows on the device
        # calibrated depth for rerank="auto": (depth, coverage, size then)
        self._rerank_auto = None

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

        ``build="host"``: the native engine inserts them with ``nthreads``
        host threads (0 = all cores). ``build="device"``: an empty index
        takes ``build_on_device`` (rounds of ``batch`` rows, levels from
        ``seed``), a non-empty one ``device_insert`` against a device copy
        of the live graph; either way the result is imported back into the
        engine. Device builds pass ``candidates`` and ``flat_until`` on to
        the builder, and ``store`` too for the bulk build.
        """
        if build not in ("host", "device"):
            raise ValueError(f"build={build!r}; expected host|device")
        opts = ("candidates", "flat_until", "store") if build == "device" else ()
        unknown = set(kw) - set(opts)
        if unknown:
            raise TypeError(f"unexpected arguments for build={build!r}: "
                            f"{sorted(unknown)}")
        raw = (np.asarray(vectors, np.float32)
               if self.params.pq and self._keep_raw else None)
        vectors = self._preprocess(vectors)
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
            if g.num_nodes > self._eng._cap:
                self._grow(g.num_nodes)
            self._eng.import_graph(g)
        else:
            need = self._eng.n + len(vectors)
            if need > self._eng._cap:
                self._grow(need)
            self._eng.add(vectors, labels=labels, nthreads=nthreads)
        if raw is not None:
            self._rerank_chunks.append(raw)
            self._rerank_rows = None
            self._rerank_dev = None
        self._graph = None
        return self

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
        """Rebuild-free capacity growth (usearch_reserve doubling)."""
        new_cap = max(8, self._eng._cap)
        while new_cap < need:
            new_cap *= 2
        self._eng.grow(new_cap)  # realloc: the engine's views now dangle
        self._graph = None
        self._label_sort = None

    def delete(self, labels: np.ndarray) -> int:
        """Tombstone by label; no space reclamation (delete.c:24-25)."""
        n = self._eng.mark_deleted(np.asarray(labels, np.uint64))
        self._graph = None
        return n

    # ---- query ----
    @property
    def device_graph(self):
        """The cached device mirror, rebuilt after any mutation."""
        if self._graph is None:
            if self.params.pq:
                g = to_device(self._eng, device=self.device,
                              pq_codebook=self._codebook)
            elif self.params.quant == QuantKind.I8:
                g = to_device(self._eng, device=self.device,
                              quant=QuantKind.I8)
            else:
                dtype = (torch.bfloat16 if self.params.quant == QuantKind.F16
                         else None)
                g = to_device(self._eng, dtype=dtype, device=self.device)
            self._graph = with_aug_norms(g)
        return self._graph

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        ef: int | None = None,
        params: SearchParams | None = None,
        mode: str = "auto",
        rerank: int | str | None = None,
        with_stats: bool = False,
        allow_labels: np.ndarray | None = None,
        deny_labels: np.ndarray | None = None,
    ):
        """Batched device search -> (dists [Q, k] f32, labels [Q, k] u64).

        Missing results (unreachable/tombstoned) have dist=+inf, label=0.

        ``mode``: 'flat' = dense scan, 'graph' = batched HNSW beam search,
        'auto' = cost-model dispatch (costmodel.choose_search_strategy).
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
        q = self._query_tensor(queries)
        graph = self.device_graph
        n = self._eng.n
        exclude = None
        if allow_labels is not None or deny_labels is not None:
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
            res = self._search_rerank(q, k, rerank, exclude)
            if with_stats:
                return (*res, {"mode": "flat_pq_rerank", "shortlist": rerank,
                               "rows_scanned": n})
            return res
        if mode == "auto":
            mode = choose_search_strategy(
                n, graph.vectors.shape[1], graph.vectors.element_size(),
                memory_budget(self.device))
        stats = {"mode": mode}
        if mode == "flat":
            d, _, labels = flat_search_graph(graph, q, k=k, exclude=exclude)
            stats.update(rows_scanned=n, exact_topk=True)
        elif mode == "graph":
            out = search_batched(graph, q, k=k, ef=max(ef, k),
                                 with_stats=with_stats, exclude=exclude,
                                 seeds=seeds)
            d, _, labels = out[:3]
            if with_stats:
                stats.update({k2: v.cpu().numpy() for k2, v in out[3].items()},
                             ef=max(ef, k))
        else:
            raise ValueError(f"unknown search mode {mode!r}")
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

    def rows_for_labels(self, labels: np.ndarray) -> np.ndarray:
        """Vectorized label -> internal-row resolution; -1 for unknown labels
        (a sorted-label array cached until the node count changes)."""
        n = self._eng.n
        if self._label_sort is None or self._label_sort[2] != n:
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
        rows are cached there as bf16."""
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
        return d.cpu().numpy(), labels.cpu().numpy().view(np.uint64)

    # ---- not ported yet ----
    search_streaming = _later("search_streaming",
                              "ROADMAP queue 1, the facade remainder")
    compact = _later("compact", "ROADMAP queue 1, the facade remainder")
    reindex = _later("reindex", "ROADMAP queue 1, the facade remainder")
    reindex_concurrent = _later("reindex_concurrent",
                                "ROADMAP queue 1, the facade remainder")
    save = _later("save", "ROADMAP queue 1, the facade remainder (snapshots)")
    load = _later("load", "ROADMAP queue 1, the facade remainder (snapshots)")
    follow = _later("follow", "ROADMAP queue 1, the facade remainder (WAL)")

    def __repr__(self):
        return (f"Index(dim={self.params.dim}, m={self.params.m}, "
                f"size={self.size}, device={self.device})")
