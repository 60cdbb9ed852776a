"""The user-facing Index facade (port of lantern_tpu/index.py, search path).

One HNSW index: the native C++ engine builds the graph on the host, and
queries run batched on the device against its mirror (``DeviceGraph``).
Labels are arbitrary u64 external keys. This slice ports ``add`` (host
build), ``delete``, ``search`` (auto / flat / graph, allow and deny filters,
``with_stats``), ``rows_for_labels`` and ``size``; the rest of the reference
facade raises NotImplementedError naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import numpy as np
import torch

from lantern_tpu_torch import resolve_device
from lantern_tpu_torch.config import HnswParams, Metric, QuantKind, SearchParams
from lantern_tpu_torch.costmodel import choose_search_strategy, memory_budget
from lantern_tpu_torch.flat import flat_search_graph
from lantern_tpu_torch.graph.device import to_device, with_aug_norms
from lantern_tpu_torch.graph.search import search_batched
from lantern_tpu_torch.native import NativeHnsw


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
    >>> dists, labels = ix.search(queries)   # batched on the device
    """

    def __init__(self, params: HnswParams, capacity: int = 1024, seed: int = 0,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if params.pq:
            raise NotImplementedError("PQ indexes: ROADMAP queue 1, the PQ slice")
        if Metric(params.metric) == Metric.HAMMING:
            raise NotImplementedError("hamming indexes: ROADMAP queue 1, hamming")
        if params.quant not in (QuantKind.F32, QuantKind.F16):
            raise NotImplementedError(
                f"quant={QuantKind(params.quant).name}: ROADMAP queue 1, the "
                "PQ / scalar-quant slice")
        self.params = params
        self._eng = NativeHnsw(params, capacity=capacity, seed=seed)
        self._graph = None  # cached device mirror
        self._label_sort = None  # cached sorted-label lookup

    # ---- ingest ----
    def add(self, vectors: np.ndarray, labels: np.ndarray | None = None,
            build: str = "host", nthreads: int = 0):
        """Insert rows through the native engine with ``nthreads`` host
        threads (0 = all cores). Labels default to consecutive row numbers."""
        if build != "host":
            raise NotImplementedError(
                "build='device' waits for the device-builder slice (ROADMAP "
                "queue 1)")
        vectors = np.asarray(vectors)
        if labels is None:
            labels = np.arange(self.size, self.size + len(vectors),
                               dtype=np.uint64)
        need = self._eng.n + len(vectors)
        if need > self._eng._cap:
            self._grow(need)
        self._eng.add(vectors, labels=labels, nthreads=nthreads)
        self._graph = None
        return self

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
            dtype = torch.bfloat16 if self.params.quant == QuantKind.F16 else None
            self._graph = with_aug_norms(
                to_device(self._eng, dtype=dtype, device=self.device))
        return self._graph

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        ef: int | None = None,
        params: SearchParams | None = None,
        mode: str = "auto",
        with_stats: bool = False,
        allow_labels: np.ndarray | None = None,
        deny_labels: np.ndarray | None = None,
    ):
        """Batched device search -> (dists [Q, k] f32, labels [Q, k] u64).

        Missing results (unreachable/tombstoned) have dist=+inf, label=0.

        ``mode``: 'flat' = dense scan, 'graph' = batched HNSW beam search,
        'auto' = cost-model dispatch (costmodel.choose_search_strategy).
        ``with_stats=True`` appends a dict describing the executed plan: the
        mode, plus per-query visited / expanded counts for the graph.
        ``allow_labels`` / ``deny_labels``: predicate filters. The flat scan
        filters exactly; the graph drops filtered nodes at emit time like
        tombstones, so raise ``ef`` under heavy filtering.
        """
        if params is not None:
            k, ef = params.k, params.ef
        ef = ef or self.params.ef
        seeds = (params or SearchParams()).seeds
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        q = torch.from_numpy(np.ascontiguousarray(queries)).to(self.device)
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

    # ---- not ported in this slice ----
    train_pq = _later("train_pq", "ROADMAP queue 1, the PQ slice")
    calibrate_rerank = _later("calibrate_rerank", "ROADMAP queue 1, the PQ slice")
    set_rerank_source = _later("set_rerank_source",
                               "ROADMAP queue 1, the PQ slice")
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
