"""ctypes binding for the native HNSW host engine (hnsw_engine.cpp).

The port's own copy of lantern_tpu/native: ``hnsw_engine.cpp`` is the same
source byte for byte, compiled with g++ at first use into the port's build
directory (``lantern_tpu_torch/_build/``, see csrc/build.py). Plain C ABI,
no framework. Hamming indexes store ``ceil(dim/32)`` uint32 words a row, as
the reference's wrapper does. ``import_graph`` adopts a graph built on the
device (``graph/build_device.py``) as the engine's state.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from lantern_tpu_torch.config import HnswParams, Metric, QuantKind
from lantern_tpu_torch.csrc.build import build_shared

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hnsw_engine.cpp")
# max graph levels; hnsw_engine.cpp's LMAX constant has the same value
LMAX = 16
_GXX = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread"]


@functools.cache
def get_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_shared(_SRC, _GXX, "hnsw"))
    lib.ldb_index_new.restype = ctypes.c_void_p
    lib.ldb_index_new.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64,
    ]
    lib.ldb_index_free.argtypes = [ctypes.c_void_p]
    lib.ldb_index_add.restype = ctypes.c_int64
    lib.ldb_index_add.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32,
    ]
    lib.ldb_index_search.restype = ctypes.c_int32
    lib.ldb_index_search.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ldb_index_mark_deleted.restype = ctypes.c_int64
    lib.ldb_index_mark_deleted.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.ldb_index_stats.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
    for name in (
        "ldb_index_vectors", "ldb_index_neighbors0", "ldb_index_counts0",
        "ldb_index_upper_neighbors", "ldb_index_upper_counts",
        "ldb_index_upper_slot", "ldb_index_levels", "ldb_index_labels",
        "ldb_index_deleted",
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_void_p
        fn.argtypes = [ctypes.c_void_p]
    lib.ldb_index_error.restype = ctypes.c_char_p
    lib.ldb_index_error.argtypes = [ctypes.c_void_p]
    lib.ldb_index_grow.restype = ctypes.c_int32
    lib.ldb_index_grow.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ldb_index_import.restype = ctypes.c_int32
    lib.ldb_index_import.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
         ctypes.c_int32] + [ctypes.c_void_p] * 9)
    return lib


def _as_np(ptr: int, shape, dtype):
    """Zero-copy view into C++-owned memory.

    LIFETIME CONTRACT: the view dangles after ldb_index_grow (realloc) or
    engine destruction. Consumers re-fetch the property after grow() and
    copy before keeping data (``torch.from_numpy`` would alias it).
    """
    size = int(np.prod(shape))
    buf = (ctypes.c_char * (size * np.dtype(dtype).itemsize)).from_address(ptr)
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


class NativeHnsw:
    """Multicore native HNSW index over f32 rows (l2sq / cos) or packed
    uint32 bit words (hamming, ``ceil(dim/32)`` words a row)."""

    def __init__(self, params: HnswParams, capacity: int = 1024, seed: int = 0):
        self.p = params
        self.metric = Metric(params.metric)
        if self.metric == Metric.HAMMING:
            self.words = -(-params.dim // 32)
            self._vec_dtype, self._vec_width = np.uint32, self.words
        else:
            self._vec_dtype, self._vec_width = np.float32, params.dim
        self._cap = max(int(capacity), 8)
        self._lib = get_lib()
        self._h = self._lib.ldb_index_new(
            params.dim, self._vec_width, params.m, params.ef_construction,
            int(self.metric), self._cap, seed,
        )

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ldb_index_free(h)
            self._h = None

    # ---- stats ----
    def _stats(self):
        vals = [ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int32(),
                ctypes.c_int32(), ctypes.c_int64(), ctypes.c_int64()]
        self._lib.ldb_index_stats(self._h, *[ctypes.byref(v) for v in vals])
        return tuple(v.value for v in vals)  # n, n_upper, entry, max_level, cap, ucap

    @property
    def n(self):
        return self._stats()[0]

    @property
    def n_upper(self):
        return self._stats()[1]

    @property
    def entry(self):
        return self._stats()[2]

    @property
    def max_level(self):
        return self._stats()[3]

    # ---- array views (zero-copy; see _as_np lifetime contract) ----
    def _view(self, name, shape, dtype):
        return _as_np(getattr(self._lib, name)(self._h), shape, dtype)

    @property
    def vectors(self):
        cap = self._stats()[4]
        return self._view("ldb_index_vectors", (cap, self._vec_width),
                          self._vec_dtype)

    @property
    def neighbors0(self):
        cap = self._stats()[4]
        return self._view("ldb_index_neighbors0", (cap, self.p.m0), np.int32)

    @property
    def counts0(self):
        cap = self._stats()[4]
        return self._view("ldb_index_counts0", (cap,), np.int32)

    @property
    def upper_neighbors(self):
        ucap = self._stats()[5]
        return self._view("ldb_index_upper_neighbors", (ucap, LMAX, self.p.m),
                          np.int32)

    @property
    def upper_counts(self):
        ucap = self._stats()[5]
        return self._view("ldb_index_upper_counts", (ucap, LMAX), np.int32)

    @property
    def upper_slot(self):
        cap = self._stats()[4]
        return self._view("ldb_index_upper_slot", (cap,), np.int32)

    @property
    def levels(self):
        cap = self._stats()[4]
        return self._view("ldb_index_levels", (cap,), np.int32)

    @property
    def labels(self):
        cap = self._stats()[4]
        return self._view("ldb_index_labels", (cap,), np.uint64)

    @property
    def deleted(self):
        cap = self._stats()[4]
        return self._view("ldb_index_deleted", (cap,), np.uint8).astype(bool)

    # ---- operations ----
    def add(self, vecs: np.ndarray, labels: np.ndarray | None = None,
            nthreads: int = 0):
        """Insert rows with ``nthreads`` workers (0 = all host cores; the
        graph then depends on thread timing, so pass 1 to reproduce one)."""
        vecs = np.ascontiguousarray(vecs, dtype=self._vec_dtype)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        if vecs.shape[1] != self._vec_width:
            raise ValueError(
                f"vector width {vecs.shape[1]} != expected {self._vec_width}")
        if labels is None:
            # NULL: the engine derives label = row id inside its atomically
            # reserved range (safe under concurrent add())
            labels_ptr = None
        else:
            labels = np.ascontiguousarray(labels, np.uint64)
            if len(labels) != len(vecs):
                raise ValueError(f"{len(labels)} labels for {len(vecs)} vectors")
            labels_ptr = labels.ctypes.data_as(ctypes.c_void_p)
        rc = self._lib.ldb_index_add(
            self._h, len(vecs), vecs.ctypes.data_as(ctypes.c_void_p),
            labels_ptr, nthreads,
        )
        if rc < 0:
            raise MemoryError(self._lib.ldb_index_error(self._h).decode())
        return rc

    def search(self, q: np.ndarray, k: int, ef: int | None = None):
        """Single-query search on the host (the reference's execution model)."""
        ef = ef or self.p.ef
        q = np.ascontiguousarray(q, self._vec_dtype)
        out_ids = np.empty(max(k, ef), np.int32)
        out_d = np.empty(max(k, ef), np.float32)
        cnt = self._lib.ldb_index_search(
            self._h, q.ctypes.data_as(ctypes.c_void_p), k, ef,
            out_ids.ctypes.data_as(ctypes.c_void_p),
            out_d.ctypes.data_as(ctypes.c_void_p),
        )
        return out_ids[:cnt].copy(), out_d[:cnt].copy()

    def import_graph(self, graph, labels: np.ndarray | None = None) -> None:
        """Adopt a DeviceGraph (f32 or bf16 rows, or hamming words) as this
        engine's state, the reverse of ``to_device``: the first
        ``graph.num_nodes`` rows, their adjacency, levels, slots, labels
        (``labels`` if given, else the graph's) and tombstones.

        The C import copies at the engine's row width and ``m``, so a graph
        of another width or ``m`` is refused here, as are more nodes than
        the capacity or fewer labels than nodes. Hamming words arrive as
        int32 tensors carrying the uint32 bits and are reinterpreted, not
        converted; bf16 rows are widened to f32. int8 codes and PQ codes
        are refused: the engine stores the rows themselves.
        """
        from lantern_tpu_torch.graph.device import QUANT_PQ

        n = int(graph.num_nodes)
        if n > self._cap:
            raise ValueError(f"graph has {n} nodes > capacity {self._cap}")
        g_width = graph.vectors.shape[1]
        if g_width != self._vec_width:
            raise ValueError(
                f"graph vector width {g_width} != engine width "
                f"{self._vec_width} (dim/quant mismatch)")
        if int(graph.m) != self.p.m:
            raise ValueError(f"graph m={int(graph.m)} != engine m={self.p.m}")
        if graph.quant in (int(QuantKind.I8), QUANT_PQ):
            raise ValueError("import_graph takes rows (f32, bf16) or hamming "
                             f"words, not quant={graph.quant} codes")
        if labels is not None and len(labels) < n:
            raise ValueError(f"{len(labels)} labels for {n} nodes")

        def host(t, dtype):
            return np.ascontiguousarray(t.cpu().numpy(), dtype)

        vec = graph.vectors[:n]
        if self.metric == Metric.HAMMING:
            vec = host(vec, np.int32).view(np.uint32)
        else:
            vec = host(vec.float(), np.float32)
        nb0 = host(graph.neighbors0[:n], np.int32)
        slots = host(graph.upper_slot[:n], np.int32)
        used = slots[slots >= 0]
        n_upper = int(used.max()) + 1 if used.size else 1
        up = host(graph.upper_neighbors[:n_upper], np.int32)
        if labels is None:
            labels = graph.labels[:n].cpu().numpy().view(np.uint64)
        args = [
            vec,
            nb0,
            np.ascontiguousarray((nb0 >= 0).sum(1), np.int32),
            up,
            np.ascontiguousarray((up >= 0).sum(-1), np.int32),
            slots,
            host(graph.levels[:n], np.int32),
            np.ascontiguousarray(np.asarray(labels)[:n], np.uint64),
            host(graph.deleted[:n], np.uint8),
        ]
        rc = self._lib.ldb_index_import(
            self._h, n, n_upper, int(graph.entry), int(graph.max_level),
            *[a.ctypes.data_as(ctypes.c_void_p) for a in args])
        if rc != 0:
            raise ValueError(self._lib.ldb_index_error(self._h).decode())

    def grow(self, new_cap: int) -> None:
        """Grow capacity in place (doubling semantics of server.rs:243-247).
        Must not run concurrently with add/search."""
        rc = self._lib.ldb_index_grow(self._h, int(new_cap))
        if rc != 0:
            raise MemoryError(self._lib.ldb_index_error(self._h).decode())
        self._cap = int(new_cap)

    def mark_deleted(self, labels: np.ndarray) -> int:
        labels = np.ascontiguousarray(labels, np.uint64)
        return self._lib.ldb_index_mark_deleted(
            self._h, labels.ctypes.data_as(ctypes.c_void_p), len(labels)
        )
