"""Versioned index snapshots + append-only insert log (the WAL analog);
port of lantern_tpu/storage/snapshot.py, the same file format.

The reference's durability model (SURVEY.md §5.4): the index IS its own
checkpoint — a versioned header page (magic 0xa47e60db, version 0x3, params,
usearch header — external_index.h:20-56) plus packed node pages, all WAL
logged; single inserts are atomic GenericXLog transactions; version mismatch
on scan says "Please reindex" (scan.c:103-105).

Here: a snapshot file = fixed little-endian header struct (same magic, our
format version, all build params persisted so loads don't depend on external
state — mirroring how reloptions are frozen into the header at build time,
external_index.c:262-277) + length-prefixed raw arrays. Incremental
durability between snapshots = InsertLog, an append-only record stream
(8-byte label + vector payload, framing like the tuple wire format,
external_index_socket.c:517-536) replayed on load; each record carries a
CRC so torn tail writes are detected and truncated, which is the crash
atomicity the reference gets from GenericXLog.

Files written by this module and by the JAX package's are byte-equal for
equal engines, and each loads the other's. Arrays tagged "bfloat16" (the
JAX package's bf16 tables) are read without ml_dtypes: their uint16 bits
are widened to f32 by a 16-bit shift, which is exact.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from lantern_tpu_torch.config import HnswParams, Metric, QuantKind
from lantern_tpu_torch.utils.failpoints import failure_point

HEADER_MAGIC = 0xA47E60DB  # same magic as the reference header page
HEADER_VERSION = 3
_HDR_V1_BODY = "<iiiiiiiqqiiiiQ"  # dim..nsub (after magic+version)
_HDR_V2_EXTRA = "<QQ"  # log_generation, log_lsn
_HDR_V3_EXTRA = "<I"  # has_rotation: an OPQ rotation array follows the codebook
_LOG_MAGIC = 0xA47E60DC
_LOG_VERSION = 3  # v2 added a generation id; v3 adds tombstone records
_LOG_REC_HDR = "<QII"  # label, payload bytes, crc32(payload)
# a v3 record with this payload-length sentinel (and crc 0) is a DELETE of
# `label` — the WAL coverage the reference's bulk delete gets from
# GenericXLog (delete.c:40-70); without it, tombstones set after the last
# save() vanished on crash
_DELETE_PLEN = 0xFFFFFFFF


def _pack_header(p: HnswParams, n, n_upper, entry, max_level, width,
                 log_generation: int = 0, log_lsn: int = 0,
                 has_rotation: bool = False) -> bytes:
    return struct.pack("<II", HEADER_MAGIC, HEADER_VERSION) + struct.pack(
        _HDR_V1_BODY,
        p.dim,
        width,
        p.m,
        p.ef_construction,
        p.ef,
        int(p.metric),
        int(p.quant),
        int(n),
        int(n_upper),
        int(entry),
        int(max_level),
        int(p.pq),
        p.num_centroids if p.pq else 0,
        p.effective_num_subvectors if p.pq else 0,
    ) + struct.pack(_HDR_V2_EXTRA, log_generation, log_lsn) + struct.pack(
        _HDR_V3_EXTRA, int(has_rotation)
    )


def _read_header(f):
    """Version-dispatching header read (v1 snapshots upgrade on load; unknown
    future versions error with the reference's 'rebuild' message,
    scan.c:103-105 / sql/updates migration story)."""
    magic, version = struct.unpack("<II", _read_exactly(f, 8))
    if magic != HEADER_MAGIC:
        raise ValueError(f"not a lantern-tpu snapshot (magic {magic:#x})")
    if version not in (1, 2, 3):
        raise ValueError(
            f"snapshot version {version} is newer than supported "
            f"{HEADER_VERSION}; please rebuild the index"
        )
    (
        dim, width, m, efc, ef, metric, quant, n, n_upper,
        entry, max_level, pq, ncent, nsub,
    ) = struct.unpack(
        _HDR_V1_BODY, _read_exactly(f, struct.calcsize(_HDR_V1_BODY))
    )
    if version >= 2:
        log_generation, log_lsn = struct.unpack(
            _HDR_V2_EXTRA, _read_exactly(f, struct.calcsize(_HDR_V2_EXTRA))
        )
    else:  # v1 -> v2 upgrade: no log bookkeeping existed; replay everything
        log_generation, log_lsn = 0, 0
    if version >= 3:  # v3: OPQ rotation flag
        (has_rotation,) = struct.unpack(
            _HDR_V3_EXTRA, _read_exactly(f, struct.calcsize(_HDR_V3_EXTRA))
        )
    else:
        has_rotation = 0
    params = HnswParams(
        dim=dim,
        m=m,
        ef_construction=efc,
        ef=ef,
        metric=Metric(metric),
        quant=QuantKind(quant),
        pq=bool(pq),
        num_centroids=ncent or 256,
        num_subvectors=nsub,
    )
    return (params, width, n, n_upper, entry, max_level, log_generation,
            log_lsn, bool(has_rotation))


def _write_arr(f, arr):
    """Write a numpy array, or a CPU bf16 tensor (bf16 row tables, which
    numpy cannot hold without ml_dtypes), tagged "bfloat16" with its 2-byte
    bits as the JAX package writes its bfloat16 arrays."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype != torch.bfloat16:
            raise ValueError(f"unserializable tensor dtype {arr.dtype}")
        tag, shape = "bfloat16", tuple(arr.shape)
        raw = arr.contiguous().view(torch.int16).numpy().astype("<i2").tobytes()
    else:
        arr = np.ascontiguousarray(arr)
        # ml_dtypes dtypes (the JAX package's bfloat16 tables) stringify as
        # opaque void ('<V2'), which would silently reinterpret the bytes on
        # load — tag them by NAME instead
        if arr.dtype.kind == "V":
            if arr.dtype.name != "bfloat16":
                raise ValueError(f"unserializable array dtype {arr.dtype}")
            tag = "bfloat16"
        else:
            tag = arr.dtype.str
        shape, raw = arr.shape, arr.tobytes()
    meta = f"{tag};{','.join(map(str, shape))}".encode()
    f.write(struct.pack("<I", len(meta)))
    f.write(meta)
    f.write(struct.pack("<QI", len(raw), zlib.crc32(raw)))
    f.write(raw)


def _read_exactly(f, n: int) -> bytes:
    buf = f.read(n)
    if len(buf) != n:
        raise ValueError(
            f"snapshot truncated (wanted {n} bytes, got {len(buf)}); "
            "restore from a complete snapshot or rebuild the index"
        )
    return buf


def _read_arr(f) -> np.ndarray:
    (mlen,) = struct.unpack("<I", _read_exactly(f, 4))
    dtype_s, shape_s = _read_exactly(f, mlen).decode().split(";")
    shape = tuple(int(x) for x in shape_s.split(",")) if shape_s else ()
    rlen, crc = struct.unpack("<QI", _read_exactly(f, 12))
    raw = _read_exactly(f, rlen)
    if zlib.crc32(raw) != crc:
        raise ValueError("snapshot array corrupted (crc mismatch)")
    if dtype_s == "bfloat16":
        # bf16 is the top half of an f32: widen the bits, no ml_dtypes
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype_s)).reshape(shape).copy()


# array serialization order (documented, stable)
_ARRAYS = (
    "vectors", "neighbors0", "counts0", "upper_neighbors", "upper_counts",
    "upper_slot", "levels", "labels", "deleted",
)


def save_snapshot(engine, path: str, pq_codebook=None, log_state=None):
    """Persist a Host/Native HNSW engine. Atomic via fsync + rename.

    ``pq_codebook``: a quant.pq.PQCodebook (rotation persisted too) or a raw
    centroid array [S, K, dsub], persisted with the index when params.pq
    (the reference persists its codebook as a read-only SQL table guarded by
    a trigger, lantern.sql:244-250).

    ``log_state``: (generation, lsn) of the InsertLog whose records are
    already folded into this engine — recorded in the header so a crash
    between this rename and the log truncate can't replay them twice.
    """
    n = engine.n
    n_upper = max(engine.n_upper, 1)
    width = engine.vectors.shape[1]
    if engine.p.pq and pq_codebook is None:
        raise ValueError("pq index snapshot requires its codebook")
    rotation = None
    if pq_codebook is not None and hasattr(pq_codebook, "centroids"):
        rotation = pq_codebook.rotation
        pq_codebook = pq_codebook.centroids
    log_generation, log_lsn = log_state if log_state else (0, 0)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_pack_header(engine.p, n, n_upper, engine.entry, engine.max_level,
                             width, log_generation, log_lsn,
                             has_rotation=rotation is not None))
        _write_arr(f, engine.vectors[:n])
        _write_arr(f, engine.neighbors0[:n])
        _write_arr(f, engine.counts0[:n])
        _write_arr(f, engine.upper_neighbors[:n_upper])
        _write_arr(f, engine.upper_counts[:n_upper])
        _write_arr(f, engine.upper_slot[:n])
        _write_arr(f, engine.levels[:n])
        _write_arr(f, engine.labels[:n])
        _write_arr(f, engine.deleted[:n].astype(np.uint8))
        if engine.p.pq:
            _write_arr(f, np.asarray(pq_codebook, np.float32))
            if rotation is not None:
                _write_arr(f, np.asarray(rotation, np.float32))
        # crash site: everything written but not yet visible (failure_point.h idiom)
        failure_point("save_snapshot", "before_rename")
        f.flush()
        os.fsync(f.fileno())  # rename-atomicity needs the data on disk first
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def _fsync_dir(dirpath: str):
    try:
        dfd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def load_snapshot(path: str, engine: str = "native", extra_capacity: int = 0,
                  return_codebook: bool = False, return_log_state: bool = False):
    """Load a snapshot into a fresh engine (native C++ or python).

    With ``return_codebook=True`` returns (engine, PQCodebook-or-None);
    ``return_log_state=True`` appends the header's (log_generation, log_lsn).
    """
    with open(path, "rb") as f:
        (params, width, n, n_upper, entry, max_level,
         log_generation, log_lsn, has_rotation) = _read_header(f)
        arrs = {name: _read_arr(f) for name in _ARRAYS}
        codebook = None
        if params.pq:
            from lantern_tpu_torch.quant.pq import PQCodebook

            cent = _read_arr(f)
            rot = _read_arr(f) if has_rotation else None
            codebook = PQCodebook(centroids=cent, rotation=rot)

    def _ret(ix):
        out = (ix,)
        if return_codebook:
            out = out + (codebook,)
        if return_log_state:
            out = out + ((log_generation, log_lsn),)
        return out if len(out) > 1 else ix

    cap = n + max(extra_capacity, 0)
    if engine == "native":
        import ctypes

        from lantern_tpu_torch.native import NativeHnsw, get_lib

        ix = NativeHnsw(params, capacity=max(cap, 8), seed=0)
        lib = get_lib()

        def ptr(a, dt):
            a = np.ascontiguousarray(a, dt)
            return a, a.ctypes.data_as(ctypes.c_void_p)

        # the C engine stores f32 (l2sq/cos) or u32 (hamming) rows; bf16
        # tables were widened to f32 by _read_arr (exact)
        vec_dt = arrs["vectors"].dtype
        keep = []  # keep arrays alive through the call
        ptrs = []
        for name, dt in (
            ("vectors", vec_dt), ("neighbors0", np.int32),
            ("counts0", np.int32), ("upper_neighbors", np.int32),
            ("upper_counts", np.int32), ("upper_slot", np.int32),
            ("levels", np.int32), ("labels", np.uint64), ("deleted", np.uint8),
        ):
            a, pp = ptr(arrs[name], dt)
            keep.append(a)
            ptrs.append(pp)
        rc = lib.ldb_index_import(ix._h, n, n_upper, entry, max_level, *ptrs)
        if rc != 0:
            raise ValueError(lib.ldb_index_error(ix._h).decode())
        return _ret(ix)
    elif engine == "python":
        from lantern_tpu_torch.graph.host_build import HostHnsw

        ix = HostHnsw(params, capacity=max(cap, 8), seed=0)
        ix._reserve(n)
        ix._reserve_upper(n_upper)
        ix.vectors[:n] = arrs["vectors"]
        ix.neighbors0[:n] = arrs["neighbors0"]
        ix.counts0[:n] = arrs["counts0"]
        ix.upper_neighbors[:n_upper] = arrs["upper_neighbors"]
        ix.upper_counts[:n_upper] = arrs["upper_counts"]
        ix.upper_slot[:n] = arrs["upper_slot"]
        ix.levels[:n] = arrs["levels"]
        ix.labels[:n] = arrs["labels"]
        ix.deleted[:n] = arrs["deleted"].astype(bool)
        ix.n = n
        ix.n_upper = n_upper
        ix.entry = entry
        ix.max_level = max_level
        return _ret(ix)
    raise ValueError(f"unknown engine {engine!r}")


def read_snapshot_header(path: str):
    """Parse just a snapshot file's header (no arrays) -> the _read_header
    tuple, or None if the file is absent or torn mid-header. Followers use
    this to detect a writer's save() without loading the whole snapshot."""
    try:
        with open(path, "rb") as f:
            return _read_header(f)
    except (FileNotFoundError, ValueError):
        return None


def read_log_header(path: str):
    """-> (version, generation, header_end_offset) of an insert log, or None
    if the file is absent or its header torn (crash mid-header-write: no
    record can follow an incomplete header). Raises on a wrong magic or a
    version newer than supported — misparsing a future grammar and then
    'truncating the torn tail' would destroy valid records."""
    try:
        f = open(path, "rb")
    except FileNotFoundError:
        return None
    with f:
        magic_ver = f.read(8)
        if len(magic_ver) < 8:
            return None
        magic, version = struct.unpack("<II", magic_ver)
        if magic != _LOG_MAGIC:
            raise ValueError("not an insert log")
        if version > _LOG_VERSION:
            raise ValueError(
                f"insert log version {version} is newer than supported "
                f"{_LOG_VERSION}; please rebuild the index"
            )
        if version >= 2:
            gen_bytes = f.read(8)
            if len(gen_bytes) < 8:
                return None  # v2+ header torn before its generation field
            return version, struct.unpack("<Q", gen_bytes)[0], 16
        return version, 0, 8


def scan_log_tail(path: str, width: int, dtype, offset: int, version: int):
    """Parse complete records from byte ``offset`` -> (ops, new_offset).

    Stops at the first incomplete/CRC-failing record WITHOUT consuming it —
    a live writer may still be appending that record (its bytes become valid
    on the writer's next flush), so a torn tail reads as "not yet", never as
    corruption. Callers resume from ``new_offset`` on the next poll. This is
    what lets a read replica tail a log another process is appending to
    (the WAL-follow analog, scripts/test_wal.py:8-40).
    """
    dtype = np.dtype(dtype)
    payload = width * dtype.itemsize
    hdr = struct.calcsize(_LOG_REC_HDR)
    ops = []
    with open(path, "rb") as f:
        f.seek(offset)
        valid_end = offset
        while True:
            h = f.read(hdr)
            if len(h) < hdr:
                break  # clean EOF or torn header: stop
            label, plen, crc = struct.unpack(_LOG_REC_HDR, h)
            if version >= 3 and plen == _DELETE_PLEN and crc == 0:
                ops.append(("del", label))
                valid_end += hdr
                continue
            raw = f.read(plen)
            if len(raw) < plen or zlib.crc32(raw) != crc or plen != payload:
                break  # torn/corrupt tail: discard
            ops.append(("add", label, np.frombuffer(raw, dtype)))
            valid_end += hdr + plen
    return ops, valid_end


class InsertLog:
    """Append-only insert log with CRC-framed records (WAL-append analog).

    Records survive process crashes; a torn tail record is detected by CRC
    and truncated on replay — the insert either fully happened or didn't,
    which is the reference's GenericXLog atomicity for ldb_aminsert.
    """

    def __init__(self, path: str, width: int, dtype=np.float32):
        self.path = path
        self.width = width
        self.dtype = np.dtype(dtype)
        size = os.path.getsize(path) if os.path.exists(path) else 0
        if 0 < size < 8:
            # torn log header (crash during header write): no record can
            # have been appended past an incomplete header — recover by
            # starting a fresh log rather than failing every open until
            # someone deletes the file by hand
            size = 0
        if size > 0:
            # adopt the existing generation and count its valid records so
            # the next snapshot records a correct LSN
            ops, self.generation, self.count, valid_end = self._scan(
                path, width, self.dtype
            )
            # v1/v2 logs (version < 3) adopt by REWRITE so appends use the
            # v3 record grammar; generation 0 (v1, or a v2 header torn
            # before its generation field) additionally mints a real id —
            # generation 0 reads as "no state" in replay()'s dedup check,
            # which would re-open the double-replay crash window
            with open(path, "rb") as hf:
                version = struct.unpack("<II", hf.read(8))[1]
            if version < 3 or self.generation == 0:
                if self.generation == 0:
                    self.generation = self._new_generation()
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "wb") as f:
                    self._write_log_header(f, self.generation)
                    for op in ops:
                        f.write(self._pack_record(op))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
                self._f = open(path, "ab")
                return
            # truncate any torn tail record BEFORE appending: records written
            # after torn bytes would be unreachable on the next replay
            # (_scan stops at the first bad record), silently dropping
            # fsync-acknowledged inserts
            if os.path.getsize(path) > valid_end:
                with open(path, "r+b") as tf:
                    tf.truncate(valid_end)
                    tf.flush()
                    os.fsync(tf.fileno())
            self._f = open(path, "ab")
        else:
            self.generation = self._new_generation()
            self.count = 0
            self._f = open(path, "wb")
            self._write_log_header(self._f, self.generation)
            self._f.flush()

    @staticmethod
    def _new_generation() -> int:
        return int.from_bytes(os.urandom(8), "little") or 1

    @staticmethod
    def _write_log_header(f, generation: int):
        f.write(struct.pack("<IIQ", _LOG_MAGIC, _LOG_VERSION, generation))

    def _pack_record(self, op) -> bytes:
        if op[0] == "del":
            return struct.pack(_LOG_REC_HDR, int(op[1]), _DELETE_PLEN, 0)
        raw = np.ascontiguousarray(op[2], self.dtype).tobytes()
        return struct.pack(_LOG_REC_HDR, int(op[1]), len(raw),
                           zlib.crc32(raw)) + raw

    def append(self, vecs: np.ndarray, labels: np.ndarray):
        vecs = np.ascontiguousarray(vecs, self.dtype)
        labels = np.asarray(labels, np.uint64)
        for v, lab in zip(vecs, labels):
            raw = v.tobytes()
            self._f.write(struct.pack(_LOG_REC_HDR, int(lab), len(raw), zlib.crc32(raw)))
            # crash site: header written, payload missing -> torn record
            failure_point("insert_log_append", "mid_record")
            self._f.write(raw)
        self.count += len(labels)
        self._f.flush()
        os.fsync(self._f.fileno())

    def append_delete(self, labels: np.ndarray):
        """Log tombstones (the delete leg of the WAL — delete.c:40-70)."""
        labels = np.atleast_1d(np.asarray(labels, np.uint64))
        for lab in labels:
            self._f.write(self._pack_record(("del", int(lab))))
            failure_point("insert_log_append", "mid_delete_record")
        self.count += len(labels)
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self):
        self._f.close()

    @property
    def state(self) -> tuple[int, int]:
        """(generation, lsn) to stamp into a snapshot that folds this log."""
        return self.generation, self.count

    def truncate(self):
        """Reset after folding the log into a snapshot. A fresh generation id
        distinguishes post-truncate records from the pre-snapshot ones the
        snapshot header's (generation, lsn) refers to."""
        self._f.close()
        self.generation = self._new_generation()
        self.count = 0
        with open(self.path, "wb") as f:
            self._write_log_header(f, self.generation)
            f.flush()
            os.fsync(f.fileno())
        self._f = open(self.path, "ab")

    @staticmethod
    def _scan(path: str, width: int, dtype):
        """Parse a log file -> (ops, generation, n_valid_records, valid_end).

        ``ops``: in-order list of ``("add", label, vec)`` /
        ``("del", label)``. Tolerates a torn tail record (truncated by
        CRC). Accepts v1 (no generation), v2, and v3 (tombstones) headers;
        ``valid_end`` is the byte offset just past the last valid record
        (records are variable-size once tombstones exist).
        """
        hdr = read_log_header(path)
        if hdr is None:
            # torn header (crash mid-write): nothing could follow it
            return [], 0, 0, 0
        version, generation, pos = hdr
        ops, valid_end = scan_log_tail(path, width, dtype, pos, version)
        return ops, generation, len(ops), valid_end

    @classmethod
    def replay_ops(cls, path: str, width: int, dtype=np.float32,
                   snapshot_state=None):
        """In-order op list (adds + deletes); tolerates a torn tail.

        ``snapshot_state``: the loading snapshot's (generation, lsn). Records
        already folded into that snapshot (same generation, index < lsn) are
        skipped — closes the crash window between snapshot rename and log
        truncate where replay would double-apply.
        """
        ops, generation, _, _ = cls._scan(path, width, dtype)
        if snapshot_state is not None:
            snap_gen, snap_lsn = snapshot_state
            if snap_gen and snap_gen == generation and snap_lsn > 0:
                ops = ops[snap_lsn:]
        return ops

    @classmethod
    def replay(cls, path: str, width: int, dtype=np.float32, snapshot_state=None):
        """Adds only -> (vectors [n, width], labels [n]). Use replay_ops
        when the log may contain tombstone records."""
        ops = cls.replay_ops(path, width, dtype, snapshot_state)
        adds = [op for op in ops if op[0] == "add"]
        if not adds:
            return np.empty((0, width), np.dtype(dtype)), np.empty(0, np.uint64)
        return (np.stack([op[2] for op in adds]),
                np.array([op[1] for op in adds], np.uint64))
