"""Benchmark dataset loaders: .fvecs / .ivecs / .bvecs (+gzip).

Parity with lantern_extras dotvecs.rs:32-40: little-endian records of
``int32 dim`` followed by dim values (f32 / i32 / u8). These are the
standard SIFT/GIST benchmark formats (texmex).
"""

from __future__ import annotations

import gzip

import numpy as np


def _open(path_or_bytes):
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)
    if str(path_or_bytes).endswith(".gz"):
        with gzip.open(path_or_bytes, "rb") as f:
            return f.read()
    with open(path_or_bytes, "rb") as f:
        return f.read()


def _parse(raw: bytes, value_dtype, count: int | None) -> np.ndarray:
    if len(raw) < 4:
        return np.empty((0, 0), value_dtype)
    dim = int(np.frombuffer(raw[:4], "<i4")[0])
    if dim <= 0:
        raise ValueError(f"invalid record dimension {dim}")
    itemsize = np.dtype(value_dtype).itemsize
    rec_bytes = 4 + dim * itemsize
    n = len(raw) // rec_bytes
    if count is not None:
        n = min(n, count)
    buf = np.frombuffer(raw[: n * rec_bytes], np.uint8).reshape(n, rec_bytes)
    dims = buf[:, :4].copy().view("<i4").ravel()
    if (dims != dim).any():
        raise ValueError("inconsistent record dimensions")
    return buf[:, 4:].copy().view(np.dtype(value_dtype).newbyteorder("<")).reshape(n, dim)


def parse_fvecs(path_or_bytes, count: int | None = None) -> np.ndarray:
    """-> float32 [n, dim]"""
    return _parse(_open(path_or_bytes), np.float32, count)


def parse_ivecs(path_or_bytes, count: int | None = None) -> np.ndarray:
    """-> int32 [n, dim] (ground-truth neighbor files)"""
    return _parse(_open(path_or_bytes), np.int32, count)


def parse_bvecs(path_or_bytes, count: int | None = None) -> np.ndarray:
    """-> uint8 [n, dim]"""
    return _parse(_open(path_or_bytes), np.uint8, count)


def iter_fvecs(path, chunk_rows: int = 65536):
    """Stream an .fvecs(.gz) file as successive [<=chunk_rows, dim] float32
    blocks WITHOUT materializing the dataset (gzip decompresses
    sequentially). The streaming producer for chunked PQ training — the
    analog of the reference's parallel row fetch over N connections
    (codebook.rs:168-211) for tables that don't fit in RAM.
    """
    opener = gzip.open if str(path).endswith(".gz") else open
    rec = None
    dim = None
    buf = b""
    with opener(path, "rb") as f:
        while True:
            want = (rec or 4 + 4) * chunk_rows
            data = f.read(max(want - len(buf), 1 << 16))
            eof = not data
            buf += data
            if rec is None:
                if len(buf) < 4:
                    if eof and buf:
                        raise ValueError("truncated fvecs header")
                    if eof:
                        return
                    continue
                dim = int(np.frombuffer(buf[:4], "<i4")[0])
                if dim <= 0:
                    raise ValueError(f"invalid record dimension {dim}")
                rec = 4 + dim * 4
            while len(buf) >= rec:
                nfull = min(len(buf) // rec, chunk_rows)
                take = np.frombuffer(buf[: nfull * rec], np.uint8).reshape(
                    nfull, rec
                )
                dims = take[:, :4].copy().view("<i4").ravel()
                if (dims != dim).any():
                    raise ValueError("inconsistent record dimensions")
                yield take[:, 4:].copy().view("<f4").reshape(nfull, dim)
                buf = buf[nfull * rec:]
            if eof:
                if buf:
                    raise ValueError("truncated trailing fvecs record")
                return


def write_fvecs(path: str, data: np.ndarray):
    data = np.ascontiguousarray(data, np.float32)
    n, dim = data.shape
    out = np.empty((n, 4 + dim * 4), np.uint8)
    out[:, :4] = np.frombuffer(
        np.full(n, dim, "<i4").tobytes(), np.uint8
    ).reshape(n, 4)
    out[:, 4:] = data.view(np.uint8).reshape(n, dim * 4)
    with open(path, "wb") as f:
        f.write(out.tobytes())
