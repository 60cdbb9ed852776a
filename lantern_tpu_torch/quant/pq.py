"""Product quantization: codebook training, encode/decode, ADC tables
(port of lantern_tpu/quant/pq.py).

- The codebook is ``[S, K, dsub]`` f32 centroids (S subspaces of dsub dims,
  K <= 256 centroids each, so codes are uint8), optionally with an OPQ
  rotation ``[dim, dim]``: codes and centroids then live in the rotated
  space, encode applies R, decode applies R^T, and searches rotate the query
  once (R is orthogonal, so distances are unchanged).
- Training is Lloyd k-means per subspace, batched over subspaces (the
  reference vmaps the same step), from centroids drawn as random rows. The
  reference draws them with ``jax.random.choice``; the port draws them from a
  ``torch.Generator`` seeded by ``seed`` (on the CPU, so the draw does not
  depend on the device), so the two packages train from different inits and
  agree on quality, not on centroids.
- The assignment ``argmin_k |c_k|^2 - 2 x.c_k`` and the one-hot mean update
  are the reference's formulas. The ``[S, rows, K]`` block they need is
  walked in row chunks of at most ``_CHUNK_ELEMS`` elements: at 1M rows a
  whole block would be 32 GB.
- ``train_codebook_chunked`` streams the rows (``.npy``, ``.fvecs`` or a
  chunk factory) through exact Lloyd / OPQ passes with a resumable state
  file. Its init is the reference's numpy draw, so both packages start it
  from the same centroids, and its state file is the reference's.
- Search uses asymmetric distances: a per-query table LUT ``[Q, S, K]`` of
  partial distances, summed over the candidate's codes. The reference sums
  them by a one-hot matmul on the TPU's matrix unit; here it is a gather.

Entry points that take numpy data run on ``cuda`` unless ``device="cpu"``.
On the card, matmuls are full f32 unless TF32 was switched on.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np
import torch

from lantern_tpu_torch import resolve_device
from lantern_tpu_torch.config import Metric

# f32 elements of one [S, rows, K] assignment block (256 MiB)
_CHUNK_ELEMS = 1 << 26
# Lloyd iterations per OPQ alternation (the reference's `inner`)
_OPQ_INNER = 4


@dataclasses.dataclass(frozen=True)
class PQCodebook:
    """Trained codebook: centroids [S, K, dsub] f32 and an optional OPQ
    rotation [dim, dim] f32 (numpy, as the reference keeps them)."""

    centroids: np.ndarray
    rotation: np.ndarray | None = None

    @property
    def num_subvectors(self) -> int:
        return self.centroids.shape[0]

    @property
    def num_centroids(self) -> int:
        return self.centroids.shape[1]

    @property
    def dsub(self) -> int:
        return self.centroids.shape[2]

    @property
    def dim(self) -> int:
        return self.num_subvectors * self.dsub


def _f32(a, dev: torch.device) -> torch.Tensor:
    """numpy -> f32 tensor on ``dev``; copies only a read-only or
    non-contiguous array (torch cannot wrap those)."""
    return torch.from_numpy(np.require(a, np.float32, ("C", "W"))).to(dev)


def _split(x: torch.Tensor, s: int) -> torch.Tensor:
    """[n, dim] -> [S, n, dsub] subspace-major copy."""
    n, dim = x.shape
    return x.reshape(n, s, dim // s).transpose(0, 1).contiguous()


def _chunks(n: int, s: int, k: int):
    step = max(1, _CHUNK_ELEMS // max(s * k, 1))
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def _nearest(xs: torch.Tensor, cent: torch.Tensor, c_sq: torch.Tensor):
    """xs [S, B, dsub] -> [S, B] int64 nearest centroid per subspace."""
    dots = torch.bmm(xs, cent.transpose(1, 2))  # [S, B, K]
    return torch.argmin(c_sq[:, None, :] - 2.0 * dots, dim=2)


def _assign(xs: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Codes of xs [S, n, dsub] under cent [S, K, dsub] -> [S, n] uint8."""
    s, n, _ = xs.shape
    c_sq = (cent * cent).sum(2)
    out = torch.empty((s, n), dtype=torch.uint8, device=xs.device)
    for a, b in _chunks(n, s, cent.shape[1]):
        out[:, a:b] = _nearest(xs[:, a:b], cent, c_sq)
    return out


def _kmeans(xs: torch.Tensor, cent: torch.Tensor, iters: int) -> torch.Tensor:
    """Lloyd iterations for every subspace at once (the reference's
    ``_kmeans_one_subspace``, vmapped). xs [S, n, dsub], cent [S, K, dsub].

    Sums and counts come from a one-hot [S, B, K] block contracted with the
    rows, as in the reference (deterministic, unlike atomic scatters). Empty
    clusters keep their previous centroid.
    """
    for _ in range(iters):
        sums, counts = _lloyd_stats(xs, cent)
        new = sums / torch.clamp(counts, min=1.0)[:, :, None]
        cent = torch.where((counts > 0)[:, :, None], new, cent)
    return cent


def _lloyd_stats(xs: torch.Tensor, cent: torch.Tensor):
    """One Lloyd assignment of xs [S, n, dsub] under cent [S, K, dsub] ->
    (per-centroid sums [S, K, dsub], counts [S, K])."""
    s, n, _ = xs.shape
    k = cent.shape[1]
    c_sq = (cent * cent).sum(2)
    sums = torch.zeros_like(cent)
    counts = torch.zeros((s, k), dtype=cent.dtype, device=cent.device)
    for a, b in _chunks(n, s, k):
        x = xs[:, a:b]
        oh = torch.zeros((s, b - a, k), dtype=cent.dtype, device=cent.device)
        oh.scatter_(2, _nearest(x, cent, c_sq)[:, :, None], 1.0)
        counts += oh.sum(1)
        sums += torch.bmm(oh.transpose(1, 2), x)
    return sums, counts


def _assign_decode(xr: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Encode + decode in one pass: xr [n, dim] (rotated space) -> [n, dim]
    f32 reconstruction from the bf16-rounded centroids (the reference's
    one-hot decode multiplies bf16 centroids)."""
    n, dim = xr.shape
    s = cent.shape[0]
    codes = _assign(_split(xr, s), cent).long()  # [S, n]
    cb = cent.to(torch.bfloat16).float()
    sub = torch.arange(s, device=cent.device)[:, None]
    return cb[sub, codes].transpose(0, 1).reshape(n, dim)


def _train_opq(data: torch.Tensor, cent: torch.Tensor, iters: int,
               opq_iters: int):
    """OPQ (the reference's ``_train_opq_jit`` from a given init): alternate
    a few Lloyd iterations on X R with the orthogonal Procrustes update
    R = U V^T of svd(X^T Y), Y the reconstruction of X R; then a full Lloyd
    polish at the final rotation. Returns (centroids, rotation)."""
    s = cent.shape[0]
    rot = torch.eye(data.shape[1], dtype=torch.float32, device=data.device)
    for _ in range(opq_iters):
        xr = data @ rot
        cent = _kmeans(_split(xr, s), cent, _OPQ_INNER)
        y = _assign_decode(xr, cent)
        u, _, vt = torch.linalg.svd(data.T @ y, full_matrices=False)
        rot = u @ vt
    cent = _kmeans(_split(data @ rot, s), cent, iters)
    return cent, rot


def init_rows(n: int, num_centroids: int, seed: int) -> torch.Tensor:
    """Row ids of the k-means init: a random sample without replacement
    (with replacement when n < K), drawn on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    if n >= num_centroids:
        return torch.randperm(n, generator=gen)[:num_centroids]
    return torch.randint(0, n, (num_centroids,), generator=gen)


def train_codebook(
    data: np.ndarray,
    num_subvectors: int,
    num_centroids: int = 256,
    iters: int = 25,
    seed: int = 0,
    rotate: bool = False,
    opq_iters: int = 16,
    device: str | torch.device | None = None,
) -> PQCodebook:
    """Train a PQ codebook by per-subspace k-means on ``device``.

    ``rotate=True`` learns an OPQ rotation jointly (same code bytes, lower
    quantisation error on data with correlated dimensions).
    """
    data = np.asarray(data, np.float32)
    n, dim = data.shape
    if dim % num_subvectors:
        raise ValueError(f"dim {dim} not divisible by num_subvectors {num_subvectors}")
    if num_centroids > 256:
        raise ValueError("codes are uint8; num_centroids must be <= 256")
    dev = resolve_device(device)
    x = _f32(data, dev)
    idx = init_rows(n, num_centroids, seed).to(dev)
    init = _split(x[idx], num_subvectors)  # [S, K, dsub]
    if rotate:
        cent, rot = _train_opq(x, init, iters, opq_iters)
        return PQCodebook(centroids=cent.cpu().numpy(),
                          rotation=rot.cpu().numpy())
    cent = _kmeans(_split(x, num_subvectors), init, iters)
    return PQCodebook(centroids=cent.cpu().numpy())


def pq_encode(data, codebook: PQCodebook,
              device: str | torch.device | None = None) -> np.ndarray:
    """Vectors [n, dim] -> codes [n, S] uint8 (rotated first under OPQ)."""
    dev = resolve_device(device)
    x = _f32(data, dev)
    if codebook.rotation is not None:
        x = x @ _f32(codebook.rotation, dev)
    cent = _f32(codebook.centroids, dev)
    codes = _assign(_split(x, codebook.num_subvectors), cent)
    return codes.T.contiguous().cpu().numpy()


def pq_decode(codes, codebook: PQCodebook) -> np.ndarray:
    """Codes [n, S] -> f32 reconstructions [n, dim] in the ORIGINAL space
    (rotation undone); numpy, on the host."""
    codes = np.asarray(codes)
    cent = codebook.centroids
    n, s = codes.shape
    out = cent[np.arange(s)[None, :], codes]  # [n, S, dsub]
    out = out.reshape(n, s * cent.shape[2]).astype(np.float32)
    if codebook.rotation is not None:
        out = out @ np.asarray(codebook.rotation, np.float32).T
    return out


def adc_lut(queries: torch.Tensor, centroids: torch.Tensor,
            metric: Metric | int) -> torch.Tensor:
    """Per-query ADC tables [Q, S, K] from queries [Q, dim] and centroids
    [S, K, dsub]: l2sq ``|q_s - c_sk|^2`` (summed over s: the distance to
    the decoded row), cos ``q_s . c_sk`` (a dot, combined with norms)."""
    qn = queries.shape[0]
    s, _, dsub = centroids.shape
    qs = queries.float().reshape(qn, s, dsub)
    dots = torch.einsum("qsd,skd->qsk", qs, centroids)
    if Metric(metric) == Metric.COS:
        return dots
    c_sq = (centroids * centroids).sum(2)  # [S, K]
    q_sq = (qs * qs).sum(2)  # [Q, S]
    return q_sq[:, :, None] - 2.0 * dots + c_sq[None, :, :]


def adc_distances(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Sum LUT entries for candidate codes: lut [Q, S, K], codes [Q, C, S]
    -> [Q, C] f32, ``sum_s lut[q, s, codes[q, c, s]]``."""
    return lut.gather(2, codes.transpose(1, 2).long()).sum(1)


def _chunk_stats(x: torch.Tensor, cent: torch.Tensor, rot, want_xty: bool):
    """One streamed Lloyd step over a row chunk x [B, dim] f32 on the
    device: (sums [S, K, dsub], counts [S, K], X^T Y [dim, dim] or None),
    Y the reconstruction of X R from the bf16-rounded centroids (the
    reference's one-hot decode)."""
    xr = x if rot is None else x @ rot
    sums, counts = _lloyd_stats(_split(xr, cent.shape[0]), cent)
    xty = x.T @ _assign_decode(xr, cent) if want_xty else None
    return sums, counts, xty


def train_codebook_chunked(
    chunks,
    num_subvectors: int,
    num_centroids: int = 256,
    iters: int = 8,
    seed: int = 0,
    rotate: bool = False,
    resume_path: str | None = None,
    chunk_rows: int = 65536,
    device: str | torch.device | None = None,
) -> PQCodebook:
    """Streamed, resumable PQ training: exact Lloyd passes over row chunks,
    never holding the dataset in memory.

    ``chunks``: a ``.fvecs``/``.fvecs.gz`` path (streamed), a ``.npy`` path
    (memory-mapped), or a zero-argument callable returning an iterator of
    [B, dim] f32 blocks (a fresh iterator per pass).

    Each pass sums every chunk's per-subspace assignments (and, with
    ``rotate=True``, the X^T Y product for the Procrustes rotation update)
    on ``device``; centroids and rotation are updated at the pass's end, so
    the result is in-RAM Lloyd / OPQ at O(chunk) memory.

    ``resume_path``: the whole state is written atomically after every
    pass; a run with the same arguments resumes from the last finished pass
    and ends bit-identical to an unbroken one. The file is the reference's
    (``np.savez``), so either package resumes the other's.
    """
    if num_centroids > 256:
        raise ValueError("codes are uint8; num_centroids must be <= 256")
    dev = resolve_device(device)
    factory = _chunk_factory(chunks, chunk_rows)

    start_pass = 0
    cent = rot = None
    if resume_path and os.path.exists(resume_path):
        with np.load(resume_path, allow_pickle=False) as st:
            if int(st["seed"]) != seed or int(st["num_centroids"]) != num_centroids \
                    or int(st["num_subvectors"]) != num_subvectors:
                raise ValueError(
                    "resume state does not match the training arguments")
            cent = st["centroids"].copy()
            rot = st["rotation"].copy() if bool(st["has_rotation"]) else None
            start_pass = int(st["next_pass"])

    if cent is None:
        # init: random rows of the first chunk(s), drawn by numpy from seed
        rows = []
        got = 0
        for blk in factory():
            rows.append(np.asarray(blk, np.float32))
            got += len(blk)
            if got >= max(num_centroids, 4096):
                break
        if not rows:
            raise ValueError("empty training stream")
        first = np.concatenate(rows)[: max(num_centroids, 4096)]
        n0, dim = first.shape
        if dim % num_subvectors:
            raise ValueError(
                f"dim {dim} not divisible by num_subvectors {num_subvectors}")
        dsub = dim // num_subvectors
        rng = np.random.default_rng(seed)
        idx = rng.choice(n0, num_centroids, replace=n0 < num_centroids)
        cent = (first[idx].reshape(num_centroids, num_subvectors, dsub)
                .transpose(1, 0, 2).copy())
        rot = np.eye(dim, dtype=np.float32) if rotate else None

    dim = cent.shape[0] * cent.shape[2]
    for p in range(start_pass, iters):
        sums = np.zeros(cent.shape, np.float32)
        counts = np.zeros(cent.shape[:2], np.float32)
        xty = np.zeros((dim, dim), np.float32)
        cent_dev = _f32(cent, dev)
        rot_dev = _f32(rot, dev) if rot is not None else None
        for blk in factory():
            sm, cnt, xy = _chunk_stats(_f32(blk, dev), cent_dev, rot_dev,
                                       rotate)
            sums += sm.cpu().numpy()
            counts += cnt.cpu().numpy()
            if rotate:
                xty += xy.cpu().numpy()
        new = sums / np.maximum(counts, 1.0)[:, :, None]
        cent = np.where((counts > 0)[:, :, None], new, cent).astype(np.float32)
        if rotate:
            u, _, vt = np.linalg.svd(xty, full_matrices=False)
            rot = (u @ vt).astype(np.float32)
        if resume_path:
            tmp = resume_path + ".tmp"
            np.savez(
                tmp,
                centroids=cent,
                rotation=rot if rot is not None else np.zeros(0, np.float32),
                has_rotation=rot is not None,
                next_pass=p + 1,
                seed=seed,
                num_centroids=num_centroids,
                num_subvectors=num_subvectors,
            )
            # np.savez appends .npz when the name lacks it
            src = tmp if os.path.exists(tmp) else tmp + ".npz"
            os.replace(src, resume_path)
    return PQCodebook(centroids=cent, rotation=rot)


def _chunk_factory(chunks, chunk_rows: int):
    """The chunk source as a zero-argument factory of block iterators."""
    if callable(chunks):
        return chunks
    path = str(chunks)
    if path.endswith((".fvecs", ".fvecs.gz")):
        from lantern_tpu_torch.io.dotvecs import iter_fvecs

        return lambda: iter_fvecs(path, chunk_rows)
    if path.endswith(".npy"):
        def npy_iter():
            mm = np.load(path, mmap_mode="r")
            for i in range(0, len(mm), chunk_rows):
                yield np.asarray(mm[i : i + chunk_rows], np.float32)

        return npy_iter
    raise ValueError(
        "chunks must be a callable, an .fvecs(.gz) path, or an .npy path")


# ---- pqvec codecs (the reference's pqvec type and its casts) ------------
# a length-prefixed byte value of uint8 codes, with array casts

_PQVEC_MAGIC = 0x7051  # 'Pq'


def array_to_pqvec(codes) -> bytes:
    """[S] uint8 codes -> packed pqvec bytes (one vector only)."""
    codes = np.asarray(codes, np.uint8)
    if codes.ndim != 1:
        raise ValueError("array_to_pqvec packs one vector; got shape "
                         f"{codes.shape}")
    return struct.pack("<HH", _PQVEC_MAGIC, codes.shape[0]) + codes.tobytes()


def pqvec_to_array(raw: bytes) -> np.ndarray:
    """Packed pqvec bytes -> [S] uint8 codes."""
    magic, s = struct.unpack("<HH", raw[:4])
    if magic != _PQVEC_MAGIC:
        raise ValueError(f"not a pqvec value (magic {magic:#x})")
    codes = np.frombuffer(raw[4 : 4 + s], np.uint8)
    if len(codes) != s:
        raise ValueError("pqvec value truncated")
    return codes.copy()


def quantize_vector(vec, codebook: PQCodebook,
                    device: str | torch.device | None = None) -> bytes:
    """One vector -> pqvec bytes (the SQL ``quantize_vector``)."""
    return array_to_pqvec(pq_encode(np.asarray(vec, np.float32)[None],
                                    codebook, device=device)[0])


def dequantize_vector(raw: bytes, codebook: PQCodebook) -> np.ndarray:
    """pqvec bytes -> the reconstructed vector (the SQL
    ``dequantize_vector``)."""
    return pq_decode(pqvec_to_array(raw)[None], codebook)[0]
