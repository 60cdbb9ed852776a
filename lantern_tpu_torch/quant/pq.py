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
- Search uses asymmetric distances: a per-query table LUT ``[Q, S, K]`` of
  partial distances, summed over the candidate's codes. The reference sums
  them by a one-hot matmul on the TPU's matrix unit; here it is a gather.

Entry points that take numpy data run on ``cuda`` unless ``device="cpu"``.
On the card, matmuls are full f32 unless TF32 was switched on.
"""

from __future__ import annotations

import dataclasses

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
    s, n, dsub = xs.shape
    k = cent.shape[1]
    for _ in range(iters):
        c_sq = (cent * cent).sum(2)
        sums = torch.zeros_like(cent)
        counts = torch.zeros((s, k), dtype=cent.dtype, device=cent.device)
        for a, b in _chunks(n, s, k):
            x = xs[:, a:b]
            oh = torch.zeros((s, b - a, k), dtype=cent.dtype, device=cent.device)
            oh.scatter_(2, _nearest(x, cent, c_sq)[:, :, None], 1.0)
            counts += oh.sum(1)
            sums += torch.bmm(oh.transpose(1, 2), x)
        new = sums / torch.clamp(counts, min=1.0)[:, :, None]
        cent = torch.where((counts > 0)[:, :, None], new, cent)
    return cent


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
