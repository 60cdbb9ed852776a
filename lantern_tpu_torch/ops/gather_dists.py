"""K1: the beam's fused gather + distance (port of ops/pallas_gather.py).

``gather_dists`` computes ``out[q, c] = dist(queries[q], vectors[ids[q, c]])``
for l2sq and cosine over f32 or bf16 rows. On CUDA tensors it launches the
hand-written Hopper kernel ``csrc/gather_dists.cu`` (built at first use) and
counts the launch in ``gather_dists.launches``; on CPU tensors it runs
``gather_dists_ref``, the plain PyTorch version of the same function. A CUDA
call never falls back to the plain version: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lantern_tpu_torch.config import Metric
from lantern_tpu_torch.utils.bench import launch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def gather_dists_ref(vectors: torch.Tensor, ids: torch.Tensor,
                     queries: torch.Tensor, q_sq: torch.Tensor,
                     metric: Metric | int = Metric.L2SQ) -> torch.Tensor:
    """Plain PyTorch version of K1: a row gather, an einsum and the same
    l2sq/cos formulas as the kernel (|x|^2 from the gathered rows)."""
    rows = vectors[ids].float()  # [Q, C, d]
    dots = torch.einsum("qd,qcd->qc", queries.float(), rows)
    norms = (rows * rows).sum(-1)
    if Metric(metric) == Metric.L2SQ:
        return q_sq[:, None] - 2.0 * dots + norms
    den = torch.sqrt(q_sq)[:, None] * torch.sqrt(norms)
    return 1.0 - dots / torch.clamp(den, min=1e-30)


@functools.cache
def _kernel():
    """The built kernel's C entry point (nvcc runs on the first call)."""
    from lantern_tpu_torch.csrc.build import cuda_library

    fn = cuda_library("gather_dists").ldb_gather_dists
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_int] * 6
        + [ctypes.c_void_p]
    )
    return fn


def gather_dists(vectors: torch.Tensor, ids: torch.Tensor,
                 queries: torch.Tensor, q_sq: torch.Tensor,
                 metric: Metric | int = Metric.L2SQ) -> torch.Tensor:
    """Fused candidate distances -> [Q, C] f32.

    vectors [N, d] f32/bf16; ids [Q, C] int32, pre-clipped to [0, N) (the
    kernel writes NaN for an id outside it and never reads that row);
    queries [Q, d] f32; q_sq [Q] f32 (|q|^2).
    """
    metric = Metric(metric)
    if metric not in (Metric.L2SQ, Metric.COS):
        raise ValueError(f"gather_dists serves l2sq and cos, not {metric.name}")
    if not vectors.is_cuda:
        return gather_dists_ref(vectors, ids, queries, q_sq, metric)
    dev = vectors.device
    for name, t in (("ids", ids), ("queries", queries), ("q_sq", q_sq)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, vectors on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if vectors.dtype not in _DTYPE_CODES or not vectors.is_contiguous():
        raise ValueError(
            f"vectors must be contiguous f32 or bf16, got {vectors.dtype}"
        )
    if ids.dtype != torch.int32 or queries.dtype != torch.float32 or (
        q_sq.dtype != torch.float32
    ):
        raise ValueError("ids must be int32; queries and q_sq float32")
    n, d = vectors.shape
    q, c = ids.shape
    if queries.shape != (q, d) or q_sq.shape != (q,):
        raise ValueError(
            f"shapes disagree: vectors {tuple(vectors.shape)}, ids "
            f"{tuple(ids.shape)}, queries {tuple(queries.shape)}, q_sq "
            f"{tuple(q_sq.shape)}"
        )
    if d * 4 > 48 * 1024:
        raise ValueError(f"gather_dists supports d <= 12288, got {d}")
    out = torch.empty((q, c), dtype=torch.float32, device=dev)
    if q == 0 or c == 0:
        return out
    per_vec = 4 if vectors.dtype == torch.float32 else 8
    vec = int(d % per_vec == 0 and vectors.data_ptr() % 16 == 0)
    with torch.cuda.device(dev), launch("k1.launch"):
        rc = _kernel()(
            vectors.data_ptr(), ids.data_ptr(), queries.data_ptr(),
            q_sq.data_ptr(), out.data_ptr(), n, d, q, c,
            _DTYPE_CODES[vectors.dtype], int(metric), vec,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gather_dists kernel launch failed: CUDA error {rc}")
    gather_dists.launches += 1
    return out


gather_dists.launches = 0
