"""PQ decode: kernels K2, K3, K5 and K6 of the reference in one.

``pq_decode(codes, centroids_bf16, want_xsq)`` returns the decoded rows
``out[n] = concat_s centroids_bf16[s, codes[n, s]]`` ([N, S*dsub] bf16) and,
when asked, their |x|^2 ([N] f32, the sum of squares of the bf16 values).
It replaces ``lantern_tpu/ops/pallas_kernels.py::pq_decode_mxu_hilo`` (K2),
``::pq_decode_mxu`` (K3), ``benchmarks/exp_hilo_v2.py::pq_decode_hilo_v2``
(K5) and ``benchmarks/exp_hilo_v3.py::pq_decode_hilo_v3`` (K6, whose
``xsq=True`` output is ``want_xsq``): all four compute this function, bit for
bit, from the bf16-rounded codebook (``codebook_bf16``).

On CUDA tensors it launches the hand-written Hopper kernel
``csrc/pq_decode.cu`` (built at first use) and counts the launch in
``pq_decode.launches``; on CPU tensors it runs ``pq_decode_ref``, the plain
PyTorch version. A CUDA call never falls back: a build or launch failure
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lantern_tpu_torch.utils.bench import launch


def codebook_bf16(centroids: torch.Tensor) -> torch.Tensor:
    """The decode operand: the f32 codebook [S, K, dsub] rounded once to
    bf16 (round-to-nearest-even, the reference's ``astype(bfloat16)``)."""
    return centroids.to(torch.bfloat16).contiguous()


def pq_decode_ref(codes: torch.Tensor, centroids_bf16: torch.Tensor,
                  want_xsq: bool = False):
    """Plain PyTorch version: index the bf16 codebook, then
    ``(dec.float() ** 2).sum(1)``. A code >= K decodes to zeros."""
    n, s = codes.shape
    k, dsub = centroids_bf16.shape[1:]
    c = codes.long()
    sub = torch.arange(s, device=codes.device)
    dec = centroids_bf16[sub[None, :], torch.clamp(c, max=k - 1)]  # [N, S, dsub]
    dec = torch.where((c < k)[:, :, None], dec, torch.zeros_like(dec))
    dec = dec.reshape(n, s * dsub)
    return dec, ((dec.float() ** 2).sum(1) if want_xsq else None)


@functools.cache
def _kernel():
    """The built kernel's C entry point (nvcc runs on the first call)."""
    from lantern_tpu_torch.csrc.build import cuda_library

    fn = cuda_library("pq_decode").ldb_pq_decode
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 3
        + [ctypes.c_void_p]
    )
    return fn


_PLAN_KEYS = ("vec", "epv", "slices", "slice_subs", "lanes", "tile_rows",
              "stages", "threads", "blocks", "smem", "tiles", "cluster")


def decode_plan(n: int, s: int, k: int, dsub: int, want_xsq: bool = True):
    """The launch the kernel makes for these shapes on the current CUDA
    device, as a dict: bytes a lane stores at once (``vec``) and entries in
    one store (``epv``), codebook ``slices`` and subspaces a slice, lanes a
    row, rows a tile, ring stages, threads and blocks, dynamic shared memory
    bytes, tiles, and whether the blocks of a tile form a cluster."""
    fn = _plan_fn()
    plan = (ctypes.c_int64 * len(_PLAN_KEYS))()
    rc = fn(n, s, k, dsub, int(want_xsq), plan)
    if rc != 0:
        raise RuntimeError(f"pq_decode has no plan for n={n} S={s} K={k} "
                           f"dsub={dsub}: CUDA error {rc}")
    return dict(zip(_PLAN_KEYS, plan))


@functools.cache
def _plan_fn():
    from lantern_tpu_torch.csrc.build import cuda_library

    fn = cuda_library("pq_decode").ldb_pq_decode_plan
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int64] + [ctypes.c_int] * 4
                  + [ctypes.POINTER(ctypes.c_int64)])
    return fn


def pq_decode(codes: torch.Tensor, centroids_bf16: torch.Tensor,
              want_xsq: bool = False):
    """Decode PQ codes -> (decoded [N, S*dsub] bf16, |x|^2 [N] f32 or None).

    codes [N, S] uint8; centroids_bf16 [S, K, dsub] bf16 with K <= 256 (from
    ``codebook_bf16``, built once per search, not per block).
    """
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"codes must be [N, S] uint8, got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    if centroids_bf16.dtype != torch.bfloat16 or centroids_bf16.dim() != 3:
        raise ValueError("centroids must be a [S, K, dsub] bf16 codebook")
    n, s = codes.shape
    s2, k, dsub = centroids_bf16.shape
    if s2 != s:
        raise ValueError(f"codes have {s} subspaces, the codebook {s2}")
    if k > 256:
        raise ValueError(f"codes are bytes: K <= 256, got K = {k}")
    if not codes.is_cuda:
        return pq_decode_ref(codes, centroids_bf16, want_xsq)
    dev = codes.device
    if centroids_bf16.device != dev:
        raise ValueError(f"centroids are on {centroids_bf16.device}, codes on {dev}")
    if not (codes.is_contiguous() and centroids_bf16.is_contiguous()):
        raise ValueError("codes and centroids must be contiguous")
    out = torch.empty((n, s * dsub), dtype=torch.bfloat16, device=dev)
    xsq = torch.empty((n,), dtype=torch.float32, device=dev) if want_xsq else None
    if n == 0:
        return out, xsq
    with torch.cuda.device(dev), launch("pq_decode.launch"):
        rc = _kernel()(
            codes.data_ptr(), centroids_bf16.data_ptr(), out.data_ptr(),
            xsq.data_ptr() if want_xsq else None, n, s, k, dsub,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"pq_decode kernel launch failed: CUDA error {rc}")
    pq_decode.launches += 1
    return out, xsq


pq_decode.launches = 0
