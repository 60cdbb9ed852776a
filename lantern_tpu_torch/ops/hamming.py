"""K4: all-pairs hamming distances over packed bit words (port of
lantern_tpu/ops/pallas_kernels.py::hamming_block and hamming_exact_topk).

``hamming_block(queries, base)`` computes ``out[q, n] = sum_w popcount(
queries[q, w] XOR base[n, w])`` as f32 (exact: counts <= 32 W). Packed words
are int32 tensors carrying the uint32 bits, 4 bytes a word; a word with its
top bit set is negative as an int32 and counts the same 32 bits.

On CUDA tensors it launches the hand-written Hopper kernel
``csrc/hamming.cu`` (the +-1 product on the int8 tensor cores, built at first
use) and counts the launch in ``hamming_block.launches``; on CPU tensors it
runs ``hamming_block_ref``, the plain PyTorch version. A CUDA call never
falls back: a build or launch failure raises. ``hamming_scores`` is the flat
scan's score block, ``-hamming_block`` with -inf at deleted rows, from the
same kernel's score epilogue (plain version ``hamming_scores_ref``).
``hamming_exact_topk`` is the exact hamming k-NN oracle over a large base:
one ``hamming_block`` per block of rows and a running top-k.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lantern_tpu_torch.utils.bench import launch

_U32 = 0xFFFFFFFF
# elements of the plain version's [Q, rows, W] int64 XOR block (128 MiB; the
# popcount keeps up to three such buffers alive): bounds its working set at
# any shape, so it can run on the card at the flat scan's shape
_REF_CHUNK_ELEMS = 1 << 24
# widest rows the CUDA kernel takes (its int32 counts hold 32 W' exactly)
_MAX_WORDS = 1 << 20


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """Words as their unsigned 32-bit values, in int64 (any integer dtype
    in; int32 words with the top bit set come out >= 2^31)."""
    return x.to(torch.int64) & _U32


def _popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit words held in int64 -> int32 counts."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & _U32) >> 24).to(torch.int32)


def to_words(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 words with the same bits."""
    return ((v ^ 0x80000000) - 0x80000000).to(torch.int32)


def hamming_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bit-level hamming distance between packed word arrays (hnsw.c:383-395),
    broadcasting over leading dimensions; widens the words to int64."""
    x = torch.bitwise_xor(_as_u32(a), _as_u32(b))
    return _popcount_u32(x).sum(-1).float()


def hamming_block_ref(queries: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: ``hamming_dist`` over chunks of base
    rows so the [Q, rows, W] int64 intermediate stays bounded."""
    q, w = queries.shape
    n = base.shape[0]
    out = torch.empty((q, n), dtype=torch.float32, device=queries.device)
    rows = max(1, _REF_CHUNK_ELEMS // max(1, q * w))
    for start in range(0, n, rows):
        out[:, start:start + rows] = hamming_dist(
            queries[:, None, :], base[start:start + rows][None])
    return out


def hamming_scores_ref(queries: torch.Tensor, base: torch.Tensor,
                       deleted: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``hamming_scores``: the negated distances,
    -inf at the rows ``deleted`` marks."""
    s = hamming_block_ref(queries, base).neg_()
    if deleted is not None:
        s.masked_fill_(deleted[None, :], float("-inf"))
    return s


@functools.cache
def _kernel():
    """The built kernel's C entry point (nvcc runs on the first call)."""
    from lantern_tpu_torch.csrc.build import cuda_library

    fn = cuda_library("hamming").ldb_hamming_block
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_void_p]
    )
    return fn


def _check_words(queries: torch.Tensor, base: torch.Tensor) -> None:
    if queries.dim() != 2 or base.dim() != 2 or queries.shape[1] != base.shape[1]:
        raise ValueError(
            f"need [Q, W] and [N, W] words, got {tuple(queries.shape)} and "
            f"{tuple(base.shape)}")


def _launch(queries: torch.Tensor, base: torch.Tensor,
            deleted: torch.Tensor | None, scores: bool) -> torch.Tensor:
    """One launch of the CUDA kernel: distances, or (``scores``) negated
    distances with -inf at deleted rows. Checks what the kernel takes."""
    dev = base.device
    if queries.device != dev:
        raise ValueError(f"queries are on {queries.device}, base on {dev}")
    if queries.dtype != torch.int32 or base.dtype != torch.int32:
        raise ValueError(f"words must be int32, got {queries.dtype} and "
                         f"{base.dtype}")
    if not (queries.is_contiguous() and base.is_contiguous()):
        raise ValueError("queries and base must be contiguous")
    q, w = queries.shape
    n = base.shape[0]
    if w > _MAX_WORDS:
        raise ValueError(f"hamming kernels take at most {_MAX_WORDS} words a "
                         f"row, got {w}")
    if deleted is not None and (
            deleted.dtype != torch.bool or deleted.shape != (n,)
            or deleted.device != dev or not deleted.is_contiguous()):
        raise ValueError(
            f"deleted must be a contiguous [{n}] bool tensor on {dev}, got "
            f"{deleted.dtype} {tuple(deleted.shape)} on {deleted.device}")
    out = torch.empty((q, n), dtype=torch.float32, device=dev)
    if q == 0 or n == 0:
        return out
    vec = int(w % 4 == 0 and queries.data_ptr() % 16 == 0
              and base.data_ptr() % 16 == 0)
    with torch.cuda.device(dev), launch("k4.launch"):
        rc = _kernel()(
            queries.data_ptr(), base.data_ptr(),
            None if deleted is None else deleted.data_ptr(), out.data_ptr(),
            q, n, w, vec, int(scores),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"hamming kernel launch failed: CUDA error {rc}")
    hamming_block.launches += 1
    return out


def hamming_block(queries: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """All-pairs hamming distances: [Q, W] x [N, W] packed words -> [Q, N]
    f32.

    On CUDA both operands are contiguous int32 words on one device; the
    plain CPU version takes any integer dtype holding 32-bit words.
    """
    _check_words(queries, base)
    if not base.is_cuda:
        return hamming_block_ref(queries, base)
    return _launch(queries, base, None, scores=False)


hamming_block.launches = 0


def hamming_scores(queries: torch.Tensor, base: torch.Tensor,
                   deleted: torch.Tensor | None = None) -> torch.Tensor:
    """The hamming flat scan's score block: [Q, N] f32 equal to
    ``-hamming_block(queries, base)``, with -inf at the rows where
    ``deleted`` ([N] bool) is set.

    On CUDA it is K4's launch with the score epilogue (one pass over the
    block; counted in ``hamming_block.launches``); on CPU tensors it runs
    ``hamming_scores_ref``.
    """
    _check_words(queries, base)
    if not base.is_cuda:
        return hamming_scores_ref(queries, base, deleted)
    return _launch(queries, base, deleted, scores=True)


def hamming_exact_topk(queries: torch.Tensor, base: torch.Tensor, k: int,
                       block_n: int = 65536):
    """Exact hamming k-NN over a large packed base without a [Q, N] block:
    ``exact_search``'s running top-k over ``block_n``-row blocks, each scored
    by ``hamming_block``. Returns (dists [Q, min(k, N)] f32 ascending, ids
    int32). Tied distances may come in any id order."""
    from lantern_tpu_torch.config import Metric
    from lantern_tpu_torch.ops.distance import exact_search

    return exact_search(queries, base, k, Metric.HAMMING, block=block_n)
