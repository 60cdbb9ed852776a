"""Exact row top-k of a [Q, N] f32 score block, ties to the lower position.

``row_topk(scores, k)`` returns (values [Q, k] f32, positions [Q, k] int64):
each row's k best entries, best first. The order is total: a larger score
first; equal scores in ascending position; NaN above +inf (as ``torch.topk``
ranks it); -0.0 equal to +0.0. So a row with fewer than k entries above -inf
returns its -inf entries at the lowest remaining positions, and a caller
that keeps ids in ascending position gets the lower id of every tie. The
values are the selected entries themselves, bit for bit.

On CUDA tensors it launches the hand-written kernel ``csrc/row_topk.cu``
(built at first use; one read of the block, see its note) and counts each
launch in ``row_topk.launches``; a build or launch failure raises, with no
fallback. One launch selects up to ``KMAX`` entries a row, which covers
search k (up to 1000), entry seeds, ef_construction (up to 400) and the
default rerank shortlist (100). A larger k (a deep PQ rerank shortlist:
``calibrate_rerank``'s ladder runs to 2400) takes ceil(k / ``KMAX``)
launches, each selecting the next ``KMAX`` of every row below the last
one's k-th, so each reads the block once more. On CPU tensors it runs
``row_topk_ref``, the plain PyTorch version of the same order.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from lantern_tpu_torch.utils.bench import launch

KMAX = 1024  # the most entries of a row one launch selects
# kernel 1's blocks to aim for: about two waves of 6 resident blocks on each
# of the H100's 132 SMs. Each slice pays for filling its buffer and a last
# sort, so fewer, longer slices win until the card runs short of blocks
TARGET_BLOCKS = 2048
MERGE_MAX = 16384  # candidates kernel 2 sorts a row in shared memory (128 KiB)
CAP_MIN = 512  # kernel 1's buffer: this many candidates, or 2 kp where more
# entries of a block the plain version keys at a time: its int64
# temporaries stay near 64 MiB each, whatever the block's size
_REF_GROUP = 1 << 23

_TOP = 1 << 32


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: kernel 1 keeps ``kp`` candidates of each of a row's
    ``slices`` slices of ``slice_len`` entries, in a shared buffer of
    ``cap``; kernel 2 sorts a row's ``merge`` (padded) candidates with
    ``merge_threads`` threads."""

    kp: int
    cap: int
    slices: int
    slice_len: int
    merge: int
    merge_threads: int


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def plan(q: int, n: int, k: int, step: int) -> Plan:
    """The launch for a [q, n] block at k (1 <= k <= min(n, KMAX)), for a
    kernel 1 that reads ``step`` entries a step (``step()`` on the card):
    enough slices for about ``TARGET_BLOCKS`` blocks, each a whole number
    of steps, no more than the row has steps or kernel 2 can merge."""
    kp = max(16, _pow2_at_least(k))
    steps = -(-n // step)
    slices = max(1, min(-(-TARGET_BLOCKS // q), steps, MERGE_MAX // kp))
    slice_len = -(-steps // slices) * step
    slices = -(-n // slice_len)
    merge = _pow2_at_least(slices * kp)
    return Plan(kp=kp, cap=max(CAP_MIN, 2 * kp), slices=slices,
                slice_len=slice_len, merge=merge,
                merge_threads=min(1024, max(32, merge // 2)))


def order_keys(scores: torch.Tensor) -> torch.Tensor:
    """Each f32 entry's rank key as int64 in [0, 2^32): larger is better,
    NaN the largest, -0.0 equal to +0.0 (the kernel's ``order_key``)."""
    s = scores.contiguous()
    bits = s.view(torch.int32).long() & (_TOP - 1)
    bits = bits.masked_fill(s == 0, 0)
    key = torch.where(bits >= (1 << 31), (_TOP - 1) - bits, bits | (1 << 31))
    return key.masked_fill(torch.isnan(s), _TOP - 1)


def row_topk_ref(scores: torch.Tensor, k: int):
    """Plain PyTorch version of ``row_topk``: ``torch.topk`` on one int64
    key an entry that orders (score, then lower position) and is never
    equal for two entries of a row, then the values gathered back; in
    groups of rows of about ``_REF_GROUP`` entries."""
    q, n = scores.shape
    values = scores.new_empty((q, k))
    positions = torch.empty((q, k), dtype=torch.int64, device=scores.device)
    pos = torch.arange(n, device=scores.device)
    rows = max(1, _REF_GROUP // max(n, 1))
    for r0 in range(0, q, rows):
        s = scores[r0:r0 + rows]
        # (key - 2^31) * 2^32 + (2^32 - 1 - pos) spans int64 in the right order
        comp = (order_keys(s) - (1 << 31)) * _TOP + ((_TOP - 1) - pos)
        top = torch.topk(comp, k, dim=1, sorted=True).values
        del comp
        p = (_TOP - 1) - (top & (_TOP - 1))
        positions[r0:r0 + rows] = p
        values[r0:r0 + rows] = torch.gather(s, 1, p)
    return values, positions


@functools.cache
def _kernel():
    """The built kernel's C entry point (nvcc runs on the first call)."""
    from lantern_tpu_torch.csrc.build import cuda_library

    lib = cuda_library("row_topk")
    fn = lib.ldb_row_topk
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
                   + [ctypes.c_int] * 3 + [ctypes.c_int64]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
    lib.ldb_row_topk_step.restype = ctypes.c_int
    return fn, lib.ldb_row_topk_step()


def step() -> int:
    """Entries a block of the built kernel 1 reads a step (builds it)."""
    return _kernel()[1]


def _launch(scores: torch.Tensor, k: int):
    """The CUDA kernels' launches, one for each ``KMAX`` of k. Raises on
    what they do not take: a non-contiguous block, or one of 2^32 columns
    or more."""
    if not scores.is_contiguous():
        raise ValueError("scores must be contiguous")
    q, n = scores.shape
    if n >= _TOP:
        raise ValueError(f"the kernel takes under 2^32 columns, got {n}")
    dev = scores.device
    fn, chunk = _kernel()
    values = torch.empty((q, k), dtype=torch.float32, device=dev)
    positions = torch.empty((q, k), dtype=torch.int64, device=dev)
    # each row's last selected candidate, the next launch's ceiling
    below = torch.empty(q, dtype=torch.int64, device=dev) if k > KMAX else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    for start in range(0, k, KMAX):
        kk = min(KMAX, k - start)
        p = plan(q, n, kk, chunk)
        cand = torch.empty((q, p.slices * p.kp), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev), launch("row_topk.launch"):
            rc = fn(scores.data_ptr(), q, n, kk, p.kp, p.cap, p.slice_len,
                    p.slices, p.merge, p.merge_threads, cand.data_ptr(),
                    values[:, start:].data_ptr(),
                    positions[:, start:].data_ptr(), k,
                    None if below is None else below.data_ptr(),
                    int(start > 0), stream)
        if rc != 0:
            raise RuntimeError(f"row_topk kernel launch failed: CUDA error {rc}")
        row_topk.launches += 1
    return values, positions


def row_topk(scores: torch.Tensor, k: int):
    """Each row's k best entries of a [Q, N] f32 block, best first, ties in
    ascending position: (values [Q, k] f32, positions [Q, k] int64). The
    kernel on CUDA tensors, ``row_topk_ref`` on CPU ones."""
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(f"need a [Q, N] float32 block, got {scores.dtype} "
                         f"{tuple(scores.shape)}")
    q, n = scores.shape
    if not 0 <= k <= n:
        raise ValueError(f"k must lie in [0, {n}], got {k}")
    if not scores.is_cuda:
        return row_topk_ref(scores, k)
    if q == 0 or k == 0:
        return (scores.new_empty((q, k)),
                torch.empty((q, k), dtype=torch.int64, device=scores.device))
    return _launch(scores, k)


row_topk.launches = 0
