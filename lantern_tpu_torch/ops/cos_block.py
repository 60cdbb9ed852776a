"""The flat scan's f32 cosine score block on the card's tensor cores.

``cos_block(queries, rows, sq_norms, excluded)`` forms the [Q, N] f32 block

    <queries[q], rows[n]> / max(sqrt(sq_norms[n]), 1e-30), -inf where excluded[n]

from [Q, d] f32 queries and [N, d] f32 rows. On CUDA tensors it launches the
hand-written Hopper kernel ``csrc/cos_block.cu`` (split TF32 on the tensor
cores, the divide and the mask in its epilogue; built at first use) and
counts the launch in ``cos_block.launches``; a build or launch failure
raises, with no fallback. On CPU tensors it runs ``cos_scores_ref``, the
plain PyTorch version of the same arithmetic.

The split: each operand x = hi + lo, hi = rna_tf32(x) and lo = rna_tf32(x -
hi), rounded to nearest with ties away from zero (``rna_tf32``: integer
arithmetic on the f32 bits, as ``cvt.rna.tf32.f32`` rounds). The dots are
lo_q hi_x + hi_q lo_x + hi_q hi_x, three products of TF32 values (each
exact in f32) summed in f32; the epilogue is ``flat._scaled``'s column
divide and mask, the same IEEE operations.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lantern_tpu_torch.utils.bench import launch

_TF32_HALF_ULP = 1 << 12  # the dropped 13 bits' half: rounds to nearest
_TF32_MASK = -(1 << 13)   # 0xffffe000 as an int32: the bits a TF32 value keeps


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as f32. Adding half a TF32 unit to the bit pattern
    carries into the kept bits exactly when the dropped ones are at least
    half; sign and magnitude are separate, so this holds for either sign."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + _TF32_HALF_ULP) & _TF32_MASK).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = rna_tf32(x), lo = rna_tf32(x - hi): hi + lo is x
    within about 2^-22 of |x|."""
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def split_dots(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[Q, N] f32 dots of the split operands: the two small products, then
    the large one, each a product of TF32 values summed in f32."""
    qh, ql = split_tf32(queries.float())
    xh, xl = split_tf32(rows.float())
    dots = ql @ xh.T
    dots += qh @ xl.T
    dots += qh @ xh.T
    return dots


def scale_and_mask(dots: torch.Tensor, sq_norms: torch.Tensor,
                   excluded: torch.Tensor | None) -> torch.Tensor:
    """The epilogue, in place: each column divided by max(|x|, 1e-30), then
    -inf at the ``excluded`` columns."""
    dots.div_(torch.clamp(torch.sqrt(sq_norms)[None, :], min=1e-30))
    if excluded is not None:
        dots.masked_fill_(excluded[None, :], float("-inf"))
    return dots


def cos_scores_ref(queries: torch.Tensor, rows: torch.Tensor,
                   sq_norms: torch.Tensor,
                   excluded: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``cos_block``: ``split_dots``, then the
    column divide and the mask. Run with TF32 matmuls off: every product is
    then exact and every sum f32."""
    return scale_and_mask(split_dots(queries, rows), sq_norms, excluded)


@functools.cache
def _kernel():
    """The built kernel's C entry point (nvcc runs on the first call)."""
    from lantern_tpu_torch.csrc.build import cuda_library

    fn = cuda_library("cos_block").ldb_cos_block
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p])
    return fn


def takes(rows: torch.Tensor) -> bool:
    """Whether a block of these rows is the kernel's: CUDA f32 with d % 4 ==
    0 (16-byte TMA strides). Such rows that are not contiguous reach
    ``_launch`` and raise there."""
    return rows.is_cuda and rows.dtype == torch.float32 and rows.shape[1] % 4 == 0


def _check(queries, rows, sq_norms, excluded) -> None:
    if queries.dim() != 2 or rows.dim() != 2 or queries.shape[1] != rows.shape[1]:
        raise ValueError(f"need [Q, d] queries and [N, d] rows, got "
                         f"{tuple(queries.shape)} and {tuple(rows.shape)}")
    n = rows.shape[0]
    if sq_norms.shape != (n,):
        raise ValueError(f"sq_norms must be [{n}], got {tuple(sq_norms.shape)}")
    if excluded is not None and (excluded.dtype != torch.bool
                                 or excluded.shape != (n,)):
        raise ValueError(f"excluded must be a [{n}] bool tensor, got "
                         f"{excluded.dtype} {tuple(excluded.shape)}")


def _launch(queries, rows, sq_norms, excluded) -> torch.Tensor:
    """One call of the CUDA kernel. Checks what it takes and raises on
    anything else: f32 operands on one device, contiguous, d % 4 == 0, the
    rows 16-byte aligned (the TMA's strides and addresses)."""
    dev = rows.device
    tensors = {"queries": queries, "rows": rows, "sq_norms": sq_norms}
    if excluded is not None:
        tensors["excluded"] = excluded
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rows on {dev}")
        if name != "excluded" and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    q, d = queries.shape
    n = rows.shape[0]
    if d % 4 != 0:
        raise ValueError(f"the kernel takes d % 4 == 0, got d = {d}")
    if rows.data_ptr() % 16 != 0:
        raise ValueError("rows must start on a 16-byte boundary")
    out = torch.empty((q, n), dtype=torch.float32, device=dev)
    if q == 0 or n == 0:
        return out
    split = torch.empty((2, q, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), launch("cos_block.launch"):
        rc = _kernel()(
            queries.data_ptr(), rows.data_ptr(), sq_norms.data_ptr(),
            None if excluded is None else excluded.data_ptr(),
            out.data_ptr(), split.data_ptr(), q, n, d,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"cos_block kernel launch failed: CUDA error {rc}")
    cos_block.launches += 1
    return out


def cos_block(queries: torch.Tensor, rows: torch.Tensor,
              sq_norms: torch.Tensor,
              excluded: torch.Tensor | None = None) -> torch.Tensor:
    """The f32 cosine score block: [Q, d] queries x [N, d] rows -> [Q, N] f32
    ``<q, x> / max(sqrt(sq_norms), 1e-30)``, -inf where ``excluded`` ([N]
    bool) is set. The kernel on CUDA tensors, ``cos_scores_ref`` on CPU ones.
    """
    _check(queries, rows, sq_norms, excluded)
    if not rows.is_cuda:
        return cos_scores_ref(queries, rows, sq_norms, excluded)
    return _launch(queries, rows, sq_norms, excluded)


cos_block.launches = 0
