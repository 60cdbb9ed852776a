"""Distances: squared L2, cosine, hamming; the exact-search oracle.

Port of lantern_tpu/ops/distance.py (parity with the reference's SQL distance
functions, lantern_hnsw/src/hnsw.c:354-405):

- l2sq: sum((a-b)^2)                 (not square-rooted, matches `<->`)
- cos:  1 - dot(a,b)/(|a||b|)        (matches `<=>`)
- hamming: popcount(a XOR b) over the bits of packed 32-bit words.

Batch distances are one matmul plus rank-1 corrections:
    l2sq(Q, X) = |q|^2 - 2 Q X^T + |x|^2
    cos(Q, X)  = 1 - (Q X^T) / (|q| |x|)
in full float32. On the card a float32 matmul is full f32 unless TF32 is
switched on; ``exact_search`` is the ground truth and refuses to run with
TF32 enabled (the GPU twin of the TPU's bf16-truncating default matmul).

Packed bit words are int32 tensors carrying the uint32 bits (4 bytes a
word; torch has almost no uint32 arithmetic). Batched hamming distances go
through K4 (``ops/hamming.py``); the plain single-pair versions widen the
words to int64 inside.
"""

from __future__ import annotations

import torch

from lantern_tpu_torch.config import Metric
from lantern_tpu_torch.ops.hamming import hamming_block, hamming_dist, to_words


def require_full_f32_matmul() -> None:
    """Raise if TF32 matmuls are enabled: f32 scores must be full f32."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True; exact scoring "
            "needs full-f32 matmuls (set it to False)"
        )


# ---------------------------------------------------------------------------
# pairwise (single pair) distances — parity with SQL UDFs
# ---------------------------------------------------------------------------

def l2sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distance between two vectors (hnsw.c:354-364)."""
    d = a.float() - b.float()
    return (d * d).sum(-1)


def cos_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine distance 1 - cos_sim (hnsw.c:366-381)."""
    a, b = a.float(), b.float()
    num = (a * b).sum(-1)
    den = torch.sqrt((a * a).sum(-1) * (b * b).sum(-1))
    return 1.0 - num / torch.clamp(den, min=1e-30)


# ---------------------------------------------------------------------------
# batched query-block x base-block distances
# ---------------------------------------------------------------------------

def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * xf).sum(-1)


def pairwise_dist(
    queries: torch.Tensor,
    base: torch.Tensor,
    metric: Metric | int = Metric.L2SQ,
    *,
    base_sq_norms: torch.Tensor | None = None,
) -> torch.Tensor:
    """All-pairs distances: queries [Q, d] x base [N, d] -> [Q, N] float32.

    For hamming, inputs are packed 32-bit words ([Q, W], [N, W]; int32 on
    the card), scored by K4 (``hamming_block``) with no [Q, N, W]
    intermediate. ``base_sq_norms`` (float32 [N]) skips the norm pass.
    """
    metric = Metric(metric)
    if metric == Metric.HAMMING:
        return hamming_block(queries, base)
    dots = queries.float() @ base.float().T
    bn = base_sq_norms if base_sq_norms is not None else _sq_norms(base)
    if metric == Metric.L2SQ:
        # clamp: fp cancellation can produce tiny negatives
        return torch.clamp(_sq_norms(queries)[:, None] - 2.0 * dots + bn[None, :],
                           min=0.0)
    if metric == Metric.COS:
        qn = torch.sqrt(_sq_norms(queries))[:, None]
        return 1.0 - dots / torch.clamp(qn * torch.sqrt(bn)[None, :], min=1e-30)
    raise ValueError(f"unknown metric {metric}")


# ---------------------------------------------------------------------------
# exact search (brute force) — the recall oracle
# ---------------------------------------------------------------------------

def exact_search(
    queries: torch.Tensor,
    base: torch.Tensor,
    k: int,
    metric: Metric | int = Metric.L2SQ,
    block: int = 65536,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN at full f32: (dists [Q, k], ids [Q, k] int32), ascending.

    The ground-truth oracle. Blocked over the base so a multi-million-row
    base never materialises a [Q, N] matrix; a running top-k is merged per
    block. Hamming blocks are scored by K4 (``hamming_block``).
    """
    if Metric(metric) != Metric.HAMMING:
        require_full_f32_matmul()
    n, q = base.shape[0], queries.shape[0]
    dev = queries.device
    if n == 0:  # empty base: no neighbors
        return (torch.full((q, 0), float("inf"), device=dev),
                torch.full((q, 0), -1, dtype=torch.int32, device=dev))
    k = min(k, n)
    best_d = torch.full((q, 0), float("inf"), device=dev)
    best_i = torch.full((q, 0), -1, dtype=torch.int64, device=dev)
    for start in range(0, n, block):
        d = pairwise_dist(queries, base[start:start + block], metric)
        bd, bi = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False,
                            sorted=True)
        cat_d = torch.cat([best_d, bd], 1)
        cat_i = torch.cat([best_i, bi + start], 1)
        best_d, arg = torch.topk(cat_d, min(k, cat_d.shape[1]), dim=1,
                                 largest=False, sorted=True)
        best_i = torch.gather(cat_i, 1, arg)
    return best_d, best_i.to(torch.int32)


# ---------------------------------------------------------------------------
# bit packing for hamming / b1 quantization
# ---------------------------------------------------------------------------

def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Pack a [..., dim] array into [..., ceil(dim/32)] int32 words carrying
    the uint32 bits, little-endian within a word (bit i of word w = dim
    32w+i); positive components set bits (the reference's quant_bits=1,
    options.c:137-158). One bit plane at a time, so the working set is the
    [..., words] int64 accumulator, not a [..., dim] one."""
    bits = (x > 0).to(torch.uint8)
    dim = bits.shape[-1]
    words = -(-dim // 32)
    pad = words * 32 - dim
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(bits.shape[:-1] + (words, 32))
    acc = torch.zeros(bits.shape[:-1], dtype=torch.int64, device=x.device)
    for i in range(32):
        acc |= bits[..., i].to(torch.int64) << i
    return to_words(acc)


def unpack_bits(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of pack_bits -> float32 0/1 array of size dim."""
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    bits = ((packed.to(torch.int64) & 0xFFFFFFFF)[..., :, None] >> shifts) & 1
    flat = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 32,))
    return flat[..., :dim].float()
