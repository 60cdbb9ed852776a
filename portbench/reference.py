"""The plain reference: exact k-NN over the rows and queries the harness made,
and the comparison of the program's answers with it.

Plain PyTorch, run after the window on the same device, in blocks so that it
fits. It imports nothing of the program and takes nothing the program made:
the rows and queries are the harness's own, handed to both sides.

- ``exact_knn(metric, rows, queries, k)``: the exact answers. l2sq / cos:
  an f32 scan with TF32 off keeps a shortlist of ``SHORTLIST`` rows a query,
  re-scored in float64 from the rows themselves; hamming: the +-1 product of
  the unpacked bits in f32 with TF32 off, exact (integer sums under 2^24).
  ``lower=True`` is the control: the same scan one precision below what the
  configuration states (TF32 for f32 rows: operands rounded to TF32's
  mantissa, so the CPU loses the same bits as the card; bf16 in and out for
  the +-1 bits, the step a faster scan would take), with no re-scoring.
- ``pair_dist``: the exact distance of given (query, row) pairs: float64 for
  l2sq / cos, popcounts of XORed words for hamming.
- ``compare``: the numbers that decide ``correct``, and the tie-aware
  recall.
"""

from __future__ import annotations

import contextlib

import torch

# rows of the f32 shortlist that float64 re-scores, a query
SHORTLIST = 64
ROW_BLOCK = 131072
QUERY_BLOCK = 2048
ANSWER_BLOCK = 32768
_U32 = 0xFFFFFFFF


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """f32 matmuls in full f32 (``tf32=False``) or in TF32, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (any integer dtype) -> int64 counts."""
    x = x.to(torch.int64) & _U32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _U32) >> 24


def signs(words: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Packed words [n, W] -> +-1 [n, 32 W] (bit 1 -> -1), bit b of word w
    at column 32 w + b."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words.to(torch.int32)[:, :, None] >> shifts) & 1
    return (1 - 2 * bits).reshape(words.shape[0], -1).to(dtype)


def pair_dist(metric: str, rows: torch.Tensor, queries: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """Exact distances [A, k] (float64) of ``queries`` [A, ...] to
    ``rows[ids]``; ``ids`` [A, k] must be valid row numbers."""
    if metric == "hamming":
        x = torch.bitwise_xor(rows[ids], queries[:, None, :])
        return popcount_words(x).sum(-1).double()
    x = rows[ids].double()
    q = queries.double()[:, None, :]
    if metric == "l2sq":
        return ((x - q) ** 2).sum(-1)
    if metric == "cos":
        dot = (x * q).sum(-1)
        den = torch.sqrt((x * x).sum(-1)) * torch.sqrt((q * q).sum(-1))
        return 1.0 - dot / den.clamp(min=1e-300)
    raise ValueError(f"no reference for metric {metric!r}")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10-bit mantissa (what a TF32 matmul
    reads), so the control loses the same bits on any device."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _scores(metric, q, x, lower):
    """Lower-is-nearer f32 distances of a query block to a row block; with
    ``lower`` the dot products read TF32 operands, the norms stay f32."""
    q_sq, x_sq = (q * q).sum(1), (x * x).sum(1)
    dot = (to_tf32(q) @ to_tf32(x).T) if lower else q @ x.T
    if metric == "l2sq":
        return q_sq[:, None] - 2.0 * dot + x_sq[None, :]
    den = torch.sqrt(q_sq)[:, None] * torch.sqrt(x_sq)[None, :]
    return 1.0 - dot / den.clamp(min=1e-30)


def _running_topk(best, cand_d, cand_i, k):
    """Merge a block's candidates into the running ``k`` smallest."""
    if best is not None:
        cand_d = torch.cat([best[0], cand_d], 1)
        cand_i = torch.cat([best[1], cand_i], 1)
    d, arg = torch.topk(cand_d, min(k, cand_d.shape[1]), dim=1, largest=False,
                        sorted=True)
    return d, torch.gather(cand_i, 1, arg)


def _scan(metric, rows, qb, k, lower, allowed=None):
    """The ``k`` nearest rows of one query block by a blocked scan; rows
    outside ``allowed`` are never returned."""
    best = None
    width = rows.shape[1] * 32 if metric == "hamming" else None
    if metric == "hamming":
        qs = signs(qb, torch.bfloat16 if lower else torch.float32)
    for start in range(0, rows.shape[0], ROW_BLOCK):
        xb = rows[start:start + ROW_BLOCK]
        if metric == "hamming":
            xs = signs(xb, qs.dtype)
            dot = (qs @ xs.T).float()  # bf16 out when lower
            d = (width - dot) * 0.5
        else:
            d = _scores(metric, qb, xb, lower)
        if allowed is not None:
            d = d.masked_fill(~allowed[start:start + ROW_BLOCK], float("inf"))
        dd, di = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False,
                            sorted=True)
        best = _running_topk(best, dd, di + start, k)
    return best


def exact_knn(metric: str, rows: torch.Tensor, queries: torch.Tensor, k: int,
              lower: bool = False, allowed: torch.Tensor | None = None):
    """(dists [Q, k] float64 ascending, ids [Q, k] int64): the exact k-NN
    among the ``allowed`` rows ([N] bool; None: all), or with ``lower`` the
    control's answers in the precision below."""
    out_d, out_i = [], []
    with matmul_precision(tf32=lower):
        for s in range(0, queries.shape[0], QUERY_BLOCK):
            qb = queries[s:s + QUERY_BLOCK]
            if metric == "hamming" or lower:
                d, i = _scan(metric, rows, qb, k, lower, allowed)
                out_d.append(d.double())
                out_i.append(i)
                continue
            _, cand = _scan(metric, rows, qb, max(k, SHORTLIST), lower,
                            allowed)
            exact = pair_dist(metric, rows, qb, cand)
            d, arg = torch.sort(exact, dim=1, stable=True)
            out_d.append(d[:, :k])
            out_i.append(torch.gather(cand, 1, arg[:, :k]))
    return torch.cat(out_d), torch.cat(out_i).long()


def compare(metric: str, rows: torch.Tensor, pool: torch.Tensor,
            kth: torch.Tensor, qidx: torch.Tensor, dists: torch.Tensor,
            labels: torch.Tensor, allowed: torch.Tensor | None = None) -> dict:
    """Hold answers against the reference.

    ``qidx`` [A]: each answer's query in ``pool``; ``dists`` [A, k] and
    ``labels`` [A, k] (row numbers) as the program returned them; ``kth``
    [P]: the reference's k-th nearest distance of each pool query;
    ``allowed`` [N] bool: the rows a filtered search may return (None: all).

    - ``dist_gap``: the widest gap between a returned distance and the exact
      distance of the returned row, over the k-th exact distance for l2sq /
      cos, in whole bits for hamming; a missing, invalid or filtered-out
      answer reads inf.
    - ``miss_share``: the share of returned entries that are not a distinct
      neighbour: missing, invalid, filtered out, farther than the k-th exact
      distance (tie-aware: a row at that distance counts as a neighbour), or
      a row the query's answer already holds.
    - ``recall``: distinct valid returned rows within the k-th exact
      distance, over ``k`` a query, averaged; so ``1 - miss_share``.
    """
    n, dev = rows.shape[0], rows.device
    k = labels.shape[1]
    gap, hits = 0.0, 0
    for s in range(0, qidx.shape[0], ANSWER_BLOCK):
        qi = qidx[s:s + ANSWER_BLOCK].to(dev).long()
        d = dists[s:s + ANSWER_BLOCK].to(dev).double()
        lab = labels[s:s + ANSWER_BLOCK].to(dev).long()
        ok = torch.isfinite(d) & (lab >= 0) & (lab < n)
        safe = torch.where(ok, lab, 0)
        if allowed is not None:
            ok &= allowed.to(dev)[safe]
        truth = pair_dist(metric, rows, pool[qi], safe)
        limit = kth[qi].double()[:, None]
        scale = torch.ones_like(limit) if metric == "hamming" else (
            limit.abs().clamp(min=1e-30))
        err = torch.where(ok, (d - truth).abs() / scale,
                          torch.full_like(d, float("inf")))
        gap = max(gap, float(err.max()))
        slack = 0.0 if metric == "hamming" else 1e-12 * limit.abs()
        near = ok & (truth <= limit + slack)
        # each distinct row once: a repeat is a miss
        srt = torch.sort(torch.where(near, lab, -1 - torch.arange(
            k, device=dev)), dim=1).values
        first = torch.ones_like(near)
        first[:, 1:] = srt[:, 1:] != srt[:, :-1]
        hits += int((first & (srt >= 0)).sum())
    entries = qidx.shape[0] * k
    return {"dist_gap": gap,
            "miss_share": (entries - hits) / entries if entries else 0.0,
            "recall": hits / entries if entries else 0.0}
