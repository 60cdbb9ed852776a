"""Flat scan: one matmul plus top-k (port of lantern_tpu/flat.py, non-PQ).

Scores are rank-equivalent, not metric-equal: l2sq ranks by 2<q,x> - |x|^2,
cosine by <q,x>/|x|; true distances are rebuilt for the returned k only.
The score block is computed in float32 (bf16 rows are widened, so products
are exact and sums f32, as the reference's f32-accumulating dot) with
``torch.matmul`` and reduced with ``torch.topk``, which is exact: the port has
no approximate top-k. Up to ``ONESHOT_MAX_N`` rows the scan is one [Q, N]
block; above, it walks blocks and merges a running top-k.
"""

from __future__ import annotations

import torch

from lantern_tpu_torch.config import Metric
from lantern_tpu_torch.ops.distance import require_full_f32_matmul

# one-shot scans materialise a [Q, N] score block; beyond this N the scan is
# blocked to bound it
ONESHOT_MAX_N = 1 << 21


def _scores(vectors, sq_norms, queries_f32, metric: Metric):
    """[Q, d] x [N, d] -> [Q, N] DESCENDING-better scores (rank-equivalent).

    The query is rounded to the storage type first, as the reference does
    (bf16 tables score bf16 queries).
    """
    qf = queries_f32.to(vectors.dtype).float()
    dots = qf @ vectors.float().T  # fresh [Q, N] block: updated in place
    if metric == Metric.L2SQ:
        return dots.mul_(2.0).sub_(sq_norms[None, :])
    # cosine: rank by dot / |x| (|q| constant per row)
    return dots.div_(torch.clamp(torch.sqrt(sq_norms)[None, :], min=1e-30))


def _score_to_dist(score, q_sq, metric: Metric):
    if metric == Metric.L2SQ:
        return q_sq[:, None] - score
    return 1.0 - score / torch.clamp(torch.sqrt(q_sq)[:, None], min=1e-30)


def _blocked_flat_topk(score_fn, n, k, k_out, block, q_sq, metric):
    """Top-k of ``score_fn(start, stop)`` ([Q, stop-start] descending-better
    scores with any tombstone mask applied) over rows [0, n): one block when
    n <= block, else a running merge. Returns (dists [Q, k_out] ascending,
    ids [Q, k_out] int32), padded with (inf, -1)."""
    best_s = best_i = None
    for start in range(0, n, block):
        s = score_fn(start, min(start + block, n))
        bs, bi = torch.topk(s, min(k, s.shape[1]), dim=1, sorted=True)
        bi = bi + start
        if best_s is not None:
            cat_s, cat_i = torch.cat([best_s, bs], 1), torch.cat([best_i, bi], 1)
            bs, arg = torch.topk(cat_s, min(k, cat_s.shape[1]), dim=1, sorted=True)
            bi = torch.gather(cat_i, 1, arg)
        best_s, best_i = bs, bi
    finite = torch.isfinite(best_s)
    out_d = torch.where(finite, _score_to_dist(best_s, q_sq, metric),
                        torch.full_like(best_s, float("inf")))
    out_i = torch.where(finite, best_i, torch.full_like(best_i, -1))
    return _pad_k(out_d, out_i.to(torch.int32), k_out)


def _pad_k(d, ids, k_out: int):
    """Pad result columns out to k_out (dist +inf, id -1)."""
    q, k = d.shape
    if k == k_out:
        return d, ids
    return (
        torch.cat([d, d.new_full((q, k_out - k), float("inf"))], 1),
        torch.cat([ids, ids.new_full((q, k_out - k), -1)], 1),
    )


def flat_search(
    vectors: torch.Tensor,     # [N, d] f32/bf16
    sq_norms: torch.Tensor,    # [N] f32
    queries: torch.Tensor,     # [Q, d] f32
    k: int = 10,
    metric: int = int(Metric.L2SQ),
    exact: bool = False,
    block: int | None = None,
    deleted: torch.Tensor | None = None,
):
    """Dense scan top-k. Returns (dists [Q, k] ascending, ids [Q, k] int32).

    ``deleted``: optional [N] bool mask of rows excluded from the results.
    ``exact=True`` is the ground-truth mode: it refuses to run with TF32
    matmuls enabled (top-k itself is always exact here).
    """
    metric = Metric(metric)
    if metric == Metric.HAMMING:
        raise NotImplementedError(
            "hamming scans wait for the hamming slice (ROADMAP queue 1)")
    if exact:
        require_full_f32_matmul()
    n, q = vectors.shape[0], queries.shape[0]
    qf = queries.float()
    q_sq = (qf * qf).sum(1)
    if n == 0:
        return _pad_k(qf.new_zeros((q, 0)),
                      torch.zeros((q, 0), dtype=torch.int32, device=qf.device), k)
    if block is None:
        block = min(n, ONESHOT_MAX_N)

    def score_fn(start, stop):
        s = _scores(vectors[start:stop], sq_norms[start:stop], qf, metric)
        if deleted is not None:
            s.masked_fill_(deleted[None, start:stop], float("-inf"))
        return s

    return _blocked_flat_topk(score_fn, n, min(k, n), k, block, q_sq, metric)


def flat_search_graph(graph, queries, k: int = 10, exact: bool = False,
                      exclude=None):
    """Flat scan over a DeviceGraph's stored rows, labels resolved.

    Returns (dists [Q, k], ids [Q, k], labels [Q, k] int64) like
    search_batched. Tombstones, unfilled capacity rows and the optional
    ``exclude`` [cap] bool mask are filtered exactly (masked before top-k).
    """
    excluded = graph.deleted | (
        torch.arange(graph.cap, device=graph.device) >= graph.num_nodes
    )
    if exclude is not None:
        excluded = excluded | exclude
    d, ids = flat_search(graph.vectors, graph.sq_norms, queries, k=k,
                         metric=graph.metric, exact=exact, deleted=excluded)
    return d, ids, graph.labels_at(ids)
