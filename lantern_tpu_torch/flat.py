"""Flat scan: one matmul plus top-k (port of lantern_tpu/flat.py).

Scores are rank-equivalent, not metric-equal: l2sq ranks by 2<q,x> - |x|^2,
cosine by <q,x>/|x|; true distances are rebuilt for the returned k only.
The score block is computed in float32 (bf16 rows are widened, so products
are exact and sums f32, as the reference's f32-accumulating dot) and reduced
with ``ops/row_topk.py::row_topk`` (the hand-written kernel on the card),
which is exact and breaks ties to the lower id, as the reference's
``jax.lax.top_k`` does: the port has no approximate top-k. Up to
``ONESHOT_MAX_N`` rows the scan is one [Q, N] block; above, it walks blocks
and merges a running top-k.

An l2sq block with no per-row scale is the GEMM's own output
(``_l2sq_scores``): ``torch.addmm`` of the doubled query against the rows,
with the [N] bias -|x|^2, -inf at excluded rows, added as the block is
stored (cuBLASLt's bias epilogue on the card), so the block is written once
and never passed over again. Doubling the query is exact, so the score is
fl(<2q, x> - |x|^2). Cosine and i8 blocks scale each column, which a bias
cannot carry. An unscaled cosine block (``_cos_scores``, counted in
``_cos_scores.blocks``) of CUDA f32 rows with d % 4 == 0 is one launch of
the split-TF32 tensor-core kernel ``ops/cos_block.py``, the divide and the
mask in its epilogue, so the block is written once. Other cosine blocks
(CPU tensors, bf16 and PQ-cosine rows, other widths) and i8 blocks are a
``torch.matmul`` followed by in-place passes over the block, the column
scale and then the mask, inside the span ``flat.scale`` (``_scaled``).

i8 tables (int8 codes with per-row scales) score bf16-rounded queries
against the codes widened exactly to f32, then scale the products per row.
Hamming tables (int32 words) score -distance, tombstones at -inf, in one
K4 launch (``ops/hamming.py::hamming_scores``).

PQ tables scan by decoding each block of codes with the PQ decode kernel
(``ops/pq_decode.py``, which also returns |x|^2) and scoring the decoded
block densely (``flat_search_pq``); ``flat_search_pq_rerank`` re-scores an
ADC shortlist against full-precision rows.
"""

from __future__ import annotations

import torch

from lantern_tpu_torch.config import Metric
from lantern_tpu_torch.ops.cos_block import cos_block, takes
from lantern_tpu_torch.ops.distance import require_full_f32_matmul
from lantern_tpu_torch.ops.hamming import hamming_scores
from lantern_tpu_torch.ops.pq_decode import codebook_bf16, pq_decode
from lantern_tpu_torch.ops.row_topk import row_topk
from lantern_tpu_torch.utils.bench import span

# one-shot scans materialise a [Q, N] score block; beyond this N the scan is
# blocked to bound it. Hamming blocks too: the reference caps them at 8192
# rows because its jnp XOR/popcount builds a [Q, B, W] intermediate
# (lantern_tpu/flat.py:227-230); K4 writes only the [Q, B] block, the same
# size as every other metric's score block.
ONESHOT_MAX_N = 1 << 21


def _l2sq_scores(qf, x, sq_norms, excluded=None):
    """The l2sq score block 2<qf, x> - |x|^2, -inf at ``excluded`` rows, as
    one GEMM: [Q, d] f32 queries (already rounded to the storage type) x
    [N, d] rows -> [Q, N] f32. The bias is an [N] pass; the [Q, N] block is
    written once, by the GEMM. Counts each block in ``_l2sq_scores.blocks``.
    """
    bias = -sq_norms.float()
    if excluded is not None:
        bias.masked_fill_(excluded, float("-inf"))
    _l2sq_scores.blocks += 1
    return torch.addmm(bias, qf * 2.0, x.float().T)


_l2sq_scores.blocks = 0


def _cos_scores(qf, x, sq_norms, excluded=None):
    """The cosine score block <qf, x> / |x|, -inf at ``excluded`` rows: [Q, d]
    f32 queries (already rounded to the storage type) x [N, d] rows -> [Q, N]
    f32. Rows that ``ops/cos_block.takes`` (CUDA f32, d % 4 == 0) go to
    ``cos_block`` (one kernel, the divide and the mask in its epilogue); any
    other block is the GEMM's fresh block divided and masked in place.
    Counts each block in ``_cos_scores.blocks``."""
    _cos_scores.blocks += 1
    if takes(x):
        return cos_block(qf.contiguous(), x, sq_norms.float().contiguous(),
                         None if excluded is None else excluded.contiguous())
    return _scaled(qf @ x.float().T, Metric.COS, sq_norms, None, excluded)


_cos_scores.blocks = 0


def _scaled(dots, metric: Metric, sq_norms, vec_scales, excluded):
    """The passes over a fresh [Q, N] product block, in place, inside the
    span ``flat.scale``: the i8 row scale, then the metric's column pass (l2sq:
    2 dots - |x|^2; cosine: dots / |x|, |q| being constant along a row),
    then -inf at the ``excluded`` rows."""
    with span("flat.scale"):
        if vec_scales is not None:
            dots.mul_(vec_scales[None, :])
        if metric == Metric.L2SQ:
            dots.mul_(2.0).sub_(sq_norms[None, :])
        else:
            dots.div_(torch.clamp(torch.sqrt(sq_norms)[None, :], min=1e-30))
        if excluded is not None:
            dots.masked_fill_(excluded[None, :], float("-inf"))
    return dots


def _scores(vectors, sq_norms, queries_f32, metric: Metric, vec_scales=None,
            excluded=None):
    """[Q, d] x [N, d] -> [Q, N] DESCENDING-better scores (rank-equivalent),
    -inf at the rows where ``excluded`` ([N] bool) is set.

    The query is rounded to the storage type first, as the reference does
    (bf16 tables score bf16 queries; int8 codes score bf16 queries, the
    codes widened exactly, then each row's product times its i8 scale).
    l2sq with no scale is ``_l2sq_scores``, one GEMM with the bias in its
    epilogue; cosine with no scale is ``_cos_scores`` (the split-TF32
    kernel on the card); i8 scales the fresh block in place, then masks it
    (``_scaled``).
    """
    qdt = torch.bfloat16 if vectors.dtype == torch.int8 else vectors.dtype
    qf = queries_f32.to(qdt).float()
    if vec_scales is None:
        if metric == Metric.L2SQ:
            return _l2sq_scores(qf, vectors, sq_norms, excluded)
        return _cos_scores(qf, vectors, sq_norms, excluded)
    return _scaled(qf @ vectors.float().T, metric, sq_norms, vec_scales,
                   excluded)


def _score_to_dist(score, q_sq, metric: Metric):
    if metric == Metric.L2SQ:
        return q_sq[:, None] - score
    if metric == Metric.HAMMING:
        return -score  # hamming scores are negated distances
    return 1.0 - score / torch.clamp(torch.sqrt(q_sq)[:, None], min=1e-30)


def _blocked_flat_topk(score_fn, n, k, k_out, block, q_sq, metric):
    """Top-k of ``score_fn(start, stop)`` ([Q, stop-start] descending-better
    scores with any tombstone mask applied) over rows [0, n): one block when
    n <= block, else a running merge, each select a ``row_topk`` (ties to
    the lower id). Returns (dists [Q, k_out] ascending, ids [Q, k_out]
    int32), padded with (inf, -1)."""
    best_s = best_i = None
    for start in range(0, n, block):
        with span("flat.score"):
            s = score_fn(start, min(start + block, n))
        with span("flat.topk"):
            bs, bi = row_topk(s, min(k, s.shape[1]))
            bi = bi + start
            if best_s is not None:
                # the running best's ids all lie below the block's, so the
                # lower position of a tie is the lower id
                cat_s = torch.cat([best_s, bs], 1)
                cat_i = torch.cat([best_i, bi], 1)
                bs, arg = row_topk(cat_s, min(k, cat_s.shape[1]))
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
    vectors: torch.Tensor,     # [N, d] f32/bf16/i8, or [N, W] int32 words
    sq_norms: torch.Tensor,    # [N] f32 (unused for hamming)
    queries: torch.Tensor,     # [Q, d] f32, or [Q, W] int32 words
    k: int = 10,
    metric: int = int(Metric.L2SQ),
    exact: bool = False,
    block: int | None = None,
    deleted: torch.Tensor | None = None,
    vec_scales: torch.Tensor | None = None,  # [N] f32 for i8 codes
):
    """Dense scan top-k. Returns (dists [Q, k] ascending, ids [Q, k] int32).

    ``deleted``: optional [N] bool mask of rows excluded from the results.
    ``exact=True`` is the ground-truth mode: it refuses to run with TF32
    matmuls enabled (top-k itself is always exact here). Hamming scores
    ``hamming_scores`` (K4 on the card, mask included). Tied distances come
    in ascending id, and a tie at the k-th place keeps the lower ids.
    """
    metric = Metric(metric)
    hamming = metric == Metric.HAMMING
    if exact and not hamming:
        require_full_f32_matmul()
    n, q = vectors.shape[0], queries.shape[0]
    dev = queries.device
    if hamming:
        qf, q_sq = queries, torch.zeros(q, device=dev)
    else:
        qf = queries.float()
        q_sq = (qf * qf).sum(1)
    if n == 0:
        return _pad_k(q_sq.new_zeros((q, 0)),
                      torch.zeros((q, 0), dtype=torch.int32, device=dev), k)
    if block is None:
        block = min(n, ONESHOT_MAX_N)

    def score_fn(start, stop):
        dele = None if deleted is None else deleted[start:stop]
        if hamming:  # K4 negates and masks in its epilogue
            return hamming_scores(qf, vectors[start:stop], dele)
        return _scores(vectors[start:stop], sq_norms[start:stop], qf, metric,
                       None if vec_scales is None else vec_scales[start:stop],
                       dele)

    return _blocked_flat_topk(score_fn, n, min(k, n), k, block, q_sq, metric)


def flat_search_pq(
    codes: torch.Tensor,       # [N, S] uint8 PQ codes
    centroids: torch.Tensor,   # [S, K, dsub] f32 codebook
    queries: torch.Tensor,     # [Q, dim] f32
    k: int = 10,
    metric: int = int(Metric.L2SQ),
    block: int = 1 << 19,
    deleted: torch.Tensor | None = None,
    rotation: torch.Tensor | None = None,
):
    """Flat ADC scan over PQ codes: decode each block, then score densely.

        decoded[b] = concat_s bf16(centroids[s, codes[b, s]])  (K2/K3's port)
        score[q, b] = 2 <bf16(q), decoded[b]> - |decoded[b]|^2  (l2sq ranks)

    |x|^2 comes from the decode kernel's fused output (K6's). As in the
    reference, the query is rounded to bf16 for the product but |q|^2 comes
    from the f32 query; the product runs in f32 on the widened operands
    (bf16 values multiply exactly in f32, and in TF32 too). With an OPQ
    ``rotation`` the query is rotated first. The bf16 codebook is rounded
    once per call, not per block. Returns (dists [Q, k] ascending, ids [Q, k]
    int32), padded with (inf, -1).
    """
    metric = Metric(metric)
    if metric == Metric.HAMMING:
        raise ValueError("PQ scan supports l2sq/cos only")
    n = codes.shape[0]
    qf = queries.float()
    if rotation is not None:  # OPQ: codes live in the rotated space
        qf = qf @ rotation
    q_sq = (qf * qf).sum(1)
    if n == 0:
        return _pad_k(qf.new_zeros((qf.shape[0], 0)),
                      torch.zeros((qf.shape[0], 0), dtype=torch.int32,
                                  device=qf.device), k)
    cb = codebook_bf16(centroids)

    def score_fn(start, stop):
        dec, x_sq = pq_decode(codes[start:stop], cb, want_xsq=True)
        # dec is bf16: _scores rounds the query to bf16 for the product
        return _scores(dec, x_sq, qf, metric, excluded=(
            None if deleted is None else deleted[start:stop]))

    return _blocked_flat_topk(score_fn, n, min(k, n), k, min(block, n), q_sq,
                              metric)


def flat_search_pq_rerank(
    codes: torch.Tensor,       # [N, S] uint8 PQ codes
    centroids: torch.Tensor,   # [S, K, dsub] f32 codebook
    vectors: torch.Tensor,     # [N, d] full-precision rows (f32 or bf16)
    queries: torch.Tensor,     # [Q, d] f32
    k: int = 10,
    shortlist: int = 100,
    metric: int = int(Metric.L2SQ),
    block: int = 1 << 19,
    deleted: torch.Tensor | None = None,
    rotation: torch.Tensor | None = None,
):
    """Two-stage PQ search: an ADC scan keeps ``shortlist`` candidates per
    query, then the true metric re-scores them against ``vectors`` at full
    f32 (the reference's HIGHEST-precision einsums; TF32 is refused), |x|^2
    from the gathered rows. Returns (dists [Q, k], ids [Q, k] int32)."""
    metric = Metric(metric)
    require_full_f32_matmul()
    _, ids = flat_search_pq(codes, centroids, queries, k=shortlist,
                            metric=metric, block=block, deleted=deleted,
                            rotation=rotation)
    rows = vectors[torch.clamp(ids, 0, vectors.shape[0] - 1).long()].float()
    qf = queries.float()
    dots = torch.einsum("qd,qld->ql", qf, rows)
    x_sq = (rows * rows).sum(-1)
    q_sq = (qf * qf).sum(1)[:, None]
    if metric == Metric.L2SQ:
        # clamp: bf16 rerank rows can round a self-match slightly negative
        d = torch.clamp(q_sq - 2.0 * dots + x_sq, min=0.0)
    else:
        d = 1.0 - dots / torch.clamp(torch.sqrt(q_sq) * torch.sqrt(x_sq),
                                     min=1e-30)
    d = torch.where(ids >= 0, d, float("inf"))
    s_d, order = torch.sort(d, dim=1, stable=True)
    kk = min(k, d.shape[1])
    out_d = s_d[:, :kk]
    out_i = torch.where(torch.isfinite(out_d),
                        torch.gather(ids, 1, order[:, :kk]), -1)
    return _pad_k(out_d, out_i, k)


def _excluded(graph, exclude):
    """Tombstones, unfilled capacity rows and the optional exclude mask."""
    excluded = graph.deleted | (
        torch.arange(graph.cap, device=graph.device) >= graph.num_nodes
    )
    return excluded if exclude is None else excluded | exclude


def flat_search_graph_rerank(graph, rerank_rows, queries, k: int = 10,
                             shortlist: int = 100, exclude=None):
    """Two-stage PQ search over a PQ DeviceGraph: ADC shortlist over its
    codes, exact re-score against ``rerank_rows`` ([n, d] bf16 or f32, on
    the graph's device). Returns (dists, ids, labels) like
    flat_search_graph."""
    from lantern_tpu_torch.graph.device import QUANT_PQ

    if graph.quant != QUANT_PQ:
        raise ValueError("flat_search_graph_rerank serves PQ graphs only")
    d, ids = flat_search_pq_rerank(
        graph.vectors, graph.pq_codebook, rerank_rows, queries, k=k,
        shortlist=shortlist, metric=graph.metric,
        deleted=_excluded(graph, exclude), rotation=graph.pq_rotation)
    return d, ids, graph.labels_at(ids)


def flat_search_graph(graph, queries, k: int = 10, exact: bool = False,
                      exclude=None):
    """Flat scan over a DeviceGraph's stored rows, labels resolved.

    Returns (dists [Q, k], ids [Q, k], labels [Q, k] int64) like
    search_batched. Tombstones, unfilled capacity rows and the optional
    ``exclude`` [cap] bool mask are filtered exactly (masked before top-k).
    PQ graphs run the ADC scan over their codes (``flat_search_pq``); i8
    graphs scale by ``vec_scales``; hamming graphs take int32 word queries.
    """
    from lantern_tpu_torch.graph.device import QUANT_PQ

    excluded = _excluded(graph, exclude)
    if graph.quant == QUANT_PQ:
        d, ids = flat_search_pq(graph.vectors, graph.pq_codebook, queries,
                                k=k, metric=graph.metric, deleted=excluded,
                                rotation=graph.pq_rotation)
    else:
        d, ids = flat_search(graph.vectors, graph.sq_norms, queries, k=k,
                             metric=graph.metric, exact=exact,
                             deleted=excluded, vec_scales=graph.vec_scales)
    return d, ids, graph.labels_at(ids)
