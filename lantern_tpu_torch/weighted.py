"""Weighted multi-vector search — parity with lantern.weighted_vector_search.

Reference (lantern_hnsw/sql/lantern.sql:601-855): for up to 3 vector columns
with weights w1..w3, build per-column HNSW subqueries (each pulling ef
candidates), UNION + dedup, then re-rank by the weighted sum of distances
(w1*d1 + w2*d2 + w3*d3) and return the top k.

Here: any number of (Index, weight, query) triples over a shared label
space; each index's own search (on its device) pulls the candidate pools,
and an exact numpy re-rank computes every candidate's distance to every
query column.
"""

from __future__ import annotations

import numpy as np

from lantern_tpu_torch.config import Metric
from lantern_tpu_torch.index import Index


def weighted_search(
    columns: list[tuple[Index, float, np.ndarray]],
    k: int = 10,
    ef: int | None = None,
    pull_k: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """columns = [(index, weight, query_vector), ...] sharing labels.

    Returns (weighted_dists [k'], labels [k']) ascending, k' <= k.
    """
    if not columns:
        raise ValueError("need at least one (index, weight, query) column")
    pull_k = pull_k or max(k * 2, 16)

    # 1) per-column candidate pull (the per-column HNSW subqueries)
    cand_labels: set[int] = set()
    for ix, weight, q in columns:
        if weight == 0:
            continue
        d, labels = ix.search(np.asarray(q)[None, :], k=min(pull_k, 1000), ef=ef)
        cand_labels.update(int(x) for x, dd in zip(labels[0], d[0]) if np.isfinite(dd))
    if not cand_labels:
        return np.empty(0, np.float32), np.empty(0, np.uint64)
    cand = np.array(sorted(cand_labels), np.uint64)

    # 2) exact re-rank: weighted sum of true distances per column
    total = np.zeros(len(cand), np.float64)
    for ix, weight, q in columns:
        if weight == 0:
            continue
        eng = ix._eng
        rows = ix.rows_for_labels(cand)  # cached O(log n) resolution
        ok = rows >= 0
        # tombstoned rows resolve (labels persist) but must be excluded —
        # the SQL's LEFT-JOIN-NULL semantics treat them as absent
        ok = np.logical_and(
            ok, ~np.asarray(eng.deleted[: eng.n])[np.maximum(rows, 0)]
        )
        vecs = np.asarray(eng.vectors[: eng.n])[np.maximum(rows, 0)]
        metric = Metric(ix.params.metric)
        if metric == Metric.HAMMING:
            q = np.asarray(q)
            if q.dtype != np.uint32:
                # raw +/- bit vector: sign-binarise and pack as Index.search
                # does; the port's words are int32 tensors holding the
                # uint32 bits, so view them as uint32 before the popcount
                q = ix._binarized(q[None])[0].cpu().numpy().view(np.uint32)
        else:
            q = np.asarray(q, vecs.dtype)
        if metric == Metric.L2SQ:
            dcol = ((vecs - q[None, :]) ** 2).sum(1)
        elif metric == Metric.COS:
            num = vecs @ q
            den = np.linalg.norm(vecs, axis=1) * max(np.linalg.norm(q), 1e-30)
            dcol = 1.0 - num / np.maximum(den, 1e-30)
        else:  # hamming
            dcol = np.bitwise_count(
                np.bitwise_xor(vecs.astype(np.uint32), q.astype(np.uint32))
            ).sum(1)
        # a label missing from one column contributes a +inf like the SQL's
        # LEFT-JOIN NULL -> excluded from results
        total += np.where(ok, weight * dcol, np.inf)

    order = np.argsort(total)[:k]
    order = order[np.isfinite(total[order])]
    return total[order].astype(np.float32), cand[order]


def hybrid_search(
    index: Index,
    bm25,
    query_vector: np.ndarray,
    query_text: str,
    k: int = 10,
    pull_k: int | None = None,
    rrf_k: int = 60,
    ef: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Hybrid dense + lexical retrieval via reciprocal-rank fusion.

    Beyond the reference: it ships BM25 (`bm25_agg.rs`) and vector search as
    separate SQL surfaces and leaves fusion to the application's SQL. Here
    the two rankings merge with RRF — score = Σ 1/(rrf_k + rank) over the
    lists a label appears in — which needs no score calibration between
    BM25 points and vector distances.

    ``index`` and ``bm25`` share a label space (doc id == vector label).
    Returns (rrf_scores [k'], labels [k']) descending, k' <= k.
    """
    pull_k = pull_k or max(4 * k, 32)
    scores: dict[int, float] = {}
    d, labels = index.search(
        np.asarray(query_vector)[None, :], k=min(pull_k, 1000), ef=ef
    )
    rank = 0
    for dd, lab in zip(d[0], labels[0]):
        if np.isfinite(dd):
            scores[int(lab)] = scores.get(int(lab), 0.0) + 1.0 / (rrf_k + rank)
            rank += 1
    for rank, (doc_id, _s) in enumerate(bm25.search(query_text, k=pull_k)):
        scores[int(doc_id)] = scores.get(int(doc_id), 0.0) + 1.0 / (rrf_k + rank)
    if not scores:
        return np.empty(0, np.float32), np.empty(0, np.uint64)
    top = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
    return (np.array([s for _, s in top], np.float32),
            np.array([lab for lab, _ in top], np.uint64))
