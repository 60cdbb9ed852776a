"""Filtered search, hybrid dense + BM25 retrieval, and index maintenance
(compact / reindex): ``examples/filters_and_maintenance.py`` on the port.

    python -m lantern_tpu_torch.examples.filters_and_maintenance \\
        [--device cpu] [--n N]
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from lantern_tpu_torch import HnswParams, Index, resolve_device
from lantern_tpu_torch.examples._common import (
    check,
    emit,
    example_n,
    launches,
    launches_since,
    parser,
)
from lantern_tpu_torch.text.bm25 import Bm25Index
from lantern_tpu_torch.weighted import hybrid_search

N, DIM = 3000, 32  # examples/filters_and_maintenance.py:23-24


def _plain(v):
    """A plan statistic as JSON: arrays as lists."""
    return v.tolist() if isinstance(v, np.ndarray) else v


def main(device=None, n: int | None = None) -> dict:
    dev = resolve_device(device)
    n = example_n(n, N)
    t0, before = time.perf_counter(), launches()
    rng = np.random.default_rng(7)
    vectors = rng.standard_normal((n, DIM)).astype(np.float32)
    ix = Index(HnswParams(dim=DIM, m=8, ef_construction=64), capacity=n,
               device=dev)
    ix.add(vectors)

    # deny-list: hide specific labels (filters_and_maintenance.py:31-36)
    q = vectors[42]
    d, deny = ix.search(q, k=5, deny_labels=np.array([42], np.uint64))
    check(42 not in deny[0].tolist(), "a denied label returned")
    print("deny-filtered top-1:", deny[0, 0])

    # allow-list: restrict the search to a candidate subset (:38-42)
    allow = np.arange(1000, 1100, dtype=np.uint64)
    d, allowed = ix.search(q, k=5, allow_labels=allow)
    check(set(allowed[0][np.isfinite(d[0])].tolist()) <= set(allow.tolist()),
          "a label outside the allow list returned")
    print("allow-filtered results:", allowed[0].tolist())

    # executed-plan introspection (:44-46)
    d, _, stats = ix.search(q, k=5, with_stats=True)
    plan = {k: _plain(v) for k, v in stats.items()}
    print("plan:", plan["mode"], {k: v for k, v in plan.items() if k != "mode"})

    # hybrid dense + lexical retrieval, RRF (:48-60)
    docs = {i: f"document {i} about topic {i % 7}" for i in range(50)}
    docs[3] = "tpu pallas kernels and systolic arrays"
    bm = Bm25Index()
    bm.add_documents(docs)
    small = Index(HnswParams(dim=DIM, m=8, ef_construction=32), capacity=64,
                  device=dev)
    small.add(vectors[:50], labels=np.arange(50, dtype=np.uint64))
    _, hybrid = hybrid_search(small, bm, vectors[3], "pallas kernels", k=3)
    check(hybrid[0] == 3, f"hybrid top {hybrid[0]}")
    print("hybrid top:", hybrid.tolist())

    # maintenance: tombstone reclaim (:62-68)
    ix.delete(np.arange(0, n // 2, dtype=np.uint64))
    tombstoned = ix.num_deleted
    print("tombstoned:", tombstoned)
    ix.compact()  # rebuild without the dead nodes (host engine)
    check(ix.num_deleted == 0 and ix.size == n - n // 2,
          f"after compact: {ix.num_deleted} deleted, size {ix.size}")
    ix.validate().raise_if_failed()
    print("after compact:", ix)
    compacted = {"size": ix.size, "num_deleted": ix.num_deleted}

    # reindex with other graph parameters (:70-74)
    ix.reindex(dataclasses.replace(ix.params, m=12, ef_construction=96))
    print("after reindex:", ix)
    return {"example": "filters_and_maintenance", "device": str(dev), "n": n,
            "deny_labels": deny[0].tolist(),
            "allow_labels": allowed[0].tolist(), "plan": plan,
            "hybrid_labels": hybrid.tolist(), "tombstoned": tombstoned,
            "after_compact": compacted,
            "after_reindex": {"size": ix.size, "num_deleted": ix.num_deleted,
                              "m": ix.params.m,
                              "ef_construction": ix.params.ef_construction},
            "launches": launches_since(before),
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    args = parser(__doc__).parse_args()
    emit(main(args.device, args.n))
