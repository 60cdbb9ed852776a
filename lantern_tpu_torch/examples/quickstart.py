"""Quickstart: build an index, search it, persist it (``examples/quickstart.py``
on the port).

    python -m lantern_tpu_torch.examples.quickstart [--device cpu] [--n N]
"""

from __future__ import annotations

import os
import tempfile
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

N, DIM = 5000, 64  # examples/quickstart.py:23-24


def main(device=None, n: int | None = None) -> dict:
    dev = resolve_device(device)
    n = example_n(n, N)
    t0, before = time.perf_counter(), launches()
    rng = np.random.default_rng(0)
    vectors = rng.standard_normal((n, DIM)).astype(np.float32)
    queries = vectors[:5] + 0.01 * rng.standard_normal((5, DIM)).astype(np.float32)

    # CREATE INDEX ... WITH (m=16, ef_construction=128)  (quickstart.py:30-33)
    ix = Index(HnswParams(dim=DIM, m=16, ef_construction=128), capacity=n,
               device=dev)
    ix.add(vectors)  # host engine build
    print(ix)

    # ORDER BY v <-> q LIMIT 10; mode="auto" picks flat or graph (:35-39)
    dists, labels, stats = ix.search(queries, k=10, with_stats=True)
    print("top-1 labels:", labels[:, 0], "(expect 0..4)")
    check((labels[:, 0] == np.arange(5)).all(), f"top-1 {labels[:, 0]}")

    # snapshot round trip (:41-48)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "index.ldb")
        ix.save(path)
        snapshot_bytes = os.path.getsize(path)
        ix2 = Index.load(path, device=dev)
        d2, l2 = ix2.search(queries, k=10)
        check((l2 == labels).all(), "labels differ after the round trip")
    print("snapshot round trip: OK")

    # tombstone deletes, no reclaim (:50-54)
    ix.delete(np.arange(5))
    d3, l3 = ix.search(queries, k=10)
    check(not np.isin(l3, np.arange(5)).any(), "a deleted label returned")
    print("delete: OK")
    return {"example": "quickstart", "device": str(dev), "n": n,
            "size": ix.size, "mode": stats["mode"],
            "top1": labels[:, 0].tolist(), "labels": labels.tolist(),
            "dists": dists.tolist(), "labels_after_load": l2.tolist(),
            "dists_after_load": d2.tolist(),
            "labels_after_delete": l3.tolist(),
            "dists_after_delete": d3.tolist(),
            "snapshot_bytes": snapshot_bytes,
            "launches": launches_since(before),
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    args = parser(__doc__).parse_args()
    emit(main(args.device, args.n))
