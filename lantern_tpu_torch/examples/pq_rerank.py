"""Product quantization with two-stage rerank search (``examples/pq_rerank.py``
on the port).

PQ stores 8-bit subvector codes; the ADC scan alone loses recall at high
dimension, and ``search(rerank=L)`` re-scores an ADC shortlist against the
full-precision rows to recover it. The ADC scan decodes the codes with the
PQ decode kernel (``csrc/pq_decode.cu``).

    python -m lantern_tpu_torch.examples.pq_rerank [--device cpu] [--n N]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lantern_tpu_torch import HnswParams, Index, resolve_device
from lantern_tpu_torch.examples._common import (
    check,
    emit,
    example_n,
    launches,
    launches_since,
    parser,
)
from lantern_tpu_torch.ops.distance import exact_search

N, DIM = 4000, 96  # examples/pq_rerank.py:25-26


def recall(labels: np.ndarray, true_ids: np.ndarray) -> float:
    """recall@10 of each query's labels against its exact top 10
    (pq_rerank.py:42-46)."""
    return float(np.mean([
        len(set(int(x) for x in got) & set(exp.tolist())) / 10
        for got, exp in zip(labels, true_ids)]))


def main(device=None, n: int | None = None) -> dict:
    dev = resolve_device(device)
    n = example_n(n, N)
    t0, before = time.perf_counter(), launches()
    rng = np.random.default_rng(0)
    vectors = rng.standard_normal((n, DIM)).astype(np.float32)
    queries = rng.standard_normal((8, DIM)).astype(np.float32)

    ix = Index(HnswParams(dim=DIM, m=16, ef_construction=64, pq=True,
                          num_subvectors=24, num_centroids=64),
               capacity=n, device=dev)
    ix.add(vectors)  # trains the codebook on the first batch, keeps raw rows

    _, true_ids = exact_search(torch.from_numpy(queries).to(dev),
                               torch.from_numpy(vectors).to(dev), k=10)
    true_ids = true_ids.cpu().numpy()

    _, raw = ix.search(queries, k=10, mode="flat")  # ADC over codes
    _, rr = ix.search(queries, k=10, rerank=100)  # + exact rerank
    adc, reranked = recall(raw, true_ids), recall(rr, true_ids)
    print(f"recall@10: ADC alone {adc:.3f} -> reranked {reranked:.3f}")
    check(reranked >= adc, f"reranked {reranked} < ADC {adc}")  # :52
    return {"example": "pq_rerank", "device": str(dev), "n": n,
            "size": ix.size, "adc_recall": adc, "rerank_recall": reranked,
            "top1_adc": raw[:, 0].tolist(), "top1_rerank": rr[:, 0].tolist(),
            "launches": launches_since(before),
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    args = parser(__doc__).parse_args()
    emit(main(args.device, args.n))
