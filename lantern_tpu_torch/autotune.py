"""Index parameter autotuning — parity with lantern_cli index_autotune.

Reference (lantern_cli/src/index_autotune/mod.rs):
- samples up to N rows into a test table, computes exact ground truth for 10
  random queries via seq scan (:188-218)
- iterates 6 (m, ef_construction, ef) variants (:328-359):
  (6,32,64) (8,40,64) (12,48,64) (16,60,76) (32,96,96) (48,128,128)
- measures recall@k, query latency, build time per variant (:220-254)
- picks the fastest (latency, then build time) variant meeting the target
  recall (:161-186)

Here each variant is built by the native host engine or the device builder,
its queries run batched on ``device`` (default cuda), and the ground truth
comes from the exact oracle on the same device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

import torch

from lantern_tpu_torch import resolve_device
from lantern_tpu_torch.config import HnswParams, Metric

# (m, ef_construction, ef) — index_autotune/mod.rs:328-359
AUTOTUNE_VARIANTS = (
    (6, 32, 64),
    (8, 40, 64),
    (12, 48, 64),
    (16, 60, 76),
    (32, 96, 96),
    (48, 128, 128),
)


@dataclasses.dataclass
class AutotuneResult:
    m: int
    ef_construction: int
    ef: int
    recall: float
    latency_s: float
    build_s: float
    # which builder produced build_s: "native" (the host engine) or
    # "device". Recorded in the stored payload so results saved under
    # either builder stay interpretable; rows stored before this field
    # existed load as "unknown".
    engine: str = "unknown"

    def exp_str(self) -> str:
        return (
            f"m={self.m} efc={self.ef_construction} ef={self.ef}: "
            f"recall={self.recall:.3f} latency={self.latency_s*1e3:.2f}ms "
            f"build={self.build_s:.1f}s [{self.engine}]"
        )


def load_prior_result(model_name: str, results_path: str,
                      target_recall: float) -> AutotuneResult | None:
    """Reuse a prior autotune result for the same model name — parity with
    the reference skipping the sweep when `_lantern_extras_internal
    .autotune_results` already has rows for the model (mod.rs:111-159)."""
    import json
    import os

    if not model_name or not os.path.exists(results_path):
        return None
    with open(results_path) as f:
        store = json.load(f)
    rows = store.get(model_name, [])
    meeting = [AutotuneResult(**r) for r in rows
               if r["recall"] >= target_recall]
    if not meeting:
        return None
    return min(meeting, key=lambda r: (r.latency_s, r.build_s))


def save_results(model_name: str, results: list[AutotuneResult],
                 results_path: str):
    """Append this sweep's rows under the model name (export_results analog)."""
    import json
    import os

    store = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            store = json.load(f)
    store.setdefault(model_name, []).extend(vars(r) for r in results)
    tmp = results_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(store, f)
    os.replace(tmp, results_path)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def autotune(
    vectors: np.ndarray,
    metric: Metric = Metric.L2SQ,
    k: int = 10,
    target_recall: float = 0.9,
    sample: int = 10_000,
    num_queries: int = 10,
    variants=AUTOTUNE_VARIANTS,
    seed: int = 0,
    engine: str = "native",
    model_name: str | None = None,
    results_path: str | None = None,
    device: str | torch.device | None = None,
) -> tuple[AutotuneResult | None, list[AutotuneResult]]:
    """Sweep variants; returns (best_meeting_target_or_None, all_results).

    With ``model_name`` + ``results_path``, a prior stored result meeting
    the target short-circuits the sweep, and fresh sweeps are appended to
    the store (mod.rs:111-159 reuse semantics).

    ``engine`` picks the variant BUILD path; search latency and recall are
    always measured batched on ``device``:

    - ``"native"`` (default): build each variant on the host engine (all
      host cores) and copy it to the device.
    - ``"device"``: build each variant with the device builder
      (``build_on_device``), when the device build time is itself the
      quantity being tuned.

    A variant's latency is one search batch of ``num_queries`` queries:
    the best of 2 timed windows of 48 ``search_batched`` calls on slightly
    perturbed copies of the queries, each window ended by a device sync.
    """
    if model_name and results_path:
        prior = load_prior_result(model_name, results_path, target_recall)
        if prior is not None:
            return prior, [prior]
    from lantern_tpu_torch.graph.search import search_batched
    from lantern_tpu_torch.ops import exact_search

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    vectors = np.asarray(vectors, np.float32)
    if len(vectors) > sample:
        idx = rng.choice(len(vectors), sample, replace=False)
        vectors = vectors[idx]
    n, dim = vectors.shape

    qidx = rng.choice(n, size=min(num_queries, n), replace=False)
    queries = vectors[qidx] + 0.0
    qs = torch.from_numpy(queries).to(dev)
    # exact ground truth (mod.rs:188-218's seq-scan oracle)
    _, true_ids = exact_search(qs, torch.from_numpy(vectors).to(dev), k=k,
                               metric=metric)
    true_ids = true_ids.cpu().numpy()

    results: list[AutotuneResult] = []
    for m, efc, ef in variants:
        p = HnswParams(dim=dim, m=m, ef_construction=min(efc, 400),
                       ef=min(ef, 400), metric=metric)
        _sync(dev)
        t0 = time.perf_counter()
        if engine == "device":
            from lantern_tpu_torch.graph.build_device import build_on_device

            g = build_on_device(vectors, p, batch=min(512, n), seed=seed,
                                device=dev)
        else:
            from lantern_tpu_torch.graph.device import to_device
            from lantern_tpu_torch.native import NativeHnsw

            ix = NativeHnsw(p, capacity=n, seed=seed)
            ix.add(vectors)
            g = to_device(ix, device=dev)
        _sync(dev)
        build_s = time.perf_counter() - t0

        d, ids, _ = search_batched(g, qs, k=k, ef=ef)  # also the warm-up
        # 48 batches a window, each a perturbed copy of the queries, and
        # the best of 2 windows: one call is a few host-bound milliseconds
        reps = 48
        qbs = [qs + 1e-4 * (i + 1) for i in range(reps)]
        best = float("inf")
        for rep in range(2):
            shifted = [qb + 1e-5 * (rep + 1) for qb in qbs]
            _sync(dev)
            t0 = time.perf_counter()
            for qb in shifted:
                search_batched(g, qb, k=k, ef=ef)
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
        latency = best / reps
        ids = ids.cpu().numpy()
        recall = float(
            np.mean(
                [
                    len(set(a[a >= 0].tolist()) & set(b.tolist())) / k
                    for a, b in zip(ids, true_ids)
                ]
            )
        )
        results.append(
            AutotuneResult(m, efc, ef, recall, latency, build_s,
                           engine=engine)
        )

    # selection: fastest meeting target, ties by build time (mod.rs:161-186)
    meeting = [r for r in results if r.recall >= target_recall]
    best = min(meeting, key=lambda r: (r.latency_s, r.build_s)) if meeting else None
    if model_name and results_path:
        save_results(model_name, results, results_path)
    return best, results
