#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lantern_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--n ROWS] [--seed SEED]

Phases, each of which exits non-zero on failure:

1. environment: torch, the card, ``nvidia-smi`` name and power limit;
2. build: the K1 kernel (``csrc/gather_dists.cu``, nvcc for sm_90a) and the
   native host engine (g++), both from this checkout's sources;
3. K1 against its plain PyTorch version on the card at the beam's shapes
   (N = n rows, d = 128, Q = 1024, C in {1, 32}; f32 and bf16; l2sq and cos),
   tolerance 1e-5 relative + 1e-4 absolute, then timed (device time from
   torch.profiler, call time from CUDA events) beside its bound, its plain
   version and a library yardstick;
4. the main path: ``Index(HnswParams(dim=128)).add`` of n clustered rows
   (SIFT1M's shape, 4096 centres, jitter 0.35, from the seed) built on all
   host cores, then ``Index.search`` in flat and graph mode (k=10, ef=64,
   8 seeds) on 1024-query batches, held against exact ground truth, then
   one batch of each mode profiled by kernel;
5. one JSON line of kernel numbers, the ``nvidia-smi`` line, and last the
   result line ``{"ok": true, "device": {...}}``.

Needs the ``lantern_tpu_torch`` package beside it and a CUDA device; never
imports jax or lantern_tpu.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np
import torch

from lantern_tpu_torch import HnswParams, Index
from lantern_tpu_torch.config import Metric
from lantern_tpu_torch.csrc.build import library_path
from lantern_tpu_torch.native import get_lib
from lantern_tpu_torch.ops.distance import exact_search
from lantern_tpu_torch.ops.gather_dists import gather_dists, gather_dists_ref

DIM, K, BATCH, N_BATCHES = 128, 10, 1024, 4
RTOL, ATOL = 1e-5, 1e-4
# one H100 SXM's published peaks: HBM bytes/s and f32 (non-tensor-core) flop/s
PEAK_BYTES_PER_S, PEAK_F32_FLOPS = 3.35e12, 67e12
FLAT_RECALL_MIN, GRAPH_RECALL_MIN = 0.999, 0.90


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, inputs, warm: int = 3) -> float:
    """Mean ms per call of fn(x) over ``inputs`` (cycled so the 50 MB L2
    cache cannot hold the working set), timed with CUDA events."""
    for x in inputs[:warm]:
        fn(x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    reps = 5 * len(inputs)
    start.record()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, inputs, warm: int = 3):
    """Mean device time per call of fn(x): the summed durations of the CUDA
    kernels torch.profiler records over the calls, or None if it records
    none (then only the CUDA-event time stands)."""
    for x in inputs[:warm]:
        fn(x)
    torch.cuda.synchronize()
    reps = 5 * len(inputs)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / 1e3 / reps if us > 0 else None


def clustered(rng, n, n_centers=4096, jitter=0.35):
    """benchmarks/clustered_1m.py's recipe, in numpy: centre + jitter."""
    centers = rng.standard_normal((n_centers, DIM), dtype=np.float32)
    assign = rng.integers(0, n_centers, n)
    out = rng.standard_normal((n, DIM), dtype=np.float32)
    out *= jitter
    out += centers[assign]
    return out, centers


def phase_environment():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    log(f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()} capability "
        f"{torch.cuda.get_device_capability(0)}")
    log(f"nvidia-smi: {smi}")
    return smi


def phase_build():
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        k1 = pool.submit(library_path, "gather_dists")
        native = pool.submit(get_lib)
        so = k1.result()
        native.result()
    log(f"build: K1 lantern_tpu_torch/csrc/gather_dists.cu (nvcc sm_90a) and "
        f"the native engine (g++) in {time.perf_counter() - t0:.2f} s")
    with open(so + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")


def phase_kernel(base_dev, queries_dev, seed):
    """K1 against gather_dists_ref on the card, then timings."""
    n = base_dev.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = queries_dev[:BATCH].contiguous()
    q_sq = (q * q).sum(1)
    tables = {"f32": base_dev, "bf16": base_dev.to(torch.bfloat16)}
    rows, max_abs = [], 0.0
    for c in (1, 32):
        # 10 id sets: 10 x 17 MB of rows at C=32, beyond the L2 cache
        id_sets = [torch.randint(0, n, (BATCH, c), generator=gen, device="cuda",
                                 dtype=torch.int32) for _ in range(10)]
        for dt, vec in tables.items():
            for metric in (Metric.L2SQ, Metric.COS):
                got = gather_dists(vec, id_sets[0], q, q_sq, metric)
                want = gather_dists_ref(vec, id_sets[0], q, q_sq, metric)
                torch.cuda.synchronize()
                err = (got - want).abs()
                ok = bool((err <= ATOL + RTOL * want.abs()).all())
                abs_err = float(err.max())
                rel_err = float((err / want.abs().clamp(min=1e-30)).max())
                max_abs = max(max_abs, abs_err)
                qc = q.to(vec.dtype)[:, :, None]
                fns = {
                    "": lambda i: gather_dists(vec, i, q, q_sq, metric),
                    "plain_": lambda i: gather_dists_ref(vec, i, q, q_sq, metric),
                    # library yardstick: two calls, a row gather and torch.bmm
                    "library_": lambda i: torch.bmm(vec[i], qc),
                }
                times = {}
                for key, fn in fns.items():
                    # device: kernel time alone; call: CUDA events around
                    # back-to-back calls, so host overhead shows when larger
                    times[key + "call_ms"] = cuda_ms(fn, id_sets)
                    times[key + "device_ms"] = device_ms(fn, id_sets)
                    times[key + "ms"] = (times[key + "device_ms"]
                                         or times[key + "call_ms"])
                itemsize = vec.element_size()
                nbytes = BATCH * c * (DIM * itemsize + 4) + BATCH * DIM * 4 + (
                    BATCH * 4) + BATCH * c * 4
                bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
                ops_ms = 4 * BATCH * c * DIM / PEAK_F32_FLOPS * 1e3
                row = dict(c=c, dtype=dt, metric=metric.name.lower(), ok=ok,
                           max_abs_err=abs_err, max_rel_err=rel_err, **times,
                           bound_ms=max(bytes_ms, ops_ms),
                           bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                           bytes=nbytes)
                rows.append(row)
                log("K1 " + json.dumps(row))
                if not ok:
                    fail(f"K1 disagrees with its plain version: {row}")
    main = next(r for r in rows
                if r["c"] == 32 and r["dtype"] == "f32" and r["metric"] == "l2sq")
    return main, max_abs


def recall(found, truth):
    hits = sum(len(set(f.tolist()) & set(t.tolist())) for f, t in zip(found, truth))
    return hits / truth.size


def phase_main_path(base, queries, base_dev, queries_dev, seed):
    n = base.shape[0]
    ix = Index(HnswParams(dim=DIM), capacity=n, seed=seed, device="cuda")
    t0 = time.perf_counter()
    ix.add(base, nthreads=0)
    build_s = time.perf_counter() - t0
    log(f"host build: {n} rows x {DIM} (m=16, ef_construction=128, all host "
        f"cores) in {build_s:.1f} s")
    t0 = time.perf_counter()
    graph = ix.device_graph
    torch.cuda.synchronize()
    log(f"device mirror: {time.perf_counter() - t0:.2f} s, vectors "
        f"{graph.vectors.numel() * graph.vectors.element_size() / 2**20:.0f} MiB,"
        f" neighbors0 {graph.neighbors0.numel() * 4 / 2**20:.0f} MiB")

    t0 = time.perf_counter()
    gt_d, gt_i = exact_search(queries_dev, base_dev, K)  # full f32, TF32 off
    torch.cuda.synchronize()
    gt_i = gt_i.cpu().numpy()
    log(f"ground truth: exact_search of {len(queries)} queries in "
        f"{time.perf_counter() - t0:.2f} s")

    batches = [queries[i:i + BATCH] for i in range(0, len(queries), BATCH)]
    results = {}
    gather_dists.launches = 0  # the main path's launches start here
    for mode in ("flat", "graph"):
        ix.search(batches[0], k=K, mode=mode)  # warm-up
        torch.cuda.synchronize()
        launches0 = gather_dists.launches
        labels, dists, stats = [], [], []
        t0 = time.perf_counter()
        for b in batches:
            d, lab, st = ix.search(b, k=K, mode=mode, with_stats=True)
            labels.append(lab)
            dists.append(d)
            stats.append(st)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        labels, dists = np.concatenate(labels), np.concatenate(dists)
        if labels.shape != (len(queries), K) or not np.isfinite(dists).all():
            fail(f"{mode}: results of shape {labels.shape} or non-finite dists")
        ids = labels.astype(np.int64)  # default labels are the row numbers
        rows = base_dev[torch.from_numpy(ids).cuda()]
        exact_d = ((rows - queries_dev[:, None, :]) ** 2).sum(-1).cpu().numpy()
        if not np.allclose(dists, exact_d, rtol=1e-4, atol=1e-2):
            fail(f"{mode}: returned distances disagree with the rows' exact "
                 f"distances (max abs {np.abs(dists - exact_d).max()})")
        res = dict(mode=mode, queries=len(queries), batch=BATCH,
                   qps=len(queries) / secs, ms_per_batch=secs / len(batches) * 1e3,
                   recall_at_10=recall(ids, gt_i))
        if mode == "graph":
            res.update(
                iterations_mean=float(np.mean([s["iterations"] for s in stats])),
                visited_per_query=float(np.mean([s["visited"].mean() for s in stats])),
                k1_launches_per_batch=(gather_dists.launches - launches0) / len(batches))
        results[mode] = res
        log("search " + json.dumps(res))
    launches = gather_dists.launches
    for mode in ("flat", "graph"):
        profile_search(ix, batches[0], mode, results[mode]["ms_per_batch"])
    if results["flat"]["recall_at_10"] < FLAT_RECALL_MIN:
        fail(f"flat recall@10 {results['flat']['recall_at_10']} < {FLAT_RECALL_MIN}")
    if results["graph"]["recall_at_10"] < GRAPH_RECALL_MIN:
        fail(f"graph recall@10 {results['graph']['recall_at_10']} < "
             f"{GRAPH_RECALL_MIN}")
    if launches == 0:
        fail("the graph search never launched K1 (gather_dists.launches == 0)")
    return launches, build_s


def profile_search(ix, batch, mode, wall_ms):
    """Device time of one search batch by kernel (torch.profiler), and the
    device's idle share against the unprofiled wall time per batch."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ix.search(batch, k=K, mode=mode)
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    log("profile " + json.dumps({
        "mode": mode, "device_busy_ms_per_batch": busy_ms,
        "wall_ms_per_batch": wall_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "kernels": len(ev), "launches": sum(e.count for e in ev),
        "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                for e in ev[:8]],
    }))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="base rows")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    smi = phase_environment()
    phase_build()
    if args.n != 1_000_000:
        log(f"n cut: {args.n} rows instead of 1000000")
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    base, centers = clustered(rng, args.n)
    assign = rng.integers(0, len(centers), N_BATCHES * BATCH)
    queries = (centers[assign] + 0.35 * rng.standard_normal(
        (len(assign), DIM), dtype=np.float32)).astype(np.float32)
    base_dev = torch.from_numpy(base).cuda()
    queries_dev = torch.from_numpy(queries).cuda()
    log(f"data: {args.n} x {DIM} clustered rows + {len(queries)} queries in "
        f"{time.perf_counter() - t0:.1f} s (seed {args.seed})")

    k1, max_abs = phase_kernel(base_dev, queries_dev, args.seed)
    torch.cuda.synchronize()
    launches, _ = phase_main_path(base, queries, base_dev, queries_dev, args.seed)
    torch.cuda.synchronize()

    log(json.dumps({"kernels": [{
        "name": "gather_dists",
        "route": "cuda",
        "source": "lantern_tpu_torch/csrc/gather_dists.cu",
        "replaces": "lantern_tpu/ops/pallas_gather.py:85",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
    }]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
