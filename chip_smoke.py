#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lantern_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--n ROWS] [--seed SEED]

Phases, each of which exits non-zero on failure:

1. environment: torch, the card, ``nvidia-smi`` name and power limit;
2. build, in parallel: the K1 kernel (``csrc/gather_dists.cu``) and the PQ
   decode kernel (``csrc/pq_decode.cu``), nvcc for sm_90a, and the native
   host engine (g++), all from this checkout's sources;
3. K1 against its plain PyTorch version on the card at the beam's shapes
   (N = n rows, d = 128, Q = 1024, C in {1, 32}; f32 and bf16; l2sq and cos),
   tolerance 1e-5 relative + 1e-4 absolute, then timed (device time from
   torch.profiler, call time from CUDA events) beside its bound, its plain
   version and a library yardstick;
4. the PQ decode kernel against its plain version at the PQ shapes (1M rows
   at S=32/K=256/dsub=4, the 960-d S=240 codebook beyond shared memory, the
   grouped S=24/K=16/dsub=40, the S=24/K=64 OPQ shape, and a prime row
   count): decoded rows bit-equal, |x|^2 within 1e-5 relative, then timed
   the same way;
5. the f32 main path: ``Index(HnswParams(dim=128)).add`` of n clustered rows
   (SIFT1M's shape, 4096 centres, jitter 0.35, from the seed) built on all
   host cores, then ``Index.search`` in flat and graph mode (k=10, ef=64,
   8 seeds) on 1024-query batches, held against exact ground truth, then
   one batch of each mode profiled by kernel;
6. the PQ main path on the same rows: ``Index(HnswParams(dim=128,
   pq=True))``; ``add`` trains the S=32, K=256 codebook on the batch and
   builds the host graph over the decoded rows; ``Index.search`` in flat and
   graph mode, with ``rerank=100`` and ``rerank="auto"`` after one
   ``calibrate_rerank``, held against the same ground truth, with distance
   checks, recall floors and the decode kernel's launches per batch;
7. a small OPQ index at ``examples/pq_rerank.py``'s configuration (dim 96,
   24 subspaces, K=64, ``train_pq(rotate=True)``) over 100k rows: flat,
   graph and rerank through the kernel's K3 shape and the rotation;
8. one JSON line of kernel numbers, the ``nvidia-smi`` line, and last the
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
from lantern_tpu_torch.ops.pq_decode import codebook_bf16, pq_decode, pq_decode_ref

DIM, K, BATCH, N_BATCHES = 128, 10, 1024, 4
RTOL, ATOL = 1e-5, 1e-4
# one H100 SXM's published peaks: HBM bytes/s and f32 (non-tensor-core) flop/s
PEAK_BYTES_PER_S, PEAK_F32_FLOPS = 3.35e12, 67e12
FLAT_RECALL_MIN, GRAPH_RECALL_MIN = 0.999, 0.90
# PQ decode cases (rows, S, K, dsub); the first is the main path's block shape
PQ_CASES = [(1_000_000, 32, 256, 4), (200_000, 240, 256, 4),
            (200_000, 24, 16, 40), (100_000, 24, 64, 4), (99_991, 32, 256, 4)]
PQ_XSQ_RTOL = 1e-5
PQ_AUTO_RECALL_MIN = 0.90  # rerank="auto" recall@10 floor on the PQ path
OPQ_N, OPQ_DIM = 100_000, 96


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
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        kernels = {name: pool.submit(library_path, name)
                   for name in ("gather_dists", "pq_decode")}
        native = pool.submit(get_lib)
        sos = {name: f.result() for name, f in kernels.items()}
        native.result()
    log("build: lantern_tpu_torch/csrc/{gather_dists,pq_decode}.cu (nvcc "
        f"sm_90a) and the native engine (g++) in {time.perf_counter() - t0:.2f} s")
    for name, so in sos.items():
        with open(so + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")


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


def phase_pq_kernel(seed):
    """The PQ decode kernel against pq_decode_ref on the card, then
    timings. Returns (the main case's row, max abs error over all cases)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    rows, max_abs = [], 0.0
    for n, s, kc, dsub in PQ_CASES:
        dim = s * dsub
        cb = codebook_bf16(torch.randn((s, kc, dsub), generator=gen,
                                       device="cuda"))
        # two code sets: the decoded output alone (>= 190 MB) exceeds L2
        code_sets = [torch.randint(0, kc, (n, s), generator=gen, device="cuda",
                                   dtype=torch.uint8) for _ in range(2)]
        dec, xsq = pq_decode(code_sets[0], cb, want_xsq=True)
        want, want_xsq = pq_decode_ref(code_sets[0], cb, want_xsq=True)
        torch.cuda.synchronize()
        bit_equal = bool(torch.equal(dec.view(torch.int16), want.view(torch.int16)))
        xsq_err = (xsq - want_xsq).abs()
        xsq_rel = float((xsq_err / want_xsq.abs().clamp(min=1e-30)).max())
        abs_err = max(float((dec.float() - want.float()).abs().max()),
                      float(xsq_err.max()))
        max_abs = max(max_abs, abs_err)
        ok = bit_equal and xsq_rel <= PQ_XSQ_RTOL
        del dec, xsq, want, want_xsq
        table = cb.reshape(s * kc, dsub)
        offs = torch.arange(s, device="cuda") * kc
        # library yardstick: one embedding lookup of codes + s*K into the
        # [S*K, dsub] bf16 table (the index prepared outside the timing; no
        # |x|^2)
        idx_sets = [c.long() + offs for c in code_sets]
        fns = {
            "": (lambda c: pq_decode(c, cb, want_xsq=True), code_sets),
            "plain_": (lambda c: pq_decode_ref(c, cb, want_xsq=True), code_sets),
            "library_": (lambda i: torch.nn.functional.embedding(i, table),
                         idx_sets),
        }
        times = {}
        for key, (fn, inputs) in fns.items():
            times[key + "call_ms"] = cuda_ms(fn, inputs)
            times[key + "device_ms"] = device_ms(fn, inputs)
            times[key + "ms"] = times[key + "device_ms"] or times[key + "call_ms"]
        del idx_sets
        # each input read once, each output written once: codes, the bf16
        # codebook, the decoded rows and |x|^2; no arithmetic to speak of
        nbytes = n * s + s * kc * dsub * 2 + n * dim * 2 + n * 4
        row = dict(n=n, s=s, k=kc, dsub=dsub, ok=ok, bit_equal=bit_equal,
                   max_abs_err=abs_err, xsq_max_rel_err=xsq_rel, **times,
                   bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
                   bytes=nbytes)
        rows.append(row)
        log("pq_decode " + json.dumps(row))
        if not ok:
            fail(f"pq_decode disagrees with its plain version: {row}")
    return rows[0], max_abs


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
    # the f32 path's launches start here
    gather_dists.launches = pq_decode.launches = 0
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
    if pq_decode.launches:
        fail(f"the f32 path launched the PQ decode kernel {pq_decode.launches}"
             " times")
    for mode in ("flat", "graph"):
        profile_search(ix, batches[0], mode, results[mode]["ms_per_batch"],
                       mode=mode)
    if results["flat"]["recall_at_10"] < FLAT_RECALL_MIN:
        fail(f"flat recall@10 {results['flat']['recall_at_10']} < {FLAT_RECALL_MIN}")
    if results["graph"]["recall_at_10"] < GRAPH_RECALL_MIN:
        fail(f"graph recall@10 {results['graph']['recall_at_10']} < "
             f"{GRAPH_RECALL_MIN}")
    if launches == 0:
        fail("the graph search never launched K1 (gather_dists.launches == 0)")
    return launches, build_s, gt_i


def pq_exact_dists(graph, queries_dev, ids):
    """|q - x|^2 to the f32-decoded rows of ``ids`` [Q, k] (numpy)."""
    codes = graph.vectors[torch.from_numpy(ids).cuda()].long()  # [Q, k, S]
    s = codes.shape[-1]
    rows = graph.pq_codebook[torch.arange(s, device="cuda"), codes]
    rows = rows.reshape(*codes.shape[:2], -1)
    x_sq = (rows * rows).sum(-1)
    d = ((rows - queries_dev[:, None, :]) ** 2).sum(-1)
    return d.cpu().numpy(), x_sq.cpu().numpy()


def timed_modes(ix, batches, modes, gt_i, check=None):
    """Search every batch in each mode (one warm-up batch first); returns
    {name: result} with QPS, ms/batch, recall@10 and launches per batch.
    ``check(name, dists, ids)``, when given, holds the returned distances."""
    results = {}
    nq = sum(len(b) for b in batches)
    for name, kw in modes.items():
        ix.search(batches[0], k=K, **kw)  # warm-up
        torch.cuda.synchronize()
        pq0, k10 = pq_decode.launches, gather_dists.launches
        labels, dists = [], []
        t0 = time.perf_counter()
        for b in batches:
            d, lab = ix.search(b, k=K, **kw)
            labels.append(lab)
            dists.append(d)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        labels, dists = np.concatenate(labels), np.concatenate(dists)
        if labels.shape != (nq, K) or not np.isfinite(dists).all():
            fail(f"{name}: results of shape {labels.shape} or non-finite dists")
        ids = labels.astype(np.int64)  # default labels are the row numbers
        if check is not None:
            check(name, dists, ids)
        res = dict(mode=name, queries=nq, batch=BATCH, qps=nq / secs,
                   ms_per_batch=secs / len(batches) * 1e3,
                   recall_at_10=recall(ids, gt_i),
                   pq_decode_launches_per_batch=(pq_decode.launches - pq0)
                   / len(batches),
                   k1_launches_per_batch=(gather_dists.launches - k10)
                   / len(batches))
        results[name] = res
        log("search " + json.dumps(res))
    return results


def phase_pq_path(base, queries, queries_dev, gt_i, seed):
    """The PQ main path at full width: train on the batch inside add, host
    build over the decoded rows, then flat / graph / rerank / auto."""
    n = base.shape[0]
    # the PQ path's launches start here
    gather_dists.launches = pq_decode.launches = 0
    ix = Index(HnswParams(dim=DIM, pq=True), capacity=n, seed=seed,
               device="cuda")
    spans = {}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    ix.train_pq = timed("train", ix.train_pq)  # add() calls these two
    ix._preprocess = timed("encode_decode", ix._preprocess)
    t0 = time.perf_counter()
    ix.add(base, nthreads=0)
    add_s = time.perf_counter() - t0
    cb = ix._codebook
    log(f"pq add: {n} rows x {DIM}, S={cb.num_subvectors} K={cb.num_centroids}"
        f" dsub={cb.dsub}: {add_s:.1f} s = training {spans['train']:.1f} s "
        f"(25 Lloyd iterations on the card) + encode/decode "
        f"{spans['encode_decode'] - spans['train']:.1f} s + host build "
        f"{add_s - spans['encode_decode']:.1f} s (m=16, ef_construction=128, "
        "all host cores, over the decoded rows)")
    t0 = time.perf_counter()
    graph = ix.device_graph
    torch.cuda.synchronize()
    log(f"pq device mirror: {time.perf_counter() - t0:.2f} s (encode on the "
        f"card), codes {graph.vectors.numel() / 2**20:.0f} MiB "
        f"{tuple(graph.vectors.shape)} {graph.vectors.dtype}")
    t0 = time.perf_counter()
    cal = ix.calibrate_rerank(k=K)
    torch.cuda.synchronize()
    log("pq calibrate_rerank " + json.dumps(
        dict(cal, seconds=time.perf_counter() - t0)))

    batches = [queries[i:i + BATCH] for i in range(0, len(queries), BATCH)]
    rerank_rows = torch.from_numpy(base).cuda().to(torch.bfloat16)
    q_sq = (queries_dev * queries_dev).sum(1).cpu().numpy()[:, None]

    def check(name, dists, ids):
        if name in ("flat", "graph"):
            # flat scores bf16(q) against the bf16 decode; each rounding is
            # within 2^-9 relative, so the error is <= 2^-8 (|q|^2 + 2|x|^2),
            # held here with a factor 2 slack. Graph results are ADC sums
            # (f32 LUT) except the entry scan's seeds, which keep their
            # flat-scan distance.
            exact, x_sq = pq_exact_dists(graph, queries_dev, ids)
            ok = np.abs(dists - exact) <= 2.0 ** -7 * (q_sq + 2 * x_sq) + 1e-3
        else:
            rows = rerank_rows[torch.from_numpy(ids).cuda()].float()
            exact = ((rows - queries_dev[:, None, :]) ** 2).sum(-1).cpu().numpy()
            ok = np.isclose(dists, exact, rtol=1e-4, atol=1e-2)
        log(f"pq {name}: max |dist - exact| {np.abs(dists - exact).max():.3e}")
        if not ok.all():
            fail(f"pq {name}: returned distances disagree with the exact "
                 f"distances (max abs {np.abs(dists - exact).max()})")

    modes = {"pq_flat": dict(mode="flat"), "pq_graph": dict(mode="graph"),
             "pq_rerank100": dict(rerank=100), "pq_rerank_auto": dict(rerank="auto")}
    results = timed_modes(ix, batches, modes, gt_i,
                          lambda name, d, i: check(name[3:], d, i))
    launches = pq_decode.launches
    for name, kw in modes.items():
        profile_search(ix, batches[0], name, results[name]["ms_per_batch"], **kw)
    r = {name: res["recall_at_10"] for name, res in results.items()}
    if r["pq_rerank_auto"] < PQ_AUTO_RECALL_MIN:
        fail(f"pq rerank=auto recall@10 {r['pq_rerank_auto']} < "
             f"{PQ_AUTO_RECALL_MIN}")
    if r["pq_rerank100"] < r["pq_flat"]:
        fail(f"pq rerank=100 recall {r['pq_rerank100']} < ADC flat {r['pq_flat']}")
    for name in ("pq_flat", "pq_graph", "pq_rerank100"):
        if results[name]["pq_decode_launches_per_batch"] <= 0:
            fail(f"{name} never launched the PQ decode kernel")
    if gather_dists.launches:
        fail(f"the PQ path launched K1 {gather_dists.launches} times")
    return launches


def phase_opq(seed):
    """examples/pq_rerank.py's configuration at 100k rows on the card."""
    rng = np.random.default_rng(seed + 2)
    base = rng.standard_normal((OPQ_N, OPQ_DIM), dtype=np.float32)
    queries = rng.standard_normal((BATCH, OPQ_DIM), dtype=np.float32)
    _, gt = exact_search(torch.from_numpy(queries).cuda(),
                         torch.from_numpy(base).cuda(), K)
    gt = gt.cpu().numpy()
    ix = Index(HnswParams(dim=OPQ_DIM, m=16, ef_construction=64, pq=True,
                          num_subvectors=24, num_centroids=64),
               capacity=OPQ_N, seed=seed, device="cuda")
    t0 = time.perf_counter()
    ix.train_pq(base, rotate=True)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ix.add(base, nthreads=0)
    log(f"opq: {OPQ_N} x {OPQ_DIM}, S=24 K=64, OPQ training {train_s:.1f} s, "
        f"add {time.perf_counter() - t0:.1f} s")
    if ix.device_graph.pq_rotation is None:
        fail("opq: the index has no rotation")

    res = timed_modes(ix, [queries], {"opq_flat": dict(mode="flat"),
                                      "opq_graph": dict(mode="graph"),
                                      "opq_rerank100": dict(rerank=100)}, gt)
    for name, r in res.items():
        if r["pq_decode_launches_per_batch"] <= 0:
            fail(f"{name} never launched the PQ decode kernel")
    if res["opq_rerank100"]["recall_at_10"] < res["opq_flat"]["recall_at_10"]:
        fail("opq: rerank recall below the ADC scan's")


def profile_search(ix, batch, label, wall_ms, **search_kw):
    """Device time of one search batch by kernel (torch.profiler), and the
    device's idle share against the unprofiled wall time per batch."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ix.search(batch, k=K, **search_kw)
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    log("profile " + json.dumps({
        "mode": label, "device_busy_ms_per_batch": busy_ms,
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

    t_start = time.perf_counter()
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
    pq, pq_max_abs = phase_pq_kernel(args.seed)
    torch.cuda.synchronize()
    launches, _, gt_i = phase_main_path(base, queries, base_dev, queries_dev,
                                        args.seed)
    torch.cuda.synchronize()
    del base_dev
    pq_launches = phase_pq_path(base, queries, queries_dev, gt_i, args.seed)
    torch.cuda.synchronize()
    phase_opq(args.seed)
    torch.cuda.synchronize()
    log(f"whole run: {time.perf_counter() - t_start:.1f} s")

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
    }, {
        "name": "pq_decode",
        "route": "cuda",
        "source": "lantern_tpu_torch/csrc/pq_decode.cu",
        "replaces": "lantern_tpu/ops/pallas_kernels.py:302 (K2), "
                    "lantern_tpu/ops/pallas_kernels.py:386 (K3), "
                    "benchmarks/exp_hilo_v2.py:110 (K5), "
                    "benchmarks/exp_hilo_v3.py:135 (K6)",
        "launches": pq_launches,
        "max_abs_err": pq_max_abs,
        "ms": pq["ms"],
        "plain_ms": pq["plain_ms"],
        "bound_ms": pq["bound_ms"],
        "bound_by": pq["bound_by"],
        "library_ms": pq["library_ms"],
    }]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
