#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lantern_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--n ROWS] [--i8-n ROWS] [--seed SEED]

Phases, each of which exits non-zero on failure:

1. environment: torch, the card, ``nvidia-smi`` name, power limit and
   maximum SM clock;
2. build, in parallel: the K1 kernel (``csrc/gather_dists.cu``), the PQ
   decode kernel (``csrc/pq_decode.cu``) and the hamming kernel K4
   (``csrc/hamming.cu``), nvcc for sm_90a, and the native host engine (g++),
   all from this checkout's sources;
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
8. K4 (``hamming_block`` and its score epilogue ``hamming_scores``, with a
   ragged tombstone mask) against their plain versions on the card,
   bit-equal, at ragged shapes (Q and N off the tiles; W = 1, 3, 4, 32, 48,
   128 words) and the flat scan's shape (Q = 1024, N = n, W = 32), then timed
   there beside its bound, its plain version and two yardsticks of the same
   +-1 product on the tensor cores (a bf16 ``torch.matmul`` and an int8
   ``torch._int_mm``); it fails if K4 reads under 0.95 of its bound;
   ``hamming_exact_topk`` against a top-k of the plain distances;
9. the hamming main path: ``Index(HnswParams(dim=1024, metric=HAMMING,
   quant=B1))`` over n clustered 1024-bit rows (4096 random centres, each
   bit flipped with p = 1/8) given as packed uint32 words, built on all
   host cores, searched flat and graph (k=10, ef=64, 8 seeds) on 1024-query
   batches; ground truth from ``hamming_exact_topk``; returned distances
   equal to host-recomputed ones; tie-aware recall@10 floors; K4 launches
   per batch; the flat batch's profile has no pass over the score block
   beside K4 (no negate or mask kernel); one batch given as float +-1 rows
   returns the same labels;
10. the i8 main path: ``Index(HnswParams(dim=128, quant=I8))`` over the f32
   phase's rows (``--i8-n`` of them), flat and graph, recall@10 against the
   f32 truth and (flat) against an exact scan of the dequantised rows; no
   kernel launches (K1 and the decode kernel are bypassed, as in the
   reference);
11. the device build (``graph/build_device.py``): (a) ``Index(HnswParams(
   dim=128, m=16, ef_construction=128)).add(base, build="device",
   batch=1024)`` over the f32 phase's n rows with flat candidate pools, its
   seconds beside phase 5's host build, a window of full rounds timed and
   the next full round profiled after a warm-up round (top kernels,
   launches, device idle share, host and device time of the candidate scan,
   pair distances, selection loops and reverse passes; the record must hold
   the round's candidate-scan kernels, else a later round is profiled, at
   most 3 times), recall@10 at ef=64 with 8 seeds against phase 5's truth,
   ``Index.validate()`` and the engine's own search; (b) ``add(extra,
   build="device", candidates="beam")`` of INSERT_N new clustered
   rows: ``device_insert`` through the beam, K1's launches, self-search
   top-1 of the new rows, validation; (c), after phase 9, a hamming index
   built with ``build="device"`` over phase 9's rows: K4's launches,
   tie-aware recall@10;
12. persistence on (a)+(b)'s index (``storage/``, ``Index.save / load /
   follow / reindex_concurrent / search_streaming``), snapshots in a
   temporary directory checked for room first: (1) ``save``, then
   ``Index.load`` into the native and the python engine, whose flat and
   graph searches equal the original's exactly, and ``validate``; (2) a
   writer opened with ``log_path=`` adds WAL_N rows on one host thread and
   deletes WAL_DELETES labels, a follower (``Index.follow``) catches up and
   the crashed writer is reopened (both replays side by side), and both
   equal the writer: size, num_deleted, searches; (3)
   ``reindex_concurrent(build="device")`` while a thread keeps searching in
   graph mode and the main thread makes add/delete pairs: swapped, no
   tombstone left or deleted label returned, the pairs' rows found,
   recall@10 against an exact scan of the live rows, search batches served
   during the rebuild and their latency, peak device memory; (4)
   ``search_streaming`` of 16 queries to 1000 distinct live rows, the first
   64 those of ``search(k=64, mode="graph")``; (5), after phase 11 (c), the
   hamming index and phase 7's OPQ index saved and loaded with equal
   searches (K4; the decode kernel, rerank after ``set_rerank_source``),
   then the OPQ index compacted after deleting a tenth: rerank rows
   realigned, no deleted label returned;
13. one JSON line of kernel numbers (K1's and K4's ``build_launches`` from
   (b) and (c), every kernel's ``persist_launches`` from 12), the
   ``nvidia-smi`` line, and last the result line
   ``{"ok": true, "device": {...}}``.

Needs the ``lantern_tpu_torch`` package beside it and a CUDA device; never
imports jax or lantern_tpu.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from lantern_tpu_torch import HnswParams, Index
from lantern_tpu_torch.config import Metric, QuantKind
from lantern_tpu_torch.csrc.build import library_path
from lantern_tpu_torch.native import get_lib
from lantern_tpu_torch.ops.distance import exact_search, unpack_bits
from lantern_tpu_torch.ops.gather_dists import gather_dists, gather_dists_ref
from lantern_tpu_torch.ops.hamming import (
    hamming_block,
    hamming_block_ref,
    hamming_exact_topk,
    hamming_scores,
    hamming_scores_ref,
)
from lantern_tpu_torch.ops.pq_decode import codebook_bf16, pq_decode, pq_decode_ref
from lantern_tpu_torch.graph import build_device

DIM, K, BATCH, N_BATCHES = 128, 10, 1024, 4
RTOL, ATOL = 1e-5, 1e-4
# one H100 SXM's published peaks: HBM bytes/s, f32 (non-tensor-core) flop/s,
# int8 tensor-core op/s
PEAK_BYTES_PER_S, PEAK_F32_FLOPS, PEAK_INT8_OPS = 3.35e12, 67e12, 1979e12
# a kernel timed under this share of its bound was mis-timed (no run can go
# below the bound)
BOUND_SHARE_MIN = 0.95
FLAT_RECALL_MIN, GRAPH_RECALL_MIN = 0.999, 0.90
# PQ decode cases (rows, S, K, dsub); the first is the main path's block shape
PQ_CASES = [(1_000_000, 32, 256, 4), (200_000, 240, 256, 4),
            (200_000, 24, 16, 40), (100_000, 24, 64, 4), (99_991, 32, 256, 4)]
PQ_XSQ_RTOL = 1e-5
PQ_AUTO_RECALL_MIN = 0.90  # rerank="auto" recall@10 floor on the PQ path
OPQ_N, OPQ_DIM = 100_000, 96
# K4 cases (Q, N, W): ragged Q and N; 1, 3, 4 words; 1024, 1536, 4096 bits
K4_CASES = [(37, 333, 1), (1000, 99_991, 3), (1024, 65_537, 4),
            (1023, 100_003, 32), (77, 20_011, 48), (1024, 30_001, 128)]
HAM_DIM, HAM_CENTRES = 1024, 4096
HAM_WORDS = HAM_DIM // 32
HAM_FLAT_RECALL_MIN, HAM_GRAPH_RECALL_MIN = 0.999, 0.90
I8_RECALL_MIN = 0.85  # the reference's own i8 floor (tests/test_quant.py:79)
I8_DEQ_FLAT_RECALL_MIN = 0.98
INSERT_N = 65_536  # rows of the device-build phase's beam inserts
INSERT_SELF_MIN = 0.99  # self-search top-1 of the inserted rows
ENGINE_PROBES = 16  # built rows the engine's own search must find at rank 0
# full-batch rounds of the device build: ROUND_WINDOW of them timed from
# PROFILED_ROUND on, then the next one profiled
PROFILED_ROUND, ROUND_WINDOW = 400, 8
PROFILE_TRIES = 3  # profiled round pairs before an incomplete record fails
BUILD_SPANS = ("build.candidates", "build.pair_dists", "build.select",
               "build.reverse")
# the persistence phase: rows the writer adds through the insert log, labels
# it deletes, the rebuild's concurrent add/delete pairs (rows added, then
# half of them deleted), the search thread's pause between batches (it
# shares the interpreter with the rebuild's Python loops), the streaming
# scan's queries and rows, the share of the OPQ index compacted away
WAL_N, WAL_DELETES = 65_536, 50_000
RC_PAIRS, RC_PAIR_ROWS, RC_SEARCH_PAUSE_S = 4, 256, 0.5
STREAM_QUERIES, STREAM_ROWS = 16, 1000
OPQ_DELETE_EVERY = 10


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, inputs, warm: int = 3, reps: int | None = None) -> float:
    """Mean ms per call of fn(x) over ``inputs`` (cycled so the 50 MB L2
    cache cannot hold the working set), timed with CUDA events."""
    for x in inputs[:warm]:
        fn(x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    reps = reps or 5 * len(inputs)
    start.record()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _recorded(ev) -> bool:
    return any(e.self_device_time_total > 0 for e in ev)


def profiled(step, complete=_recorded, tries: int = 3):
    """torch.profiler's per-kernel averages over the second of two runs of
    ``step()`` in one session; the first is a warm-up, because sessions
    late in a long run lost kernels (a K4 time below what it can reach, a
    flat batch profile without its matmul). A session whose record fails
    ``complete`` (by default: no device time at all, seen once in a graph
    batch) is run again; [] if every try fails."""
    for _ in range(tries):
        got = {}
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA],
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                on_trace_ready=lambda p: got.setdefault("ev", p.key_averages()),
        ) as prof:
            for _ in range(2):
                step()
                torch.cuda.synchronize()
                prof.step()
        ev = got.get("ev", [])
        if complete(ev):
            return ev
    return []


def device_ms(fn, inputs, per_call: int | None = None):
    """Mean device time per call of fn(x): the summed durations of the CUDA
    kernels torch.profiler records over the calls. The record must hold
    every launch: ``per_call`` launches a call where that is known (1 for a
    kernel's wrapper), else a whole multiple of the calls. A session that
    lost a launch would time the kernel too fast, so it is run again; None
    if no try records them all (then only the CUDA-event time stands)."""
    reps = 5 * len(inputs)

    def calls():  # drops each output before the next call
        for i in range(reps):
            fn(inputs[i % len(inputs)])

    def complete(ev):
        n = sum(e.count for e in ev if e.self_device_time_total > 0)
        return n > 0 and (n == reps * per_call if per_call else n % reps == 0)

    us = sum(e.self_device_time_total for e in profiled(calls, complete))
    if us == 0:
        log("device_ms: torch.profiler lost launches in every try; the "
            "CUDA-event time stands")
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
    def query(fields):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]

    smi = query("name,power.limit")
    clock = query("clocks.max.sm")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    log(f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()} capability "
        f"{torch.cuda.get_device_capability(0)}")
    log(f"nvidia-smi: {smi}, clocks.max.sm {clock}")
    return smi


def phase_build():
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        kernels = {name: pool.submit(library_path, name)
                   for name in ("gather_dists", "pq_decode", "hamming")}
        native = pool.submit(get_lib)
        sos = {name: f.result() for name, f in kernels.items()}
        native.result()
    log("build: lantern_tpu_torch/csrc/{gather_dists,pq_decode,hamming}.cu "
        f"(nvcc sm_90a) and the native engine (g++) in "
        f"{time.perf_counter() - t0:.2f} s")
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
                    times[key + "device_ms"] = device_ms(
                        fn, id_sets, per_call=1 if key == "" else None)
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
            times[key + "device_ms"] = device_ms(
                fn, inputs, per_call=1 if key == "" else None)
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
    {name: result} with QPS, ms/batch, recall@10 and each kernel's launches
    per batch. ``check(name, dists, ids)``, when given, holds the returned
    distances and may return more fields for the result."""
    results = {}
    nq = sum(len(b) for b in batches)
    for name, kw in modes.items():
        ix.search(batches[0], k=K, **kw)  # warm-up
        torch.cuda.synchronize()
        pq0, k10, k40 = (pq_decode.launches, gather_dists.launches,
                         hamming_block.launches)
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
        extra = check(name, dists, ids) if check is not None else None
        res = dict(mode=name, queries=nq, batch=BATCH, qps=nq / secs,
                   ms_per_batch=secs / len(batches) * 1e3,
                   recall_at_10=recall(ids, gt_i),
                   pq_decode_launches_per_batch=(pq_decode.launches - pq0)
                   / len(batches),
                   k1_launches_per_batch=(gather_dists.launches - k10)
                   / len(batches),
                   k4_launches_per_batch=(hamming_block.launches - k40)
                   / len(batches), **(extra or {}))
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
    return ix, base, queries


def random_words(gen, rows, w):
    """[rows, w] int32 words of uniform random bits (about half >= 2^31)."""
    return torch.randint(-2**31, 2**31, (rows, w), generator=gen,
                         device="cuda", dtype=torch.int32)


def pm1(words, dim, dtype):
    """Unpack [N, W] words to +-1 [N, dim] of ``dtype`` (bit set -> +1), in
    chunks."""
    out = torch.empty((words.shape[0], dim), dtype=dtype, device=words.device)
    for i in range(0, words.shape[0], 1 << 16):
        out[i:i + (1 << 16)] = unpack_bits(words[i:i + (1 << 16)], dim) * 2 - 1
    return out


def phase_hamming_kernel(n, seed):
    """K4 and its score epilogue against their plain versions on the card
    (bit-equal), then timings at the flat scan's shape. Returns (the flat
    shape's row, max abs error)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    max_abs = 0.0
    for nq, nb, w in K4_CASES:
        q, b = random_words(gen, nq, w), random_words(gen, nb, w)
        dele = torch.rand(nb, generator=gen, device="cuda") < 0.3
        got, want = hamming_block(q, b), hamming_block_ref(q, b)
        got_s = hamming_scores(q, b, dele)
        want_s = hamming_scores_ref(q, b, dele)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_abs = max(max_abs, err)
        row = dict(q=nq, n=nb, w=w, bit_equal=bool(torch.equal(got, want)),
                   scores_bit_equal=bool(torch.equal(got_s, want_s)),
                   max_abs_err=err, device_ms=device_ms(
                       lambda x: hamming_block(q, x), [b], per_call=1))
        log("hamming_block " + json.dumps(row))
        if not (row["bit_equal"] and row["scores_bit_equal"]):
            fail(f"hamming_block disagrees with its plain version: {row}")
        del got, want, got_s, want_s

    # the flat scan's shape: Q = 1024 queries against n rows of 1024 bits
    w = HAM_WORDS
    q = random_words(gen, BATCH, w)
    bases = [random_words(gen, n, w) for _ in range(2)]
    got = hamming_block(q, bases[0])
    want = hamming_block_ref(q, bases[0])
    torch.cuda.synchronize()
    bit_equal = bool(torch.equal(got, want))
    err = float((got - want).abs().max())
    max_abs = max(max_abs, err)
    del got
    # the score epilogue with a ragged tombstone mask (a tenth of the rows)
    dele = torch.rand(n, generator=gen, device="cuda") < 0.1
    scores_equal = bool(torch.equal(hamming_scores(q, bases[0], dele),
                                    hamming_scores_ref(q, bases[0], dele)))
    # hamming_exact_topk against a top-k of the plain distances
    d, ids = hamming_exact_topk(q, bases[0], K)
    want_d, _ = torch.topk(want, K, dim=1, largest=False, sorted=True)
    topk_ok = bool(torch.equal(d, want_d)) and bool(torch.equal(
        torch.gather(want, 1, ids.long()), d))
    del want, d, ids, want_d
    times = {}
    times["call_ms"] = cuda_ms(lambda x: hamming_block(q, x), bases)
    times["device_ms"] = device_ms(lambda x: hamming_block(q, x), bases,
                                   per_call=1)
    times["ms"] = times["device_ms"] or times["call_ms"]
    times["scores_call_ms"] = cuda_ms(lambda x: hamming_scores(q, x, dele),
                                      bases)
    times["scores_device_ms"] = device_ms(
        lambda x: hamming_scores(q, x, dele), bases, per_call=1)
    # the plain version takes seconds a call here: one warm-up, two calls
    times["plain_ms"] = cuda_ms(lambda x: hamming_block_ref(q, x), bases,
                                warm=1, reps=2)
    # yardsticks: one call computing the +-1 product of the operands
    # (unpacked outside the timing), dot = 32W - 2 hamming: a bf16
    # torch.matmul [1024, 1024] x [1024, n] with bf16 out (rounded above
    # 256), and torch._int_mm of int8 operands with exact int32 out
    for key, dtype, fn in (
            ("library", torch.bfloat16, lambda a, x: torch.matmul(a, x.T)),
            ("library_int8", torch.int8, lambda a, x: torch._int_mm(a, x.T))):
        qa = pm1(q, 32 * w, dtype)
        pm = [pm1(b, 32 * w, dtype) for b in bases]
        times[key + "_call_ms"] = cuda_ms(lambda x: fn(qa, x), pm)
        times[key + "_device_ms"] = device_ms(lambda x: fn(qa, x), pm)
        times[key + "_ms"] = (times[key + "_device_ms"]
                              or times[key + "_call_ms"])
        del pm, qa
    nbytes = (BATCH + n) * w * 4 + BATCH * n * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = 2 * BATCH * n * 32 * w / PEAK_INT8_OPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    row = dict(q=BATCH, n=n, w=w, bit_equal=bit_equal,
               scores_bit_equal=scores_equal, topk_ok=topk_ok,
               max_abs_err=err, **times, bound_ms=bound_ms,
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bytes=nbytes, ops_ms=ops_ms,
               share_of_bound=bound_ms / times["ms"])
    log("hamming_block " + json.dumps(row))
    if not (bit_equal and scores_equal and topk_ok):
        fail(f"hamming_block, hamming_scores or hamming_exact_topk "
             f"disagrees: {row}")
    if row["ms"] < BOUND_SHARE_MIN * bound_ms:  # no run can go below it
        fail(f"hamming_block timed under {BOUND_SHARE_MIN} of its bound: "
             f"{row}")
    return row, max_abs


_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int64)
_POPCOUNT16 = np.array([bin(i).count("1") for i in range(1 << 16)], np.uint8)
HAM_HOST_TRUTH_QUERIES = 64  # queries whose k nearest the host recomputes


def host_hamming(rows, queries, ids):
    """Hamming distances [Q, k] of ``ids`` on the host (numpy byte table)."""
    x = np.bitwise_xor(queries[:, None, :], rows[ids])
    return _POPCOUNT8[x.view(np.uint8)].sum(-1).astype(np.float32)


def bit_rows(rng, centres, n):
    """centre XOR (r1 & r2 & r3): each bit flips with p = 1/8."""
    r1, r2, r3 = (rng.integers(0, 2**32, (n, centres.shape[1]), dtype=np.uint32)
                  for _ in range(3))
    return centres[rng.integers(0, len(centres), n)] ^ (r1 & r2 & r3)


def phase_hamming_path(n, seed):
    """The hamming main path at full width: 1024-bit rows (128 bytes each,
    the width of binary-quantised 1024-d sentence embeddings)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 4)
    centres = rng.integers(0, 2**32, (HAM_CENTRES, HAM_WORDS), dtype=np.uint32)
    rows = bit_rows(rng, centres, n)
    queries = bit_rows(rng, centres, N_BATCHES * BATCH)
    log(f"hamming data: {n} x {HAM_DIM} bits ({HAM_CENTRES} centres, p(flip) "
        f"1/8) + {len(queries)} queries in {time.perf_counter() - t0:.1f} s")
    ix = Index(HnswParams(dim=HAM_DIM, metric=Metric.HAMMING,
                          quant=QuantKind.B1), capacity=n, seed=seed,
               device="cuda")
    t0 = time.perf_counter()
    ix.add(rows, nthreads=0)
    build_s = time.perf_counter() - t0
    log(f"hamming host build: {n} rows x {HAM_DIM} bits (m=16, "
        f"ef_construction=128, all host cores) in {build_s:.1f} s")
    graph = ix.device_graph
    log(f"hamming device mirror: words {tuple(graph.vectors.shape)} "
        f"{graph.vectors.dtype}, {graph.vectors.numel() * 4 / 2**20:.0f} MiB")
    t0 = time.perf_counter()
    gt_d, gt_i = hamming_exact_topk(
        torch.from_numpy(queries.view(np.int32)).cuda(), graph.vectors, K)
    gt_d, gt_i = gt_d.cpu().numpy(), gt_i.cpu().numpy()
    log(f"hamming ground truth: hamming_exact_topk of {len(queries)} queries "
        f"in {time.perf_counter() - t0:.2f} s")
    # K4 scores that truth, so hold it on a sample to a scan on the host
    # (16-bit popcount table) that no kernel touches: the k nearest
    # distances must be equal, or K4 missed a true neighbour
    t0 = time.perf_counter()
    sample = np.linspace(0, len(queries) - 1, HAM_HOST_TRUTH_QUERIES).astype(int)
    for i in sample:
        d = _POPCOUNT16[(rows ^ queries[i]).view(np.uint16)].sum(
            1, dtype=np.int32)
        want = np.sort(np.partition(d, K - 1)[:K]).astype(np.float32)
        if not np.array_equal(gt_d[i], want):
            fail(f"hamming ground truth of query {i}: {gt_d[i].tolist()} "
                 f"!= the host scan's {want.tolist()}")
    log(f"hamming ground truth: the k nearest distances of {len(sample)} "
        "queries equal a host scan of all rows "
        f"({time.perf_counter() - t0:.1f} s)")
    kth = gt_d[:, K - 1:K]

    def check(name, dists, ids):
        exact = host_hamming(rows, queries, ids)
        if not np.array_equal(dists, exact):
            fail(f"{name}: returned distances differ from the host's hamming "
                 f"distances (max abs {np.abs(dists - exact).max()})")
        # tie-aware: a returned id counts if its distance is within the k-th
        # true distance (ids are distinct, so at most k count per query)
        return dict(recall_at_10_tie_aware=float((exact <= kth).mean()))

    batches = [queries[i:i + BATCH] for i in range(0, len(queries), BATCH)]
    # the hamming path's launches start here
    gather_dists.launches = pq_decode.launches = hamming_block.launches = 0
    modes = {"hamming_flat": dict(mode="flat"),
             "hamming_graph": dict(mode="graph")}
    results = timed_modes(ix, batches, modes, gt_i, check)
    launches = hamming_block.launches
    if gather_dists.launches or pq_decode.launches:
        fail("the hamming path launched K1 or the PQ decode kernel")
    for name, kw in modes.items():
        if results[name]["k4_launches_per_batch"] <= 0:
            fail(f"{name} never launched K4")
        ev = profile_search(ix, batches[0], name,
                            results[name]["ms_per_batch"], **kw)
        if name == "hamming_flat":
            check_one_pass(ev)
    # float +-1 rows, binarised inside search, return the packed batch's labels
    signs = np.unpackbits(batches[0].view(np.uint8), axis=1, bitorder="little")
    signs = signs.astype(np.float32) * 2 - 1
    for mode in ("flat", "graph"):
        _, lab_w = ix.search(batches[0], k=K, mode=mode)
        _, lab_f = ix.search(signs, k=K, mode=mode)
        if not np.array_equal(lab_w, lab_f):
            fail(f"hamming {mode}: float +-1 queries return other labels than "
                 "their packed words")
    log("hamming: float +-1 queries return the packed batch's labels (flat, "
        "graph)")
    r = {name: res["recall_at_10_tie_aware"] for name, res in results.items()}
    if r["hamming_flat"] < HAM_FLAT_RECALL_MIN:
        fail(f"hamming flat tie-aware recall@10 {r['hamming_flat']} < "
             f"{HAM_FLAT_RECALL_MIN}")
    if r["hamming_graph"] < HAM_GRAPH_RECALL_MIN:
        fail(f"hamming graph tie-aware recall@10 {r['hamming_graph']} < "
             f"{HAM_GRAPH_RECALL_MIN}")
    return launches, rows, queries, gt_i, gt_d, build_s, ix


def phase_i8_path(base, queries, queries_dev, gt_i, seed):
    """The i8 main path on the f32 phase's rows: int8 codes and per-row
    scales on the card, flat and graph, no kernel launched."""
    n = base.shape[0]
    gather_dists.launches = pq_decode.launches = hamming_block.launches = 0
    ix = Index(HnswParams(dim=DIM, quant=QuantKind.I8), capacity=n, seed=seed,
               device="cuda")
    t0 = time.perf_counter()
    ix.add(base, nthreads=0)
    log(f"i8 add: {n} rows x {DIM} (quantise + dequantise on the card, host "
        f"build over the dequantised rows, all host cores) in "
        f"{time.perf_counter() - t0:.1f} s")
    graph = ix.device_graph
    log(f"i8 device mirror: codes {tuple(graph.vectors.shape)} "
        f"{graph.vectors.dtype} {graph.vectors.numel() / 2**20:.0f} MiB + "
        f"scales {graph.vec_scales.numel() * 4 / 2**20:.1f} MiB")
    if gt_i is None:  # a cut i8 table: its own f32 truth
        _, gt_i = exact_search(queries_dev, torch.from_numpy(base).cuda(), K)
        gt_i = gt_i.cpu().numpy()
    deq = torch.from_numpy(np.array(ix._eng.vectors[:n])).cuda()
    _, gt_deq = exact_search(queries_dev, deq, K)
    gt_deq = gt_deq.cpu().numpy()
    q_sq = (queries_dev * queries_dev).sum(1).cpu().numpy()[:, None]

    def check(name, dists, ids):
        rows = deq[torch.from_numpy(ids).cuda()]
        exact = ((rows - queries_dev[:, None, :]) ** 2).sum(-1).cpu().numpy()
        x_sq = (rows * rows).sum(-1).cpu().numpy()
        # the flat scan (and the graph's entry seeds) score bf16(q): each
        # rounding is within 2^-9 relative, held with a factor 2 slack
        ok = np.abs(dists - exact) <= 2.0 ** -7 * (q_sq + x_sq) + 1e-3
        log(f"i8 {name}: max |dist - exact| {np.abs(dists - exact).max():.3e}")
        if not ok.all():
            fail(f"{name}: returned distances disagree with the dequantised "
                 f"rows' (max abs {np.abs(dists - exact).max()})")
        return dict(recall_at_10_vs_dequantised=recall(ids, gt_deq))

    batches = [queries[i:i + BATCH] for i in range(0, len(queries), BATCH)]
    modes = {"i8_flat": dict(mode="flat"), "i8_graph": dict(mode="graph")}
    results = timed_modes(ix, batches, modes, gt_i, check)
    del deq
    launched = (gather_dists.launches, pq_decode.launches, hamming_block.launches)
    if any(launched):
        fail(f"the i8 path launched kernels (K1, decode, K4) {launched}")
    for name, kw in modes.items():
        profile_search(ix, batches[0], name, results[name]["ms_per_batch"], **kw)
    for name, res in results.items():
        if res["recall_at_10"] < I8_RECALL_MIN:
            fail(f"{name} recall@10 {res['recall_at_10']} < {I8_RECALL_MIN}")
    deq_r = results["i8_flat"]["recall_at_10_vs_dequantised"]
    if deq_r < I8_DEQ_FLAT_RECALL_MIN:
        fail(f"i8 flat recall@10 against the dequantised rows {deq_r} < "
             f"{I8_DEQ_FLAT_RECALL_MIN}")


class RoundProbe:
    """Wraps the device builder's round function for one build: counts the
    rounds, times ROUND_WINDOW full-batch rounds from the ``at``-th on
    (host clock, a device sync at either end, so host and device overlap
    as in the build), then profiles the next two full rounds in one
    torch.profiler session (CPU and CUDA), the first as its warm-up, the
    second recorded. The record must hold the round's candidate-scan
    kernels: those whose names contain ``scan``, as many as ``counter``
    (a kernel wrapper) counted launches in the recorded round, and at
    least ``min_ms`` of device time (the least an SGEMM over the rows can
    take). An incomplete record is dropped and the next two full rounds
    profiled, up to PROFILE_TRIES times. Restores the function on exit.
    ``report`` fails if no record was complete."""

    def __init__(self, scan: str, counter=None, min_ms: float = 0.0,
                 at: int = PROFILED_ROUND):
        self.scan, self.counter, self.min_ms = scan, counter, min_ms
        self.at, self.rounds, self.full, self.tries = at, 0, 0, 0
        self.round_ms = self.events = self._prof = None
        self.incomplete = []  # (kernels recorded, launched, ms) per try

    def _ready(self, prof):
        events = prof.events()
        scan = [e for e in events if e.device_type == DeviceType.CUDA
                and self.scan in e.name]
        ms = sum(e.self_device_time_total for e in scan) / 1e3
        launched = (self.counter.launches - self._launches0
                    if self.counter is not None else None)
        if scan and ms >= self.min_ms and launched in (None, len(scan)):
            self.events, self.scan_ms = events, ms
        else:
            self.incomplete.append((len(scan), launched, ms))

    def __enter__(self):
        self.real = real = build_device._insert_round
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]

        def wrapped(st, ids, *a, **kw):
            self.rounds += 1
            if int((np.asarray(ids) >= 0).sum()) != BATCH:
                return real(st, ids, *a, **kw)
            self.full += 1
            if self.full == self.at:
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()
            if (self.full < self.at + ROUND_WINDOW or self.events is not None
                    or self.tries == PROFILE_TRIES):
                return real(st, ids, *a, **kw)
            if self.round_ms is None:
                torch.cuda.synchronize()
                self.round_ms = ((time.perf_counter() - self.t0) * 1e3
                                 / ROUND_WINDOW)
            warm = self._prof is None
            if warm:
                self._prof = torch.profiler.profile(
                    activities=acts, on_trace_ready=self._ready,
                    schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                     active=1))
                self._prof.__enter__()
            elif self.counter is not None:
                self._launches0 = self.counter.launches
            out = real(st, ids, *a, **kw)
            torch.cuda.synchronize()
            self._prof.step()  # after the recorded round: _ready runs
            if not warm:
                self._prof.__exit__(None, None, None)
                self._prof = None
                self.tries += 1
            return out

        build_device._insert_round = wrapped
        return self

    def __exit__(self, *exc):
        if self._prof is not None:  # the build ended after a warm-up round
            self._prof.__exit__(None, None, None)
        build_device._insert_round = self.real

    def report(self, label):
        """Log the profiled round: its device busy time (the kernels' and
        copies' own durations), launches and top kernels, the idle share
        against the timed rounds' mean, and each span of ``build_device``
        (``record_function``): its host time and its kernels' device time,
        both inclusive (the reverse passes include their own pair distances
        and selection loops)."""
        if self.events is None:
            fail(f"{label} round profile: no complete record in {self.tries} "
                 f"tries (candidate-scan kernels '{self.scan}' recorded, "
                 f"launched, ms: {self.incomplete}; at least {self.min_ms} ms "
                 f"needed) over {self.full} full rounds")
        kernels, spans = {}, {}
        for e in self.events:
            # the session's step annotation spans the round: not a kernel
            if e.name.startswith("ProfilerStep"):
                continue
            if e.device_type == DeviceType.CUDA and e.name not in BUILD_SPANS:
                k = kernels.setdefault(e.name, [0.0, 0])
                k[0] += e.self_device_time_total / 1e3
                k[1] += 1
            elif e.device_type == DeviceType.CPU and e.name in BUILD_SPANS:
                sp = spans.setdefault(e.name, {"host_ms": 0.0, "device_ms": 0.0,
                                               "calls": 0})
                sp["host_ms"] += e.cpu_time_total / 1e3
                sp["device_ms"] += e.device_time_total / 1e3
                sp["calls"] += 1
        busy_ms = sum(v[0] for v in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
        row = {"build": label,
               "profiled_round": self.at + ROUND_WINDOW + 2 * self.tries - 1,
               "tries": self.tries, "incomplete": self.incomplete,
               "scan": self.scan, "scan_ms": self.scan_ms,
               "scan_min_ms": self.min_ms,
               "batch": BATCH, "rounds": self.rounds,
               "round_ms_mean_of_window": self.round_ms,
               "window": ROUND_WINDOW, "device_busy_ms": busy_ms,
               "idle_share": 1.0 - busy_ms / self.round_ms,
               "launches": sum(v[1] for v in kernels.values()),
               "spans": spans,
               "top": [[k[:70], v[0], v[1]] for k, v in top]}
        log("build round profile " + json.dumps(row))
        return row


def sgemm_min_ms(rows: int) -> float:
    """The least device time of a flat-pool round's candidate scan: the
    [BATCH, DIM] x [DIM, rows] f32 product at the card's f32 peak."""
    return 2 * BATCH * rows * DIM / PEAK_F32_FLOPS * 1e3


def phase_device_build(base, queries, gt_i, centers, host_build_s, seed):
    """(a) the bulk device build of the f32 rows, (b) beam inserts into it.
    Returns K1's launches in (b) and the index."""
    n = base.shape[0]
    gather_dists.launches = pq_decode.launches = hamming_block.launches = 0
    ix = Index(HnswParams(dim=DIM, m=16, ef_construction=128), capacity=n,
               seed=seed, device="cuda")
    t0 = time.perf_counter()
    with RoundProbe("gemm", min_ms=sgemm_min_ms(n)) as probe:
        ix.add(base, build="device", batch=BATCH, seed=seed)
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"device build: {n} rows x {DIM} (m=16, ef_construction=128, batch "
        f"{BATCH}, flat pools) in {build_s:.1f} s over {probe.rounds} rounds "
        f"({build_s / probe.rounds * 1e3:.1f} ms a round, import into the "
        f"engine included); host build (phase 5, all host cores) "
        f"{host_build_s:.1f} s")
    probe.report("f32 flat")
    launched = (gather_dists.launches, pq_decode.launches, hamming_block.launches)
    log(f"device build launches (K1, decode, K4): {launched}")
    if any(launched):
        fail(f"the flat f32 device build launched kernels {launched}")
    t0 = time.perf_counter()
    rep = ix.validate()
    log(f"device build validate: ok {rep.ok}, {rep.n_reachable}/{rep.n} "
        f"reachable ({time.perf_counter() - t0:.1f} s)")
    rep.raise_if_failed()
    probes = np.linspace(0, n - 1, ENGINE_PROBES).astype(int)
    found = [int(ix._eng.search(base[i], k=K, ef=64)[0][0]) == i for i in probes]
    log(f"device build: the engine's own search finds {sum(found)}/"
        f"{len(found)} built rows at rank 0")
    if not all(found):
        fail("the engine's search misses rows of the imported device build")
    batches = [queries[i:i + BATCH] for i in range(0, len(queries), BATCH)]
    res = timed_modes(ix, batches, {"device_built_graph": dict(mode="graph")},
                      gt_i)["device_built_graph"]
    if res["recall_at_10"] < GRAPH_RECALL_MIN:
        fail(f"device-built graph recall@10 {res['recall_at_10']} < "
             f"{GRAPH_RECALL_MIN}")

    # (b) beam inserts: device_insert against the live graph
    rng = np.random.default_rng(seed + 5)
    extra = (centers[rng.integers(0, len(centers), INSERT_N)] + 0.35
             * rng.standard_normal((INSERT_N, DIM), dtype=np.float32))
    extra = extra.astype(np.float32)
    gather_dists.launches = 0
    t0 = time.perf_counter()
    with RoundProbe("gather_dists", counter=gather_dists,
                    at=INSERT_N // BATCH // 2 - ROUND_WINDOW) as probe:
        ix.add(extra, build="device", batch=BATCH, seed=seed,
               candidates="beam")
        torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    k1_launches = gather_dists.launches
    log(f"device insert: {INSERT_N} rows into {n} through the beam in "
        f"{insert_s:.1f} s over {probe.rounds} rounds, K1 launches "
        f"{k1_launches}")
    probe.report("f32 beam insert")
    if k1_launches <= 0:
        fail("the beam inserts never launched K1")
    labels = []
    for i in range(0, INSERT_N, BATCH):
        labels.append(ix.search(extra[i:i + BATCH], k=1, mode="graph")[1][:, 0])
    top1 = float((np.concatenate(labels) == n + np.arange(INSERT_N)).mean())
    log(f"device insert: self-search top-1 of the {INSERT_N} new rows {top1}")
    if top1 < INSERT_SELF_MIN:
        fail(f"inserted rows' self-search top-1 {top1} < {INSERT_SELF_MIN}")
    rep = ix.validate()
    log(f"device insert validate: ok {rep.ok}, {rep.n_reachable}/{rep.n} "
        "reachable")
    rep.raise_if_failed()
    return k1_launches, ix


def phase_hamming_device_build(rows, queries, gt_i, gt_d, host_build_s, seed):
    """(c) a hamming index built on the card over phase 9's rows: flat
    pools through K4's score epilogue. Returns K4's launches in the build."""
    n = rows.shape[0]
    gather_dists.launches = pq_decode.launches = hamming_block.launches = 0
    ix = Index(HnswParams(dim=HAM_DIM, metric=Metric.HAMMING,
                          quant=QuantKind.B1), capacity=n, seed=seed,
               device="cuda")
    t0 = time.perf_counter()
    with RoundProbe("hamming", counter=hamming_block) as probe:
        ix.add(rows, build="device", batch=BATCH, seed=seed)
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    k4_launches = hamming_block.launches
    log(f"hamming device build: {n} rows x {HAM_DIM} bits in {build_s:.1f} s "
        f"over {probe.rounds} rounds, K4 launches {k4_launches}; host build "
        f"(phase 9, all host cores) {host_build_s:.1f} s")
    probe.report("hamming flat")
    if k4_launches <= 0:
        fail("the hamming device build never launched K4")
    if gather_dists.launches or pq_decode.launches:
        fail("the hamming device build launched K1 or the PQ decode kernel")
    ix.validate().raise_if_failed()
    kth = gt_d[:, K - 1:K]

    def check(name, dists, ids):
        exact = host_hamming(rows, queries, ids)
        if not np.array_equal(dists, exact):
            fail(f"{name}: returned distances differ from the host's")
        return dict(recall_at_10_tie_aware=float((exact <= kth).mean()))

    batches = [queries[i:i + BATCH] for i in range(0, len(queries), BATCH)]
    res = timed_modes(ix, batches, {"hamming_device_built_graph":
                                    dict(mode="graph")}, gt_i, check)
    r = res["hamming_device_built_graph"]["recall_at_10_tie_aware"]
    if r < HAM_GRAPH_RECALL_MIN:
        fail(f"hamming device-built graph tie-aware recall@10 {r} < "
             f"{HAM_GRAPH_RECALL_MIN}")
    return k4_launches


def search_all(ix, batches, mode):
    """(dists, labels) of every batch in one mode, concatenated."""
    out = [ix.search(b, k=K, mode=mode) for b in batches]
    return (np.concatenate([d for d, _ in out]),
            np.concatenate([lab for _, lab in out]))


def check_equal(name, got, want):
    for what, a, b in zip(("distances", "labels"), got, want):
        if a.shape != b.shape or not np.array_equal(a, b):
            fail(f"{name}: {what} differ from the original's "
                 f"({int((a != b).sum()) if a.shape == b.shape else a.shape})")


def snapshot_dir(need_bytes: int):
    """A temporary directory with room for two snapshots of ``need_bytes``
    (a save writes the new file beside the old one before the rename)."""
    tmp = tempfile.TemporaryDirectory(prefix="lantern_smoke_")
    free = shutil.disk_usage(tmp.name).free
    if free < 2 * need_bytes + (256 << 20):
        tmp.cleanup()
        fail(f"no room for snapshots: {free / 2**20:.0f} MiB free in "
             f"{tmp.name}, {2 * need_bytes / 2**20:.0f} MiB + 256 MiB needed")
    return tmp


def snapshot_bytes(ix) -> int:
    """About the bytes of ``ix``'s snapshot: rows, level-0 adjacency, and
    labels, levels, counts and slots."""
    return ix.size * (ix._eng.vectors.itemsize * ix._eng.vectors.shape[1]
                      + 4 * ix.params.m0 + 24)


def check_live(name, labels, dead: np.ndarray):
    hit = np.isin(labels, dead)
    if hit.any():
        fail(f"{name}: {int(hit.sum())} deleted labels returned")


def phase_persistence(ix, queries, queries_dev, centers, seed):
    """(1)-(4) on the device-built f32 index: save and load into both
    engines; the insert log with a follower and a crash; a concurrent
    device rebuild under searches and writes; the streaming scan. Returns
    K1's launches (two threads in (3): counted, not held to a number)."""
    batches = [queries[i:i + BATCH] for i in range(0, len(queries), BATCH)]
    modes = ("graph", "flat")
    n = ix.size
    tmp = snapshot_dir(snapshot_bytes(ix))
    snap = os.path.join(tmp.name, "f32.ldb")
    wal = os.path.join(tmp.name, "f32.log")
    gather_dists.launches = pq_decode.launches = hamming_block.launches = 0

    # (1) save, load into the native and the python engine
    want = {mode: search_all(ix, batches, mode) for mode in modes}
    t0 = time.perf_counter()
    ix.save(snap)
    save_s = time.perf_counter() - t0
    snap_mb = os.path.getsize(snap) / 2**20
    load_s = {}
    for engine in ("native", "python"):
        t0 = time.perf_counter()
        loaded = Index.load(snap, engine=engine, device="cuda")
        load_s[engine] = time.perf_counter() - t0
        rep = loaded.validate()
        if not rep.ok:
            fail(f"load {engine}: validate: {rep.errors}")
        for mode in modes:
            check_equal(f"load {engine} {mode}", search_all(loaded, batches,
                                                            mode), want[mode])
        del loaded
    log("persistence save/load " + json.dumps(dict(
        rows=n, snapshot_mb=snap_mb, save_s=save_s, load_s=load_s,
        equal=f"{len(queries)} queries, graph (ef 64) and flat, both "
              "engines")))

    # (2) the insert log: a writer, a follower, the writer's crash
    rng = np.random.default_rng(seed + 6)
    new = (centers[rng.integers(0, len(centers), WAL_N)] + 0.35
           * rng.standard_normal((WAL_N, DIM), dtype=np.float32))
    new = new.astype(np.float32)
    new_labels = np.arange(n, n + WAL_N, dtype=np.uint64)
    dead = np.sort(rng.choice(n, WAL_DELETES, replace=False)).astype(np.uint64)
    writer = Index.load(snap, log_path=wal, device="cuda")
    follower = Index.follow(snap, wal, device="cuda")
    t0 = time.perf_counter()
    writer.add(new, labels=new_labels, nthreads=1)  # one thread: replayable
    add_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    writer.delete(dead)
    delete_s = time.perf_counter() - t0
    log_mb = os.path.getsize(wal) / 2**20
    w_state = (writer.size, writer.num_deleted)
    if w_state != (n + WAL_N, WAL_DELETES):
        fail(f"writer holds {w_state}, not {(n + WAL_N, WAL_DELETES)}")
    w_res = {mode: search_all(writer, batches, mode) for mode in modes}
    for mode in modes:
        check_live(f"writer {mode}", w_res[mode][1], dead)
    del writer  # the writer crashes: no save

    def timed(fn, *a, **kw):
        t0 = time.perf_counter()
        return fn(*a, **kw), time.perf_counter() - t0

    # the follower's catch-up and the crashed writer's reopening replay the
    # same log on one host thread each; run them side by side
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fut_c = pool.submit(timed, follower.catchup)
        fut_r = pool.submit(timed, Index.load, snap, log_path=wal,
                            device="cuda")
        (applied, catchup_s), (reopened, replay_s) = (fut_c.result(),
                                                      fut_r.result())
    if applied != WAL_N + WAL_DELETES:
        fail(f"follower applied {applied} records, not {WAL_N + WAL_DELETES}")
    for name, other in (("follower", follower), ("reopened", reopened)):
        state = (other.size, other.num_deleted)
        if state != w_state:
            fail(f"{name} holds {state}, the writer held {w_state}")
        for mode in modes:
            check_equal(f"{name} {mode}", search_all(other, batches, mode),
                        w_res[mode])
    del follower
    log("persistence wal " + json.dumps(dict(
        added=WAL_N, deleted=WAL_DELETES, log_mb=log_mb,
        writer_add_s=add_s, writer_delete_s=delete_s,
        follower_catchup_s=catchup_s, reopen_replay_s=replay_s,
        replay="one host thread each, side by side",
        equal="follower and reopened: size, num_deleted, graph and flat "
              "searches")))

    # (3) reindex_concurrent(build="device") under a search thread and writes
    ix2 = reopened
    ix2.search(batches[0], k=K, mode="graph")  # warm
    before = []
    for b in batches:
        t0 = time.perf_counter()
        ix2.search(b, k=K, mode="graph")
        before.append((time.perf_counter() - t0) * 1e3)
    pair_labels = np.arange(2 * n, 2 * n + RC_PAIRS * RC_PAIR_ROWS,
                            dtype=np.uint64)
    pair_rows = (centers[rng.integers(0, len(centers), len(pair_labels))]
                 + 0.35 * rng.standard_normal((len(pair_labels), DIM),
                                              dtype=np.float32))
    pair_rows = pair_rows.astype(np.float32)
    pair_dead = pair_labels.reshape(RC_PAIRS, RC_PAIR_ROWS)[:, :RC_PAIR_ROWS
                                                            // 2].ravel()
    all_dead = np.concatenate([dead, pair_dead])
    stop, errors, served = threading.Event(), [], []

    def searcher():
        try:
            i = 0
            while not stop.is_set():
                t0 = time.perf_counter()
                _, lab = ix2.search(batches[i % len(batches)], k=K,
                                    mode="graph")
                t1 = time.perf_counter()
                served.append((t1, (t1 - t0) * 1e3))
                if np.isin(lab, all_dead).any():
                    errors.append(f"batch {i}: a deleted label returned")
                i += 1
                stop.wait(RC_SEARCH_PAUSE_S)
        except Exception as e:  # reported by the main thread
            errors.append(repr(e))

    torch.cuda.reset_peak_memory_stats()
    thread = threading.Thread(target=searcher, name="smoke-search")
    thread.start()
    t_start = time.perf_counter()
    try:
        handle = ix2.reindex_concurrent(build="device", batch=BATCH, seed=seed)
        writes_s = []
        for p in range(RC_PAIRS):
            t0 = time.perf_counter()
            lo, hi = p * RC_PAIR_ROWS, (p + 1) * RC_PAIR_ROWS
            ix2.add(pair_rows[lo:hi], labels=pair_labels[lo:hi])
            ix2.delete(pair_labels[lo:lo + RC_PAIR_ROWS // 2])
            writes_s.append(time.perf_counter() - t0)
        writes_done = handle.done
        swapped = handle.join()
        t_done = time.perf_counter()
    finally:
        stop.set()
        thread.join(timeout=120)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if thread.is_alive():
        fail("the search thread did not stop")
    if errors:
        fail(f"search thread during the rebuild: {errors[:3]}")
    during = [ms for t, ms in served if t_start < t <= t_done]
    if not swapped:
        fail("reindex_concurrent did not swap")
    if not during:
        fail("no search batch completed during the rebuild")
    if writes_done:
        fail("the rebuild ended before the writes it should replay")
    want_size = n + WAL_N - WAL_DELETES + RC_PAIRS * RC_PAIR_ROWS // 2
    if (ix2.size, ix2.num_deleted) != (want_size, 0):
        fail(f"after the swap: size {ix2.size}, num_deleted "
             f"{ix2.num_deleted}; want {want_size}, 0")
    kept = pair_labels.reshape(RC_PAIRS, RC_PAIR_ROWS)[:, RC_PAIR_ROWS // 2:]
    kept_rows = pair_rows.reshape(RC_PAIRS, RC_PAIR_ROWS, DIM)[
        :, RC_PAIR_ROWS // 2:].reshape(-1, DIM)
    _, lab = ix2.search(kept_rows, k=1, mode="flat")
    if not np.array_equal(lab[:, 0], kept.ravel()):
        fail("rows added during the rebuild are not found after the swap")
    eng_rows = torch.from_numpy(np.array(ix2._eng.vectors[:ix2.size])).cuda()
    eng_labels = np.array(ix2._eng.labels[:ix2.size])
    _, truth = exact_search(queries_dev, eng_rows, K)
    truth = eng_labels[truth.cpu().numpy()]
    del eng_rows
    d, lab = search_all(ix2, batches, "graph")
    check_live("after the swap", lab, all_dead)
    rc_recall = recall(lab, truth)
    if rc_recall < GRAPH_RECALL_MIN:
        fail(f"recall@10 after reindex_concurrent {rc_recall} < "
             f"{GRAPH_RECALL_MIN}")
    log("persistence reindex_concurrent " + json.dumps(dict(
        rows_rebuilt=n + WAL_N - WAL_DELETES, rebuild_s=t_done - t_start,
        writes_s=writes_s, batches_during=len(during),
        search_pause_s=RC_SEARCH_PAUSE_S,
        latency_ms_before_median=float(np.median(before)),
        latency_ms_during_median=float(np.median(during)),
        latency_ms_during_max=float(np.max(during)),
        peak_gib=peak_gb, size=ix2.size, num_deleted=ix2.num_deleted,
        recall_at_10=rc_recall,
        stream="the rebuild's own CUDA stream")))

    # (4) the streaming scan to 1000 rows
    t0 = time.perf_counter()
    for i, q in enumerate(queries[:STREAM_QUERIES]):
        rows = list(itertools.islice(ix2.search_streaming(q), STREAM_ROWS))
        labs = np.array([lab for _, lab in rows], np.uint64)
        if len(rows) != STREAM_ROWS or len(np.unique(labs)) != len(labs):
            fail(f"streaming query {i}: {len(rows)} rows, "
                 f"{len(np.unique(labs))} distinct; want {STREAM_ROWS}")
        check_live(f"streaming query {i}", labs, all_dead)
        _, lab64 = ix2.search(q, k=64, mode="graph")
        if not np.array_equal(labs[:64], lab64[0]):
            fail(f"streaming query {i}: the first 64 rows are not "
                 "search(k=64, mode='graph')'s")
    stream_s = (time.perf_counter() - t0) / STREAM_QUERIES
    log("persistence streaming " + json.dumps(dict(
        queries=STREAM_QUERIES, rows=STREAM_ROWS, s_per_query=stream_s,
        tiers=list(Index.STREAM_TIERS))))
    launches = gather_dists.launches
    if launches <= 0:
        fail("the persistence phase never launched K1")
    tmp.cleanup()
    return launches


def phase_persistence_roundtrips(ham_ix, ham_queries, opq):
    """(5) save and load the hamming and OPQ indexes (searches equal: K4,
    the decode kernel), then compact the OPQ index. Returns K4's and the
    decode kernel's launches."""
    gather_dists.launches = pq_decode.launches = hamming_block.launches = 0
    opq_ix, opq_base, opq_queries = opq
    batches = [ham_queries[i:i + BATCH]
               for i in range(0, len(ham_queries), BATCH)]
    tmp = snapshot_dir(max(snapshot_bytes(ham_ix), snapshot_bytes(opq_ix)))
    path = os.path.join(tmp.name, "ix.ldb")
    t0 = time.perf_counter()
    ham_ix.save(path)
    save_s = time.perf_counter() - t0
    mb = os.path.getsize(path) / 2**20
    t0 = time.perf_counter()
    loaded = Index.load(path, device="cuda")
    load_s = time.perf_counter() - t0
    for mode in ("flat", "graph"):
        check_equal(f"hamming load {mode}", search_all(loaded, batches, mode),
                    search_all(ham_ix, batches, mode))
    del loaded
    os.remove(path)
    k4 = hamming_block.launches
    if k4 <= 0:
        fail("the hamming round trip never launched K4")
    log("persistence hamming " + json.dumps(dict(
        rows=ham_ix.size, snapshot_mb=mb, save_s=save_s, load_s=load_s,
        k4_launches=k4)))

    opq_ix.save(path)
    loaded = Index.load(path, device="cuda")
    cb, cb2 = opq_ix._codebook, loaded._codebook
    if not (np.array_equal(cb.centroids, cb2.centroids)
            and np.array_equal(cb.rotation, cb2.rotation)):
        fail("opq load: the codebook or its rotation did not persist")
    loaded.set_rerank_source(opq_base)
    for kw in (dict(mode="flat"), dict(mode="graph"), dict(rerank=100)):
        got, want = (loaded.search(opq_queries, k=K, **kw),
                     opq_ix.search(opq_queries, k=K, **kw))
        check_equal(f"opq load {kw}", got, want)
    del loaded
    tmp.cleanup()
    # compact away a tenth: the rerank rows follow the new slots
    dead = np.arange(0, len(opq_base), OPQ_DELETE_EVERY, dtype=np.uint64)
    opq_ix.delete(dead)
    t0 = time.perf_counter()
    opq_ix.compact(build="host")
    compact_s = time.perf_counter() - t0
    live = np.array(opq_ix._eng.labels[:opq_ix.size]).astype(np.int64)
    if (opq_ix.num_deleted != 0 or len(live) != len(opq_base) - len(dead)
            or not np.array_equal(opq_ix._raw_rows, opq_base[live])):
        fail("opq compact: tombstones kept or rerank rows not realigned")
    d, lab = opq_ix.search(opq_queries, k=K, rerank=100)
    check_live("opq compact rerank", lab, dead)
    rows = torch.from_numpy(opq_base[lab.astype(np.int64)]).cuda()
    exact = ((rows.to(torch.bfloat16).float()
              - torch.from_numpy(opq_queries).cuda()[:, None, :]) ** 2).sum(-1)
    if not np.allclose(d, exact.cpu().numpy(), rtol=1e-4, atol=1e-2):
        fail("opq compact: reranked distances are not the rows' distances")
    decode = pq_decode.launches
    if decode <= 0:
        fail("the opq round trip never launched the decode kernel")
    log("persistence opq " + json.dumps(dict(
        rows=len(opq_base), compacted_to=opq_ix.size, compact_s=compact_s,
        decode_launches=decode)))
    return k4, decode


def check_one_pass(ev):
    """The hamming flat batch's kernels (logged by name): K4 writes the
    negated, masked score block itself, so no negate or mask kernel may
    take a pass over it. A pass over the 4 GB block takes milliseconds;
    the negation of the [Q, k] result and the [N] tombstone mask take
    microseconds, so any such kernel above 0.1 ms is a pass over it."""
    log("hamming flat kernels: " + json.dumps(
        [[e.key, e.self_device_time_total / 1e3, e.count] for e in ev]))
    passes = [e.key for e in ev
              if ("neg" in e.key.lower() or "masked_fill" in e.key.lower())
              and e.self_device_time_total / 1e3 > 0.1]
    if passes:
        fail(f"the hamming flat batch makes a separate pass over its score "
             f"block: {passes}")


def profile_search(ix, batch, label, wall_ms, **search_kw):
    """Device time of one search batch by kernel (torch.profiler), and the
    device's idle share against the unprofiled wall time per batch. Returns
    the profiler's events with device time, largest first."""
    ev = sorted((e for e in profiled(lambda: ix.search(batch, k=K, **search_kw))
                 if e.self_device_time_total > 0),
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
    return ev


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="base rows")
    ap.add_argument("--i8-n", type=int, default=None,
                    help="rows of the i8 path (default: --n)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    i8_n = args.i8_n or args.n

    t_start = time.perf_counter()
    smi = phase_environment()
    phase_build()
    if args.n != 1_000_000:
        log(f"n cut: {args.n} rows instead of 1000000")
    if i8_n != args.n:
        log(f"i8 n cut: {i8_n} rows instead of {args.n}")
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
    k4, k4_max_abs = phase_hamming_kernel(args.n, args.seed)
    torch.cuda.synchronize()
    launches, host_build_s, gt_i = phase_main_path(
        base, queries, base_dev, queries_dev, args.seed)
    torch.cuda.synchronize()
    del base_dev
    k1_build_launches, dev_ix = phase_device_build(
        base, queries, gt_i, centers, host_build_s, args.seed)
    torch.cuda.synchronize()
    k1_persist = phase_persistence(dev_ix, queries, queries_dev, centers,
                                   args.seed)
    del dev_ix
    torch.cuda.synchronize()
    pq_launches = phase_pq_path(base, queries, queries_dev, gt_i, args.seed)
    torch.cuda.synchronize()
    opq = phase_opq(args.seed)
    torch.cuda.synchronize()
    (k4_launches, ham_rows, ham_queries, ham_gt_i, ham_gt_d, ham_build_s,
     ham_ix) = phase_hamming_path(args.n, args.seed)
    torch.cuda.synchronize()
    k4_build_launches = phase_hamming_device_build(
        ham_rows, ham_queries, ham_gt_i, ham_gt_d, ham_build_s, args.seed)
    del ham_rows
    torch.cuda.synchronize()
    k4_persist, pq_persist = phase_persistence_roundtrips(
        ham_ix, ham_queries, opq)
    del ham_ix, opq
    torch.cuda.synchronize()
    phase_i8_path(base[:i8_n], queries, queries_dev,
                  gt_i if i8_n == args.n else None, args.seed)
    torch.cuda.synchronize()
    log(f"whole run: {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"kernels": [{
        "name": "gather_dists",
        "route": "cuda",
        "source": "lantern_tpu_torch/csrc/gather_dists.cu",
        "replaces": "lantern_tpu/ops/pallas_gather.py:85",
        "launches": launches,
        "build_launches": k1_build_launches,
        "persist_launches": k1_persist,
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
        "persist_launches": pq_persist,
        "max_abs_err": pq_max_abs,
        "ms": pq["ms"],
        "plain_ms": pq["plain_ms"],
        "bound_ms": pq["bound_ms"],
        "bound_by": pq["bound_by"],
        "library_ms": pq["library_ms"],
    }, {
        "name": "hamming_block",
        "route": "cuda",
        "source": "lantern_tpu_torch/csrc/hamming.cu",
        "replaces": "lantern_tpu/ops/pallas_kernels.py:45 (K4) and :79 "
                    "(hamming_exact_topk)",
        "launches": k4_launches,
        "build_launches": k4_build_launches,
        "persist_launches": k4_persist,
        "max_abs_err": k4_max_abs,
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"],
    }]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
