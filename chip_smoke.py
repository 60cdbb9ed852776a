#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lantern_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--n ROWS] [--i8-n ROWS] [--seed SEED]

Phases, each of which exits non-zero on failure:

1. environment: torch, the card, ``nvidia-smi`` name, power limit and
   maximum SM clock;
2. build, in parallel: the K1 kernel (``csrc/gather_dists.cu``), the PQ
   decode kernel (``csrc/pq_decode.cu``), the hamming kernel K4
   (``csrc/hamming.cu``) and the cosine score block (``csrc/cos_block.cu``),
   nvcc for sm_90a, and the native host engine (g++),
   all from this checkout's sources;
3. K1 against its plain PyTorch version on the card at the beam's shapes
   (N = n rows, d = 128, Q = 1024, C in {1, 32}; f32 and bf16; l2sq and cos),
   tolerance 1e-5 relative + 1e-4 absolute, then timed (device time from
   torch.profiler, call time from CUDA events) beside its bound, its plain
   version and a library yardstick;
4. the PQ decode kernel against its plain version at the PQ shapes (1M rows
   at S=32/K=256/dsub=4, the 960-d S=240 codebook in shared-memory slices,
   the grouped S=24/K=16/dsub=40, the S=24/K=64 OPQ shape, a prime row
   count, and the OPQ shape's codes as a view one row into a larger
   table): decoded rows bit-equal, |x|^2 within 1e-5 relative and
   bit-equal on a repeat call, the kernel's plan logged, then timed the same
   way with its share of the bound; then one ``flat_search_pq`` batch of
   1024 queries over the 960-d codes, timed, with the decode's share of its
   device time;
5. the f32 main path: ``Index(HnswParams(dim=128)).add`` of n clustered rows
   (SIFT1M's shape, 4096 centres, jitter 0.35, from the seed) built on all
   host cores, then ``Index.search`` in flat and graph mode (k=10, ef=64,
   8 seeds) on 1024-query batches, held against exact ground truth, then
   one batch of each mode profiled by kernel;
6. the PQ main path on the first PQ_PATH_N of the same rows:
   ``Index(HnswParams(dim=128, pq=True))``; ``add`` trains the S=32, K=256
   codebook on the batch and builds the host graph over the decoded rows;
   ``Index.search`` in flat and graph mode, with ``rerank=100`` and
   ``rerank="auto"`` after one ``calibrate_rerank``, held against an exact
   scan of those rows, with distance
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
   ``hamming_exact_topk`` against a top-k of the plain distances; then the
   cosine score block kernel (``ops/cos_block.py``) at ``openai1m``'s flat
   shape (Q = 1024, N = 1M, d = 1536 unit rows made on the card, a tenth
   masked): one ``flat_search`` through it (one launch, counted from 0),
   whose distances against float64 give its ``dist_gap`` (at most
   COS_DIST_GAP_MAX), its whole block against the plain version and
   float64 with -inf exactly at the masked rows, and its time beside its
   bound, the plain version and two library products the port never calls
   (the FFMA and the TF32 ``torch.matmul``); then the flat scan's row
   select (``ops/row_topk.py``) over the l2sq block of 1024 queries against
   the n rows: one ``flat_search`` through it (one launch, counted from 0),
   the kernel bit-equal to its plain version at k = 10 and 128, and its time
   beside its bound (one read of the block), the plain version and
   ``torch.topk``;
9. the hamming main path: ``Index(HnswParams(dim=1024, metric=HAMMING,
   quant=B1))`` over HAM_PATH_N clustered 1024-bit rows (4096 random
   centres, each bit flipped with p = 1/8) given as packed uint32 words,
   built on all host cores, searched flat and graph (k=10, ef=64, 8 seeds)
   on 1024-query batches; ground truth from ``hamming_exact_topk``;
   returned distances equal to host-recomputed ones; tie-aware recall@10
   floors; K4 launches per batch; the flat batch's profile has no pass over
   the score block beside K4 (no negate or mask kernel); one batch given as
   float +-1 rows returns the same labels;
10. the i8 main path: ``Index(HnswParams(dim=128, quant=I8))`` over the f32
   phase's first I8_N rows (``--i8-n``), flat and graph, recall@10 against the
   f32 truth and (flat) against an exact scan of the dequantised rows; no
   kernel launches (K1 and the decode kernel are bypassed, as in the
   reference);
11. the device build (``graph/build_device.py``): (a) the f32 phase's n
   rows streamed (labels 0..n-1) by ``build_via_server`` to an in-process
   ``IndexServer(build="device")``, which builds them with
   ``build_on_device`` (m=16, ef_construction=128, batch=1024, flat
   candidate pools) in its executor thread and sends its snapshot back,
   loaded onto the card: the client's stream, build-wait and receive
   seconds, tuples/s, the snapshot's bytes, the status endpoint's
   ``Succeeded``, the build's seconds beside phase 5's host build; the
   reply kept for phase 13; a window of full rounds timed and
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
   tie-aware recall@10 against phase 9's truth;
12. persistence on (a)+(b)'s index (``storage/``, ``Index.save / load /
   follow / reindex_concurrent / search_streaming``), snapshots in a
   temporary directory checked for room first: (1) ``save``, then
   ``Index.load`` into the native and the python engine, whose flat and
   graph searches equal the original's exactly, and ``validate``; (2) on
   an index of the first PERSIST_N rows built on the host and saved, a
   writer opened with ``log_path=`` adds WAL_N rows on one host thread and
   deletes WAL_DELETES labels, a follower (``Index.follow``) catches up and
   the crashed writer is reopened (both replays side by side), and both
   equal the writer: size, num_deleted, searches; (3)
   ``reindex_concurrent(build="device")`` while a thread keeps searching in
   graph mode and the main thread makes add/delete pairs: swapped, no
   tombstone left, no label returned by a search that began after its
   delete() returned, the pairs' rows found, recall@10 against an exact
   scan of the live rows, search batches served during the rebuild and
   their latency, peak device memory; (4) ``search_streaming`` of
   STREAM_QUERIES queries to 1000 distinct live rows, the first 64 those
   of ``search(k=64, mode="graph")``; (5), after phase 11 (c), the
   hamming index and phase 7's OPQ index saved and loaded with equal
   searches (K4; the decode kernel, rerank after ``set_rerank_source``),
   then the OPQ index compacted after deleting a tenth: rerank rows
   realigned, no deleted label returned;
13. the services (``service/``, ``weighted``, ``autotune``, ``cli``) on the
   server's snapshot from 11 (a): (b) ``HttpApi(data_dir=...)`` serving
   it as a collection; HTTP_REQUESTS single-vector ``POST .../search``
   requests (k=10) from HTTP_THREADS client threads, each equal to
   ``Index.search`` of the same query on a directly loaded copy (ties
   aside), recall@10 against phase 5's truth, request latency (median,
   p99), requests/s, the direct single-query latency, the cost model's
   mode; (c) a collection of HTTP_N of the rows built over HTTP (rows in
   requests of HTTP_BATCH, ``/index {"external": true}``, ``/pq`` with 32
   subspaces, searches with ``rerank`` 100 and ``"auto"``, the decode
   kernel's launches, a tenth deleted and ``/compact``, no deleted id
   returned), recall against exact scans of its rows; a hamming
   collection of HTTP_HAM_N 1024-bit rows sent as +-1 floats, distances
   equal to the host's, K4's launches; (d) ``weighted_search`` of two
   query columns (0.7 / 0.3) over the copy, held to an exact float64
   re-rank of its candidate pools; (e) an ``autotune`` job (10,000 sampled
   rows, the AUTOTUNE_JOB_VARIANTS, 10 queries) through
   ``Daemon(JobQueue(...))``,
   completed with a best variant at 0.9, then reused from its stored
   result with no sweep; ``cli.main(["search", ..., "--mode", "graph"])``
   over the snapshot and phase 5's queries, recall@10 and K1's launches;
   ``cli.main(["pq-table", ..., "--chunk-rows", ...])`` over the rows as
   .npy: codes equal to ``pq_encode``'s, MSE within PQ_MSE_RATIO of
   in-RAM training, a run stopped after PQ_STOP_PASSES passes and resumed
   bit-identical to it; any non-200 response, error frame or failed job
   fails the run;
14. sharding (``parallel/sharded.py``): the f32 phase's rows over SHARDS
   shards stacked on the one card, every kernel's launches counted from 0
   over (a)-(d): (a) ``build_sharded_device`` (batch 1024, flat pools) beside
   phase 11's single-index build; ``search_sharded`` (k=10, ef=64) on the
   query batches, recall@10 against phase 5's truth, ms a batch and K1's
   launches a batch beside phase 5's; ``flat_search_sharded(exact=True)``;
   (b) ``quantize_sharded("pq")`` (32 subvectors, trained on
   SHARD_PQ_TRAIN_ROWS rows, rerank rows kept): the ADC flat scan and
   ``flat_search_sharded_rerank`` (shortlist SHARD_RERANK), the rerank's
   recall at least the scan's, the decode kernel's launches;
   ``quantize_sharded("i8")``, beam and flat; (c) ``insert_sharded`` of
   SHARD_INSERT_N clustered rows (self-search top-1), ``delete_sharded`` of
   SHARD_DELETES labels (none returned), ``save_sharded`` / ``load_sharded``
   (snapshot MiB, seconds; graph and flat searches after the load equal
   to before), ``build_sharded`` (host) and ``compact_sharded`` of the
   first SHARD_COMPACT_N rows with a tenth deleted; (d)
   ``build_sharded_device`` over phase 9's first SHARD_HAM_N 1024-bit rows
   (K4 pools), beam and flat: distances equal to the host's popcount,
   tie-aware recall@10 against a K4 truth over those rows;
15. ranks (``init_multihost``, ``make_mesh`` over a process group): phase
   14's S=4 index placed over ranks of this script (``--rank-leg``, started
   with torchrun's environment, each leg killed and failed at its wall
   limit, any rank's failure failing the run), every kernel's launches
   summed over the ranks: (a) one NCCL rank: ``build_sharded_device``
   (shard digests equal to phase 14's), beam and exact flat results equal
   to phase 14's; NCCL with two ranks on the one card must raise; (b) two
   gloo ranks sharing the card, two shards each: the same build, beam and
   flat, ``quantize_sharded("pq")`` (one codebook on both ranks; rerank
   equal to phase 14's when the codebook is, recall floor), phase 14's
   inserts and deletes (searches equal), ``save_sharded`` (files
   byte-equal to phase 14's one-process save) and ``load_sharded`` on the
   ranks and in this process (searches equal), the hamming rows' device
   build, beam and flat scan (equal to phase 14 (d)); (c) four gloo ranks,
   data=RANKS_DATA x 2 shard ranks, loading (b)'s save: beam and flat
   results equal to (b)'s; seconds and ms a batch of each beside phase
   14's, and the merge's bytes and ms a batch;
16. the examples (``lantern_tpu_torch/examples/``): quickstart, pq_rerank,
   filters_and_maintenance and sharded_mesh, and sharded_mesh over
   EXAMPLE_RANKS gloo ranks sharing the card, each started as a user
   starts it (``python3 -m lantern_tpu_torch.examples.<name>``, no
   ``--device``, so on the default cuda, at the reference's N), all at
   once under one wall limit; each one's last JSON line, seconds and
   kernel launches logged; any non-zero exit fails the run, and so do no
   decode launch in pq_rerank, no K1 launch in sharded_mesh and ranks
   whose ids differ from one process's; then a tiny ``torch.nn.Module``
   embedder injected into ``LocalTransformerRuntime`` with no device (on
   the card, every pooling within EMBED_ATOL of a CPU copy's run, dynamic
   batch sizing from the card's free memory) and run by a daemon
   ``local`` embedding job with the daemon on the card;
17. one JSON line of kernel numbers (K1's and K4's ``build_launches`` from
   (b) and (c), every kernel's ``persist_launches`` from 12,
   ``service_launches`` from 13, ``shard_launches`` from 14,
   ``rank_launches`` from 15 and ``example_launches`` from 16), the
   ``nvidia-smi`` line, and last the result line ``{"ok": true, "device":
   {...}}``.

Needs the ``lantern_tpu_torch`` package beside it and a CUDA device; never
imports jax or lantern_tpu.
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import contextlib
import copy
import dataclasses
import hashlib
import io
import itertools
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request
import zlib

import numpy as np
import torch
from torch.autograd import DeviceType

from lantern_tpu_torch import HnswParams, Index
from lantern_tpu_torch.config import Metric, QuantKind
from lantern_tpu_torch.csrc.build import library_path
from lantern_tpu_torch.flat import _scores, flat_search, flat_search_pq
from lantern_tpu_torch.native import get_lib
from lantern_tpu_torch.ops.cos_block import cos_block, cos_scores_ref
from lantern_tpu_torch.ops.distance import exact_search, unpack_bits
from lantern_tpu_torch.ops.gather_dists import gather_dists, gather_dists_ref
from lantern_tpu_torch.ops.hamming import (
    hamming_block,
    hamming_block_ref,
    hamming_exact_topk,
    hamming_scores,
    hamming_scores_ref,
)
from lantern_tpu_torch.ops.pq_decode import (
    codebook_bf16,
    decode_plan,
    pq_decode,
    pq_decode_ref,
)
from lantern_tpu_torch.ops.row_topk import plan as row_topk_plan
from lantern_tpu_torch.ops.row_topk import row_topk, row_topk_ref
from lantern_tpu_torch.ops.row_topk import step as row_topk_step
from lantern_tpu_torch.graph import build_device
from lantern_tpu_torch import cli, embeddings
from lantern_tpu_torch.autotune import AutotuneResult, autotune, save_results
from lantern_tpu_torch.quant.pq import (
    PQCodebook,
    pq_encode,
    train_codebook,
    train_codebook_chunked,
)
from lantern_tpu_torch.parallel import (
    _dist,
    build_sharded,
    build_sharded_device,
    compact_sharded,
    delete_sharded,
    flat_search_sharded,
    flat_search_sharded_rerank,
    init_multihost,
    insert_sharded,
    load_sharded,
    make_mesh,
    quantize_sharded,
    save_sharded,
    search_sharded,
)
from lantern_tpu_torch.parallel.sharded import ShardedSearchStats
from lantern_tpu_torch.service.client import ExternalIndexClient, build_via_server
from lantern_tpu_torch.service.daemon import Daemon, JobQueue
from lantern_tpu_torch.service.http_api import HttpApi
from lantern_tpu_torch.service.index_server import IndexServer, ServerStatus
from lantern_tpu_torch.weighted import weighted_search

DIM, K, BATCH, N_BATCHES = 128, 10, 1024, 4
RTOL, ATOL = 1e-5, 1e-4
# one H100 SXM's published peaks: HBM bytes/s, f32 (non-tensor-core) flop/s,
# int8 tensor-core op/s
PEAK_BYTES_PER_S, PEAK_F32_FLOPS, PEAK_INT8_OPS = 3.35e12, 67e12, 1979e12
# a kernel timed under this share of its bound was mis-timed (no run can go
# below the bound)
BOUND_SHARE_MIN = 0.95
FLAT_RECALL_MIN, GRAPH_RECALL_MIN = 0.999, 0.90
# PQ decode cases (rows, S, K, dsub, row offset of the codes' view); the
# first is the main path's block shape, the last the OPQ shape's codes as a
# view one row into a larger table (its pointer 8 bytes off 16)
PQ_CASES = [(1_000_000, 32, 256, 4, 0), (200_000, 240, 256, 4, 0),
            (200_000, 24, 16, 40, 0), (100_000, 24, 64, 4, 0),
            (99_991, 32, 256, 4, 0), (100_000, 24, 64, 4, 1)]
# the flat ADC scan timed over the 960-d case's codes: one batch of queries
PQ_SCAN_CASE = (200_000, 240, 256, 4, 0)
PQ_XSQ_RTOL = 1e-5
PQ_AUTO_RECALL_MIN = 0.90  # rerank="auto" recall@10 floor on the PQ path
OPQ_N, OPQ_DIM = 100_000, 96
# K4 cases (Q, N, W): ragged Q and N; 1, 3, 4 words; 1024, 1536, 4096 bits
K4_CASES = [(37, 333, 1), (1000, 99_991, 3), (1024, 65_537, 4),
            (1023, 100_003, 32), (77, 20_011, 48), (1024, 30_001, 128)]
HAM_DIM, HAM_CENTRES = 1024, 4096
HAM_WORDS = HAM_DIM // 32
# the cosine score block kernel's phase: openai1m's flat scan (1M x 1536 unit
# rows, 4096 centres, jitter 1.25, a tenth masked; 1024 queries), the TF32
# peak its bound counts, the widest dist_gap it may read (twice the FFMA
# GEMM's 2.05e-6 in the benchmark, a third of the cell's 1.2e-5 limit), the
# tolerance of its block against the plain version and float64 in units of
# |q| (f32 accuracy reads ~3e-7; TF32 operands 4e-5)
COS_N, COS_DIM, COS_JITTER, COS_MASKED = 1_000_000, 1536, 1.25, 0.1
PEAK_TF32_FLOPS = 495e12
COS_DIST_GAP_MAX = 4e-6
COS_REF_TOL = 4e-6
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
WAL_N, WAL_DELETES = 4_096, 5_000
RC_PAIRS, RC_PAIR_ROWS, RC_SEARCH_PAUSE_S = 4, 256, 0.5
STREAM_QUERIES, STREAM_ROWS = 4, 1000
# the i8 path's default rows. Cuts that keep the whole run under 1200 s
# once the service phase (~200 s) joined it: the i8 path from 1M rows
# (its host build took 73.5 s), WAL_N from 65,536 (a one-thread insert of
# ~0.6 ms a row, twice: the writer, then the replays), STREAM_QUERIES
# from 16 (2.5 s each)
I8_N = 100_000
# Cuts, each the depth of an earlier path, that bring the whole run back
# inside its 1200 s once the ranks phase joined it (1,022.8 s on an H100 at
# 700 W, and past 1200 s on a slower host): the PQ path's rows (its host
# build over the 1M decoded rows took 67.1 s); the hamming path's rows (its
# host build took 41.3 s at 1M; phase 11 (c) builds the same rows on the
# card, in enough rounds to reach PROFILED_ROUND); the index of the
# persistence phase's insert log, concurrent rebuild and streaming scan,
# built on the host from the first PERSIST_N rows (the rebuild of 1.03M
# rows took 112.1 s; (1) still saves and loads the n-row device-built
# index), with WAL_N from 16,384, WAL_DELETES from 50,000 (a twentieth of
# the index, as before) and STREAM_QUERIES from 8; the autotune job's
# variants (the six took 74.2 s, ~10 s each but 20 s for m=48); HTTP_N
# from 100,000 (24.4 s of JSON rows); SHARD_COMPACT_N and SHARD_HAM_N from
# 100,000. With them the run took 675.8 s. Cuts that make room for the
# examples phase (27.7 s on an H100 80GB HBM3 at 700 W, where the run took
# 888.2 s with it, against 777.3-842.0 s before it): PERSIST_N from
# 200,000 (a host build and a concurrent device rebuild of the index),
# WAL_N from 8,192 and WAL_DELETES from 10,000 (a twentieth of the index,
# as before), the autotune job's third variant (16, 60, 76), and HTTP_N
# from 50,000.
PQ_PATH_N = 250_000
HAM_PATH_N = 500_000
PERSIST_N = 100_000
AUTOTUNE_JOB_VARIANTS = ((8, 40, 64), (12, 48, 64))
OPQ_DELETE_EVERY = 10
# the service phase: the collection the HTTP API serves from the indexing
# server's snapshot, its single-vector requests and client threads; the
# collection built over HTTP (cut to HTTP_N rows: JSON carries a 128-d row
# as ~1.3 KB of text) in requests of HTTP_BATCH rows, its queries, the
# share deleted; the hamming collection's rows; the weighted queries; the
# PQ table's chunk rows, the passes of its stopped run, its MSE bound
# against in-RAM training (tests/test_quant.py:321); a 90% recall target
HTTP_COLLECTION = "smoke"
HTTP_REQUESTS, HTTP_THREADS = 1024, 4
HTTP_RECALL_MIN = 0.999
HTTP_N, HTTP_BATCH, HTTP_QUERIES, HTTP_DELETE_SHARE = 25_000, 1000, 64, 0.1
HTTP_HAM_N, HTTP_HAM_QUERIES = 10_000, 32
WEIGHTED_QUERIES, WEIGHTS = 64, (0.7, 0.3)
PQ_CHUNK_ROWS, PQ_STOP_PASSES, PQ_TABLE_ITERS, PQ_MSE_RATIO = 65536, 3, 8, 1.15
AUTOTUNE_TARGET = 0.9
# the sharding phase: the f32 rows over SHARDS shards on the one card (the
# reference's external-indexing fleet of 4 servers); PQ training rows; the
# rows inserted and labels deleted; the rows of the host build + compact
# part (a compact of 1M rows would be a second full build) and of the
# hamming part, each the first rows of its path's table
SHARDS = 4
SHARD_PQ_TRAIN_ROWS, SHARD_RERANK = 65_536, 100
SHARD_INSERT_N, SHARD_DELETES = 16_384, 50_000
SHARD_COMPACT_N, SHARD_COMPACT_DELETE_EVERY = 50_000, 10
SHARD_HAM_N = 50_000
# the ranks phase: phase 14's index over ranks of this script, the data axis
# of leg (c), each collective's timeout (a rank that died fails the others)
# and each leg's wall limit (a leg past it is killed and fails the run)
RANKS_DATA = 2
RANK_TIMEOUT_S = 120
RANKS_A_TIMEOUT_S, RANKS_B_TIMEOUT_S, RANKS_C_TIMEOUT_S = 240, 360, 180
# the examples phase: each example of lantern_tpu_torch/examples started as
# a user starts it (no --device, the reference's N), all at once, under one
# wall limit; sharded_mesh also over EXAMPLE_RANKS gloo ranks; the injected
# embedder's texts and the tolerance of its card run against its CPU run
EXAMPLES = ("quickstart", "pq_rerank", "filters_and_maintenance",
            "sharded_mesh")
EXAMPLE_RANKS = 2
EXAMPLES_TIMEOUT_S = 240
EMBED_TEXTS = 40
EMBED_ATOL = 1e-5


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
                   for name in ("gather_dists", "pq_decode", "hamming",
                                "cos_block", "row_topk")}
        native = pool.submit(get_lib)
        sos = {name: f.result() for name, f in kernels.items()}
        native.result()
    log("build: lantern_tpu_torch/csrc/{gather_dists,pq_decode,hamming,"
        "cos_block,row_topk}.cu "
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
    for case in PQ_CASES:
        n, s, kc, dsub, offset = case
        dim = s * dsub
        cent = torch.randn((s, kc, dsub), generator=gen, device="cuda")
        cb = codebook_bf16(cent)
        # two code sets: the decoded output alone (>= 190 MB) exceeds L2;
        # each a view `offset` rows into its table
        code_sets = [torch.randint(0, kc, (n + offset, s), generator=gen,
                                   device="cuda", dtype=torch.uint8)[offset:]
                     for _ in range(2)]
        plan = decode_plan(n, s, kc, dsub, want_xsq=True)
        dec, xsq = pq_decode(code_sets[0], cb, want_xsq=True)
        _, xsq_again = pq_decode(code_sets[0], cb, want_xsq=True)
        want, want_xsq = pq_decode_ref(code_sets[0], cb, want_xsq=True)
        torch.cuda.synchronize()
        bit_equal = bool(torch.equal(dec.view(torch.int16), want.view(torch.int16)))
        xsq_repeat_equal = bool(torch.equal(xsq.view(torch.int32),
                                            xsq_again.view(torch.int32)))
        xsq_err = (xsq - want_xsq).abs()
        xsq_rel = float((xsq_err / want_xsq.abs().clamp(min=1e-30)).max())
        abs_err = max(float((dec.float() - want.float()).abs().max()),
                      float(xsq_err.max()))
        max_abs = max(max_abs, abs_err)
        ok = bit_equal and xsq_repeat_equal and xsq_rel <= PQ_XSQ_RTOL
        del dec, xsq, xsq_again, want, want_xsq
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
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        row = dict(n=n, s=s, k=kc, dsub=dsub, row_offset=offset,
                   codes_misalign=code_sets[0].data_ptr() % 16, plan=plan,
                   ok=ok, bit_equal=bit_equal,
                   xsq_repeat_equal=xsq_repeat_equal, max_abs_err=abs_err,
                   xsq_max_rel_err=xsq_rel, **times, bound_ms=bound_ms,
                   bound_by="bytes", bytes=nbytes,
                   share_of_bound=bound_ms / times["ms"])
        rows.append(row)
        log("pq_decode " + json.dumps(row))
        if not ok:
            fail(f"pq_decode disagrees with its plain version: {row}")
        if case == PQ_SCAN_CASE:
            pq_scan(code_sets[0], cent, row["ms"], gen)
        del code_sets
    return rows[0], max_abs


def pq_scan(codes, cent, decode_ms, gen):
    """One ``flat_search_pq`` batch of BATCH queries over these codes: its
    ms (CUDA events) and device time by kernel (torch.profiler), and the
    decode kernel's share of that device time."""
    s, kc, dsub = cent.shape
    queries = torch.randn((BATCH, s * dsub), generator=gen, device="cuda")
    launches = pq_decode.launches

    def scan(q):
        return flat_search_pq(codes, cent, q, k=K)

    # one search must decode the codes in one launch (one block of rows)
    scan(queries)
    torch.cuda.synchronize()
    per_batch = pq_decode.launches - launches
    ms = cuda_ms(scan, [queries], warm=1, reps=5)

    def decoded(ev):  # a record that lost the decode kernel is taken again
        return any("pq_decode_kernel" in e.key and e.self_device_time_total > 0
                   for e in ev)

    ev = [e for e in profiled(lambda: scan(queries), decoded)
          if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    dec_ms = sum(e.self_device_time_total for e in ev
                 if "pq_decode_kernel" in e.key) / 1e3
    if not ev:
        log("pq_scan: torch.profiler lost the decode kernel in every try; "
            "no device split")
    log("pq_scan " + json.dumps({
        "n": codes.shape[0], "s": s, "k": kc, "dsub": dsub,
        "queries": BATCH, "ms": ms, "device_busy_ms": busy_ms or None,
        "decode_device_ms": dec_ms or None, "decode_kernel_ms": decode_ms,
        "decode_share_of_device": dec_ms / busy_ms if busy_ms else None,
        "pq_decode_launches_per_batch": per_batch,
        "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]],
    }))
    if per_batch != 1:
        fail(f"pq_scan: {per_batch} decode launches a batch, not 1")


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
    gather_dists.launches = pq_decode.launches = row_topk.launches = 0
    for mode in ("flat", "graph"):
        ix.search(batches[0], k=K, mode=mode)  # warm-up
        torch.cuda.synchronize()
        launches0, selects0 = gather_dists.launches, row_topk.launches
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
                   recall_at_10=recall(ids, gt_i),
                   row_topk_launches_per_batch=(row_topk.launches - selects0)
                   / len(batches))
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
    # the flat scan selects its one [BATCH, n] block once; the graph's entry
    # scan selects through the same kernel
    if results["flat"]["row_topk_launches_per_batch"] != 1:
        fail(f"flat: {results['flat']['row_topk_launches_per_batch']} row_topk "
             "launches a batch, not 1")
    if results["graph"]["row_topk_launches_per_batch"] <= 0:
        fail("the graph's entry scan never launched row_topk")
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
    return launches, build_s, gt_i, results


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
        pq0, k10, k40, sel0 = (pq_decode.launches, gather_dists.launches,
                               hamming_block.launches, row_topk.launches)
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
                   / len(batches),
                   row_topk_launches_per_batch=(row_topk.launches - sel0)
                   / len(batches), **(extra or {}))
        results[name] = res
        log("search " + json.dumps(res))
    return results


def phase_pq_path(base, queries, queries_dev, gt_i, seed):
    """The PQ main path at full width: train on the batch inside add, host
    build over the decoded rows, then flat / graph / rerank / auto."""
    n = base.shape[0]
    if gt_i is None:  # a cut PQ table: its own f32 truth
        _, gt_i = exact_search(queries_dev, torch.from_numpy(base).cuda(), K)
        gt_i = gt_i.cpu().numpy()
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


def phase_cos_block(seed):
    """The cosine score block kernel at openai1m's flat shape: one flat scan
    through it held against float64 (``dist_gap``), its whole block against
    the plain version and float64, then timed beside its bound, the plain
    version and the FFMA and TF32 products. Returns the shape's row."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    centres = torch.randn((4096, COS_DIM), device="cuda", generator=gen)

    def unit(n):
        x = torch.randn((n, COS_DIM), device="cuda", generator=gen)
        x.mul_(COS_JITTER).add_(centres[torch.randint(
            0, 4096, (n,), device="cuda", generator=gen)])
        return x.div_(torch.linalg.vector_norm(x, dim=1, keepdim=True))

    rows, queries = unit(COS_N), unit(BATCH)
    sqn = (rows * rows).sum(1)
    masked = torch.rand(COS_N, device="cuda", generator=gen) < COS_MASKED
    cos_block.launches = 0
    d, ids = flat_search(rows, sqn, queries, k=K, metric=Metric.COS,
                         exact=True, deleted=masked)
    torch.cuda.synchronize()
    launches = cos_block.launches
    if launches != 1:
        fail(f"flat_search made {launches} cos_block launches, not 1")
    # the whole block against the plain version, -inf exactly where masked
    got = cos_block(queries, rows, sqn, masked)
    want = cos_scores_ref(queries, rows, sqn, masked)
    mask_ok = bool(torch.equal(torch.isneginf(got),
                               masked[None, :].expand_as(got)))
    ref_err = float((got - want).abs_().masked_fill_(masked[None, :], 0).max())
    del want
    # against float64, chunk by chunk: the block, the exact k-th distance
    # among the unmasked rows, then the returned rows' exact distances
    kth, f64_err = None, 0.0
    qd = queries.double()
    qn = torch.linalg.vector_norm(qd, dim=1)
    for s0 in range(0, COS_N, 65_536):
        cols = slice(s0, s0 + 65_536)
        xb = rows[cols].double()
        dots = qd @ xb.T
        blk = dots / torch.sqrt(sqn[cols].double())[None, :]
        blk.sub_(got[:, cols].double()).abs_()
        f64_err = max(f64_err, float(
            blk.masked_fill_(masked[None, cols], 0).max()))
        dd = 1.0 - dots / (qn[:, None] * torch.linalg.vector_norm(
            xb, dim=1)[None, :])
        dd.masked_fill_(masked[None, cols], float("inf"))
        top = torch.topk(dd, K, dim=1, largest=False).values
        kth = top if kth is None else torch.topk(
            torch.cat([kth, top], 1), K, dim=1, largest=False).values
    del xb, dots, blk, dd, got
    kth = kth[:, -1]
    xr = rows[ids.long()].double()
    exact = 1.0 - (xr * qd[:, None, :]).sum(-1) / (
        torch.linalg.vector_norm(xr, dim=-1) * qn[:, None])
    del xr
    dist_gap = float(((d.double() - exact).abs() / kth[:, None]).max())
    miss = float((exact > kth[:, None] + 1e-12).double().mean())
    del exact

    times = {}
    fn = lambda x: cos_block(queries, x, sqn, masked)  # noqa: E731
    times["call_ms"] = cuda_ms(fn, [rows])
    times["device_ms"] = device_ms(fn, [rows], per_call=2)  # split, block
    times["ms"] = times["device_ms"] or times["call_ms"]
    # the plain version: three FFMA GEMMs and the passes, seconds a call
    times["plain_ms"] = cuda_ms(
        lambda x: cos_scores_ref(queries, x, sqn, masked), [rows], warm=1,
        reps=2)
    # yardsticks the port never calls: the FFMA product (the block's GEMM
    # before this kernel) and a TF32 one, which fails the cell's check
    for key, tf32 in (("library", False), ("library_tf32", True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            times[key + "_call_ms"] = cuda_ms(lambda x: queries @ x.T, [rows])
            times[key + "_device_ms"] = device_ms(lambda x: queries @ x.T,
                                                  [rows])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        times[key + "_ms"] = (times[key + "_device_ms"]
                              or times[key + "_call_ms"])
    ops = 2 * BATCH * COS_N * COS_DIM
    nbytes = (BATCH + COS_N) * COS_DIM * 4 + COS_N * 5 + BATCH * COS_N * 4
    bound_ms = max(ops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    row = dict(q=BATCH, n=COS_N, d=COS_DIM, masked=COS_MASKED,
               launches=launches, dist_gap=dist_gap, miss_share=miss, ref_max_abs_err=ref_err,
               f64_max_abs_err=f64_err, mask_ok=mask_ok, **times,
               bound_ms=bound_ms, bound_by="operations",
               three_products_bound_ms=3 * ops / PEAK_TF32_FLOPS * 1e3,
               share_of_bound=bound_ms / times["ms"])
    log("cos_block " + json.dumps(row))
    if not (mask_ok and ref_err <= COS_REF_TOL and f64_err <= COS_REF_TOL
            and dist_gap <= COS_DIST_GAP_MAX):
        fail(f"cos_block disagrees: {row}")
    if times["ms"] < BOUND_SHARE_MIN * row["three_products_bound_ms"]:
        fail(f"cos_block timed under {BOUND_SHARE_MIN} of its bound: {row}")
    return row


def phase_row_topk(base_dev, queries_dev):
    """The flat scan's row select (``ops/row_topk.py``) at the cells' shape:
    the l2sq block of the first BATCH queries against the n rows; one
    ``flat_search`` through it (one launch, counted from 0); the kernel
    against the plain version, positions and values bit-equal, at k = 10
    and 128 (the search's k, the build's ef_construction); then timed
    beside its bound (one read of the block), the plain version and
    ``torch.topk``, which the port no longer calls. Returns the row; its
    ``launches`` are this phase's own (the main path counts the search's)."""
    queries = queries_dev[:BATCH]
    sqn = (base_dev * base_dev).sum(1)
    row_topk.launches = 0
    flat_search(base_dev, sqn, queries, k=K)
    torch.cuda.synchronize()
    launches = row_topk.launches
    if launches != 1:
        fail(f"flat_search made {launches} row_topk launches, not 1")
    scores = _scores(base_dev, sqn, queries, Metric.L2SQ)
    equal = {}
    for k in (K, 128):
        values, positions = row_topk(scores, k)
        want = row_topk_ref(scores, k)
        equal[f"k{k}"] = bool(torch.equal(positions, want[1]) and torch.equal(
            values.view(torch.int32), want[0].view(torch.int32)))
    times = {}
    for k, key in ((K, ""), (128, "_k128")):
        fn = lambda x, k=k: row_topk(x, k)  # noqa: E731
        call_ms = cuda_ms(fn, [scores])
        times["ms" + key] = device_ms(fn, [scores], per_call=2) or call_ms
        times["call_ms" + key] = call_ms
        times["library_ms" + key] = cuda_ms(
            lambda x, k=k: torch.topk(x, k, dim=1), [scores], warm=1, reps=3)
    times["plain_ms"] = cuda_ms(lambda x: row_topk_ref(x, K), [scores],
                                warm=1, reps=1)
    bound_ms = scores.numel() * 4 / PEAK_BYTES_PER_S * 1e3
    del scores
    row = dict(q=BATCH, n=base_dev.shape[0], launches=launches, equal=equal,
               plan=dataclasses.asdict(row_topk_plan(
                   BATCH, base_dev.shape[0], K, row_topk_step())),
               **times, bound_ms=bound_ms, bound_by="bytes",
               share_of_bound=bound_ms / times["ms"])
    log("row_topk " + json.dumps(row))
    if not all(equal.values()):
        fail(f"row_topk disagrees with its plain version: {row}")
    if times["ms"] < BOUND_SHARE_MIN * bound_ms:  # no run can go below it
        fail(f"row_topk timed under {BOUND_SHARE_MIN} of its bound: {row}")
    return row


_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int64)
_POPCOUNT16 = np.array([bin(i).count("1") for i in range(1 << 16)], np.uint8)
# queries whose k nearest the host recomputes (cut from 64, 20.2 s at 1M
# rows, once the ranks phase joined the run)
HAM_HOST_TRUTH_QUERIES = 16


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


class ServerThread:
    """An asyncio event loop on a thread of its own, serving ``servers``
    (the indexing server's executor runs its builds on further threads)."""

    def __init__(self, *servers):
        self.servers = servers
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="smoke-index-server")
        self.started = threading.Event()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        for srv in self.servers:
            self.loop.run_until_complete(srv.start())
        self.started.set()
        self.loop.run_forever()

    def __enter__(self):
        self.thread.start()
        if not self.started.wait(60):
            fail("the indexing server did not start")
        return self

    def __exit__(self, *exc):
        for srv in self.servers:
            asyncio.run_coroutine_threadsafe(srv.stop(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


def phase_device_build(base, queries, gt_i, centers, host_build_s, seed,
                       snapshot):
    """(a) the bulk device build of the f32 rows through the indexing
    server, the reply's snapshot kept at ``snapshot``; (b) beam inserts
    into the loaded index. Returns K1's launches in (b) and the index."""
    n = base.shape[0]
    gather_dists.launches = pq_decode.launches = hamming_block.launches = 0
    params = HnswParams(dim=DIM, m=16, ef_construction=128)
    srv = IndexServer(port=0, status_port=0, build="device", device="cuda")
    with ServerThread(srv):
        client = ExternalIndexClient("127.0.0.1", srv.port, reply_timeout=900)
        t0 = time.perf_counter()
        # the server builds in its executor thread; the probe wraps the
        # builder's round function there
        with RoundProbe("gemm", min_ms=sgemm_min_ms(n)) as probe:
            ix = build_via_server(base, params, "127.0.0.1", srv.port,
                                  labels=np.arange(n, dtype=np.uint64),
                                  device="cuda", client=client)
            torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.status_port}/status", timeout=30) as r:
            status = json.loads(r.read())["status"]
    t = client.last_timings
    wire_s = t["stream_s"] + t["build_wait_s"] + t["index_recv_s"]
    log("service build " + json.dumps(dict(
        rows=n, status=status, **t, snapshot_mib=t["index_bytes"] / 2**20,
        write_and_load_s=total_s - wire_s, total_s=total_s)))
    if status != ServerStatus.SUCCEEDED:
        fail(f"the indexing server's status after the build is {status}")
    if ix.size != n or ix.device.type != "cuda":
        fail(f"build_via_server returned {ix!r}")
    build_s = t["build_wait_s"]
    log(f"device build: {n} rows x {DIM} (m=16, ef_construction=128, batch "
        f"{BATCH}, flat pools, in the indexing server) in {build_s:.1f} s "
        f"over {probe.rounds} rounds ({build_s / probe.rounds * 1e3:.1f} ms a "
        f"round, the import and the server's snapshot included); host build "
        f"(phase 5, all host cores) {host_build_s:.1f} s")
    probe.report("f32 flat")
    launched = (gather_dists.launches, pq_decode.launches, hamming_block.launches)
    log(f"device build launches (K1, decode, K4): {launched}")
    if any(launched):
        fail(f"the flat f32 device build launched kernels {launched}")
    ix.save(snapshot)  # the reply's bytes (tests/test_torch_service.py)
    if os.path.getsize(snapshot) != t["index_bytes"]:
        fail(f"the saved snapshot holds {os.path.getsize(snapshot)} bytes, "
             f"the reply {t['index_bytes']}")
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
    return k1_launches, ix, build_s


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
        f"of phase 9's rows (all host cores) {host_build_s:.1f} s")
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


def phase_persistence(ix, rows, queries, queries_dev, centers, seed):
    """(1) on the device-built f32 index: save and load into both engines;
    (2)-(4) on an index of ``rows`` built on the host: the insert log with a
    follower and a crash; a concurrent device rebuild under searches and
    writes; the streaming scan. Returns K1's launches (two threads in (3):
    counted, not held to a number)."""
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

    # (2) the insert log on the smaller index: a writer, a follower, the
    # writer's crash
    n = len(rows)
    t0 = time.perf_counter()
    small = Index(HnswParams(dim=DIM), capacity=n, seed=seed, device="cuda")
    small.add(rows, nthreads=0)
    small.save(snap)
    del small
    log(f"persistence: the insert log's index, {n} rows built on all host "
        f"cores and saved, in {time.perf_counter() - t0:.1f} s")
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
        rows=n, added=WAL_N, deleted=WAL_DELETES, log_mb=log_mb,
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
    # labels whose delete() had returned; a search may return a pair's row
    # that is deleted while it runs, but none deleted before it began
    gone = [dead]

    def searcher():
        try:
            i = 0
            while not stop.is_set():
                gone_before = np.concatenate(list(gone))
                t0 = time.perf_counter()
                _, lab = ix2.search(batches[i % len(batches)], k=K,
                                    mode="graph")
                t1 = time.perf_counter()
                served.append((t1, (t1 - t0) * 1e3))
                if np.isin(lab, gone_before).any():
                    errors.append(f"batch {i}: a label deleted before the "
                                  "search began was returned")
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
            gone.append(pair_labels[lo:lo + RC_PAIR_ROWS // 2])
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


def http(method: str, url: str, body=None, timeout: float = 900.0):
    """One JSON request; any status but 200/201 fails the run with the
    server's own error message."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        fail(f"{method} {url}: HTTP {e.code} {e.read().decode()[:2000]}")


def result_ids(res) -> np.ndarray:
    return np.array([r["id"] for r in res["results"]], np.int64)


def tie_aware_equal(got, want, want_d) -> bool:
    """Label lists equal where their distances do not tie (with a row past
    the k-th, too)."""
    if len(got) != len(want):
        return False
    for i, (a, b) in enumerate(zip(got, want)):
        near = np.isclose(want_d, want_d[i], rtol=1e-6)
        if a != b and near.sum() == 1 and not near[-1]:
            return False
    return True


def phase_http_1m(url, snapshot, queries, gt_i):
    """(b) the HTTP API serving the indexing server's 1M index: single-
    vector requests from HTTP_THREADS threads against the same searches
    made directly on a loaded copy. Returns the copy."""
    direct = Index.load(snapshot, device="cuda")
    mode = direct.search(queries[:1], k=K, with_stats=True)[2]["mode"]
    qs = queries[:HTTP_REQUESTS]

    def one(i):
        t0 = time.perf_counter()
        res = http("POST", f"{url}/collections/{HTTP_COLLECTION}/search",
                   {"vector": qs[i].tolist(), "k": K})
        return res, time.perf_counter() - t0

    http("POST", f"{url}/collections/{HTTP_COLLECTION}/search",
         {"vector": qs[0].tolist(), "k": K})  # the mirror's first copy
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(HTTP_THREADS) as pool:
        out = list(pool.map(one, range(len(qs))))
    wall_s = time.perf_counter() - t0
    lat = np.array([t for _, t in out]) * 1e3
    direct_ms, mismatched = [], 0
    ids = np.full((len(qs), K), -1, np.int64)
    for i, (res, _) in enumerate(out):
        t1 = time.perf_counter()
        d, lab = direct.search(qs[i:i + 1], k=K)
        direct_ms.append((time.perf_counter() - t1) * 1e3)
        got = result_ids(res)
        ids[i, :len(got)] = got
        if not tie_aware_equal(got.tolist(), lab[0].astype(np.int64).tolist(),
                               d[0]):
            mismatched += 1
    rec = recall(ids, gt_i[:len(qs)])
    log("service http " + json.dumps(dict(
        rows=direct.size, requests=len(qs), threads=HTTP_THREADS,
        mode_chosen=mode, request_ms_median=float(np.median(lat)),
        request_ms_p99=float(np.percentile(lat, 99)),
        requests_per_s=len(qs) / wall_s,
        direct_single_query_ms_median=float(np.median(direct_ms)),
        recall_at_10=rec, mismatched=mismatched)))
    if mismatched:
        fail(f"{mismatched} HTTP searches differ from the direct searches")
    if rec < HTTP_RECALL_MIN:
        fail(f"HTTP recall@10 {rec} < {HTTP_RECALL_MIN}")
    return direct


def exact_ids(rows_dev, queries) -> np.ndarray:
    _, ids = exact_search(torch.from_numpy(queries).cuda(), rows_dev, K)
    return ids.cpu().numpy().astype(np.int64)


def phase_http_collections(url, base, queries):
    """(c) a HTTP_N-row collection built over HTTP: rows, the device
    rebuild, PQ with rerank, deletes and compaction; then a hamming
    collection. Returns the decode kernel's and K4's launches."""
    col = f"{url}/collections/rows"
    rows = base[:HTTP_N]
    qs = queries[:HTTP_QUERIES]
    t0 = time.perf_counter()
    http("POST", f"{url}/collections", {"name": "rows", "metric": "l2sq"})
    for i in range(0, HTTP_N, HTTP_BATCH):
        res = http("POST", f"{col}/rows", {"rows": [
            {"vector": r.tolist()} for r in rows[i:i + HTTP_BATCH]]})
        if res["inserted"] != len(rows[i:i + HTTP_BATCH]):
            fail(f"rows request {i // HTTP_BATCH}: {res['inserted']} inserted")
    insert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = http("POST", f"{col}/index", {"external": True})
    external_s = time.perf_counter() - t0
    if res["indexed"] != HTTP_N:
        fail(f"/index external indexed {res['indexed']}")
    rows_dev = torch.from_numpy(rows).cuda()
    truth = exact_ids(rows_dev, qs) + 1  # ids start at 1

    def searched(**kw):
        return np.stack([np.pad(result_ids(http("POST", f"{col}/search", {
            "vector": q.tolist(), "k": K, **kw})), (0, K), constant_values=-1)
            [:K] for q in qs])

    flat_rec = recall(searched(), truth)
    t0 = time.perf_counter()
    res = http("POST", f"{col}/pq", {"num_subvectors": 32})
    pq_s = time.perf_counter() - t0
    if res != {"codebook": [32, 256, DIM // 32], "requantized": HTTP_N}:
        fail(f"/pq answered {res}")
    pq_decode.launches = 0
    rerank_rec = recall(searched(rerank=100), truth)
    auto_rec = recall(searched(rerank="auto"), truth)
    rng = np.random.default_rng(11)
    dead = rng.choice(HTTP_N, int(HTTP_N * HTTP_DELETE_SHARE),
                      replace=False) + 1
    res = http("DELETE", f"{col}/rows", {"ids": dead.tolist()})
    if res["deleted"] != len(dead):
        fail(f"DELETE rows deleted {res['deleted']} of {len(dead)}")
    t0 = time.perf_counter()
    res = http("POST", f"{col}/compact", {})
    compact_s = time.perf_counter() - t0
    if res != {"size": HTTP_N - len(dead), "reclaimed": len(dead)}:
        fail(f"/compact answered {res}")
    live = np.setdiff1d(np.arange(1, HTTP_N + 1), dead)
    live_truth = live[exact_ids(rows_dev[torch.from_numpy(live - 1).cuda()],
                                qs)]
    got = searched(rerank=100)
    check_live("HTTP after compact", got.astype(np.uint64),
               dead.astype(np.uint64))
    compact_rec = recall(got, live_truth)
    decode_launches = pq_decode.launches
    del rows_dev
    log("service http collection " + json.dumps(dict(
        rows=HTTP_N, cut="JSON carries a row as ~1.3 KB of text",
        insert_s=insert_s, external_rebuild_s=external_s, pq_s=pq_s,
        compact_s=compact_s, flat_recall_at_10=flat_rec,
        pq_rerank100_recall_at_10=rerank_rec, pq_auto_recall_at_10=auto_rec,
        after_compact_recall_at_10=compact_rec, deleted=len(dead),
        decode_launches=decode_launches)))
    if flat_rec < HTTP_RECALL_MIN:
        fail(f"the rebuilt collection's recall@10 {flat_rec}")
    for name, r in (("rerank=100", rerank_rec), ("auto", auto_rec),
                    ("after compact", compact_rec)):
        if r < PQ_AUTO_RECALL_MIN:
            fail(f"HTTP PQ {name} recall@10 {r} < {PQ_AUTO_RECALL_MIN}")
    if decode_launches <= 0:
        fail("the HTTP PQ searches never launched the decode kernel")

    # the hamming collection: +-1 floats, binarised by the collection
    rng = np.random.default_rng(12)
    bits = np.where(rng.random((HTTP_HAM_N, HAM_DIM)) < 0.5, -1.0,
                    1.0).astype(np.float32)
    hcol = f"{url}/collections/bits"
    http("POST", f"{url}/collections", {"name": "bits", "metric": "hamming"})
    for i in range(0, HTTP_HAM_N, HTTP_BATCH):
        http("POST", f"{hcol}/rows", {"rows": [
            {"vector": r.tolist()} for r in bits[i:i + HTTP_BATCH]]})
    hq = bits[:HTTP_HAM_QUERIES].copy()
    hq[:, :64] *= -1  # 64 bits off the stored row
    hamming_block.launches = 0
    bad = 0
    for q in hq:
        res = http("POST", f"{hcol}/search", {"vector": q.tolist(), "k": K})
        ids = result_ids(res) - 1
        d = np.array([r["distance"] for r in res["results"]])
        host = (bits[ids] != q).sum(1)
        best = np.sort((bits != q).sum(1))[:K]
        bad += int(not (np.array_equal(d, host) and np.array_equal(d, best)))
    k4_launches = hamming_block.launches
    log("service http hamming " + json.dumps(dict(
        rows=HTTP_HAM_N, bits=HAM_DIM, queries=HTTP_HAM_QUERIES,
        k4_launches=k4_launches, distances_unequal=bad)))
    if bad:
        fail(f"{bad} hamming HTTP searches' distances differ from the host's")
    if k4_launches <= 0:
        fail("the HTTP hamming searches never launched K4")
    return decode_launches, k4_launches


def phase_weighted(direct, base, queries):
    """(d) weighted_search of two query columns over the 1M index, held
    to an exact float64 re-rank of the same candidate pools."""
    worst, bad = 0.0, 0
    t0 = time.perf_counter()
    for i in range(WEIGHTED_QUERIES):
        qa, qb = queries[i], queries[i + WEIGHTED_QUERIES]
        d, lab = weighted_search([(direct, WEIGHTS[0], qa),
                                  (direct, WEIGHTS[1], qb)], k=K)
        cand = np.unique(np.concatenate(
            [direct.search(q, k=max(2 * K, 16))[1][0] for q in (qa, qb)]))
        rows = base[cand.astype(np.int64)].astype(np.float64)
        total = (WEIGHTS[0] * ((rows - qa) ** 2).sum(1)
                 + WEIGHTS[1] * ((rows - qb) ** 2).sum(1))
        order = np.argsort(total, kind="stable")[:K]
        worst = max(worst, float(np.max(np.abs(d - total[order])
                                        / total[order])))
        bad += int(not tie_aware_equal(lab.tolist(), cand[order].tolist(),
                                       total[order]))
    log("service weighted " + json.dumps(dict(
        queries=WEIGHTED_QUERIES, weights=WEIGHTS,
        s_per_query=(time.perf_counter() - t0) / WEIGHTED_QUERIES,
        max_rel_err=worst, labels_unequal=bad)))
    if bad or worst > 1e-5:
        fail(f"weighted_search: {bad} label lists differ, relative error "
             f"{worst}")


def phase_jobs_and_cli(work, base_npy, snapshot, queries, gt_i, base):
    """(e) an autotune job through the daemon and the stored result's
    reuse; the CLI's graph search of the server's snapshot; the CLI's
    chunked PQ table with a stopped and resumed run. Returns K1's
    launches."""
    q = JobQueue(os.path.join(work, "jobs"))
    jid = q.submit("autotune", {"input": base_npy, "k": K,
                                "target_recall": AUTOTUNE_TARGET,
                                "variants": AUTOTUNE_JOB_VARIANTS})
    gather_dists.launches = 0
    t0 = time.perf_counter()
    Daemon(q, device="cuda").run_pending()
    job = q.get(jid)
    k1 = gather_dists.launches
    log("service autotune " + json.dumps(dict(
        status=job["status"], error=job["error"], s=time.perf_counter() - t0,
        k1_launches=k1, **(job["usage"] or {}))))
    if job["status"] != "completed" or job["usage"]["best"] is None:
        fail(f"the autotune job ended {job['status']}: {job['error']}")
    store = os.path.join(work, "autotune.json")
    save_results("smoke", [AutotuneResult(**r)
                           for r in job["usage"]["results"]], store)
    l0, t0 = gather_dists.launches, time.perf_counter()
    best, results = autotune(np.load(base_npy, mmap_mode="r"),
                             target_recall=AUTOTUNE_TARGET,
                             model_name="smoke", results_path=store,
                             device="cuda")
    if (len(results) != 1 or gather_dists.launches != l0
            or vars(best) != job["usage"]["best"]):
        fail(f"the stored autotune result was not reused: {results}")
    log(f"service autotune reuse: {vars(best)} in "
        f"{time.perf_counter() - t0:.3f} s, no sweep")

    queries_npy = os.path.join(work, "queries.npy")
    np.save(queries_npy, queries)
    buf = io.StringIO()
    l0, t0 = gather_dists.launches, time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["search", "--index", snapshot, "--queries", queries_npy,
                  "--mode", "graph", "--k", str(K), "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    k1_cli = gather_dists.launches - l0
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    ids = np.full((len(queries), K), -1, np.int64)
    for i, row in enumerate(rows):
        ids[i, :len(row)] = [r["label"] for r in row]
    rec = recall(ids, gt_i)
    log("service cli search " + json.dumps(dict(
        queries=len(rows), s=cli_s, recall_at_10=rec, k1_launches=k1_cli)))
    if len(rows) != len(queries) or rec < GRAPH_RECALL_MIN:
        fail(f"CLI search: {len(rows)} rows, recall@10 {rec}")
    if k1_cli <= 0:
        fail("the CLI's graph search never launched K1")

    out = os.path.join(work, "pq.npz")
    t0 = time.perf_counter()
    cli.main(["pq-table", "--input", base_npy, "--output", out,
              "--chunk-rows", str(PQ_CHUNK_ROWS), "--clusters", "256",
              "--splits", "32", "--iters", str(PQ_TABLE_ITERS),
              "--device", "cuda"])
    table_s = time.perf_counter() - t0
    z = np.load(out)
    cb = PQCodebook(z["codebook"])
    codes = pq_encode(base, cb, device="cuda")
    if not np.array_equal(codes, z["codes"]):
        fail(f"pq-table codes differ from pq_encode's in "
             f"{int((codes != z['codes']).sum())} places")

    def mse(book, c):
        rec_rows = book.centroids[np.arange(c.shape[1])[None, :], c]
        return float(np.mean((rec_rows.reshape(len(c), -1) - base) ** 2))

    t0 = time.perf_counter()
    ram = train_codebook(base, num_subvectors=32, num_centroids=256,
                         iters=PQ_TABLE_ITERS, seed=0, device="cuda")
    ram_s = time.perf_counter() - t0
    mse_chunked = mse(cb, codes)
    mse_ram = mse(ram, pq_encode(base, ram, device="cuda"))
    state = os.path.join(work, "pq.state")
    kw = dict(num_subvectors=32, num_centroids=256, seed=0,
              resume_path=state, chunk_rows=PQ_CHUNK_ROWS, device="cuda")
    t0 = time.perf_counter()
    train_codebook_chunked(base_npy, iters=PQ_STOP_PASSES, **kw)
    stop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed = train_codebook_chunked(base_npy, iters=PQ_TABLE_ITERS, **kw)
    resume_s = time.perf_counter() - t0
    identical = np.array_equal(resumed.centroids, cb.centroids)
    log("service pq-table " + json.dumps(dict(
        rows=len(base), chunk_rows=PQ_CHUNK_ROWS, passes=PQ_TABLE_ITERS,
        cli_s=table_s, s_per_pass=stop_s / PQ_STOP_PASSES,
        resumed_s_per_pass=resume_s / (PQ_TABLE_ITERS - PQ_STOP_PASSES),
        mse_chunked=mse_chunked, mse_in_ram=mse_ram, in_ram_train_s=ram_s,
        resume_bit_identical=identical)))
    if mse_chunked > PQ_MSE_RATIO * mse_ram:
        fail(f"chunked PQ MSE {mse_chunked} > {PQ_MSE_RATIO} x in-RAM "
             f"{mse_ram}")
    if not identical:
        fail("the resumed PQ training differs from the unbroken one")
    return k1 + k1_cli


def phase_service(work, snapshot, base, queries, gt_i):
    """(b)-(e) on the indexing server's snapshot. Returns the service
    launches of K1, the decode kernel and K4."""
    t_phase = time.perf_counter()
    # the snapshot is the collection's index file; its row store is empty
    with open(os.path.join(work, f"{HTTP_COLLECTION}.json"), "w") as f:
        json.dump({"name": HTTP_COLLECTION, "dim": DIM,
                   "metric": int(Metric.L2SQ), "next_id": len(base),
                   "rows": {}, "has_index": True}, f)
    t0 = time.perf_counter()
    api = HttpApi(data_dir=work, device="cuda").start()
    log(f"service http: HttpApi loaded the {len(base)}-row snapshot in "
        f"{time.perf_counter() - t0:.2f} s")
    url = f"http://127.0.0.1:{api.port}"
    try:
        direct = phase_http_1m(url, snapshot, queries, gt_i)
        decode_launches, k4_launches = phase_http_collections(url, base,
                                                              queries)
    finally:
        api.stop()  # saves every collection into ``work``
    phase_weighted(direct, base, queries)
    del direct
    base_npy = os.path.join(work, "base.npy")
    np.save(base_npy, base)
    k1 = phase_jobs_and_cli(work, base_npy, snapshot, queries, gt_i, base)
    log(f"service phase: {time.perf_counter() - t_phase:.1f} s")
    return k1, decode_launches, k4_launches


def sharded_batches(fn, batches, name, k=K, labels_are_gids=True):
    """fn(batch) -> (dists, global ids, labels) tensors over every batch,
    after one warm-up batch; returns numpy (dists, gids, labels) and the
    ms a batch. Fails on a wrong shape, a non-finite distance or (unless
    ``labels_are_gids`` is False: a compact assigns gids anew) a label that
    is not its gid (the phase's labels are the row numbers)."""
    fn(batches[0])
    torch.cuda.synchronize()
    out = []
    t0 = time.perf_counter()
    for b in batches:
        out.append(fn(b))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / len(batches) * 1e3
    d, g, lab = (np.concatenate([o[i].cpu().numpy() for o in out])
                 for i in range(3))
    nq = sum(len(b) for b in batches)
    if g.shape != (nq, k) or not np.isfinite(d).all():
        fail(f"sharded {name}: results of shape {g.shape} or non-finite dists")
    if labels_are_gids and not np.array_equal(lab, g.astype(np.int64)):
        fail(f"sharded {name}: labels differ from the global ids")
    return d, g, lab, ms


def check_exact_dists(name, base, queries, d, g, rtol=1e-4, atol=1e-2):
    rows = torch.from_numpy(base[g]).cuda()
    exact = ((rows - torch.from_numpy(queries).cuda()[:, None, :]) ** 2).sum(-1)
    exact = exact.cpu().numpy()
    if not np.allclose(d, exact, rtol=rtol, atol=atol):
        fail(f"sharded {name}: returned distances disagree with the rows' "
             f"exact distances (max abs {np.abs(d - exact).max()})")


def phase_sharding(base, queries, gt_i, centers, ham_rows, ham_queries,
                   single, seed):
    """(a)-(d) of the sharding phase over SHARDS shards on the one card.
    ``single``: the unsharded numbers to report beside (phase 5's graph and
    flat ms a batch and K1 launches a batch, phase 11's build seconds).
    Returns each kernel's launches over (a)-(d) and what phase 15 is held
    to: the builds' shard digests, the search results, the PQ codebook's
    digest, the save's file digests, the inserted rows and deleted labels
    and the seconds and ms a batch of each step."""
    n = base.shape[0]
    t_phase = time.perf_counter()
    params = HnswParams(dim=DIM, m=16, ef_construction=128)
    q_dev = torch.from_numpy(queries).cuda()
    batches = [q_dev[i:i + BATCH] for i in range(0, len(queries), BATCH)]
    ham = ham_rows[:SHARD_HAM_N]
    hq_dev = torch.from_numpy(ham_queries.view(np.int32)).cuda()
    hbatches = [hq_dev[i:i + BATCH] for i in range(0, len(ham_queries), BATCH)]
    # truths that go through no wrapper of the counted run: K4 scores the
    # hamming truth, so it comes before the counts are set to 0
    ham_gt_d, _ = hamming_exact_topk(hq_dev, torch.from_numpy(
        ham.view(np.int32)).cuda(), K)
    ham_kth = ham_gt_d.cpu().numpy()[:, K - 1:K]
    mesh = make_mesh(n_shards=SHARDS)
    # the sharded path's launches start here
    gather_dists.launches = pq_decode.launches = hamming_block.launches = 0

    # (a) the parallel device build, the beam and the exact flat scan
    t0 = time.perf_counter()
    ix = build_sharded_device(base, params, mesh, batch=BATCH, seed=seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launched = (gather_dists.launches, pq_decode.launches, hamming_block.launches)
    log(f"sharded device build: {n} rows x {DIM} over {SHARDS} shards of "
        f"{ix.cap} slots (m=16, ef_construction=128, batch {BATCH}, flat "
        f"pools) in {build_s:.1f} s; single-index device build (phase 11) "
        f"{single['device_build_s']:.1f} s; launches (K1, decode, K4) "
        f"{launched}")
    if any(launched):
        fail(f"the flat-pool sharded build launched kernels {launched}")
    ref = {"build_digests": shard_digests(ix), "build_s": build_s}
    k10 = gather_dists.launches
    d, g, lab, graph_ms = sharded_batches(
        lambda b: search_sharded(ix, b, k=K, ef=64), batches, "graph")
    k1_per_batch = (gather_dists.launches - k10) / (len(batches) + 1)
    ref.update(graph=(d, g, lab), graph_ms=graph_ms,
               k1_per_batch=k1_per_batch)
    check_exact_dists("graph", base, queries, d, g)
    graph_r = recall(g, gt_i)
    d, g, lab, flat_ms = sharded_batches(
        lambda b: flat_search_sharded(ix, b, k=K, exact=True), batches, "flat")
    ref.update(flat=(d, g, lab), flat_ms=flat_ms)
    check_exact_dists("flat", base, queries, d, g)
    flat_r = recall(g, gt_i)
    log("sharded search " + json.dumps(dict(
        shards=SHARDS, graph_ms_per_batch=graph_ms,
        single_graph_ms_per_batch=single["graph_ms"],
        graph_recall_at_10=graph_r, k1_launches_per_batch=k1_per_batch,
        single_k1_launches_per_batch=single["k1_per_batch"],
        flat_ms_per_batch=flat_ms, single_flat_ms_per_batch=single["flat_ms"],
        flat_recall_at_10=flat_r)))
    if graph_r < GRAPH_RECALL_MIN:
        fail(f"sharded graph recall@10 {graph_r} < {GRAPH_RECALL_MIN}")
    if flat_r < FLAT_RECALL_MIN:
        fail(f"sharded exact flat recall@10 {flat_r} < {FLAT_RECALL_MIN}")
    if k1_per_batch <= 0:
        fail("the sharded beam never launched K1")

    # (b) PQ shards (ADC flat scan, rerank) and i8 shards (beam, flat)
    pq0 = pq_decode.launches
    t0 = time.perf_counter()
    ixq = quantize_sharded(ix, mesh, quant="pq",
                           train_rows=SHARD_PQ_TRAIN_ROWS, seed=seed)
    torch.cuda.synchronize()
    pq_s = time.perf_counter() - t0
    pq_enc = pq_decode.launches - pq0
    ref.update(codebook=codebook_digest(ixq), pq_s=pq_s)
    _, g, _, adc_ms = sharded_batches(
        lambda b: flat_search_sharded(ixq, b, k=K), batches, "pq flat")
    adc_r = recall(g, gt_i)
    d, g, lab, rr_ms = sharded_batches(
        lambda b: flat_search_sharded_rerank(ixq, b, k=K,
                                             shortlist=SHARD_RERANK),
        batches, "pq rerank")
    # the rerank scores bf16 copies of the rows: within bf16's rounding
    check_exact_dists("pq rerank", base, queries, d, g, rtol=2e-2, atol=0.1)
    rr_r = recall(g, gt_i)
    ref.update(rerank=(d, g, lab), rerank_ms=rr_ms, rerank_recall=rr_r)
    pq_per_batch = (pq_decode.launches - pq0 - pq_enc) / (2 * len(batches) + 2)
    log("sharded pq " + json.dumps(dict(
        quantize_s=pq_s, subvectors=ixq.vectors.shape[2],
        train_rows=SHARD_PQ_TRAIN_ROWS, adc_flat_ms_per_batch=adc_ms,
        adc_flat_recall_at_10=adc_r, rerank_ms_per_batch=rr_ms,
        rerank_recall_at_10=rr_r,
        decode_launches_per_batch=pq_per_batch)))
    if rr_r < PQ_AUTO_RECALL_MIN or rr_r < adc_r:
        fail(f"sharded PQ rerank recall@10 {rr_r} under {PQ_AUTO_RECALL_MIN} "
             f"or the ADC scan's {adc_r}")
    if pq_per_batch <= 0:
        fail("the sharded PQ scans never launched the decode kernel")
    del ixq
    t0 = time.perf_counter()
    ix8 = quantize_sharded(ix, mesh, quant="i8")
    torch.cuda.synchronize()
    i8_s = time.perf_counter() - t0
    _, g, _, i8g_ms = sharded_batches(
        lambda b: search_sharded(ix8, b, k=K, ef=64), batches, "i8 graph")
    i8g_r = recall(g, gt_i)
    _, g, _, i8f_ms = sharded_batches(
        lambda b: flat_search_sharded(ix8, b, k=K), batches, "i8 flat")
    i8f_r = recall(g, gt_i)
    log("sharded i8 " + json.dumps(dict(
        quantize_s=i8_s, graph_ms_per_batch=i8g_ms, graph_recall_at_10=i8g_r,
        flat_ms_per_batch=i8f_ms, flat_recall_at_10=i8f_r)))
    if min(i8g_r, i8f_r) < I8_RECALL_MIN:
        fail(f"sharded i8 recall@10 (graph {i8g_r}, flat {i8f_r}) < "
             f"{I8_RECALL_MIN}")
    del ix8

    # (c) the lifecycle: insert, delete, save / load, host build + compact
    rng = np.random.default_rng(seed + 9)
    extra = (centers[rng.integers(0, len(centers), SHARD_INSERT_N)] + 0.35
             * rng.standard_normal((SHARD_INSERT_N, DIM), dtype=np.float32))
    extra = extra.astype(np.float32)
    t0 = time.perf_counter()
    ix = insert_sharded(ix, extra, mesh, batch=BATCH, seed=seed)
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    e_dev = torch.from_numpy(extra).cuda()
    _, g, _, _ = sharded_batches(
        lambda b: search_sharded(ix, b, k=1, ef=64),
        [e_dev[i:i + BATCH] for i in range(0, SHARD_INSERT_N, BATCH)],
        "insert self-search", k=1)
    top1 = float((g[:, 0] == n + np.arange(SHARD_INSERT_N)).mean())
    del e_dev
    dead = rng.choice(n + SHARD_INSERT_N, SHARD_DELETES,
                      replace=False).astype(np.uint64)
    t0 = time.perf_counter()
    ix = delete_sharded(ix, dead)
    delete_s = time.perf_counter() - t0
    before = {}
    for mode, fn in (("graph", lambda b: search_sharded(ix, b, k=K, ef=64)),
                     ("flat", lambda b: flat_search_sharded(ix, b, k=K))):
        d, g, lab, _ = sharded_batches(fn, batches, f"{mode} after delete")
        check_live(f"sharded {mode} after delete", lab, dead.astype(np.int64))
        before[mode] = (d, g, lab)
    need = sum(ix.num_nodes) * (DIM * 4 + 4 * params.m0 + 32)
    work = snapshot_dir(need)
    try:
        path = os.path.join(work.name, "sharded")
        t0 = time.perf_counter()
        save_sharded(ix, path)
        save_s = time.perf_counter() - t0
        mib = sum(os.path.getsize(os.path.join(path, f))
                  for f in os.listdir(path)) / 2**20
        ref["save_digests"] = file_digests(path)
        t0 = time.perf_counter()
        loaded = load_sharded(path, mesh, engine="native")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        work.cleanup()
    for mode, fn in (("graph", lambda b: search_sharded(loaded, b, k=K, ef=64)),
                     ("flat", lambda b: flat_search_sharded(loaded, b, k=K))):
        got = sharded_batches(fn, batches, f"{mode} after load")[:3]
        for what, a, b in zip(("distances", "gids", "labels"), got,
                              before[mode]):
            if not np.array_equal(a, b):
                fail(f"sharded {mode} after load: {what} differ from before "
                     f"the save ({int((a != b).sum())} of {a.size})")
    log("sharded lifecycle " + json.dumps(dict(
        insert_rows=SHARD_INSERT_N, insert_s=insert_s,
        insert_self_top1=top1, deleted=SHARD_DELETES, delete_s=delete_s,
        snapshot_mib=mib, save_s=save_s, load_s=load_s,
        searches_after_load_equal=True)))
    if top1 < INSERT_SELF_MIN:
        fail(f"sharded insert self-search top-1 {top1} < {INSERT_SELF_MIN}")
    ref.update(extra=extra, dead=dead, after_delete=before, insert_s=insert_s,
               delete_s=delete_s, save_s=save_s, load_s=load_s,
               snapshot_mib=mib)
    del ix, loaded
    sub = base[:SHARD_COMPACT_N]
    t0 = time.perf_counter()
    ixh = build_sharded(sub, params, mesh, seed=seed)
    host_s = time.perf_counter() - t0
    dead = np.arange(0, SHARD_COMPACT_N, SHARD_COMPACT_DELETE_EVERY,
                     dtype=np.uint64)
    t0 = time.perf_counter()
    ixc = compact_sharded(delete_sharded(ixh, dead), mesh, batch=BATCH,
                          seed=seed)
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    live = np.setdiff1d(np.arange(SHARD_COMPACT_N), dead.astype(np.int64))
    _, live_gt = exact_search(q_dev, torch.from_numpy(sub[live]).cuda(), K)
    live_gt = live[live_gt.cpu().numpy()]
    _, g, lab, compact_ms = sharded_batches(
        lambda b: search_sharded(ixc, b, k=K, ef=64), batches, "compacted",
        labels_are_gids=False)
    check_live("sharded graph after compact", lab, dead.astype(np.int64))
    compact_r = recall(lab, live_gt)
    log("sharded host build + compact " + json.dumps(dict(
        rows=SHARD_COMPACT_N, host_build_s=host_s, deleted=len(dead),
        compact_s=compact_s, live=sum(ixc.num_nodes),
        graph_ms_per_batch=compact_ms, graph_recall_at_10=compact_r)))
    if sum(ixc.num_nodes) != len(live) or compact_r < GRAPH_RECALL_MIN:
        fail(f"sharded compact: {sum(ixc.num_nodes)} rows (want {len(live)}),"
             f" recall@10 {compact_r}")
    del ixh, ixc

    # (d) hamming shards: device build (K4 pools), beam and flat scan
    hparams = HnswParams(dim=HAM_DIM, metric=Metric.HAMMING, quant=QuantKind.B1)
    k40 = hamming_block.launches
    t0 = time.perf_counter()
    ixb = build_sharded_device(ham, hparams, mesh, batch=BATCH, seed=seed)
    torch.cuda.synchronize()
    ham_s = time.perf_counter() - t0
    ham_build_k4 = hamming_block.launches - k40
    ref.update(ham_digests=shard_digests(ixb), ham_build_s=ham_s)
    out = {}
    for mode, fn in (("graph", lambda b: search_sharded(ixb, b, k=K, ef=64)),
                     ("flat", lambda b: flat_search_sharded(ixb, b, k=K))):
        d, g, lab, ms = sharded_batches(fn, hbatches, f"hamming {mode}")
        exact = host_hamming(ham, ham_queries, g)
        if not np.array_equal(d, exact):
            fail(f"sharded hamming {mode}: distances differ from the host's "
                 f"popcount (max abs {np.abs(d - exact).max()})")
        out[mode] = (float((exact <= ham_kth).mean()), ms)
        ref[f"ham_{mode}"], ref[f"ham_{mode}_ms"] = (d, g, lab), ms
    log("sharded hamming " + json.dumps(dict(
        rows=SHARD_HAM_N, bits=HAM_DIM, build_s=ham_s,
        build_k4_launches=ham_build_k4,
        graph_recall_at_10_tie_aware=out["graph"][0],
        graph_ms_per_batch=out["graph"][1],
        flat_recall_at_10_tie_aware=out["flat"][0],
        flat_ms_per_batch=out["flat"][1])))
    if out["graph"][0] < HAM_GRAPH_RECALL_MIN:
        fail(f"sharded hamming graph tie-aware recall@10 {out['graph'][0]} < "
             f"{HAM_GRAPH_RECALL_MIN}")
    if out["flat"][0] < HAM_FLAT_RECALL_MIN:
        fail(f"sharded hamming flat tie-aware recall@10 {out['flat'][0]} < "
             f"{HAM_FLAT_RECALL_MIN}")
    del ixb
    launches = {"gather_dists": gather_dists.launches,
                "pq_decode": pq_decode.launches,
                "hamming_block": hamming_block.launches}
    log(f"sharding phase: {time.perf_counter() - t_phase:.1f} s, launches "
        + json.dumps(launches))
    for name, count in launches.items():
        if count <= 0:
            fail(f"the sharding phase never launched {name}")
    return launches, ref


def shard_digests(ix) -> dict:
    """sha256 of each shard's tables and host ints, by global shard id."""
    out = {}
    for j, si in enumerate(ix.shard_ids):
        h = hashlib.sha256()
        for name in ("vectors", "sq_norms", "neighbors0", "upper_neighbors",
                     "upper_slot", "levels", "labels", "deleted", "upper_ids",
                     "global_ids"):
            t = getattr(ix, name)[j].contiguous().cpu()
            h.update(t.view(torch.uint8).numpy().tobytes())
        h.update(repr((ix.entry[j], ix.max_level[j], ix.num_nodes[j])).encode())
        out[str(si)] = h.hexdigest()
    return out


def codebook_digest(ix) -> str:
    h = hashlib.sha256(ix.pq_codebook.cpu().numpy().tobytes())
    if ix.pq_rotation is not None:
        h.update(ix.pq_rotation.cpu().numpy().tobytes())
    return h.hexdigest()


def file_digests(path) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        h = hashlib.sha256()
        with open(os.path.join(path, name), "rb") as f:
            for chunk in iter(lambda: f.read(1 << 24), b""):
                h.update(chunk)
        out[name] = h.hexdigest()
    return out


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(leg: str, world: int, work: str, seed: int, timeout_s: float):
    """Start ``world`` ranks of this script (``--rank-leg leg``), torchrun's
    environment each, and wait for them. Any rank's non-zero exit or the
    timeout kills the others and fails the run. Returns each rank's (info,
    results) as the rank wrote them."""
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port()), "WORLD_SIZE": str(world),
           "LOCAL_WORLD_SIZE": str(world)}
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            logs.append(open(os.path.join(work, f"{leg}_r{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank-leg", leg,
                 "--work", work, "--seed", str(seed)],
                env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                stdout=logs[-1], stderr=subprocess.STDOUT))
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes) or all(c == 0 for c in codes):
                break
            if time.perf_counter() - t0 > timeout_s:
                codes = "timeout"
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r in range(world):
        with open(os.path.join(work, f"{leg}_r{r}.log")) as f:
            for line in f.read().splitlines()[-40:]:
                log(f"  [{leg} rank {r}] {line}")
    if codes == "timeout" or any(c != 0 for c in codes):
        fail(f"ranks leg ({leg}): exit codes {codes} after "
             f"{time.perf_counter() - t0:.1f} s")
    out = []
    for r in range(world):
        with open(os.path.join(work, f"{leg}_r{r}.json")) as f:
            info = json.load(f)
        res = dict(np.load(os.path.join(work, f"{leg}_r{r}.npz")))
        out.append((info, res))
    return out, time.perf_counter() - t0


def kernel_launches() -> dict:
    return {"gather_dists": gather_dists.launches,
            "pq_decode": pq_decode.launches,
            "hamming_block": hamming_block.launches}


def rank_batches(fn, batches, res, name, info):
    """``sharded_batches`` on a rank after one more warm-up batch (a group's
    first collectives set up its communicators). Its results go to
    ``res[name]``; its ms a batch, each kernel's launches a batch and the
    merge's bytes and seconds a batch to ``info``."""
    fn(batches[0])
    _dist.reset_merge_stats()
    before = kernel_launches()
    d, g, lab, ms = sharded_batches(fn, batches, name)
    res[f"{name}/d"], res[f"{name}/g"], res[f"{name}/l"] = d, g, lab
    merge = _dist.merge_stats
    calls = len(batches) + 1
    info["ms"][name] = ms
    info["launches_per_batch"][name] = {
        k: (v - before[k]) / calls for k, v in kernel_launches().items()}
    info["merge"][name] = {"bytes_per_batch": merge["bytes"] / calls,
                           "host_bytes_per_batch": merge["host_bytes"] / calls,
                           "ms_per_batch": merge["seconds"] / calls * 1e3}


def rank_main(leg: str, work: str, seed: int) -> None:
    """One rank of phase 15: joins the group from torchrun's environment
    (NCCL in leg a, gloo in b and c) and runs its leg on the rows phase 14
    wrote; writes its results and an info JSON to ``work``."""
    import torch.distributed as dist

    dev = init_multihost(backend="nccl" if leg == "a" else "gloo",
                         timeout_s=RANK_TIMEOUT_S)
    rank, world = dist.get_rank(), dist.get_world_size()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    info = {"rank": rank, "world": world, "backend": dist.get_backend(),
            "device": str(dev), "s": {}, "ms": {}, "merge": {},
            "launches_per_batch": {}}
    res = {}
    params = HnswParams(dim=DIM, m=16, ef_construction=128)
    queries = np.load(os.path.join(work, "queries.npy"))
    q_dev = torch.from_numpy(queries).to(dev)
    batches = [q_dev[i:i + BATCH] for i in range(0, len(queries), BATCH)]

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        info["s"][name] = time.perf_counter() - t0
        return out

    if leg in ("a", "b"):
        mesh = make_mesh(SHARDS)
        base = np.load(os.path.join(work, "base.npy"), mmap_mode="r")
        ix = timed("build", lambda: build_sharded_device(
            base, params, mesh, batch=BATCH, seed=seed))
        info["build_digests"] = shard_digests(ix)
        # the [S, Q, k] results a batch, all data rows together
        info["stated_merge_bytes"] = ShardedSearchStats.of(
            ix, BATCH, K).collective_bytes_per_batch
        rank_batches(lambda b: search_sharded(ix, b, k=K, ef=64), batches,
                     res, "graph", info)
        rank_batches(lambda b: flat_search_sharded(ix, b, k=K, exact=True),
                     batches, res, "flat", info)
    if leg == "b":
        ixq = timed("quantize", lambda: quantize_sharded(
            ix, mesh, quant="pq", train_rows=SHARD_PQ_TRAIN_ROWS, seed=seed))
        info["codebook"] = codebook_digest(ixq)
        rank_batches(lambda b: flat_search_sharded_rerank(
            ixq, b, k=K, shortlist=SHARD_RERANK), batches, res, "rerank", info)
        del ixq
        extra = np.load(os.path.join(work, "extra.npy"))
        dead = np.load(os.path.join(work, "dead.npy"))
        ix = timed("insert", lambda: insert_sharded(ix, extra, mesh,
                                                    batch=BATCH, seed=seed))
        ix = timed("delete", lambda: delete_sharded(ix, dead))
        for mode, fn in (("graph", lambda b: search_sharded(ix, b, k=K, ef=64)),
                         ("flat", lambda b: flat_search_sharded(ix, b, k=K))):
            rank_batches(fn, batches, res, f"after_delete_{mode}", info)
        timed("save", lambda: save_sharded(ix, os.path.join(work, "ranks_save")))
        del ix
        ixl = timed("load", lambda: load_sharded(
            os.path.join(work, "ranks_save"), mesh))
        for mode, fn in (("graph", lambda b: search_sharded(ixl, b, k=K, ef=64)),
                         ("flat", lambda b: flat_search_sharded(ixl, b, k=K))):
            rank_batches(fn, batches, res, f"after_load_{mode}", info)
        del ixl
        # hamming shards: K4 in the flat pools, the entry scans, the flat scan
        ham = np.load(os.path.join(work, "ham_rows.npy"))
        hq = torch.from_numpy(np.load(os.path.join(work, "ham_queries.npy"))
                              .view(np.int32)).to(dev)
        hbatches = [hq[i:i + BATCH] for i in range(0, len(hq), BATCH)]
        hparams = HnswParams(dim=HAM_DIM, metric=Metric.HAMMING,
                             quant=QuantKind.B1)
        ixb = timed("ham_build", lambda: build_sharded_device(
            ham, hparams, mesh, batch=BATCH, seed=seed))
        info["ham_digests"] = shard_digests(ixb)
        for mode, fn in (("graph", lambda b: search_sharded(ixb, b, k=K, ef=64)),
                         ("flat", lambda b: flat_search_sharded(ixb, b, k=K))):
            rank_batches(fn, hbatches, res, f"ham_{mode}", info)
    if leg == "c":
        mesh = make_mesh(SHARDS, data=RANKS_DATA)
        ixl = timed("load", lambda: load_sharded(
            os.path.join(work, "ranks_save"), mesh))
        info["stated_merge_bytes"] = ShardedSearchStats.of(
            ixl, BATCH, K).collective_bytes_per_batch
        for mode, fn in (("graph", lambda b: search_sharded(ixl, b, k=K, ef=64)),
                         ("flat", lambda b: flat_search_sharded(ixl, b, k=K))):
            rank_batches(fn, batches, res, mode, info)
    info["launches"] = kernel_launches()
    np.savez(os.path.join(work, f"{leg}_r{rank}.npz"), **res)
    with open(os.path.join(work, f"{leg}_r{rank}.json"), "w") as f:
        json.dump(info, f)
    _dist.barrier(dev)
    dist.destroy_process_group()
    log(f"rank {rank} of {world} ({leg}) done")


def check_same(name, got, want):
    """Results (d, gids, labels) equal to ``want``, element for element."""
    for what, a, b in zip(("distances", "gids", "labels"), got, want):
        if a.shape != b.shape or not np.array_equal(a, b):
            n = a.size if a.shape != b.shape else int((a != b).sum())
            fail(f"ranks {name}: {what} differ from phase 14's ({n} of "
                 f"{b.size})")


def rank_results(ranks, name):
    """One result of every rank, which must all be equal; returns rank 0's."""
    got = [tuple(res[f"{name}/{x}"] for x in "dgl") for _, res in ranks]
    for r, other in enumerate(got[1:], 1):
        check_same(f"{name} (rank {r} against rank 0)", other, got[0])
    return got[0]


def rank_digests(ranks, key) -> dict:
    out = {}
    for info, _ in ranks:
        out.update(info[key])
    return out


def phase_ranks(base, queries, gt_i, ham_rows, ham_queries, ref, seed):
    """Phase 15: the S=4 index of phase 14 placed over ranks. (a) one NCCL
    rank; (b) two gloo ranks sharing the card, two shards each; (c) four
    gloo ranks, data=2 x 2 shard ranks, loading (b)'s save. Each result is
    held to phase 14's (``ref``) where the plan is the same. Returns each
    kernel's launches, summed over the ranks and this process."""
    t_phase = time.perf_counter()
    gather_dists.launches = pq_decode.launches = hamming_block.launches = 0
    if torch.cuda.device_count() == 1:
        try:
            init_multihost(f"127.0.0.1:{free_port()}", 2, 0, backend="nccl")
        except ValueError as e:
            if "gloo" not in str(e):
                fail(f"NCCL with two ranks on one card raised {e}")
            log(f"ranks: NCCL with two ranks on the one card refused: {e}")
        else:
            fail("init_multihost(backend='nccl') took two ranks on one card")
    work = snapshot_dir(2 * base.nbytes)
    try:
        t0 = time.perf_counter()
        for name, arr in (("base", base), ("queries", queries),
                          ("extra", ref["extra"]), ("dead", ref["dead"]),
                          ("ham_rows", ham_rows), ("ham_queries", ham_queries)):
            np.save(os.path.join(work.name, f"{name}.npy"), arr)
        log(f"ranks: inputs written as .npy in {time.perf_counter() - t0:.1f} s")
        launched = {"gather_dists": 0, "pq_decode": 0, "hamming_block": 0}
        summary = {}

        def leg(name, world, timeout_s):
            ranks, wall = run_ranks(name, world, work.name, seed, timeout_s)
            for info, _ in ranks:
                for k, v in info["launches"].items():
                    launched[k] += v
            summary[name] = dict(
                world=world, backend=ranks[0][0]["backend"], wall_s=wall,
                s={k: max(i["s"][k] for i, _ in ranks) for k in ranks[0][0]["s"]},
                ms_per_batch={k: max(i["ms"][k] for i, _ in ranks)
                              for k in ranks[0][0]["ms"]},
                merge_per_batch=ranks[0][0]["merge"],
                stated_merge_bytes=ranks[0][0]["stated_merge_bytes"],
                launches_per_batch_per_rank=[i["launches_per_batch"]
                                             for i, _ in ranks],
                launches_per_rank=[i["launches"] for i, _ in ranks])
            return ranks

        # (a) one NCCL rank: the collectives a multi-card machine runs
        ranks = leg("a", 1, RANKS_A_TIMEOUT_S)
        if rank_digests(ranks, "build_digests") != ref["build_digests"]:
            fail("ranks (a): the NCCL rank's device build differs from phase 14's")
        check_same("(a) graph", rank_results(ranks, "graph"), ref["graph"])
        check_same("(a) flat", rank_results(ranks, "flat"), ref["flat"])
        log("ranks (a) " + json.dumps(dict(
            summary["a"], phase14=dict(build_s=ref["build_s"],
                                       graph_ms=ref["graph_ms"],
                                       flat_ms=ref["flat_ms"],
                                       k1_per_batch=ref["k1_per_batch"]),
            equal_to_phase14=True)))

        # (b) two gloo ranks sharing the card
        ranks = leg("b", 2, RANKS_B_TIMEOUT_S)
        if rank_digests(ranks, "build_digests") != ref["build_digests"]:
            fail("ranks (b): the two ranks' device build differs from phase 14's")
        check_same("(b) graph", rank_results(ranks, "graph"), ref["graph"])
        check_same("(b) flat", rank_results(ranks, "flat"), ref["flat"])
        books = {info["codebook"] for info, _ in ranks}
        if len(books) != 1:
            fail("ranks (b): the ranks hold different PQ codebooks")
        book_equal = books == {ref["codebook"]}
        d, g, lab = rank_results(ranks, "rerank")
        rr_r = recall(g, gt_i)
        if book_equal:
            check_same("(b) rerank", (d, g, lab), ref["rerank"])
        if rr_r < PQ_AUTO_RECALL_MIN:
            fail(f"ranks (b): PQ rerank recall@10 {rr_r} < {PQ_AUTO_RECALL_MIN}")
        for mode in ("graph", "flat"):
            check_same(f"(b) {mode} after delete",
                       rank_results(ranks, f"after_delete_{mode}"),
                       ref["after_delete"][mode])
            check_same(f"(b) {mode} after load",
                       rank_results(ranks, f"after_load_{mode}"),
                       ref["after_delete"][mode])
        save_dir = os.path.join(work.name, "ranks_save")
        if file_digests(save_dir) != ref["save_digests"]:
            fail("ranks (b): the two ranks' save is not byte-equal to "
                 "phase 14's one-process save")
        if rank_digests(ranks, "ham_digests") != ref["ham_digests"]:
            fail("ranks (b): the hamming device build differs from phase 14's")
        for mode in ("graph", "flat"):
            check_same(f"(b) hamming {mode}", rank_results(ranks, f"ham_{mode}"),
                       ref[f"ham_{mode}"])
        log("ranks (b) " + json.dumps(dict(
            summary["b"], rerank_recall_at_10=rr_r, codebook_equal_to_phase14=book_equal,
            phase14=dict(build_s=ref["build_s"], graph_ms=ref["graph_ms"],
                         flat_ms=ref["flat_ms"], quantize_s=ref["pq_s"],
                         rerank_ms=ref["rerank_ms"],
                         rerank_recall=ref["rerank_recall"],
                         insert_s=ref["insert_s"], delete_s=ref["delete_s"],
                         save_s=ref["save_s"], load_s=ref["load_s"],
                         ham_build_s=ref["ham_build_s"],
                         ham_graph_ms=ref["ham_graph_ms"],
                         ham_flat_ms=ref["ham_flat_ms"]),
            save_byte_equal=True, equal_to_phase14=True)))
        b_after_load = {m: rank_results(ranks, f"after_load_{m}")
                        for m in ("graph", "flat")}

        # the two ranks' save in one process (no group)
        mesh = make_mesh(n_shards=SHARDS)
        t0 = time.perf_counter()
        one = load_sharded(save_dir, mesh)
        torch.cuda.synchronize()
        one_load_s = time.perf_counter() - t0
        q_dev = torch.from_numpy(queries).cuda()
        batches = [q_dev[i:i + BATCH] for i in range(0, len(queries), BATCH)]
        for mode, fn in (("graph", lambda b: search_sharded(one, b, k=K, ef=64)),
                         ("flat", lambda b: flat_search_sharded(one, b, k=K))):
            check_same(f"one process after the ranks' save ({mode})",
                       sharded_batches(fn, batches, mode)[:3],
                       ref["after_delete"][mode])
        del one

        # (c) four gloo ranks: data=2 x 2 shard ranks
        ranks = leg("c", 4, RANKS_C_TIMEOUT_S)
        for mode in ("graph", "flat"):
            check_same(f"(c) {mode}", rank_results(ranks, mode),
                       b_after_load[mode])
        graph_ms = summary["c"]["ms_per_batch"]["graph"]
        log("ranks (c) " + json.dumps(dict(
            summary["c"], graph_qps=BATCH / graph_ms * 1e3,
            b_graph_ms=summary["b"]["ms_per_batch"]["after_load_graph"],
            phase14_graph_ms=ref["graph_ms"], equal_to_b=True)))
    finally:
        work.cleanup()
    for k, v in kernel_launches().items():
        launched[k] += v
    log(f"ranks phase: {time.perf_counter() - t_phase:.1f} s, one-process "
        f"load of the ranks' save {one_load_s:.2f} s, launches summed over "
        f"ranks " + json.dumps(launched))
    for name, count in launched.items():
        if count <= 0:
            fail(f"the ranks phase never launched {name}")
    return launched


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


def run_examples(work: str) -> dict:
    """Start every example, and sharded_mesh over EXAMPLE_RANKS ranks, as a
    user does (``python3 -m lantern_tpu_torch.examples.<name>``, no
    ``--device``, no ``--n``), all at once; any non-zero exit or the wall
    limit kills the rest and fails the run. Returns each run's last line
    and wall seconds by run name."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "EXAMPLE_N"}
    env["PYTHONPATH"] = root
    runs = {name: [name] for name in EXAMPLES}
    runs[f"sharded_mesh --ranks {EXAMPLE_RANKS}"] = [
        "sharded_mesh", "--ranks", str(EXAMPLE_RANKS)]
    procs, logs, t0 = {}, {}, time.perf_counter()
    try:
        for run, (name, *args) in runs.items():
            logs[run] = open(os.path.join(work, f"{len(logs)}.log"), "w+")
            procs[run] = subprocess.Popen(
                [sys.executable, "-m", f"lantern_tpu_torch.examples.{name}",
                 *args], cwd=root, env=env, stdout=logs[run],
                stderr=subprocess.STDOUT)
        wall = {}
        while len(wall) < len(procs):
            for run, p in procs.items():
                if run not in wall and p.poll() is not None:
                    wall[run] = time.perf_counter() - t0
            if any(p.returncode not in (None, 0) for p in procs.values()):
                break
            if time.perf_counter() - t0 > EXAMPLES_TIMEOUT_S:
                break
            time.sleep(0.1)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    out = {}
    for run, p in procs.items():
        logs[run].seek(0)
        lines = logs[run].read().splitlines()
        logs[run].close()
        if p.returncode != 0:
            for line in lines[-40:]:
                log(f"  [{run}] {line}")
            fail(f"examples: {run} exited {p.returncode} after "
                 f"{time.perf_counter() - t0:.1f} s")
        out[run] = json.loads(lines[-1])
        out[run]["wall_s"] = wall[run]
    return out


class SmokeTokenizer:
    """Words hashed into VOCAB ids, padded to the batch's longest."""

    VOCAB = 512

    def __call__(self, batch, padding, truncation, max_length,
                 return_tensors):
        ids = [[zlib.crc32(w.encode()) % self.VOCAB for w in t.split()]
               [:max_length] or [0] for t in batch]
        width = max(len(r) for r in ids)
        return {"input_ids": torch.tensor([r + [0] * (width - len(r))
                                           for r in ids]),
                "attention_mask": torch.tensor([[1] * len(r)
                                                + [0] * (width - len(r))
                                                for r in ids])}


class SmokeEmbedder(torch.nn.Module):
    """A tiny text encoder from a seed: token embeddings and one tanh
    layer; records the device of each output it returns."""

    def __init__(self, dim: int = 64):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.emb = torch.nn.Embedding(SmokeTokenizer.VOCAB, dim)
        self.proj = torch.nn.Linear(dim, dim)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
        self.seen = []

    def forward(self, input_ids, attention_mask):
        hidden = torch.tanh(self.proj(self.emb(input_ids)))
        self.seen.append(hidden.device.type)
        return types.SimpleNamespace(last_hidden_state=hidden)


def check_embedder() -> dict:
    """The injected embedder through ``LocalTransformerRuntime`` with no
    device (on the card) and a daemon ``local`` job (the daemon on the
    card), each pooling against a CPU copy's run. Returns the max abs
    differences."""
    texts = [" ".join(f"word{(i * 7 + j) % 97}" for j in range(3 + i % 9))
             for i in range(EMBED_TEXTS)]
    model, tok = SmokeEmbedder(), SmokeTokenizer()
    cpu_model = copy.deepcopy(model)
    err = {}
    for pooling in embeddings.LocalTransformerRuntime.POOLINGS:
        rt = embeddings.LocalTransformerRuntime(model=model, tokenizer=tok,
                                                pooling=pooling, batch_size=0)
        model.seen.clear()
        got = rt.process(texts)
        if rt.device.type != "cuda" or set(model.seen) != {"cuda"} or any(
                not p.is_cuda for p in model.parameters()):
            fail(f"embedder ({pooling}): ran on {rt.device} / {model.seen}")
        want = embeddings.LocalTransformerRuntime(
            model=cpu_model, tokenizer=tok, pooling=pooling, device="cpu",
            batch_size=16).process(texts)
        err[pooling] = float(np.abs(got - want).max())
        if not err[pooling] <= EMBED_ATOL or got.shape != want.shape:
            fail(f"embedder ({pooling}): {got.shape} against {want.shape}, "
                 f"max abs err {err[pooling]} > {EMBED_ATOL}")
        log(f"embedder {pooling}: {got.shape} on {rt.device}, dynamic batch "
            f"{rt.batch_size}, max abs err against the CPU {err[pooling]:.3g}")
    with tempfile.TemporaryDirectory() as work:
        inp = os.path.join(work, "texts.txt")
        with open(inp, "w") as f:
            f.write("\n".join(texts) + "\n")
        q = JobQueue(os.path.join(work, "jobs"))
        jid = q.submit("embedding", {
            "input": inp, "output": os.path.join(work, "e.npy"),
            "runtime": "local", "runtime_args": {"model_path": "smoke",
                                                 "pooling": "mean"}})
        loader = embeddings._load_pretrained
        embeddings._load_pretrained = lambda path: (model, tok)
        try:
            daemon = Daemon(q, backoff_base_s=0.01)
            model.seen.clear()
            daemon.run_pending()
        finally:
            embeddings._load_pretrained = loader
        job = q.get(jid)
        if daemon.device.type != "cuda" or job["status"] != "completed":
            fail(f"embedder daemon job on {daemon.device}: {job}")
        got = np.load(os.path.join(work, "e.npy"))
    want = embeddings.LocalTransformerRuntime(
        model=cpu_model, tokenizer=tok, pooling="mean",
        device="cpu").process(texts)
    err["daemon_mean"] = float(np.abs(got - want).max())
    if set(model.seen) != {"cuda"} or not err["daemon_mean"] <= EMBED_ATOL:
        fail(f"embedder daemon job: ran on {model.seen}, max abs err "
             f"{err['daemon_mean']}")
    log(f"embedder daemon job: {job['usage']} on {daemon.device}, max abs "
        f"err against the CPU {err['daemon_mean']:.3g}")
    return err


def phase_examples() -> dict:
    """Phase 16: the four examples and sharded_mesh over ranks as
    subprocesses on the default device, then the injected embedder.
    Returns each kernel's launches summed over the example runs."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        runs = run_examples(work)
    total = dict.fromkeys(kernel_launches(), 0)
    for run, res in runs.items():
        launched = dict(res["launches"])
        for k, v in res.get("ranks", {}).get("launches", {}).items():
            launched[k] += v
        for k, v in launched.items():
            total[k] += v
        brief = {k: res[k] for k in ("recall", "adc_recall", "rerank_recall",
                                     "top1", "mode", "hybrid_labels",
                                     "after_compact", "after_reindex", "size")
                 if k in res}
        log(f"example {run}: device {res['device']}, n {res['n']}, "
            f"{res['seconds']:.2f} s in main, {res['wall_s']:.1f} s wall, "
            f"launches {launched}, {json.dumps(brief)}")
        if res["device"] != "cuda":
            fail(f"example {run} ran on {res['device']}, not the default cuda")
    ranks = runs[f"sharded_mesh --ranks {EXAMPLE_RANKS}"]["ranks"]
    log(f"example sharded_mesh over {ranks['world']} gloo ranks: ids equal "
        f"to one process {ranks['ids_equal']}, {ranks['seconds']:.1f} s")
    if runs["pq_rerank"]["launches"]["pq_decode"] <= 0:
        fail("example pq_rerank: no PQ decode launch")
    for run in ("sharded_mesh", f"sharded_mesh --ranks {EXAMPLE_RANKS}"):
        if runs[run]["launches"]["gather_dists"] <= 0:
            fail(f"example {run}: no K1 launch")
    if ranks["ids_equal"] is not True or ranks["launches"]["gather_dists"] <= 0:
        fail(f"example sharded_mesh over ranks: {ranks}")
    check_embedder()
    log(f"examples phase: {time.perf_counter() - t0:.1f} s")
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="base rows")
    ap.add_argument("--i8-n", type=int, default=None,
                    help=f"rows of the i8 path (default: {I8_N} or --n, "
                         "the fewer)")
    ap.add_argument("--seed", type=int, default=0)
    # a rank of phase 15, started by the phase itself
    ap.add_argument("--rank-leg", choices=("a", "b", "c"), help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_leg:
        rank_main(args.rank_leg, args.work, args.seed)
        return
    i8_n = args.i8_n or min(I8_N, args.n)
    pq_n, ham_n = min(PQ_PATH_N, args.n), min(HAM_PATH_N, args.n)
    persist_n = min(PERSIST_N, args.n)

    t_start = t_lap = time.perf_counter()
    phase_s = {}

    def lap(name):  # the seconds since the last lap, logged at the end
        nonlocal t_lap
        now = time.perf_counter()
        phase_s[name] = round(now - t_lap, 1)
        t_lap = now

    smi = phase_environment()
    phase_build()
    if args.n != 1_000_000:
        log(f"n cut: {args.n} rows instead of 1000000")
    log(f"path cuts: i8 {i8_n}, PQ {pq_n}, hamming {ham_n} rows of {args.n}; "
        f"persistence (2)-(4) on {persist_n} rows, WAL_N {WAL_N}, "
        f"WAL_DELETES {WAL_DELETES}, STREAM_QUERIES {STREAM_QUERIES}; "
        f"autotune job variants {len(AUTOTUNE_JOB_VARIANTS)} of 6; HTTP_N "
        f"{HTTP_N}")
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

    lap("environment, build, data")
    k1, max_abs = phase_kernel(base_dev, queries_dev, args.seed)
    torch.cuda.synchronize()
    pq, pq_max_abs = phase_pq_kernel(args.seed)
    torch.cuda.synchronize()
    k4, k4_max_abs = phase_hamming_kernel(args.n, args.seed)
    torch.cuda.synchronize()
    cos = phase_cos_block(args.seed)
    torch.cuda.synchronize()
    select = phase_row_topk(base_dev, queries_dev)
    torch.cuda.synchronize()
    lap("kernels")
    launches, host_build_s, gt_i, main_results = phase_main_path(
        base, queries, base_dev, queries_dev, args.seed)
    select_launches = row_topk.launches  # the main path's searches, profiled too
    torch.cuda.synchronize()
    lap("main path")
    del base_dev
    # the service phase's files: the server's snapshot, the rows as .npy,
    # the collections the HTTP API saves, jobs, the PQ table
    work = snapshot_dir(3 * base.nbytes)
    snapshot = os.path.join(work.name, f"{HTTP_COLLECTION}.ldb")
    k1_build_launches, dev_ix, dev_build_s = phase_device_build(
        base, queries, gt_i, centers, host_build_s, args.seed, snapshot)
    torch.cuda.synchronize()
    lap("device build")
    k1_persist = phase_persistence(dev_ix, base[:persist_n], queries,
                                   queries_dev, centers, args.seed)
    del dev_ix
    torch.cuda.synchronize()
    lap("persistence")
    k1_service, pq_service, k4_service = phase_service(
        work.name, snapshot, base, queries, gt_i)
    work.cleanup()
    torch.cuda.synchronize()
    lap("service")
    pq_launches = phase_pq_path(base[:pq_n], queries, queries_dev,
                                gt_i if pq_n == args.n else None, args.seed)
    torch.cuda.synchronize()
    lap("pq path")
    opq = phase_opq(args.seed)
    torch.cuda.synchronize()
    lap("opq")
    (k4_launches, ham_rows, ham_queries, ham_gt_i, ham_gt_d, ham_build_s,
     ham_ix) = phase_hamming_path(ham_n, args.seed)
    torch.cuda.synchronize()
    lap("hamming path")
    k4_build_launches = phase_hamming_device_build(
        ham_rows, ham_queries, ham_gt_i, ham_gt_d, ham_build_s, args.seed)
    ham_rows = ham_rows[:SHARD_HAM_N].copy()  # the sharding phase's
    torch.cuda.synchronize()
    lap("hamming device build")
    k4_persist, pq_persist = phase_persistence_roundtrips(
        ham_ix, ham_queries, opq)
    del ham_ix, opq
    torch.cuda.synchronize()
    lap("persistence round trips")
    phase_i8_path(base[:i8_n], queries, queries_dev,
                  gt_i if i8_n == args.n else None, args.seed)
    torch.cuda.synchronize()
    lap("i8 path")
    shard, shard_ref = phase_sharding(
        base, queries, gt_i, centers, ham_rows, ham_queries,
        dict(graph_ms=main_results["graph"]["ms_per_batch"],
             flat_ms=main_results["flat"]["ms_per_batch"],
             k1_per_batch=main_results["graph"]["k1_launches_per_batch"],
             device_build_s=dev_build_s), args.seed)
    torch.cuda.synchronize()
    lap("sharding")
    ranks = phase_ranks(base, queries, gt_i, ham_rows, ham_queries, shard_ref,
                        args.seed)
    del shard_ref
    lap("ranks")
    example_launches = phase_examples()
    lap("examples")
    log("phase seconds " + json.dumps(phase_s))
    log(f"whole run: {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"kernels": [{
        "name": "gather_dists",
        "route": "cuda",
        "source": "lantern_tpu_torch/csrc/gather_dists.cu",
        "replaces": "lantern_tpu/ops/pallas_gather.py:85",
        "launches": launches,
        "build_launches": k1_build_launches,
        "persist_launches": k1_persist,
        "service_launches": k1_service,
        "shard_launches": shard["gather_dists"],
        "rank_launches": ranks["gather_dists"],
        "example_launches": example_launches["gather_dists"],
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
        "service_launches": pq_service,
        "shard_launches": shard["pq_decode"],
        "rank_launches": ranks["pq_decode"],
        "example_launches": example_launches["pq_decode"],
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
        "service_launches": k4_service,
        "shard_launches": shard["hamming_block"],
        "rank_launches": ranks["hamming_block"],
        "example_launches": example_launches["hamming_block"],
        "max_abs_err": k4_max_abs,
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"],
    }, {
        "name": "cos_block",
        "route": "cuda",
        "source": "lantern_tpu_torch/csrc/cos_block.cu",
        "replaces": "none: the flat scan's f32 cosine block (an FFMA SGEMM "
                    "and two passes), left to XLA in lantern_tpu/flat.py",
        "launches": cos["launches"],
        "dist_gap": cos["dist_gap"],
        "ms": cos["ms"],
        "plain_ms": cos["plain_ms"],
        "bound_ms": cos["bound_ms"],
        "bound_by": cos["bound_by"],
        "library_ms": cos["library_ms"],
        "library_tf32_ms": cos["library_tf32_ms"],
    }, {
        "name": "row_topk",
        "route": "cuda",
        "source": "lantern_tpu_torch/csrc/row_topk.cu",
        "replaces": "none: the flat scan's row top-k, left to XLA "
                    "(jax.lax.top_k) in lantern_tpu/flat.py",
        "launches": select_launches,
        "flat_launches_per_batch":
            main_results["flat"]["row_topk_launches_per_batch"],
        "graph_launches_per_batch":
            main_results["graph"]["row_topk_launches_per_batch"],
        "phase_launches": select["launches"],
        **{key: select[key] for key in (
            "ms", "ms_k128", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_ms_k128")},
    }]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
