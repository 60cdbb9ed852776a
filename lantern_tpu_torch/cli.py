"""lantern-tpu-torch CLI — parity with lantern_cli's subcommands (R1, cli.rs).

Subcommands (reference in parentheses):
- start-indexing-server  (StartIndexingServer)
- start-router           (the router server type)
- start-server           (StartServer — HTTP API)
- start-daemon           (StartDaemon)
- autotune-index         (AutotuneIndex)
- pq-table               (PQTable — here: PQ-train/encode a .npy dataset)
- create-embeddings      (CreateEmbeddings)
- measure-model-speed    (MeasureModelSpeed)
- build-index / search   (local convenience over .npy datasets)

Every subcommand that touches an index takes ``--device`` (default
``cuda``; ``--device cpu`` runs the plain PyTorch path on the host).
``create-embeddings`` and ``measure-model-speed`` take no ``--device``: a
``local`` runtime runs its model on ``cuda`` unless ``--runtime-params``
names one (``'{"device": "cpu", ...}'``); the other runtimes do no device
work.

Run: python -m lantern_tpu_torch.cli <subcommand> --help
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

import numpy as np


def _serve_forever(stop_fn):
    """Block until SIGINT/SIGTERM, then run the service's stop()."""
    import signal
    import threading

    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: done.set())
        except (ValueError, OSError):  # non-main thread / platform quirk
            pass
    try:
        done.wait()
    except KeyboardInterrupt:
        pass
    stop_fn()

def _cmd_start_indexing_server(args):
    from lantern_tpu_torch.service.index_server import IndexServer

    ssl_ctx = None
    if bool(args.cert) != bool(args.key):
        raise SystemExit(
            "--cert and --key must be given together; refusing to start a "
            "plaintext server when TLS was half-configured"
        )
    if args.cert and args.key:
        import ssl

        ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_ctx.load_cert_chain(args.cert, args.key)
    srv = IndexServer(host=args.host, port=args.port,
                      status_port=args.status_port, ssl_context=ssl_ctx,
                      build=args.build, device=args.device)

    async def main():
        await srv.start()
        print(f"indexing server on {srv.host}:{srv.port} "
              f"(status :{srv.status_port})", flush=True)
        await asyncio.Event().wait()

    asyncio.run(main())


def _cmd_start_router(args):
    from lantern_tpu_torch.service.index_server import RouterServer

    srv = RouterServer(args.target_host, args.target_port,
                       host=args.host, port=args.port)

    async def main():
        await srv.start()
        print(f"router on {srv.host}:{srv.port} -> "
              f"{args.target_host}:{args.target_port}", flush=True)
        await asyncio.Event().wait()

    asyncio.run(main())


def _cmd_start_server(args):
    from lantern_tpu_torch.service.http_api import HttpApi

    api = HttpApi(host=args.host, port=args.port,
                  username=args.username, password=args.password,
                  data_dir=args.data_dir, device=args.device).start()
    print(f"http api on {api.host}:{api.port}", flush=True)
    _serve_forever(lambda: api.stop())


def _cmd_start_daemon(args):
    if not args.master_registry and not args.queue_dir:
        raise SystemExit("start-daemon needs --queue-dir or --master-registry")
    if args.master_registry:
        # master mode: discover targets from the registry, one daemon per
        # target, health-ping canceling a failed target's jobs
        # (daemon/mod.rs:217-344)
        from lantern_tpu_torch.service.daemon import MasterDaemon

        md = MasterDaemon(
            args.master_registry, ping_s=args.ping_interval,
            daemon_poll_s=args.poll_interval, device=args.device,
        ).start()
        print(f"master daemon over {args.master_registry}", flush=True)
        _serve_forever(lambda: md.stop())
        return
    from lantern_tpu_torch.service.daemon import Daemon, JobQueue

    q = JobQueue(args.queue_dir)
    d = Daemon(q, poll_s=args.poll_interval, device=args.device).start()
    print(f"daemon watching {args.queue_dir}", flush=True)
    _serve_forever(lambda: d.stop())


def _cmd_start_bgworkers(args):
    """In-process services host (lantern_extras bgworkers analog)."""
    from lantern_tpu_torch.service.bgworkers import ServiceConfig, ServiceHost

    cfg = ServiceConfig(
        enable_daemon=bool(args.queue_dir),
        enable_indexing_server=args.indexing,
        indexing_port=args.indexing_port,
        status_port=args.status_port,
        jobs_dir=args.queue_dir,
    )
    host = ServiceHost(cfg, device=args.device).start()
    print(f"bgworkers up (indexing port={host.indexing_port})", flush=True)
    _serve_forever(lambda: host.stop())


def _cmd_autotune_index(args):
    from lantern_tpu_torch.autotune import autotune
    from lantern_tpu_torch.config import Metric

    vectors = np.load(args.input)
    best, results = autotune(
        vectors,
        metric=Metric.from_string(args.metric),
        k=args.k,
        target_recall=args.recall,
        sample=args.test_data_size,
        engine=args.engine,
        model_name=args.model_name,
        results_path=args.results_path,
        device=args.device,
    )
    for r in results:
        print(r.exp_str())
    if best:
        print(f"BEST: {best.exp_str()}")
    else:
        print(f"no variant met target recall {args.recall}")


def _cmd_pq_table(args):
    from lantern_tpu_torch.quant.pq import (
        pq_encode,
        train_codebook,
        train_codebook_chunked,
    )

    # stream when the input is an .fvecs file, or when --chunk-rows asks
    # for bounded-memory training over an .npy (memory-mapped)
    streamed = args.input.endswith((".fvecs", ".fvecs.gz")) or (
        bool(args.chunk_rows) and args.input.endswith(".npy")
    )
    if streamed:
        # chunked/resumable path: never materializes the dataset (the
        # reference's resumable GCP-shardable pipeline, pq/cli.rs:83-137)
        first_dim = None
        from lantern_tpu_torch.quant.pq import _chunk_factory

        for blk in _chunk_factory(args.input, max(args.chunk_rows or 65536, 8))():
            first_dim = blk.shape[1]
            break
        if first_dim is None:
            raise SystemExit("empty dataset")
        nsub = args.splits or max(
            (s for s in range(1, max(1, first_dim // 4) + 1)
             if first_dim % s == 0),
            default=1,
        )
        cb = train_codebook_chunked(
            args.input, num_subvectors=nsub, num_centroids=args.clusters,
            seed=args.seed, rotate=args.rotate, resume_path=args.resume,
            chunk_rows=args.chunk_rows or 65536, iters=args.iters,
            device=args.device,
        )
        # encode in chunks too (codes stream to the output incrementally)
        chunks = _chunk_factory(args.input, args.chunk_rows or 65536)
        codes = np.concatenate([pq_encode(blk, cb, device=args.device)
                                for blk in chunks()])
        np.savez(args.output, codebook=cb.centroids, codes=codes,
                 rotation=(cb.rotation if cb.rotation is not None
                           else np.zeros(0, np.float32)))
        print(f"codebook {cb.centroids.shape}, codes {codes.shape} "
              f"-> {args.output} (chunked)")
        return
    vectors = np.load(args.input).astype(np.float32)
    dim = vectors.shape[1]
    # default: the largest divisor of dim <= dim//4 (dim//4 verbatim need
    # not divide dim — e.g. 130-d would crash train_codebook)
    nsub = args.splits
    if not nsub:
        nsub = max(
            (s for s in range(1, max(1, dim // 4) + 1) if dim % s == 0),
            default=1,
        )
    cb = train_codebook(vectors, num_subvectors=nsub,
                        num_centroids=args.clusters, seed=args.seed,
                        rotate=args.rotate, device=args.device)
    codes = pq_encode(vectors, cb, device=args.device)
    np.savez(args.output, codebook=cb.centroids, codes=codes)
    print(f"codebook {cb.centroids.shape}, codes {codes.shape} -> {args.output}")


def _cmd_create_embeddings(args):
    from lantern_tpu_torch.embeddings import get_runtime

    with open(args.input) as f:
        texts = [line.rstrip("\n") for line in f if line.strip()]
    kw = json.loads(args.runtime_params) if args.runtime_params else {}
    rt = get_runtime(args.runtime, **kw)
    embs = rt.process(texts)
    np.save(args.output, embs)
    print(f"embedded {len(texts)} rows dim={embs.shape[1]} -> {args.output}")


def _cmd_measure_model_speed(args):
    from lantern_tpu_torch.embeddings import get_runtime, measure_speed

    kw = json.loads(args.runtime_params) if args.runtime_params else {}
    rt = get_runtime(args.runtime, **kw)
    texts = [f"sample sentence number {i} for speed measurement" for i in range(256)]
    print(f"{measure_speed(rt, texts):.0f} embeddings/s")


def _cmd_build_index(args):
    from lantern_tpu_torch.config import HnswParams, Metric
    from lantern_tpu_torch.index import Index

    vectors = np.load(args.input).astype(np.float32)
    p = HnswParams(dim=vectors.shape[1], m=args.m,
                   ef_construction=args.efc, ef=args.ef,
                   metric=Metric.from_string(args.metric))
    ix = Index(p, capacity=len(vectors), device=args.device)
    ix.add(vectors, build=args.build)
    ix.save(args.output)
    rep = ix.validate(full=False)
    print(f"built {ix.size} vectors -> {args.output} (valid={rep.ok})")


def _cmd_search(args):
    from lantern_tpu_torch.index import Index

    ix = Index.load(args.index, device=args.device)
    queries = np.load(args.queries).astype(np.float32)
    rerank = args.rerank
    if rerank not in (None, "auto"):
        rerank = int(rerank)
    if rerank is not None and ix._raw_rows is None and args.rows:
        ix.set_rerank_source(np.load(args.rows).astype(np.float32))
    d, labels = ix.search(queries, k=args.k, ef=args.ef, mode=args.mode,
                          rerank=rerank)
    for qi in range(len(queries)):
        row = [
            {"label": int(l), "dist": float(x)}
            for x, l in zip(d[qi], labels[qi])
            if np.isfinite(x)
        ]
        print(json.dumps(row))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lantern-tpu-torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    # the one option the port adds: where index work runs
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda",
                     help="torch device of the index work (cuda, or cpu)")

    s = sub.add_parser("start-indexing-server", parents=[dev])
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8998)
    s.add_argument("--status-port", type=int, default=8999)
    s.add_argument("--cert"), s.add_argument("--key")
    s.add_argument("--build", choices=("host", "device"), default="host",
                   help="device = bulk-build streamed tuples on the device "
                        "at END (b1/hamming streams stay on the host engine)")
    s.set_defaults(fn=_cmd_start_indexing_server)

    s = sub.add_parser("start-router")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8997)
    s.add_argument("--target-host", required=True)
    s.add_argument("--target-port", type=int, required=True)
    s.set_defaults(fn=_cmd_start_router)

    s = sub.add_parser("start-server", parents=[dev])
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--username"), s.add_argument("--password")
    s.add_argument("--data-dir", default=None,
                   help="persist collections here (load on start, save on "
                        "stop and POST /save)")
    s.set_defaults(fn=_cmd_start_server)

    s = sub.add_parser("start-daemon", parents=[dev])
    s.add_argument("--queue-dir",
                   help="single-target mode: the jobs directory to watch")
    s.add_argument("--master-registry",
                   help="master mode: JSON registry of targets "
                        "(id -> jobs_dir + heartbeat file)")
    s.add_argument("--poll-interval", type=float, default=1.0)
    s.add_argument("--ping-interval", type=float, default=30.0,
                   help="master mode health-ping period (reference: 30 s)")
    s.set_defaults(fn=_cmd_start_daemon)

    s = sub.add_parser("autotune-index", parents=[dev])
    s.add_argument("--input", required=True, help=".npy dataset")
    s.add_argument("--metric", default="l2sq")
    s.add_argument("--k", type=int, default=10)
    s.add_argument("--recall", type=float, default=0.9)
    s.add_argument("--test-data-size", type=int, default=10000)
    s.add_argument("--engine", default="native", choices=["device", "native"],
                   help="variant build path: native = host build (search "
                        "still measured on the device); device = the "
                        "device builder's own build times")
    s.add_argument("--model-name", default=None,
                   help="store/reuse results under this name")
    s.add_argument("--results-path", default=None,
                   help="JSON results store (prior-result reuse)")
    s.set_defaults(fn=_cmd_autotune_index)

    s = sub.add_parser("start-bgworkers", parents=[dev],
                       help="in-process daemon + indexing server")
    s.add_argument("--queue-dir", default=None)
    # BooleanOptionalAction: --indexing / --no-indexing (a bare store_true
    # with default=True was impossible to switch off)
    s.add_argument("--indexing", action=argparse.BooleanOptionalAction,
                   default=True)
    s.add_argument("--indexing-port", type=int, default=8998)
    s.add_argument("--status-port", type=int, default=8999)
    s.set_defaults(fn=_cmd_start_bgworkers)

    s = sub.add_parser("pq-table", parents=[dev])
    s.add_argument("--input", required=True,
                   help=".npy dataset, or .fvecs(.gz) for streamed training")
    s.add_argument("--output", required=True, help=".npz codebook+codes")
    s.add_argument("--clusters", type=int, default=256)
    s.add_argument("--splits", type=int, default=0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--rotate", action="store_true",
                   help="learn an OPQ rotation (better recall, same bytes)")
    s.add_argument("--iters", type=int, default=8,
                   help="Lloyd passes (chunked path)")
    s.add_argument("--chunk-rows", type=int, default=0,
                   help="stream the dataset in row chunks of this size "
                        "(bounded-memory training; .npy is memory-mapped)")
    s.add_argument("--resume", default=None,
                   help="state file: training checkpoints after every pass "
                        "and resumes from it after a kill")
    s.set_defaults(fn=_cmd_pq_table)

    s = sub.add_parser("create-embeddings")
    s.add_argument("--input", required=True, help="text file, one row per line")
    s.add_argument("--output", required=True, help=".npy output")
    s.add_argument("--runtime", default="hash")
    s.add_argument("--runtime-params", default="", help="JSON args")
    s.set_defaults(fn=_cmd_create_embeddings)

    s = sub.add_parser("measure-model-speed")
    s.add_argument("--runtime", default="hash")
    s.add_argument("--runtime-params", default="")
    s.set_defaults(fn=_cmd_measure_model_speed)

    s = sub.add_parser("build-index", parents=[dev])
    s.add_argument("--input", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--metric", default="l2sq")
    s.add_argument("--m", type=int, default=16)
    s.add_argument("--efc", type=int, default=128)
    s.add_argument("--ef", type=int, default=64)
    # device = bulk-build on the device and import (the external-build
    # analog, build.c:523-552); host = sequential native-engine inserts
    s.add_argument("--build", choices=("device", "host"), default="device")
    s.set_defaults(fn=_cmd_build_index)

    s = sub.add_parser("search", parents=[dev])
    s.add_argument("--index", required=True)
    s.add_argument("--queries", required=True)
    s.add_argument("--k", type=int, default=10)
    s.add_argument("--ef", type=int, default=None)
    s.add_argument("--mode", default="auto", choices=["auto", "flat", "graph"])
    s.add_argument("--rerank", default=None,
                   help="PQ indexes: ADC shortlist size, or 'auto' to size "
                        "it from measured coverage (calibrate_rerank)")
    s.add_argument("--rows", default=None,
                   help=".npy full-precision rows for rerank after load "
                        "(set_rerank_source)")
    s.set_defaults(fn=_cmd_search)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
