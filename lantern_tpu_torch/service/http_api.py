"""HTTP collection/search API — parity with lantern_cli's http_server (R7).

Reference (lantern_cli/src/http_server/): actix-web REST API with basic
auth: CRUD /collections, row insert, POST /collections/{name}/search
(vector or text via embedding), POST .../index (build), DELETE .../index,
POST .../pq. Stdlib ThreadingHTTPServer here — no framework dependency.

Collections are named indexes with an attached row store; search runs
on the API's device (default cuda) through the Index facade.
"""

from __future__ import annotations

import base64
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from lantern_tpu_torch import resolve_device
from lantern_tpu_torch.config import HnswParams, Metric
from lantern_tpu_torch.index import Index
from lantern_tpu_torch.utils.logger import Logger


class Collection:
    def __init__(self, name: str, dim: int, metric: Metric = Metric.COS,
                 device=None):
        self.name = name
        self.device = resolve_device(device)
        self.dim = dim
        self.metric = metric
        self.index: Index | None = None
        self.rows: dict[int, dict] = {}  # label -> row payload
        self.next_id = 1
        self.lock = threading.Lock()

    def ensure_index(self, **opts):
        if self.index is None:
            from lantern_tpu_torch.config import QuantKind

            params = HnswParams(
                dim=self.dim,
                m=opts.get("m", 16),
                ef_construction=opts.get("ef_construction", 128),
                ef=opts.get("ef", 64),
                metric=self.metric,
                pq=opts.get("pq", False),
                # hamming rows arrive as raw +/- bit vectors over JSON and
                # are sign-binarized/packed by Index._preprocess; without
                # B1 the f32 coercion would value-cast packed words
                quant=(QuantKind.B1 if self.metric == Metric.HAMMING
                       else QuantKind.F32),
            )
            self.index = Index(params, capacity=1024, device=self.device)
        return self.index

    def insert(self, vectors, payloads):
        with self.lock:
            ix = self.ensure_index()
            labels = np.arange(self.next_id, self.next_id + len(vectors), dtype=np.uint64)
            self.next_id += len(vectors)
            ix.add(np.asarray(vectors, np.float32), labels=labels)
            for lab, payload in zip(labels, payloads):
                self.rows[int(lab)] = payload
            return labels.tolist()


class ApiState:
    def __init__(self):
        self.collections: dict[str, Collection] = {}
        self.lock = threading.Lock()


class _Handler(BaseHTTPRequestHandler):
    server_version = "lantern-tpu-http/0.1"
    state: ApiState = None
    auth: str | None = None
    log_obj: Logger = None
    api = None  # owning HttpApi (persistence)

    # --- plumbing ---
    def log_message(self, fmt, *args):  # route through our logger
        if self.log_obj:
            self.log_obj.debug(fmt % args)

    def _reply(self, code: int, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _err(self, code: int, msg: str):
        self._reply(code, {"error": msg})

    def _body(self):
        n = int(self.headers.get("Content-Length", 0))
        if n == 0:
            return {}
        return json.loads(self.rfile.read(n) or b"{}")

    def _authorized(self) -> bool:
        if self.auth is None:
            return True
        got = self.headers.get("Authorization", "")
        return got == f"Basic {self.auth}"

    def _route(self, method: str):
        if not self._authorized():
            return self._err(401, "unauthorized")
        try:
            path = self.path.rstrip("/")
            if path in ("", "/"):
                return self._reply(200, {
                    "service": "lantern-tpu",
                    "endpoints": [
                        "GET /collections", "POST /collections",
                        "DELETE /collections/{name}",
                        "POST /collections/{name}/rows",
                        "DELETE /collections/{name}/rows",
                        "POST /collections/{name}/search",
                        "POST /collections/{name}/index",
                        "DELETE /collections/{name}/index",
                        "POST /collections/{name}/pq",
                        "POST /collections/{name}/compact",
                        "GET /models", "GET /runtimes",
                    ],
                })
            if path == "/models" and method == "GET":
                from lantern_tpu_torch.embeddings import get_available_models

                return self._reply(200, get_available_models())
            if path == "/runtimes" and method == "GET":
                from lantern_tpu_torch.embeddings import get_available_runtimes

                return self._reply(200, get_available_runtimes())
            if path == "/save" and method == "POST":
                if not getattr(self.api, "data_dir", None):
                    return self._err(400, "server started without --data-dir")
                return self._reply(200, {"saved": self.api.save_collections()})
            if path == "/collections":
                if method == "GET":
                    return self._reply(200, [
                        {"name": c.name, "dim": c.dim,
                         "metric": Metric(c.metric).name.lower(),
                         "size": c.index.size if c.index else 0,
                         "indexed": c.index is not None}
                        for c in self.state.collections.values()
                    ])
                if method == "POST":
                    b = self._body()
                    name = b["name"]
                    if not re.fullmatch(r"[A-Za-z0-9_\-]+", name):
                        return self._err(400, "invalid collection name")
                    with self.state.lock:
                        if name in self.state.collections:
                            return self._err(409, f"collection {name} exists")
                        self.state.collections[name] = Collection(
                            name,
                            dim=int(b.get("dim", 0)) or 0,
                            metric=Metric.from_string(b.get("metric", "cosine")),
                            device=self.api.device,
                        )
                    return self._reply(201, {"name": name})
            m = re.fullmatch(r"/collections/([A-Za-z0-9_\-]+)(/.*)?", path)
            if m:
                name, sub = m.group(1), (m.group(2) or "")
                col = self.state.collections.get(name)
                if col is None:
                    return self._err(404, f"no collection {name}")
                return self._collection_route(method, col, sub)
            return self._err(404, f"no route {method} {path}")
        except (KeyError, ValueError, TypeError) as e:
            return self._err(400, f"{type(e).__name__}: {e}")
        except Exception as e:  # noqa: BLE001
            return self._err(500, f"{type(e).__name__}: {e}")

    def _collection_route(self, method: str, col: Collection, sub: str):
        if sub == "" and method == "DELETE":
            with self.state.lock:
                del self.state.collections[col.name]
            return self._reply(200, {"deleted": col.name})
        if sub == "/rows" and method == "DELETE":
            # tombstone rows by id (SQL `DELETE FROM t` analog; space is
            # reclaimed by POST .../compact)
            b = self._body()
            ids = np.asarray(b.get("ids", []), np.uint64)
            if col.index is None or len(ids) == 0:
                return self._reply(200, {"deleted": 0})
            with col.lock:
                ndel = col.index.delete(ids)
                for lab in ids.tolist():
                    col.rows.pop(int(lab), None)
            return self._reply(200, {"deleted": int(ndel)})
        if sub == "/rows" and method == "POST":
            b = self._body()
            rows = b["rows"]
            vecs = [r["vector"] for r in rows]
            if col.dim == 0:
                col.dim = len(vecs[0])
            payloads = [{k: v for k, v in r.items() if k != "vector"} for r in rows]
            ids = col.insert(vecs, payloads)
            return self._reply(200, {"inserted": len(ids), "ids": ids})
        if sub == "/search" and method == "POST":
            b = self._body()
            if col.index is None:
                return self._err(400, "collection has no rows/index")
            k = int(b.get("k", 10))
            ef = b.get("ef")
            if "vector" in b:
                q = np.asarray([b["vector"]], np.float32)
            elif "text" in b:
                from lantern_tpu_torch.embeddings import text_embedding

                q = np.asarray(
                    [text_embedding(b.get("model", "hash"), b["text"],
                                    dim=col.dim, device=col.device)],
                    np.float32,
                )
            else:
                return self._err(400, "search needs 'vector' or 'text'")
            # PQ collections: ADC shortlist size, or "auto" to size it from
            # measured coverage (Index.calibrate_rerank)
            rerank = b.get("rerank")
            if rerank is not None and rerank != "auto":
                rerank = int(rerank)
            with col.lock:
                # inserts mutate/realloc the engine arrays the device
                # mirror is built from — searches must not race them
                d, labels = col.index.search(
                    q, k=k, ef=int(ef) if ef else None,
                    rerank=rerank or None,
                )
            out = []
            for dist, lab in zip(d[0], labels[0]):
                if not np.isfinite(dist):
                    continue
                row = dict(col.rows.get(int(lab), {}))
                row.update({"id": int(lab), "distance": float(dist)})
                out.append(row)
            return self._reply(200, {"results": out})
        if sub == "/index" and method == "POST":
            b = self._body()
            existed = col.index is not None
            col.ensure_index(
                m=int(b.get("m", 16)),
                ef_construction=int(b.get("ef_construction", 128)),
                ef=int(b.get("ef", 64)),
                pq=bool(b.get("pq", False)),
            )
            if existed and not b.get("external"):
                # an existing index is NOT silently left as-is when the
                # caller requests different graph params — rebuild in place
                # (host engine; "external": true takes the device path below)
                import dataclasses as _dc

                with col.lock:
                    want = _dc.replace(
                        col.index.params,
                        m=int(b.get("m", col.index.params.m)),
                        ef_construction=int(b.get(
                            "ef_construction",
                            col.index.params.ef_construction)),
                        ef=int(b.get("ef", col.index.params.ef)),
                    )
                    if want != col.index.params:
                        col.index.reindex(want)
            if b.get("external") and col.index.size:
                # "external": true = rebuild with the fast external builder
                # (reference: index.rs:51-84 issues CREATE INDEX WITH
                # (external=true)); here the external builder is the
                # device build, imported back into the serving engine
                import dataclasses as _dc

                with col.lock:
                    old = col.index
                    n = old.size
                    vecs = np.asarray(old._eng.vectors[:n], np.float32).copy()
                    labels = np.asarray(old._eng.labels[:n]).copy()
                    dead = labels[np.asarray(old._eng.deleted[:n]).astype(bool)]
                    params = _dc.replace(
                        old.params,
                        m=int(b.get("m", old.params.m)),
                        ef_construction=int(
                            b.get("ef_construction", old.params.ef_construction)
                        ),
                        ef=int(b.get("ef", old.params.ef)),
                    )
                    new_ix = Index(params, capacity=max(n, 8),
                                   device=col.device)
                    new_ix.add(vecs, labels=labels, build="device")
                    if len(dead):
                        new_ix.delete(dead)
                    col.index = new_ix
            return self._reply(200, {"indexed": col.index.size})
        if sub == "/index" and method == "DELETE":
            col.index = None
            return self._reply(200, {"dropped": col.name})
        if sub == "/compact" and method == "POST":
            # reclaim tombstoned rows (and optionally re-parametrize) —
            # maintenance the reference only offers as a full SQL REINDEX
            if col.index is None:
                return self._err(400, "collection has no index")
            b = self._body()
            import dataclasses as _dc

            with col.lock:
                old = col.index
                params = _dc.replace(
                    old.params,
                    m=int(b.get("m", old.params.m)),
                    ef_construction=int(
                        b.get("ef_construction", old.params.ef_construction)
                    ),
                    ef=int(b.get("ef", old.params.ef)),
                )
                reclaimed = old.num_deleted
                old.compact(
                    params=params,
                    build="device" if b.get("external") else "host",
                )
                labs = np.fromiter(col.rows, np.uint64, count=len(col.rows))
                gone = labs[old.rows_for_labels(labs) < 0]
                for lab in gone.tolist():
                    col.rows.pop(int(lab), None)
            return self._reply(200, {"size": col.index.size,
                                     "reclaimed": int(reclaimed)})
        if sub == "/pq" and method == "POST":
            # quantize the collection: train a codebook on the stored vectors
            # and REBUILD the index as a PQ index so subsequent /search calls
            # run ADC over codes — the reference's pq route quantizes the
            # actual table (lantern_cli/src/http_server/pq.rs), not metadata
            if col.index is None or col.index.size == 0:
                return self._err(400, "collection empty")
            import dataclasses

            b = self._body()
            with col.lock:
                old = col.index
                n = old.size
                vecs = np.asarray(old._eng.vectors[:n], np.float32).copy()
                labels = np.asarray(old._eng.labels[:n]).copy()
                dead = labels[np.asarray(old._eng.deleted[:n]).astype(bool)]
                nsub = int(b.get("num_subvectors", max(1, col.dim // 4)))
                ncent = min(int(b.get("num_centroids", 256)), n)
                params = dataclasses.replace(
                    old.params, pq=True, num_subvectors=nsub, num_centroids=ncent
                )
                new_ix = Index(params, capacity=max(n, 8), device=col.device)
                new_ix.train_pq(vecs)
                new_ix.add(vecs, labels=labels)
                if len(dead):
                    new_ix.delete(dead)
                col.index = new_ix
            cb = new_ix._codebook
            return self._reply(200, {
                "codebook": list(cb.centroids.shape), "requantized": n,
            })
        return self._err(404, f"no route {method} {sub}")

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_DELETE(self):
        self._route("DELETE")


class HttpApi:
    """Threaded HTTP API server.

    ``data_dir``: optional persistence root. Collections load from it at
    start and save to it on stop() and on ``POST /collections/{n}/save`` —
    the durability the reference's collections get for free by living in
    Postgres tables (lantern_cli/src/http_server/collection.rs).

    ``device``: where every collection's index lives and searches (default
    cuda; raises here when there is no card).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 username: str | None = None, password: str | None = None,
                 data_dir: str | None = None, device=None):
        self.device = resolve_device(device)
        self.state = ApiState()
        self.data_dir = data_dir
        if data_dir:
            self._load_collections()
        handler = type("BoundHandler", (_Handler,), {
            "state": self.state,
            "auth": (
                base64.b64encode(f"{username}:{password}".encode()).decode()
                if username else None
            ),
            "log_obj": Logger("http-api"),
            "api": self,
        })
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self.host = host
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(5)
        if self.data_dir:
            self.save_collections()

    # ---- persistence ----
    def save_collections(self):
        """Persist every collection: index snapshot + meta/payload JSON."""
        import json
        import os

        os.makedirs(self.data_dir, exist_ok=True)
        with self.state.lock:
            cols = list(self.state.collections.values())
        names = []
        for col in cols:
            with col.lock:
                meta = {
                    "name": col.name, "dim": col.dim,
                    "metric": int(col.metric), "next_id": col.next_id,
                    "rows": {str(k): v for k, v in col.rows.items()},
                    "has_index": col.index is not None,
                }
                if col.index is not None:
                    col.index.save(
                        os.path.join(self.data_dir, f"{col.name}.ldb"))
                tmp = os.path.join(self.data_dir, f"{col.name}.json.tmp")
                with open(tmp, "w") as f:
                    json.dump(meta, f)
                os.replace(tmp, os.path.join(self.data_dir,
                                             f"{col.name}.json"))
            names.append(col.name)
        # drop metadata of collections deleted since the last save
        for fn in os.listdir(self.data_dir):
            if fn.endswith(".json") and fn[:-5] not in names:
                os.unlink(os.path.join(self.data_dir, fn))
                ldb = os.path.join(self.data_dir, fn[:-5] + ".ldb")
                if os.path.exists(ldb):
                    os.unlink(ldb)
        return names

    def _load_collections(self):
        import json
        import os

        if not os.path.isdir(self.data_dir):
            return
        from lantern_tpu_torch.index import Index

        for fn in sorted(os.listdir(self.data_dir)):
            if not fn.endswith(".json"):
                continue
            with open(os.path.join(self.data_dir, fn)) as f:
                meta = json.load(f)
            col = Collection(meta["name"], meta["dim"], Metric(meta["metric"]),
                             device=self.device)
            col.next_id = meta["next_id"]
            col.rows = {int(k): v for k, v in meta["rows"].items()}
            if meta.get("has_index"):
                col.index = Index.load(
                    os.path.join(self.data_dir, f"{meta['name']}.ldb"),
                    device=self.device)
            self.state.collections[meta["name"]] = col
