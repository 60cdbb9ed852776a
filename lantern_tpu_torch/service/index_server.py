"""External indexing server — asyncio analog of lantern_cli's Rust server.

Parity with lantern_cli/src/external_index/server.rs:
- TCP (+optional TLS) server speaking the §5.8 wire protocol; handshake
  sends protocol version + server type (server.rs:182-183)
- one indexing connection at a time (serial accept loop, server.rs:539-582)
- tuples stream into a bounded queue drained by a builder running the
  native multicore engine (the reference's N add-threads, server.rs:311-375),
  or, with ``build="device"``, are buffered and bulk-built on the card at END
- on END: sends u64 count, u64 snapshot size, snapshot bytes
  (server.rs:377-434)
- error frames on any failure (server.rs:562-573)
- status endpoint on a side port: {"status": Idle|InProgress|Failed|
  Succeeded, "status_updated_at": ts} (server.rs:586-628)
- router mode (server type 0x2): replies to GET_SERVER with a redirect
  target (external_index_socket.c:411-447 client flow)
"""

from __future__ import annotations

import asyncio
import io
import json
import struct
import time

import numpy as np

from lantern_tpu_torch import resolve_device
from lantern_tpu_torch.service import protocol as proto
from lantern_tpu_torch.utils.failpoints import failure_point
from lantern_tpu_torch.utils.logger import Logger


class ServerStatus:
    IDLE = "Idle"
    IN_PROGRESS = "InProgress"
    FAILED = "Failed"
    SUCCEEDED = "Succeeded"

    def __init__(self):
        self.status = self.IDLE
        self.updated_at = time.time()

    def set(self, status: str):
        self.status = status
        self.updated_at = time.time()

    def as_json(self) -> bytes:
        return json.dumps(
            {"status": self.status, "status_updated_at": self.updated_at}
        ).encode()


class IndexServer:
    """Indexing server; `serve_forever` accepts one build at a time."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8998,
        status_port: int | None = 8999,
        ssl_context=None,
        logger: Logger | None = None,
        add_batch: int = 2000,  # the reference's mpsc bound (server.rs:311)
        nthreads: int = 0,
        build: str = "host",
        device=None,
    ):
        self.host = host
        self.port = port
        self.status_port = status_port
        self.ssl_context = ssl_context
        self.log = logger or Logger("indexing-server")
        self.add_batch = add_batch
        self.nthreads = nthreads
        # build="device": buffer the stream and bulk-build the graph on the
        # device at END — the role the reference's all-cores usearch build
        # plays on the indexing machine (server.rs:133-153). b1/hamming
        # streams go to the host engine, as in the reference, although
        # build_on_device serves hamming.
        self.build = build
        # the card the device build and PQ encoding run on (default cuda;
        # raises here when there is none)
        self.device = resolve_device(device)
        self.status = ServerStatus()
        self._server = None
        self._status_server = None
        self._busy = asyncio.Lock()  # one indexing connection at a time

    # ---- lifecycle ----
    async def start(self):
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, ssl=self.ssl_context
        )
        self.port = self._server.sockets[0].getsockname()[1]
        if self.status_port is not None:
            self._status_server = await asyncio.start_server(
                self._handle_status, self.host, self.status_port
            )
            self.status_port = self._status_server.sockets[0].getsockname()[1]
        self.log.info(f"indexing server listening on {self.host}:{self.port}")

    async def stop(self):
        for s in (self._server, self._status_server):
            if s:
                s.close()
                await s.wait_closed()

    # ---- status endpoint (minimal HTTP) ----
    async def _handle_status(self, reader, writer):
        try:
            await reader.readline()  # request line; drain rest lazily
            body = self.status.as_json()
            writer.write(
                b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                + f"Content-Length: {len(body)}\r\n\r\n".encode()
                + body
            )
            await writer.drain()
        finally:
            writer.close()

    # ---- indexing connection ----
    async def _handle(self, reader, writer):
        async with self._busy:
            try:
                await self._handle_inner(reader, writer)
            except Exception as e:  # noqa: BLE001 — all errors go on the wire
                self.status.set(ServerStatus.FAILED)
                self.log.error(f"indexing failed: {e}")
                try:
                    writer.write(proto.pack_error(str(e)))
                    await writer.drain()
                except Exception:  # noqa: BLE001
                    pass
            finally:
                writer.close()
                try:
                    await writer.wait_closed()
                except Exception:  # noqa: BLE001
                    pass

    async def _read_exact(self, reader, n: int) -> bytes:
        buf = await reader.readexactly(n)
        return buf

    async def _handle_inner(self, reader, writer):
        from lantern_tpu_torch.native import NativeHnsw
        from lantern_tpu_torch.storage.snapshot import save_snapshot

        writer.write(proto.pack_handshake(proto.SERVER_TYPE_INDEXING))
        await writer.drain()
        failure_point("_handle_inner", "after_handshake")

        init = proto.InitParams.unpack(
            await self._read_exact(reader, struct.calcsize("<I11I"))
        )
        params = init.to_hnsw_params()
        self.log.info(
            f"init: dim={init.dim} m={init.m} efc={init.ef_construction} "
            f"metric={init.metric_kind} quant={init.quantization} pq={init.pq} "
            f"capacity={init.estimated_capacity}"
        )
        self.status.set(ServerStatus.IN_PROGRESS)

        codebook = None
        if init.pq:
            # num_centroids rows of dim*4 bytes (row k = centroid k of every
            # subvector concatenated along dim — pqtable.c's flat [K][dim]
            # layout), then END (external_index_socket.c:304-320)
            rows = []
            row_bytes = init.dim * 4
            for _ in range(init.num_centroids):
                rows.append(
                    np.frombuffer(await self._read_exact(reader, row_bytes), np.float32)
                )
            end = await self._read_exact(reader, 4)
            if struct.unpack("<I", end)[0] != proto.END_MSG:
                raise proto.ProtocolError("missing END after codebook")
            codebook = np.stack(rows) if rows else None
        codebook = _reshape_codebook(codebook, init)

        from lantern_tpu_torch.config import Metric

        device_build = self.build == "device" and init.metric_kind in (
            int(Metric.L2SQ), int(Metric.COS),
        ) and init.element_bits != 1
        if self.build == "device" and not device_build:
            self.log.info("device build unsupported for this stream; host engine")
        capacity = max(init.estimated_capacity, 8)
        # device mode buffers the stream and builds at END — don't
        # preallocate a full-capacity host engine that would never be used
        eng = None if device_build else NativeHnsw(params, capacity=capacity, seed=0)
        pq_cb = None
        if codebook is not None:
            from lantern_tpu_torch.quant.pq import PQCodebook

            pq_cb = PQCodebook(centroids=codebook)

        payload = init.tuple_payload_bytes
        dtype = np.uint32 if init.element_bits == 1 else np.float32
        vec_buf: list[np.ndarray] = []
        lab_buf: list[int] = []
        count = 0
        loop = asyncio.get_running_loop()
        dev_vecs: list[np.ndarray] = []  # whole stream, device-build mode
        dev_labs: list[int] = []

        async def flush():
            nonlocal vec_buf, lab_buf
            if not vec_buf:
                return
            vecs = np.stack(vec_buf)
            labs = np.array(lab_buf, np.uint64)
            vec_buf, lab_buf = [], []
            if pq_cb is not None:
                # graph is built over the quantized representation, like
                # usearch building with a pq codebook (build.c:497-517)
                from lantern_tpu_torch.quant.pq import pq_decode, pq_encode

                vecs = pq_decode(pq_encode(vecs, pq_cb, device=self.device),
                                 pq_cb)
            # builder runs in a worker thread: the asyncio loop keeps
            # reading the socket while the engine inserts (the reference's
            # reader-thread / add-thread split)
            await loop.run_in_executor(
                None, lambda: eng.add(vecs, labels=labs, nthreads=self.nthreads)
            )

        while True:
            head = await self._read_exact(reader, 4)
            (magic,) = struct.unpack("<I", head)
            if magic == proto.END_MSG:
                break
            rest = await self._read_exact(reader, 4 + payload)
            (label,) = struct.unpack("<Q", head + rest[:4])
            vec = np.frombuffer(rest[4:], dtype)
            failure_point("_handle_inner", "on_tuple")
            if device_build:
                dev_vecs.append(vec)
                dev_labs.append(label)
                count += 1
                continue
            if count >= capacity:
                # the stream exceeded estimated_capacity: double, like the
                # reference server (server.rs:243-247 under RwLock write).
                # Flush first so no add runs concurrently with the grow.
                await flush()
                capacity *= 2
                await loop.run_in_executor(None, eng.grow, capacity)
                self.log.info(f"capacity doubled to {capacity}")
            vec_buf.append(vec)
            lab_buf.append(label)
            count += 1
            if len(vec_buf) >= self.add_batch:
                await flush()
        await flush()
        if device_build and dev_vecs:
            vecs = np.stack(dev_vecs)
            dev_vecs.clear()  # drop the chunk list before building (peak RAM)
            labs = np.array(dev_labs, np.uint64)
            if pq_cb is not None:
                from lantern_tpu_torch.quant.pq import pq_decode, pq_encode

                vecs = pq_decode(pq_encode(vecs, pq_cb, device=self.device),
                                 pq_cb)

            def _bulk_build():
                from lantern_tpu_torch.graph.build_device import build_on_device

                g = build_on_device(
                    np.asarray(vecs, np.float32), params, batch=1024, seed=0,
                    labels=labs, device=self.device,
                )
                e = NativeHnsw(params, capacity=max(len(vecs), 8), seed=0)
                e.import_graph(g, labels=labs)
                return e

            self.log.info(f"device bulk build of {count} tuples")
            eng = await loop.run_in_executor(None, _bulk_build)
        elif eng is None:  # device mode, empty stream
            eng = NativeHnsw(params, capacity=8, seed=0)

        self.log.info(f"indexed {count} tuples; serializing")
        failure_point("_handle_inner", "before_reply")
        import os
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".ldb", delete=False) as tf:
            path = tf.name
        try:
            save_snapshot(eng, path, pq_codebook=codebook)
            with open(path, "rb") as f:
                data = f.read()
        finally:
            os.unlink(path)
        writer.write(struct.pack("<Q", count))
        writer.write(struct.pack("<Q", len(data)))
        writer.write(data)
        await writer.drain()
        self.status.set(ServerStatus.SUCCEEDED)
        self.log.info(f"sent index ({len(data)} bytes)")


def _reshape_codebook(codebook, init: "proto.InitParams"):
    if codebook is None:
        return None
    # [K, dim] wire layout -> [S, K, dsub] device layout
    dsub = init.dim // init.num_subvectors
    return (
        codebook.reshape(init.num_centroids, init.num_subvectors, dsub)
        .transpose(1, 0, 2)
        .astype(np.float32)
        .copy()
    )


class RouterServer:
    """Router (server type 0x2): redirects clients to an indexing server.

    Parity with the router flow in external_index_socket.c:411-447.
    """

    def __init__(self, target_host: str, target_port: int,
                 host: str = "127.0.0.1", port: int = 0, is_secure: bool = False):
        self.target = (target_host, target_port, is_secure)
        self.host = host
        self.port = port
        self._server = None

    async def start(self):
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self):
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader, writer):
        try:
            writer.write(proto.pack_handshake(proto.SERVER_TYPE_ROUTER))
            await writer.drain()
            (msg,) = struct.unpack("<I", await reader.readexactly(4))
            if msg == proto.GET_SERVER_MSG:
                host, port, secure = self.target
                writer.write(proto.pack_router_redirect(host, port, secure))
                await writer.drain()
        finally:
            writer.close()
