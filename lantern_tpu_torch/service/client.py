"""External-index client — parity with the C socket client.

Reference: lantern_hnsw/src/hnsw/external_index_socket.c — connect with
timeout, handshake (version + server type), router redirect support
(:411-447), INIT frame (:455-472), optional PQ codebook stream (:304-320),
tuple stream (:517-536), END, then receive u64 count + u64 size + index
file (:488-515); ERR frames surface as exceptions (:186-254).
"""

from __future__ import annotations

import socket
import struct

import numpy as np

from lantern_tpu_torch import resolve_device
from lantern_tpu_torch.config import HnswParams
from lantern_tpu_torch.service import protocol as proto
from lantern_tpu_torch.utils.failpoints import failure_point

DEFAULT_TIMEOUT = 10.0  # the reference's 10 s read/write timeouts


class ExternalIndexClient:
    def __init__(self, host: str, port: int, timeout: float = DEFAULT_TIMEOUT,
                 ssl_context=None, reply_timeout: float | None = None):
        """``reply_timeout``: opt-in longer wait for the final build reply,
        for servers that bulk-build on the device AFTER the stream ends
        (IndexServer build='device': minutes at a million rows) — analogous
        to the reference's 10-minute router-provisioning wait
        (external_index_socket.c:411-447).
        Default None keeps the reference's 10 s timeout on every read, so
        a dead host-mode server still fails fast."""
        self.host = host
        self.port = port
        self.timeout = timeout
        self.reply_timeout = reply_timeout
        self.ssl_context = ssl_context
        self._sock: socket.socket | None = None

    # ---- connection ----
    def connect(self):
        sock = socket.create_connection((self.host, self.port), self.timeout)
        sock.settimeout(self.timeout)
        if self.ssl_context is not None:
            sock = self.ssl_context.wrap_socket(sock, server_hostname=self.host)
        failure_point("connect", "after_connect")
        _, stype = proto.unpack_handshake(self._recv_exact(sock, 8))
        if stype == proto.SERVER_TYPE_ROUTER:
            # router redirect: ask for a real indexing server and reconnect
            sock.sendall(struct.pack("<I", proto.GET_SERVER_MSG))
            is_secure, alen = struct.unpack("<II", self._recv_exact(sock, 8))
            addr = self._recv_exact(sock, alen).decode()
            (port,) = struct.unpack("<I", self._recv_exact(sock, 4))
            sock.close()
            self.host, self.port = addr, port
            if is_secure and self.ssl_context is None:
                # the redirect target is TLS-only (the reference's
                # is_secure flag drives the SSL vtable choice for the
                # redirected connection, external_index_socket.c:411-447)
                import ssl

                self.ssl_context = ssl.create_default_context()
            return self.connect()
        if stype != proto.SERVER_TYPE_INDEXING:
            raise proto.ProtocolError(f"unexpected server type {stype}")
        self._sock = sock

    def close(self):
        if self._sock:
            self._sock.close()
            self._sock = None

    def _recv_exact(self, sock, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            chunk = sock.recv(n - got)
            if not chunk:
                raise ConnectionError("connection closed by server")
            # an ERR frame can arrive at any point (external_index_socket.c:186)
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def _check_error_frame(self, head: bytes, sock) -> bytes:
        if len(head) >= 4 and struct.unpack("<I", head[:4])[0] == proto.ERR_MSG:
            # the length may already be in `head` (callers hand us 8 bytes on
            # the final-reply path) — re-reading it from the socket would
            # consume message bytes as a garbage length
            if len(head) >= 8:
                (ln,) = struct.unpack("<I", head[4:8])
                extra = head[8:]
            else:
                (ln,) = struct.unpack("<I", self._recv_exact(sock, 4))
                extra = b""
            msg = (extra + self._recv_exact(sock, ln - len(extra))).decode()
            raise RuntimeError(f"external index server error: {msg}")
        return head

    # ---- build session ----
    def build(
        self,
        vectors: np.ndarray,
        params: HnswParams,
        labels: np.ndarray | None = None,
        codebook: np.ndarray | None = None,  # [S, K, dsub] when params.pq
    ) -> bytes:
        """Stream vectors, receive the serialized index snapshot bytes."""
        if labels is not None:
            # wire-format ambiguity (inherited from the reference, server.rs
            # reads a 4-byte header per frame): a label whose LOW 32 BITS
            # equal a frame magic is indistinguishable from that frame on
            # the server side — END would silently truncate the build.
            # Fail fast BEFORE opening the session.
            low32 = np.asarray(labels, np.uint64) & np.uint64(0xFFFFFFFF)
            bad = np.isin(low32, np.array(
                [proto.END_MSG, proto.ERR_MSG, proto.INIT_MSG], np.uint64))
            if bad.any():
                raise ValueError(
                    f"{int(bad.sum())} label(s) collide with protocol "
                    "magics in their low 32 bits (e.g. label & 0xffffffff "
                    "== 0x31333337 reads as END on the wire); remap them"
                )
        self.connect()
        sock = self._sock
        init = proto.InitParams.from_hnsw_params(params, len(vectors))
        sock.sendall(init.pack())
        failure_point("build", "after_init")

        if params.pq:
            if codebook is None:
                raise ValueError("pq build requires a codebook")
            # [S, K, dsub] -> wire rows [K, dim]
            wire = codebook.transpose(1, 0, 2).reshape(codebook.shape[1], -1)
            for row in wire.astype(np.float32):
                sock.sendall(row.tobytes())
            sock.sendall(proto.pack_end())

        if labels is None:
            labels = np.arange(len(vectors), dtype=np.uint64)
        if init.element_bits == 1:
            vectors = np.asarray(vectors)
            if vectors.dtype != np.uint32:
                # float input: bit-pack (sign binarization) like the Index
                # facade — a value cast to uint32 would silently send
                # truncated floats with the wrong payload size. The port's
                # words are int32 tensors holding the uint32 bits: the
                # wire gets the same bytes through a uint32 view
                import torch

                from lantern_tpu_torch.quant.scalar import binarize

                vectors = binarize(torch.from_numpy(np.ascontiguousarray(
                    vectors, np.float32))).numpy().view(np.uint32)
            vecs = np.ascontiguousarray(vectors, np.uint32)
        else:
            vecs = np.ascontiguousarray(vectors, np.float32)
        if vecs.shape[1] * 4 != init.tuple_payload_bytes:
            raise ValueError(
                f"vector rows are {vecs.shape[1] * 4} B but the declared "
                f"init params frame {init.tuple_payload_bytes} B per tuple"
            )
        import time

        t0 = time.perf_counter()
        try:
            # frames are batched into ~256 KiB writes: per-tuple sendall()
            # costs one syscall each (1M syscalls for a 1M-row build);
            # chunking cuts that ~500x. Wire bytes are identical.
            buf = bytearray()
            for i in range(len(vecs)):
                buf += proto.pack_tuple(int(labels[i]), vecs[i].tobytes())
                failure_point("build", "on_send_tuple")
                if len(buf) >= (256 << 10):
                    sock.sendall(buf)
                    buf.clear()
            buf += proto.pack_end()
            sock.sendall(buf)
        except (BrokenPipeError, ConnectionResetError) as e:
            # the server aborted mid-stream; its ERR frame may still be
            # buffered — surface the real message if we can read it
            # (parity with the client-side error checks on send,
            # external_index_socket.c:186-254)
            try:
                head = self._recv_exact(sock, 4)
                self._check_error_frame(head, sock)
            except RuntimeError:
                raise
            except Exception:  # noqa: BLE001
                pass
            raise ConnectionError(f"server closed connection mid-stream: {e}")

        t_stream = time.perf_counter()
        if self.reply_timeout is not None:
            sock.settimeout(self.reply_timeout)  # device bulk build runs now
        head = self._recv_exact(sock, 8)
        self._check_error_frame(head, sock)
        (count,) = struct.unpack("<Q", head)
        t_built = time.perf_counter()  # count arrives when indexing is done
        (size,) = struct.unpack("<Q", self._recv_exact(sock, 8))
        data = self._recv_exact(sock, size)
        t_done = time.perf_counter()
        self.close()
        # phase timings, observable like the reference server's
        # indexing/save/stream logs (server.rs:383-432) but client-side
        self.last_timings = {
            "stream_s": round(t_stream - t0, 3),
            "ingest_tuples_per_s": round(len(vecs) / max(t_stream - t0, 1e-9), 1),
            "build_wait_s": round(t_built - t_stream, 3),
            "index_recv_s": round(t_done - t_built, 3),
            "index_bytes": size,
        }
        if count != len(vecs):
            raise proto.ProtocolError(f"server indexed {count} != sent {len(vecs)}")
        return data


def build_via_server(
    vectors: np.ndarray,
    params: HnswParams,
    host: str,
    port: int,
    labels: np.ndarray | None = None,
    codebook=None,
    timeout: float = DEFAULT_TIMEOUT,
    reply_timeout: float | None = 900.0,
    device=None,
    client: ExternalIndexClient | None = None,
):
    """Build remotely and return a loaded Index (CREATE INDEX external=true)
    on ``device`` (default cuda).

    ``reply_timeout`` defaults generous here because this convenience entry
    is what drives device-mode servers in tests/CLI; pass None for the
    strict reference 10 s behavior. ``client``: a client of your own
    (its ``last_timings`` then stay readable); made here when None.
    """
    import os
    import tempfile

    from lantern_tpu_torch.index import Index

    dev = resolve_device(device)  # before the stream: no card, no build
    cb = codebook.centroids if hasattr(codebook, "centroids") else codebook
    if client is None:
        client = ExternalIndexClient(host, port, timeout=timeout,
                                     reply_timeout=reply_timeout)
    data = client.build(vectors, params, labels=labels, codebook=cb)
    with tempfile.NamedTemporaryFile(suffix=".ldb", delete=False) as tf:
        tf.write(data)
        path = tf.name
    try:
        return Index.load(path, extra_capacity=max(256, len(vectors) // 4),
                          device=dev)
    finally:
        os.unlink(path)
