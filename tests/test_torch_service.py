"""Parity: the port's external indexing service (service/protocol.py,
client.py, index_server.py, bgworkers.py) against lantern_tpu's, and every
case of tests/test_service.py through the port on the CPU.

The wire is the reference's, byte for byte: frames packed by either package
are equal, a port client builds through a reference server and a reference
client through a port server. With one insert thread (``nthreads=1``) the
host engine's graph does not depend on thread timing, and the device
builder equals the reference's on the CPU, so every cross-package round
trip returns the same snapshot bytes as a same-package one, in host and in
device mode (tolerance: none, bytes equal). Loaded indexes are held to
exact self-matches.
"""

import asyncio
import json
import struct
import tempfile
import threading
import urllib.request

import numpy as np
import pytest
import torch

import lantern_tpu_torch
from lantern_tpu_torch.config import HnswParams, Metric, QuantKind
from lantern_tpu_torch.service import protocol as proto
from lantern_tpu_torch.service.client import (
    ExternalIndexClient,
    build_via_server,
)
from lantern_tpu_torch.service.index_server import (
    IndexServer,
    RouterServer,
    ServerStatus,
)
from lantern_tpu_torch.utils.failpoints import (
    FailurePointError,
    failure_point_disable_all,
    failure_point_enable,
)
from lantern_tpu_torch.utils.logger import Logger

CPU = "cpu"


def jax_ref():
    """The JAX package's service modules, imported by the CPU parity tests
    only: the card's machine has no jax."""
    import lantern_tpu.service.client as client
    import lantern_tpu.service.index_server as index_server
    import lantern_tpu.service.protocol as protocol
    from lantern_tpu import config

    return config, protocol, client, index_server


class _ServerThread:
    """Runs servers on an asyncio loop in a daemon thread."""

    def __init__(self, *servers):
        self.servers = servers
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.started = threading.Event()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        for s in self.servers:
            self.loop.run_until_complete(s.start())
        self.started.set()
        self.loop.run_forever()

    def __enter__(self):
        self.thread.start()
        assert self.started.wait(10)
        return self

    def __exit__(self, *exc):
        for s in self.servers:
            asyncio.run_coroutine_threadsafe(s.stop(), self.loop).result(5)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failure_point_disable_all()
    yield
    failure_point_disable_all()


def server(**kw):
    return IndexServer(port=0, status_port=None, device=CPU, **kw)


def load_bytes(data: bytes, device=CPU):
    with tempfile.NamedTemporaryFile(suffix=".ldb") as tf:
        tf.write(data)
        tf.flush()
        return lantern_tpu_torch.Index.load(tf.name, device=device)


# ---- frames ----

WIRE_CONFIGS = {
    "f32": dict(dim=16, m=8, ef_construction=48),
    "cos": dict(dim=16, m=12, ef_construction=32, ef=40, metric="COS"),
    "b1": dict(dim=64, m=8, ef_construction=32, metric="HAMMING", quant="B1"),
    "i8": dict(dim=16, m=4, ef_construction=16, quant="I8"),
    "f16": dict(dim=16, m=4, ef_construction=16, quant="F16"),
    "pq": dict(dim=32, m=8, ef_construction=32, pq=True, num_centroids=16,
               num_subvectors=4),
}


def _params(mod, cfg):
    cfg = dict(cfg)
    if "metric" in cfg:
        cfg["metric"] = mod.Metric[cfg["metric"]]
    if "quant" in cfg:
        cfg["quant"] = mod.QuantKind[cfg["quant"]]
    return mod.HnswParams(**cfg)


@pytest.mark.parametrize("name", sorted(WIRE_CONFIGS))
def test_protocol_frames_byte_equal(name):
    rconfig, rproto, _, _ = jax_ref()
    from lantern_tpu_torch import config

    p = _params(config, WIRE_CONFIGS[name])
    rp = _params(rconfig, WIRE_CONFIGS[name])
    init = proto.InitParams.from_hnsw_params(p, 1234)
    rinit = rproto.InitParams.from_hnsw_params(rp, 1234)
    assert init.pack() == rinit.pack()
    assert init.tuple_payload_bytes == rinit.tuple_payload_bytes
    assert proto.InitParams.unpack(rinit.pack()) == init
    back, rback = init.to_hnsw_params(), rinit.to_hnsw_params()
    for f in ("dim", "m", "ef_construction", "ef", "metric", "quant", "pq",
              "num_centroids", "num_subvectors"):
        assert int(getattr(back, f)) == int(getattr(rback, f)), f
    payload = np.arange(init.tuple_payload_bytes, dtype=np.uint8).tobytes()
    for fn, args in (("pack_handshake", (proto.SERVER_TYPE_ROUTER,)),
                     ("pack_tuple", (2**40 + 7, payload)),
                     ("pack_end", ()),
                     ("pack_error", ("no room: ünïcode",)),
                     ("pack_router_redirect", ("10.0.0.1", 8998, True))):
        assert getattr(proto, fn)(*args) == getattr(rproto, fn)(*args), fn
    for c in ("PROTOCOL_VERSION", "INIT_MSG", "END_MSG", "ERR_MSG",
              "GET_SERVER_MSG", "SERVER_TYPE_INDEXING", "SERVER_TYPE_ROUTER"):
        assert getattr(proto, c) == getattr(rproto, c), c
    with pytest.raises(proto.ProtocolError):
        proto.InitParams.unpack(struct.pack("<I11I", proto.END_MSG, *[0] * 11))


# ---- the two packages on one wire ----

def _clustered(rng, n, dim):
    c = rng.standard_normal((16, dim)).astype(np.float32)
    return (c[rng.integers(0, 16, n)]
            + 0.3 * rng.standard_normal((n, dim))).astype(np.float32)


@pytest.mark.parametrize("build", ["host", "device"])
def test_cross_package_round_trips_return_equal_snapshots(rng, build):
    """Every (client, server) pair of the two packages returns the same
    snapshot bytes, in host and device mode (nthreads=1)."""
    rconfig, _, rclient, rserver = jax_ref()
    base = _clustered(rng, 300, 16)
    cfg = dict(dim=16, m=8, ef_construction=32)
    servers = {"port": IndexServer(port=0, status_port=None, nthreads=1,
                                   build=build, device=CPU),
               "ref": rserver.IndexServer(port=0, status_port=None,
                                          nthreads=1, build=build)}
    clients = {"port": (ExternalIndexClient, HnswParams(**cfg)),
               "ref": (rclient.ExternalIndexClient, rconfig.HnswParams(**cfg))}
    got = {}
    with _ServerThread(*servers.values()):
        for s_name, srv in servers.items():
            for c_name, (cls, p) in clients.items():
                client = cls("127.0.0.1", srv.port, reply_timeout=300)
                got[c_name, s_name] = client.build(base, p)
                assert client.last_timings["index_bytes"] == len(
                    got[c_name, s_name])
    assert got["port", "ref"] == got["ref", "ref"]
    assert got["ref", "port"] == got["port", "port"]
    assert got["port", "port"] == got["ref", "ref"]
    ix = load_bytes(got["port", "port"])
    assert ix.size == 300
    _, labels = ix.search(base[:8], k=1, ef=32)
    np.testing.assert_array_equal(labels[:, 0], np.arange(8))
    ix.validate().raise_if_failed()


def test_external_build_roundtrip_and_status(rng):
    base = rng.standard_normal((500, 16)).astype(np.float32)
    p = HnswParams(dim=16, m=8, ef_construction=48)
    srv = IndexServer(port=0, status_port=0, device=CPU)
    with _ServerThread(srv):
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.status_port}/status", timeout=5
        ) as r:
            assert json.loads(r.read())["status"] == ServerStatus.IDLE
        ix = build_via_server(base, p, "127.0.0.1", srv.port, device=CPU)
        assert ix.size == 500 and ix.device.type == "cpu"
        _, labels = ix.search(base[:4], k=3, ef=32)
        assert (labels[:, 0] == np.arange(4)).all()
        ix.validate().raise_if_failed()
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.status_port}/status", timeout=5
        ) as r:
            status = json.loads(r.read())
        assert status["status"] == ServerStatus.SUCCEEDED


def test_build_via_server_keeps_the_callers_client(rng):
    base = rng.standard_normal((200, 8)).astype(np.float32)
    p = HnswParams(dim=8, m=4, ef_construction=16)
    srv = server()
    with _ServerThread(srv):
        client = ExternalIndexClient("127.0.0.1", srv.port)
        ix = build_via_server(base, p, "127.0.0.1", srv.port, device=CPU,
                              client=client)
    assert ix.size == 200
    t = client.last_timings
    assert set(t) == {"stream_s", "ingest_tuples_per_s", "build_wait_s",
                      "index_recv_s", "index_bytes"}
    assert t["index_bytes"] > 200 * 8 * 4


@pytest.mark.parametrize("build", ["host", "device"])
def test_a_loaded_reply_saves_to_the_reply_bytes(rng, build):
    """``Index.save`` of the index build_via_server loaded writes the
    server's reply byte for byte (the smoke run keeps the reply so)."""
    base = _clustered(rng, 300, 16)
    p = HnswParams(dim=16, m=8, ef_construction=32)
    labels = np.arange(300, dtype=np.uint64)
    srv = server(build=build, nthreads=1)
    with _ServerThread(srv):
        data = ExternalIndexClient("127.0.0.1", srv.port).build(
            base, p, labels=labels)
        ix = build_via_server(base, p, "127.0.0.1", srv.port, labels=labels,
                              device=CPU)
    with tempfile.TemporaryDirectory() as d:
        ix.save(d + "/reply.ldb")
        with open(d + "/reply.ldb", "rb") as f:
            assert f.read() == data


def test_router_redirect(rng):
    base = rng.standard_normal((100, 8)).astype(np.float32)
    p = HnswParams(dim=8, m=4, ef_construction=16)
    srv = server()
    with _ServerThread(srv):
        router = RouterServer("127.0.0.1", srv.port, port=0)
        with _ServerThread(router):
            ix = build_via_server(base, p, "127.0.0.1", router.port,
                                  device=CPU)
            assert ix.size == 100


def test_capacity_doubling(rng):
    """Streaming 2x the declared estimated_capacity succeeds: the server
    doubles the engine (server.rs:243-247)."""
    base = rng.standard_normal((200, 8)).astype(np.float32)
    p = HnswParams(dim=8, m=4, ef_construction=16)
    logs = []
    log = Logger("test")
    log.hook = lambda level, msg: logs.append(msg)
    srv = IndexServer(port=0, status_port=None, add_batch=32, logger=log,
                      device=CPU)
    with _ServerThread(srv):
        client = ExternalIndexClient("127.0.0.1", srv.port)
        client.connect()
        init = proto.InitParams.from_hnsw_params(p, 100)  # declare only half
        sock = client._sock
        sock.sendall(init.pack())
        for i in range(200):
            sock.sendall(proto.pack_tuple(i, base[i].tobytes()))
        sock.sendall(proto.pack_end())
        head = client._check_error_frame(client._recv_exact(sock, 8), sock)
        (count,) = struct.unpack("<Q", head)
        assert count == 200
        (size,) = struct.unpack("<Q", client._recv_exact(sock, 8))
        data = client._recv_exact(sock, size)
        client.close()
    assert "capacity doubled to 200" in logs
    ix = load_bytes(data)
    assert ix.size == 200
    ix.validate().raise_if_failed()


def test_server_error_frame(rng):
    """A server-side failure mid-stream reaches the client with the
    server's own message."""
    base = rng.standard_normal((50, 8)).astype(np.float32)
    p = HnswParams(dim=8, m=4, ef_construction=16)
    srv = server()
    with _ServerThread(srv):
        failure_point_enable("_handle_inner", "on_tuple",
                             dont_trigger_first_nr=49)
        try:
            with pytest.raises((RuntimeError, ConnectionError)) as exc:
                ExternalIndexClient("127.0.0.1", srv.port).build(base, p)
        finally:
            failure_point_disable_all()
        if isinstance(exc.value, RuntimeError):
            assert "failure point" in str(exc.value)
        assert srv.status.status == ServerStatus.FAILED


def test_error_frame_after_the_stream_reaches_the_client(rng):
    """A failure after END (here before the reply) arrives as an ERR frame
    that the client parses intact."""
    base = rng.standard_normal((30, 8)).astype(np.float32)
    p = HnswParams(dim=8, m=4, ef_construction=16)
    srv = server()
    with _ServerThread(srv):
        failure_point_enable("_handle_inner", "before_reply")
        with pytest.raises(RuntimeError, match="external index server error"):
            ExternalIndexClient("127.0.0.1", srv.port).build(base, p)


def _self_signed_ssl_contexts(tmp_path):
    import ssl
    import subprocess

    cert = str(tmp_path / "srv.crt")
    key = str(tmp_path / "srv.key")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "1", "-subj",
         "/CN=127.0.0.1"],
        check=True, capture_output=True,
    )
    server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server_ctx.load_cert_chain(cert, key)
    client_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    client_ctx.check_hostname = False
    client_ctx.verify_mode = ssl.CERT_NONE
    return server_ctx, client_ctx


def test_tls_roundtrip_across_packages(rng, tmp_path):
    """TLS with a self-signed certificate: the reference's client builds
    through the port's server, and gets the port client's bytes."""
    _, _, rclient, _ = jax_ref()
    from lantern_tpu import config as rconfig

    server_ctx, client_ctx = _self_signed_ssl_contexts(tmp_path)
    base = rng.standard_normal((120, 8)).astype(np.float32)
    cfg = dict(dim=8, m=4, ef_construction=16)
    srv = IndexServer(port=0, status_port=None, ssl_context=server_ctx,
                      nthreads=1, device=CPU)
    with _ServerThread(srv):
        data = ExternalIndexClient("127.0.0.1", srv.port,
                                   ssl_context=client_ctx).build(
            base, HnswParams(**cfg))
        rdata = rclient.ExternalIndexClient(
            "127.0.0.1", srv.port, ssl_context=client_ctx).build(
            base, rconfig.HnswParams(**cfg))
    assert data == rdata
    ix = load_bytes(data)
    assert ix.size == 120
    _, labels = ix.search(base[:2], k=1, ef=16)
    assert (labels[:, 0] == [0, 1]).all()


def test_failure_point_in_client(rng):
    base = rng.standard_normal((20, 8)).astype(np.float32)
    p = HnswParams(dim=8, m=4, ef_construction=16)
    srv = server()
    with _ServerThread(srv):
        failure_point_enable("build", "on_send_tuple", dont_trigger_first_nr=5)
        with pytest.raises(FailurePointError):
            build_via_server(base, p, "127.0.0.1", srv.port, device=CPU)
        failure_point_disable_all()
        # the serial accept loop serves the next build
        ix = build_via_server(base, p, "127.0.0.1", srv.port, device=CPU)
        assert ix.size == 20


def test_client_rejects_magic_colliding_labels():
    srv = server()
    with _ServerThread(srv):
        vecs = np.random.default_rng(0).standard_normal((4, 8)).astype(
            np.float32)
        labels = np.array([1, 2, proto.END_MSG, 4], np.uint64)
        c = ExternalIndexClient("127.0.0.1", srv.port)
        with pytest.raises(ValueError, match="protocol magics"):
            c.build(vecs, HnswParams(dim=8, m=4, ef_construction=16),
                    labels=labels)


@pytest.mark.parametrize("build", ["host", "device"])
def test_pq_stream_equals_the_reference_server(rng, build):
    """A PQ stream (codebook frame, then tuples) through either package's
    server: the server encodes and decodes the rows with the streamed
    codebook and builds over the decoded rows. The host engine gives the
    same snapshot bytes. The device builder's pair distances among decoded
    rows (sums of a few centroids) tie, and XLA's sums and torch's break
    the ties differently, so there the rows, labels, levels and codebook
    are equal."""
    rconfig, _, rclient, rserver = jax_ref()
    from lantern_tpu_torch.quant.pq import train_codebook

    base = _clustered(rng, 300, 16)
    cfg = dict(dim=16, m=8, ef_construction=32, pq=True, num_centroids=16,
               num_subvectors=4)
    cb = train_codebook(base, num_subvectors=4, num_centroids=16, iters=10,
                        device=CPU)
    port_srv = IndexServer(port=0, status_port=None, nthreads=1, build=build,
                           device=CPU)
    ref_srv = rserver.IndexServer(port=0, status_port=None, nthreads=1,
                                  build=build)
    with _ServerThread(port_srv, ref_srv):
        data = ExternalIndexClient("127.0.0.1", port_srv.port,
                                   reply_timeout=300).build(
            base, HnswParams(**cfg), codebook=cb.centroids)
        rdata = rclient.ExternalIndexClient("127.0.0.1", ref_srv.port,
                                            reply_timeout=300).build(
            base, rconfig.HnswParams(**cfg), codebook=cb.centroids)
        ix = build_via_server(base, HnswParams(**cfg), "127.0.0.1",
                              port_srv.port, codebook=cb, device=CPU)
    if build == "host":
        assert data == rdata
    else:
        got, want = load_bytes(data)._eng, load_bytes(rdata)._eng
        for name in ("vectors", "labels", "levels"):
            np.testing.assert_array_equal(np.asarray(getattr(got, name))[:300],
                                          np.asarray(getattr(want, name))[:300])
    assert ix.size == 300 and ix._codebook is not None
    np.testing.assert_array_equal(ix._codebook.centroids, cb.centroids)
    _, labels = ix.search(base[:4], k=3, ef=32)
    assert labels.shape == (4, 3)


def test_b1_stream_in_device_mode_goes_to_the_host_engine(rng):
    """F12, the reference's routing kept: a server in device mode builds a
    b1/hamming stream on the host engine (and logs it), although
    build_on_device serves hamming. Float rows sent by the client are
    packed by the port's int32 binarize into the reference's uint32 bytes,
    so both packages' clients and servers agree on the snapshot."""
    rconfig, _, rclient, rserver = jax_ref()
    rows = rng.standard_normal((200, 64)).astype(np.float32)
    cfg = dict(dim=64, m=8, ef_construction=32)
    logs = []
    log = Logger("test")
    log.hook = lambda level, msg: logs.append(msg)
    port_srv = IndexServer(port=0, status_port=None, nthreads=1,
                           build="device", logger=log, device=CPU)
    ref_srv = rserver.IndexServer(port=0, status_port=None, nthreads=1,
                                  build="device")
    host_srv = IndexServer(port=0, status_port=None, nthreads=1, device=CPU)
    p = HnswParams(metric=Metric.HAMMING, quant=QuantKind.B1, **cfg)
    rp = rconfig.HnswParams(metric=rconfig.Metric.HAMMING,
                            quant=rconfig.QuantKind.B1, **cfg)
    with _ServerThread(port_srv, ref_srv, host_srv):
        got = ExternalIndexClient("127.0.0.1", port_srv.port).build(rows, p)
        ref = rclient.ExternalIndexClient("127.0.0.1", ref_srv.port).build(
            rows, rp)
        host = ExternalIndexClient("127.0.0.1", host_srv.port).build(rows, p)
        held = load_bytes(got)  # the engine's arrays live while it does
        words = np.array(held._eng.vectors[:200])
        packed = ExternalIndexClient("127.0.0.1", port_srv.port).build(
            words, p)
    assert "device build unsupported for this stream; host engine" in logs
    assert got == ref == host == packed
    ix = load_bytes(got)
    d, labels = ix.search(rows[:4], k=1, ef=16)
    assert (d[:, 0] == 0).all() and (labels[:, 0] == np.arange(4)).all()


def test_hamming_build_via_server(rng):
    packed = rng.integers(0, 2**32, size=(200, 2), dtype=np.uint32)
    p = HnswParams(dim=64, m=8, ef_construction=32, metric=Metric.HAMMING,
                   quant=QuantKind.B1)
    srv = server()
    with _ServerThread(srv):
        ix = build_via_server(packed, p, "127.0.0.1", srv.port, device=CPU)
        assert ix.size == 200
        d, _ = ix.search(packed[:2], k=1, ef=16)
        assert (d[:, 0] == 0).all()


@pytest.mark.parametrize("quant", ["F16", "I8"])
def test_scalar_quant_wire_is_f32(rng, quant):
    """f16 / i8 indexes stream f32 rows; the storage kind rides the init
    frame's quantization field. The built index equals the reference
    server's."""
    rconfig, _, rclient, rserver = jax_ref()
    vecs = rng.standard_normal((200, 16)).astype(np.float32)
    cfg = dict(dim=16, m=8, ef_construction=32)
    p = HnswParams(quant=QuantKind[quant], **cfg)
    init = proto.InitParams.from_hnsw_params(p, 100)
    assert init.element_bits == 32
    assert init.tuple_payload_bytes == 16 * 4
    assert init.quantization == int(QuantKind[quant])
    srv = IndexServer(port=0, status_port=None, nthreads=1, device=CPU)
    ref_srv = rserver.IndexServer(port=0, status_port=None, nthreads=1)
    with _ServerThread(srv, ref_srv):
        data = ExternalIndexClient("127.0.0.1", srv.port).build(vecs, p)
        rdata = rclient.ExternalIndexClient("127.0.0.1", ref_srv.port).build(
            vecs, rconfig.HnswParams(quant=rconfig.QuantKind[quant], **cfg))
        ix = build_via_server(vecs, p, "127.0.0.1", srv.port, device=CPU)
    assert data == rdata
    assert ix.size == 200
    _, labels = ix.search(vecs[5], k=3, ef=32)
    assert labels[0, 0] == 5


def test_in_process_bgworkers(rng, tmp_path):
    """ServiceHost: the daemon and the indexing server inside this
    process, a dead server restarted by the supervisor."""
    import time

    from lantern_tpu_torch.service.bgworkers import ServiceConfig, ServiceHost
    from lantern_tpu_torch.service.daemon import JobQueue

    cfg = ServiceConfig(
        enable_daemon=True, enable_indexing_server=True,
        indexing_port=0, status_port=0, jobs_dir=str(tmp_path / "jobs"),
        restart_s=0.1,
    )
    base = rng.standard_normal((120, 8)).astype(np.float32)
    p = HnswParams(dim=8, m=4, ef_construction=16)
    with ServiceHost(cfg, device=CPU) as host:
        assert host._daemon.device.type == "cpu"
        assert host._server["srv"].device.type == "cpu"
        ix = build_via_server(base, p, "127.0.0.1", host.indexing_port,
                              device=CPU)
        assert ix.size == 120
        q = JobQueue(cfg.jobs_dir)
        inp = tmp_path / "texts.txt"
        inp.write_text("a doc\nanother doc\n")
        jid = q.submit("embedding", {"input": str(inp),
                                     "output": str(tmp_path / "e.npy"),
                                     "runtime": "hash",
                                     "runtime_args": {"dim": 8}})
        deadline = time.time() + 15
        while time.time() < deadline and q.get(jid)["status"] not in (
            "completed", "failed",
        ):
            time.sleep(0.05)
        assert q.get(jid)["status"] == "completed", q.get(jid)
        assert host.restarts == 0
        loop = host._server["loop"]
        loop.call_soon_threadsafe(loop.stop)
        deadline = time.time() + 15
        while time.time() < deadline and host.restarts == 0:
            time.sleep(0.05)
        assert host.restarts >= 1
        ix2 = build_via_server(base[:50], p, "127.0.0.1", host.indexing_port,
                               device=CPU)
        assert ix2.size == 50


def test_services_without_a_device_raise_without_a_card(monkeypatch):
    """Constructed with no device, every service asks for cuda and raises
    where there is none."""
    from lantern_tpu_torch.service.bgworkers import ServiceConfig, ServiceHost
    from lantern_tpu_torch.service.daemon import Daemon, JobQueue
    from lantern_tpu_torch.service.http_api import HttpApi

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: IndexServer(port=0, status_port=None),
                 lambda: HttpApi(port=0),
                 lambda: Daemon(JobQueue(tempfile.mkdtemp())),
                 lambda: ServiceHost(ServiceConfig()),
                 lambda: build_via_server(np.zeros((1, 8), np.float32),
                                          HnswParams(dim=8), "127.0.0.1", 1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_mode_round_trip_on_card(cuda):
    """A server in device mode bulk-builds the stream on the card (flat
    pools, cuBLAS and torch.topk) and the client loads the reply onto it."""
    rng = np.random.default_rng(77)
    base = _clustered(rng, 3000, 32)
    p = HnswParams(dim=32, m=8, ef_construction=48)
    srv = IndexServer(port=0, status_port=0, build="device", device=cuda)
    with _ServerThread(srv):
        client = ExternalIndexClient("127.0.0.1", srv.port, reply_timeout=300)
        ix = build_via_server(base, p, "127.0.0.1", srv.port, device=cuda,
                              client=client)
        assert srv.status.status == ServerStatus.SUCCEEDED
    assert ix.size == 3000 and ix.device.type == "cuda"
    ix.validate().raise_if_failed()
    _, labels = ix.search(base[:64], k=1, mode="graph")
    assert (labels[:, 0] == np.arange(64)).mean() >= 0.95
    assert client.last_timings["index_bytes"] > 3000 * 32 * 4
