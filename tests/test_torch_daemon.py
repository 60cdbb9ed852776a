"""Parity: the port's job daemon (service/daemon.py: JobQueue, Daemon,
TargetRegistry, MasterDaemon) and embedding runtimes (embeddings/) against
lantern_tpu's, and the daemon cases of tests/test_ecosystem.py through the
port on the CPU.

The same job specs run through both packages' daemons: embedding and
completion outputs are byte-equal (the hash runtime is numpy), an index
job's snapshot loads in either package, an autotune job completes with a
best variant. Embedding runtimes give byte-equal vectors; the REST
runtimes speak the same wire format to a mock server.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

import lantern_tpu_torch
from lantern_tpu_torch import embeddings
from lantern_tpu_torch.service import daemon as port_daemon
from lantern_tpu_torch.service.daemon import (
    Daemon,
    JobQueue,
    MasterDaemon,
    TargetRegistry,
)

CPU = "cpu"


def ref_daemon():
    from lantern_tpu.service import daemon

    return daemon


def wait_for(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


TEXTS = ["hello world", "vector search on a card", "", "ünïcode text",
         "hello world"]


@pytest.mark.parametrize("dim", [8, 64, 384])
def test_hash_embeddings_byte_equal(dim):
    from lantern_tpu import embeddings as ref

    got = embeddings.HashRuntime(dim=dim).process(TEXTS)
    want = ref.HashRuntime(dim=dim).process(TEXTS)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for t in TEXTS:
        assert (embeddings.text_embedding("hash", t, dim=dim).tobytes()
                == ref.text_embedding("hash", t, dim=dim).tobytes())
    assert (embeddings.llm_completion("hello", runtime="hash")
            == ref.llm_completion("hello", runtime="hash"))


def test_runtime_registry_equal():
    from lantern_tpu import embeddings as ref

    assert embeddings.get_available_runtimes() == ref.get_available_runtimes()
    assert embeddings.get_available_models() == ref.get_available_models()
    assert embeddings.ONNX_MODELS == ref.ONNX_MODELS


def test_openai_runtime_against_mock():
    """The REST runtime speaks the OpenAI wire format (mock server), as
    the reference's does."""
    from lantern_tpu import embeddings as ref

    seen = []

    class Mock(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            req = json.loads(self.rfile.read(n))
            seen.append((self.path, self.headers["Authorization"], req))
            body = json.dumps({"data": [
                {"embedding": [float(len(t)), 1.0]} for t in req["input"]
            ]}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), Mock)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        out = embeddings.OpenAiRuntime("test-key", base_url=base).process(
            ["ab", "abcd"])
        ref_out = ref.OpenAiRuntime("test-key", base_url=base).process(
            ["ab", "abcd"])
        np.testing.assert_array_equal(out, [[2.0, 1.0], [4.0, 1.0]])
        assert out.tobytes() == ref_out.tobytes()
        assert seen[0] == seen[1]
    finally:
        srv.shutdown()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small jobs: torch's CPU thread pool only adds contention when the
    suite runs several workers at once."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_jobs(daemon_mod, tmp_path, tag, rng_seed, autotune=True,
              **daemon_kw):
    rng = np.random.default_rng(rng_seed)
    q = daemon_mod.JobQueue(str(tmp_path / f"jobs_{tag}"))
    inp = tmp_path / "texts.txt"
    inp.write_text("hello world\nvector search\nthird row\n")
    vecs = rng.standard_normal((200, 8)).astype(np.float32)
    np.save(tmp_path / "vecs.npy", vecs)
    jobs = {
        "embedding": q.submit("embedding", {
            "input": str(inp), "output": str(tmp_path / f"e_{tag}.npy"),
            "runtime": "hash", "runtime_args": {"dim": 32}}),
        "completion": q.submit("completion", {
            "input": str(inp), "output": str(tmp_path / f"c_{tag}.jsonl"),
            "runtime": "hash"}),
        "index": q.submit("index", {
            "input": str(tmp_path / "vecs.npy"),
            "output": str(tmp_path / f"ix_{tag}.ldb"), "m": 8}),
        "failing": q.submit("embedding", {"input": "/nonexistent",
                                          "output": "x"}),
    }
    if autotune:
        jobs["autotune"] = q.submit("autotune", {
            "input": str(tmp_path / "vecs.npy"), "k": 5,
            "target_recall": 0.5, "variants": [[8, 40, 64], [16, 60, 76]]})
    daemon_mod.Daemon(q, backoff_base_s=0.01, **daemon_kw).run_pending()
    return q, jobs


def test_jobs_run_as_in_the_reference(tmp_path):
    q, jobs = _run_jobs(port_daemon, tmp_path, "port", 5, device=CPU)
    # the reference's autotune job is held to the port's in
    # test_torch_autotune.py
    rq, rjobs = _run_jobs(ref_daemon(), tmp_path, "ref", 5, autotune=False)
    for kind in ("embedding", "completion", "index"):
        doc, rdoc = q.get(jobs[kind]), rq.get(rjobs[kind])
        assert doc["status"] == rdoc["status"] == "completed", (doc, rdoc)
        assert doc["usage"] == rdoc["usage"]
    assert q.get(jobs["autotune"])["status"] == "completed"
    for name in ("e_{}.npy", "c_{}.jsonl"):
        assert ((tmp_path / name.format("port")).read_bytes()
                == (tmp_path / name.format("ref")).read_bytes())
    usage = q.get(jobs["autotune"])["usage"]
    assert len(usage["results"]) == 2 and usage["best"] is not None
    assert usage["best"]["recall"] >= 0.5
    assert {r["engine"] for r in usage["results"]} == {"native"}
    # the index job's snapshot loads in both packages
    from lantern_tpu.index import Index as RefIndex

    ix = lantern_tpu_torch.Index.load(str(tmp_path / "ix_port.ldb"),
                                      device=CPU)
    assert ix.size == RefIndex.load(str(tmp_path / "ix_port.ldb")).size == 200
    failed, rfailed = q.get(jobs["failing"]), rq.get(rjobs["failing"])
    assert failed["status"] == rfailed["status"] == "failed"
    assert failed["error"] == rfailed["error"]


def test_queue_documents_and_cancel(tmp_path):
    q = JobQueue(str(tmp_path / "q"))
    rq = ref_daemon().JobQueue(str(tmp_path / "q"))  # the same directory
    a = q.submit("embedding", {"input": "x", "output": "y"})
    b = rq.submit("index", {"input": "v.npy", "output": "o.ldb"})
    assert [j["id"] for j in q.list()] == [j["id"] for j in rq.list()] == [a, b]
    assert set(q.get(a)) == set(rq.get(b))
    q.cancel(b)
    assert rq.get(b)["status"] == "canceled"
    rq.update(a, status="completed")
    q.cancel(a)  # a finished job stays finished
    assert q.get(a)["status"] == "completed"


def test_completion_job(tmp_path):
    q = JobQueue(str(tmp_path / "jobs"))
    inp = tmp_path / "prompts.txt"
    inp.write_text("hello world\nsecond prompt\n")
    out = tmp_path / "completions.jsonl"
    jid = q.submit("completion", {"input": str(inp), "output": str(out),
                                  "runtime": "hash"})
    Daemon(q, backoff_base_s=0.01, device=CPU).run_pending()
    job = q.get(jid)
    assert job["status"] == "completed", job.get("error")
    assert job["usage"] == {"rows": 2, "failures": 0}
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert rows[0]["output"] == embeddings.llm_completion("hello world",
                                                         runtime="hash")


def test_continuous_watch_job(tmp_path):
    """Rows appended to the input after the job started are embedded; a
    cancel ends the watcher; a restarted daemon requeues a running one."""
    q = JobQueue(str(tmp_path / "jobs"))
    inp = tmp_path / "texts.txt"
    inp.write_text("first row\n")
    out = tmp_path / "emb.npy"
    jid = q.submit("embedding", {"input": str(inp), "output": str(out),
                                 "runtime": "hash", "watch": True,
                                 "runtime_args": {"dim": 16}})
    d = Daemon(q, poll_s=0.02, backoff_base_s=0.01, device=CPU).start()
    try:
        assert wait_for(lambda: q.get(jid).get("usage", {}).get("rows") == 1)
        with open(inp, "a") as f:
            f.write("second row\nthird row\n")
        assert wait_for(lambda: q.get(jid).get("usage", {}).get("rows") == 3)
        assert np.load(out).shape == (3, 16)
    finally:
        d.stop()
    first = q.get(jid)
    assert first["status"] == "running"
    d2 = Daemon(q, poll_s=0.02, device=CPU).start()  # requeues, reclaims
    try:
        assert wait_for(lambda: q.get(jid)["status"] == "running"
                        and q.get(jid)["started_at"] > first["started_at"])
        q.cancel(jid)
        time.sleep(0.1)
        assert q.get(jid)["status"] == "canceled"
    finally:
        d2.stop()


def test_failed_job_backs_off(tmp_path):
    q = JobQueue(str(tmp_path / "jobs"))
    q.submit("embedding", {"input": "/nonexistent", "output": "x"})
    d = Daemon(q, backoff_base_s=0.5, device=CPU)
    d.run_pending()
    assert d._backoff == 0.5
    q.submit("embedding", {"input": "/nonexistent", "output": "x"})
    d.run_pending()
    assert d._backoff == 1.0


def test_master_daemon_lifecycle(tmp_path):
    """Master mode: a target's jobs run; a stale heartbeat cancels its
    jobs; recovery restarts it; removal forgets it."""
    reg = TargetRegistry(str(tmp_path / "registry.json"))
    md = MasterDaemon(reg, poll_s=0.02, ping_s=0.05, heartbeat_timeout_s=0.3,
                      daemon_poll_s=0.02, device=CPU).start()
    try:
        jobs_a = str(tmp_path / "a_jobs")
        hb_a = tmp_path / "a.heartbeat"
        hb_a.touch()
        reg.add("a", jobs_a, heartbeat=str(hb_a))
        inp = tmp_path / "texts.txt"
        inp.write_text("hello\nworld\n")
        assert wait_for(lambda: "a" in md.status(), 5)
        assert md._targets["a"]["daemon"].device.type == "cpu"
        qa = JobQueue(jobs_a)
        jid = qa.submit("embedding", {"input": str(inp),
                                      "output": str(tmp_path / "a_out.npy")})

        def done_touching():
            hb_a.touch()
            return qa.get(jid)["status"] == "completed"

        assert wait_for(done_touching, 5)
        j2 = qa.submit("embedding", {"input": str(inp),
                                     "output": str(tmp_path / "a2.npy")})
        time.sleep(0.35)
        assert wait_for(lambda: not md.status()["a"]["healthy"], 5)
        assert wait_for(lambda: qa.get(j2)["status"] in ("canceled",
                                                         "completed"), 2)
        j3 = qa.submit("embedding", {"input": str(inp),
                                     "output": str(tmp_path / "a3.npy")})
        time.sleep(0.2)
        assert qa.get(j3)["status"] == "queued"

        def recovered():
            hb_a.touch()
            return qa.get(j3)["status"] == "completed"

        assert wait_for(recovered, 5)
        assert md.status()["a"]["healthy"] is True
        reg.remove("a")
        assert wait_for(lambda: "a" not in md.status(), 5)
    finally:
        md.stop()


def test_target_registry_shared_with_the_reference(tmp_path):
    path = str(tmp_path / "registry.json")
    reg = TargetRegistry(path)
    rreg = ref_daemon().TargetRegistry(path)
    reg.add("t", str(tmp_path / "t_jobs"), heartbeat="hb")
    assert rreg.read() == reg.read() == {
        "t": {"jobs_dir": str(tmp_path / "t_jobs"), "heartbeat": "hb"}}
    rreg.remove("t")
    assert reg.read() == {}
