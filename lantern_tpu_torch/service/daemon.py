"""Job daemon — parity with lantern_cli's daemon (R6) and the job SQL API (X3).

The reference watches `embedding_generation_jobs` / `autotune_jobs` tables,
locks rows, runs jobs with cancel tokens and exponential-backoff restart
(daemon/mod.rs:89-187), and records usage/failure rows.

Here the queue is a directory of JSON job files (no Postgres in this stack):
- submit(kind, spec) writes jobs/<id>.json with status "queued"
- the daemon polls, claims (status -> running), executes, and finalizes
  (completed/failed + error + usage), mirroring get_embedding_job_status
  semantics (queued/running/completed/failed, daemon.rs:229-383)
- failures retry with exponential backoff: 10s doubling, reset after a
  healthy run (daemon/mod.rs:109-187) — configurable/scaled for tests
- index and autotune jobs run on the daemon's device (default cuda), and
  so do embedding and completion jobs of the "local" runtime whose
  ``runtime_args`` name no device
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid

import numpy as np

from lantern_tpu_torch import resolve_device
from lantern_tpu_torch.utils.logger import Logger


class JobQueue:
    """Directory-backed job queue."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _file(self, job_id: str) -> str:
        return os.path.join(self.path, f"{job_id}.json")

    def submit(self, kind: str, spec: dict) -> str:
        job_id = uuid.uuid4().hex[:12]
        self._write(job_id, {
            "id": job_id, "kind": kind, "spec": spec, "status": "queued",
            "submitted_at": time.time(), "error": None, "usage": {},
        })
        return job_id

    def _write(self, job_id: str, doc: dict):
        tmp = self._file(job_id) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self._file(job_id))

    def get(self, job_id: str) -> dict:
        with open(self._file(job_id)) as f:
            return json.load(f)

    def list(self) -> list[dict]:
        out = []
        for fn in os.listdir(self.path):
            if fn.endswith(".json"):
                try:
                    with open(os.path.join(self.path, fn)) as f:
                        out.append(json.load(f))
                except (OSError, json.JSONDecodeError):
                    continue
        return sorted(out, key=lambda j: j.get("submitted_at", 0))

    def update(self, job_id: str, **fields):
        doc = self.get(job_id)
        doc.update(fields)
        self._write(job_id, doc)

    def cancel(self, job_id: str):
        doc = self.get(job_id)
        if doc["status"] in ("queued", "running"):
            self.update(job_id, status="canceled")


class Daemon:
    """Polls the queue and executes jobs with backoff restart."""

    def __init__(self, queue: JobQueue, poll_s: float = 0.2,
                 backoff_base_s: float = 10.0, logger: Logger | None = None,
                 device=None):
        self.queue = queue
        self.device = resolve_device(device)
        self.poll_s = poll_s
        self.backoff_base_s = backoff_base_s
        self.log = logger or Logger("daemon")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._watchers: list[threading.Thread] = []
        self._backoff = 0.0

    # ---- job executors ----
    def _runtime(self, spec: dict):
        """The job's embedding runtime; a "local" one runs on the daemon's
        device unless its ``runtime_args`` name one."""
        from lantern_tpu_torch.embeddings import get_runtime

        name = spec.get("runtime", "hash")
        kw = dict(spec.get("runtime_args", {}))
        if name == "local":
            kw.setdefault("device", self.device)
        return get_runtime(name, **kw)

    def _run_embedding_job(self, spec: dict) -> dict:
        with open(spec["input"]) as f:
            texts = [line.rstrip("\n") for line in f if line.strip()]
        rt = self._runtime(spec)
        embs = rt.process(texts)
        np.save(spec["output"], embs)
        return {"rows": len(texts), "dim": int(embs.shape[1])}

    def _run_completion_job(self, spec: dict) -> dict:
        """add_completion_job analog (lantern_extras/src/daemon.rs:121-227):
        run an LLM completion per input row, write one output line per row
        (JSON) plus per-row usage accounting."""
        with open(spec["input"]) as f:
            rows = [line.rstrip("\n") for line in f if line.strip()]
        rt = self._runtime(spec)
        if not hasattr(rt, "completion"):
            raise ValueError(
                f"runtime {spec.get('runtime', 'hash')!r} has no completion support"
            )
        system = spec.get("system")
        model = spec.get("model", "hash")
        failures = 0
        with open(spec["output"], "w") as out:
            for row in rows:
                try:
                    text = rt.completion(row, model=model, system=system)
                    out.write(json.dumps({"input": row, "output": text}) + "\n")
                except Exception as e:  # noqa: BLE001 — per-row failure rows
                    failures += 1
                    out.write(json.dumps({"input": row, "error": str(e)}) + "\n")
        return {"rows": len(rows), "failures": failures}

    def _run_autotune_job(self, spec: dict) -> dict:
        from lantern_tpu_torch.autotune import AUTOTUNE_VARIANTS, autotune
        from lantern_tpu_torch.config import Metric

        vectors = np.load(spec["input"])
        variants = (
            tuple(tuple(v) for v in spec["variants"])
            if spec.get("variants")
            else AUTOTUNE_VARIANTS
        )
        best, results = autotune(
            vectors,
            metric=Metric.from_string(spec.get("metric", "l2sq")),
            k=spec.get("k", 10),
            target_recall=spec.get("target_recall", 0.9),
            sample=spec.get("sample", 10000),
            variants=variants,
            engine=spec.get("engine", "native"),
            device=self.device,
        )
        return {
            "best": vars(best) if best else None,
            "results": [vars(r) for r in results],
        }

    def _run_index_job(self, spec: dict) -> dict:
        from lantern_tpu_torch.config import HnswParams, Metric
        from lantern_tpu_torch.index import Index

        vectors = np.load(spec["input"])
        p = HnswParams(
            dim=vectors.shape[1],
            m=spec.get("m", 16),
            ef_construction=spec.get("ef_construction", 128),
            metric=Metric.from_string(spec.get("metric", "l2sq")),
        )
        ix = Index(p, capacity=len(vectors), device=self.device)
        ix.add(vectors)
        ix.save(spec["output"])
        return {"rows": ix.size}

    _EXECUTORS = {
        "embedding": _run_embedding_job,
        "completion": _run_completion_job,
        "autotune": _run_autotune_job,
        "index": _run_index_job,
    }

    # ---- continuous ("client") embedding jobs ----
    def _run_watch_job(self, jid: str, spec: dict):
        """Continuous embedding of rows appended to the input after the job
        started — the reference's client jobs react to INSERT triggers +
        NOTIFY (client_embedding_jobs.rs:84-139); a polled file offset plays
        the trigger's role here. Runs until the job is canceled or the
        daemon stops; output .npy is rewritten as rows arrive."""
        rt = self._runtime(spec)
        done_rows = 0
        embs: list[np.ndarray] = []
        try:
            while not self._stop.is_set():
                if self.queue.get(jid)["status"] == "canceled":
                    return
                with open(spec["input"]) as f:
                    texts = [line.rstrip("\n") for line in f if line.strip()]
                if len(texts) > done_rows:
                    new = rt.process(texts[done_rows:])
                    embs.append(new)
                    done_rows = len(texts)
                    np.save(spec["output"], np.concatenate(embs))
                    self.queue.update(jid, usage={"rows": done_rows,
                                                  "dim": int(new.shape[1])})
                self._stop.wait(self.poll_s)
        except Exception as e:  # noqa: BLE001
            self.queue.update(jid, status="failed", error=str(e),
                              finished_at=time.time())
            self.log.error(f"watch job {jid} failed: {e}")

    # ---- loop ----
    def _step(self) -> bool:
        """Claim and run one queued job; returns True if one ran."""
        for job in self.queue.list():
            if job["status"] != "queued":
                continue
            jid = job["id"]
            if job["kind"] == "embedding" and job["spec"].get("watch"):
                # continuous job: claim it and keep it running on its own
                # thread (the reference's per-DB task concurrency)
                self.queue.update(jid, status="running", started_at=time.time())
                t = threading.Thread(
                    target=self._run_watch_job, args=(jid, job["spec"]),
                    daemon=True,
                )
                t.start()
                self._watchers.append(t)
                self.log.info(f"watch job {jid} started")
                return True
            self.queue.update(jid, status="running", started_at=time.time())
            self.log.info(f"job {jid} ({job['kind']}) started")
            try:
                fn = self._EXECUTORS[job["kind"]]
                usage = fn(self, job["spec"])
                if self._finalize(jid, status="completed", usage=usage):
                    self.log.info(f"job {jid} completed")
                self._backoff = 0.0
            except Exception as e:  # noqa: BLE001
                if self._finalize(jid, status="failed", error=str(e)):
                    self.log.error(f"job {jid} failed: {e}")
                # exponential backoff before the next claim (10s -> x2,
                # daemon/mod.rs:109-187); reset happens on the next success
                self._backoff = max(self.backoff_base_s, self._backoff * 2)
            return True
        return False

    def _finalize(self, jid, **fields) -> bool:
        """Write a terminal status unless the job was canceled mid-run —
        a cancel must stay the terminal state (daemon.rs:229-383)."""
        cur = self.queue.get(jid)
        if cur and cur.get("status") == "canceled":
            return False
        self.queue.update(jid, finished_at=time.time(), **fields)
        return True

    def _loop(self):
        while not self._stop.is_set():
            if self._backoff > 0:
                # wait out the backoff but KEEP its value — zeroing it here
                # would make the next failure start from the base again,
                # so the documented doubling could never happen
                if self._stop.wait(self._backoff):
                    break
            ran = self._step()
            if not ran:
                self._stop.wait(self.poll_s)

    def start(self):
        # Reclaim watch jobs orphaned by a previous daemon's stop/crash:
        # their threads are daemon threads, so a 'running' continuous job in
        # the queue has no live worker — requeue it (the analog of the
        # reference's bgworker restart resuming client jobs,
        # daemon/client_embedding_jobs.rs:84-139).
        for job in self.queue.list():
            if (
                job["status"] == "running"
                and job["kind"] == "embedding"
                and job["spec"].get("watch")
            ):
                self.queue.update(job["id"], status="queued")
                self.log.info(f"watch job {job['id']} requeued after restart")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(10)
        for t in self._watchers:
            t.join(10)

    def run_pending(self):
        """Synchronously drain the queue (for tests/CLI one-shot mode)."""
        while self._step():
            pass


# ---- master mode (daemon/mod.rs:217-344) --------------------------------


class TargetRegistry:
    """Master registry of daemon targets — the analog of the reference's
    master-DB table of target databases (daemon/mod.rs:217-344). A JSON
    file mapping target id -> {jobs_dir, heartbeat}; edits through add()/
    remove() are atomic, and the MasterDaemon reacts to file changes (the
    polled-mtime stand-in for the reference's NOTIFY triggers)."""

    def __init__(self, path: str):
        self.path = path
        if not os.path.exists(path):
            self._write({"targets": {}})

    def _write(self, doc: dict):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)

    def read(self) -> dict:
        try:
            with open(self.path) as f:
                return json.load(f).get("targets", {})
        except (OSError, json.JSONDecodeError):
            return {}

    def add(self, target_id: str, jobs_dir: str,
            heartbeat: str | None = None):
        doc = {"targets": self.read()}
        doc["targets"][target_id] = {
            "jobs_dir": jobs_dir, "heartbeat": heartbeat,
        }
        self._write(doc)

    def remove(self, target_id: str):
        doc = {"targets": self.read()}
        doc["targets"].pop(target_id, None)
        self._write(doc)


class MasterDaemon:
    """Multi-target daemon supervisor (reference master mode).

    Discovers targets from a TargetRegistry, runs one Daemon per target
    jobs directory, and health-pings each target every ``ping_s`` seconds
    (reference: 30 s, daemon/mod.rs:240-254): a target is healthy while its
    heartbeat file's mtime is fresher than ``heartbeat_timeout_s``. On
    failure the target's daemon stops and ALL its queued/running jobs are
    canceled (the reference cancels all jobs of a failed target DB); if the
    heartbeat recovers, a fresh daemon restarts. Targets without a
    heartbeat path are always considered healthy.

    Registry edits are picked up on the next poll: new targets get a
    daemon, removed targets are stopped and forgotten (their job files
    remain on disk, like the reference leaves target tables intact).
    Every target's daemon runs its jobs on ``device``.
    """

    def __init__(self, registry: TargetRegistry | str, poll_s: float = 0.2,
                 ping_s: float = 30.0, heartbeat_timeout_s: float | None = None,
                 daemon_poll_s: float = 0.2, logger: Logger | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.registry = (registry if isinstance(registry, TargetRegistry)
                         else TargetRegistry(registry))
        self.poll_s = poll_s
        self.ping_s = ping_s
        self.heartbeat_timeout_s = (
            heartbeat_timeout_s if heartbeat_timeout_s is not None
            else 2.0 * ping_s
        )
        self.daemon_poll_s = daemon_poll_s
        self.log = logger or Logger("master-daemon")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._targets: dict[str, dict] = {}  # id -> {daemon, spec, healthy}
        self._last_ping = 0.0
        self._lock = threading.Lock()

    # ---- health ----
    def _healthy(self, spec: dict) -> bool:
        hb = spec.get("heartbeat")
        if not hb:
            return True
        try:
            age = time.time() - os.path.getmtime(hb)
        except OSError:
            return False
        return age <= self.heartbeat_timeout_s

    def _cancel_all(self, target_id: str, queue: JobQueue):
        n = 0
        for job in queue.list():
            if job["status"] in ("queued", "running"):
                queue.cancel(job["id"])
                n += 1
        self.log.warn(
            f"target {target_id} unhealthy: canceled {n} job(s)"
        )

    # ---- supervision loop ----
    def _sync_targets(self):
        wanted = self.registry.read()
        with self._lock:
            # removed targets: stop their daemons (jobs files remain)
            for tid in list(self._targets):
                if tid not in wanted:
                    self._targets.pop(tid)["daemon"].stop()
                    self.log.info(f"target {tid} removed")
            # new targets: spawn a daemon each
            for tid, spec in wanted.items():
                cur = self._targets.get(tid)
                if cur is None:
                    q = JobQueue(spec["jobs_dir"])
                    d = Daemon(q, poll_s=self.daemon_poll_s,
                               logger=Logger(f"daemon[{tid}]"),
                               device=self.device).start()
                    self._targets[tid] = {
                        "daemon": d, "queue": q, "spec": spec,
                        "healthy": True,
                    }
                    self.log.info(f"target {tid} discovered")
                else:
                    cur["spec"] = spec

    def _ping_targets(self):
        with self._lock:
            for tid, t in self._targets.items():
                ok = self._healthy(t["spec"])
                if t["healthy"] and not ok:
                    # failure: stop the daemon, cancel every job
                    t["daemon"].stop()
                    self._cancel_all(tid, t["queue"])
                    t["healthy"] = False
                elif not t["healthy"] and ok:
                    # recovery: fresh daemon (reference reconnect+backoff)
                    t["daemon"] = Daemon(
                        t["queue"], poll_s=self.daemon_poll_s,
                        logger=Logger(f"daemon[{tid}]"), device=self.device,
                    ).start()
                    t["healthy"] = True
                    self.log.info(f"target {tid} recovered")

    def _loop(self):
        while not self._stop.is_set():
            self._sync_targets()
            now = time.time()
            if now - self._last_ping >= self.ping_s:
                self._last_ping = now
                self._ping_targets()
            self._stop.wait(self.poll_s)

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(10)
        with self._lock:
            for t in self._targets.values():
                t["daemon"].stop()

    def status(self) -> dict:
        with self._lock:
            return {
                tid: {
                    "healthy": t["healthy"],
                    "jobs": {
                        j["id"]: j["status"] for j in t["queue"].list()
                    },
                }
                for tid, t in self._targets.items()
            }
