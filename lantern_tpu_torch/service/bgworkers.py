"""In-process background services — parity with lantern_extras' bgworkers.

The reference registers two Postgres background workers inside the database
process — "Lantern Daemon" and "Lantern Indexing Server" (bound to
127.0.0.1:8998) — gated by GUCs ``lantern_extras.enable_daemon`` /
``enable_indexing_server``, restarted by the postmaster 5 s after a crash
(lantern_extras/src/lib.rs:50-63, 158-237).

Here the "database process" is whatever Python process embeds the library:
``ServiceHost`` starts the job daemon and/or the external indexing server on
daemon threads inside it, supervises them, and restarts a crashed indexing
server after ``restart_s`` (the bgworker restart interval). The same
components remain runnable standalone via the CLI (the lantern_cli path).
Both run their device work on the host's ``device`` (default cuda).
"""

from __future__ import annotations

import asyncio
import dataclasses
import threading
import time

from lantern_tpu_torch import resolve_device
from lantern_tpu_torch.utils.logger import Logger


@dataclasses.dataclass
class ServiceConfig:
    """GUC-analog switches (lantern_extras/src/lib.rs:29-150)."""

    enable_daemon: bool = False
    enable_indexing_server: bool = False
    indexing_host: str = "127.0.0.1"
    indexing_port: int = 8998      # the reference's in-DB bind (lib.rs:217-235)
    status_port: int | None = 8999
    jobs_dir: str | None = None    # required when enable_daemon
    restart_s: float = 5.0         # bgworker restart interval (lib.rs:51-63)


class ServiceHost:
    """Runs the configured services in-process and supervises them."""

    def __init__(self, config: ServiceConfig, logger: Logger | None = None,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self.log = logger or Logger("bgworkers")
        self._daemon = None
        self._server = None
        self._server_thread: threading.Thread | None = None
        self._supervisor: threading.Thread | None = None
        self._stop = threading.Event()
        self.indexing_port: int | None = None
        self.status_port: int | None = None
        self.restarts = 0

    # ---- lifecycle ----
    def start(self) -> "ServiceHost":
        cfg = self.config
        if cfg.enable_daemon:
            if not cfg.jobs_dir:
                raise ValueError("enable_daemon requires jobs_dir")
            from lantern_tpu_torch.service.daemon import Daemon, JobQueue

            self._daemon = Daemon(JobQueue(cfg.jobs_dir),
                                  device=self.device).start()
            self.log.info("daemon bgworker started")
        if cfg.enable_indexing_server:
            self._start_server()
            self._supervisor = threading.Thread(target=self._supervise,
                                                daemon=True)
            self._supervisor.start()
        return self

    def _start_server(self):
        from lantern_tpu_torch.service.index_server import IndexServer

        cfg = self.config
        started = threading.Event()
        holder: dict = {}

        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            srv = IndexServer(host=cfg.indexing_host, port=cfg.indexing_port,
                              status_port=cfg.status_port, logger=self.log,
                              device=self.device)
            holder["srv"] = srv
            holder["loop"] = loop
            try:
                loop.run_until_complete(srv.start())
                started.set()
                loop.run_forever()
            except Exception as e:  # noqa: BLE001 — supervisor restarts
                holder["error"] = e
                started.set()
            finally:
                try:
                    loop.run_until_complete(srv.stop())
                except Exception:  # noqa: BLE001
                    pass
                loop.close()

        t = threading.Thread(target=run, daemon=True,
                             name="lantern-indexing-bgworker")
        t.start()
        if not started.wait(30) or "error" in holder:
            raise RuntimeError(
                f"indexing server failed to start: {holder.get('error')}"
            )
        self._server = holder
        self._server_thread = t
        self.indexing_port = holder["srv"].port
        self.status_port = holder["srv"].status_port
        self.log.info(
            f"indexing-server bgworker on {cfg.indexing_host}:{self.indexing_port}"
        )

    def _supervise(self):
        """Restart a dead indexing-server thread after restart_s — the
        postmaster's bgworker restart behavior."""
        while not self._stop.is_set():
            if self._server_thread is not None and not self._server_thread.is_alive():
                self.log.error("indexing-server bgworker died; restarting")
                if self._stop.wait(self.config.restart_s):
                    break
                try:
                    self._start_server()
                    self.restarts += 1
                except Exception as e:  # noqa: BLE001
                    self.log.error(f"restart failed: {e}")
            self._stop.wait(0.2)

    def stop(self):
        self._stop.set()
        if self._daemon is not None:
            self._daemon.stop()
        if self._server is not None:
            loop = self._server.get("loop")
            if loop is not None and loop.is_running():
                loop.call_soon_threadsafe(loop.stop)
            if self._server_thread:
                self._server_thread.join(10)
        if self._supervisor:
            self._supervisor.join(10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
