"""Log-following read replica — the WAL-replication analog (port of
lantern_tpu/storage/replica.py).

The reference proves crash/replica safety end-to-end with a live
primary+replica pair: ``lantern_hnsw/scripts/test_wal.py:8-40`` spins a
primary, takes a backup, spawns a replica, ``catchup()``s, and asserts
identical query results, including after DELETEs. Postgres gives it that
via physical WAL shipping; here the same contract is met at the file level:

- a writer ``Index(log_path=...)`` appends CRC-framed add/delete records to
  its insert log (fsync per batch) and periodically folds them into an
  atomically-renamed snapshot stamped with the log's (generation, lsn);
- an :class:`IndexFollower` opens both files READ-ONLY and tails the live
  log. ``catchup()`` applies exactly the CRC-complete record prefix — a
  concurrent writer's in-flight (torn) tail reads as "not yet", never as
  corruption — and transparently handles the writer's save()+truncate()
  generation flips, including the crash window where the snapshot is
  durable but the log not yet truncated (the snapshot's (generation, lsn)
  identifies the already-folded records, exactly as in Index.load).

Replay is logical (vector + label), not physical: the follower re-inserts
through its own engine. The native engine draws insert levels
deterministically from (seed, row position) (hnsw_engine.cpp batch level
pre-draw), so a follower that replays the same ops in the same order from
the same snapshot converges to the same graph; query parity is asserted by
the replica tests the way the reference's test_wal.py asserts result rows.
"""

from __future__ import annotations

import os

import numpy as np

from lantern_tpu_torch.storage.snapshot import (
    read_log_header,
    read_snapshot_header,
    scan_log_tail,
)


def _stat_sig(path: str):
    """Change-detection signature for an atomically-replaced file."""
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    return st.st_ino, st.st_mtime_ns, st.st_size


class IndexFollower:
    """Read-only replica of a writer's (snapshot, insert log) pair.

    >>> follower = Index.follow("ix.snap", "ix.log")
    >>> follower.catchup()          # apply newly appended records
    >>> follower.search(queries)    # read-only query surface

    ``params`` is only needed when no snapshot exists yet (a writer that has
    logged inserts but never save()d — the pre-first-save WAL-replay case);
    the snapshot header carries the params otherwise. ``device`` is the
    replica's search device (default cuda), passed on to ``Index``.
    """

    def __init__(self, snapshot_path: str, log_path: str,
                 engine: str = "native", params=None, catchup: bool = True,
                 device=None):
        self.snapshot_path = snapshot_path
        self.log_path = log_path
        self._engine_kind = engine
        self._params = params
        self._device = device
        self._ix = None
        self._snap_stat = None    # _stat_sig of the snapshot last absorbed
        self._snap_state = None   # (generation, lsn) that snapshot folds
        self._log_gen = None      # generation of the log we are tailing
        self._log_version = 3
        self._applied = 0         # records of _log_gen consumed (incl. folded)
        self._offset = 0          # byte offset just past the last consumed rec
        self._reload()
        if catchup:
            self.catchup()

    # ---- internals ----
    def _reload(self):
        """(Re)load the snapshot from scratch and reset log progress."""
        from lantern_tpu_torch.index import Index

        sig = _stat_sig(self.snapshot_path)
        if sig is None:
            if self._params is None:
                raise ValueError(
                    "no snapshot exists yet; pass params= so the follower "
                    "can replay the log into a fresh index"
                )
            self._ix = Index(self._params, engine=self._engine_kind,
                             device=self._device)
            self._snap_state = None
        else:
            # stat BEFORE load: if the writer replaces the file in between,
            # the recorded signature is older than the content and the next
            # catchup() harmlessly re-detects the change
            self._ix = Index.load(self.snapshot_path, engine=self._engine_kind,
                                  device=self._device)
            self._snap_state = self._ix._loaded_log_state
            if self._snap_state == (0, 0):
                self._snap_state = None
        self._snap_stat = sig
        self._log_gen = None
        self._applied = 0
        self._offset = 0

    def _absorb_snapshot_change(self):
        """React to a new snapshot file. Cheap path: if the new snapshot
        folds only records this follower has already applied (same log
        generation, lsn <= applied), adopt its state without reloading —
        the live-tail fast path. Otherwise full reload."""
        sig = _stat_sig(self.snapshot_path)
        if sig == self._snap_stat:
            return False
        hdr = read_snapshot_header(self.snapshot_path) if sig else None
        if hdr is not None:
            gen, lsn = hdr[6], hdr[7]
            if (self._log_gen is not None and gen == self._log_gen
                    and 0 < lsn <= self._applied):
                self._snap_stat = sig
                self._snap_state = (gen, lsn)
                return False
        self._reload()
        return True

    # ---- public surface ----
    def catchup(self) -> int:
        """Apply all newly durable writer records; returns how many.

        Safe to call while the writer is mid-append: only the CRC-complete
        prefix is consumed. Generation flips (writer save()+truncate()) and
        file replacements are detected and resolved by re-reading the
        snapshot; the retry loop bounds pathological races.
        """
        total = 0
        for _ in range(6):
            self._absorb_snapshot_change()
            hdr = read_log_header(self.log_path)
            if hdr is None:
                break  # no log (yet) — the snapshot alone is the state
            version, gen, header_end = hdr
            if gen != self._log_gen:
                if self._log_gen is not None:
                    # the log was replaced under us (truncate after a save);
                    # re-check the snapshot first so folded records are
                    # accounted before we adopt the new generation
                    self._log_gen = None
                    continue
                # adopt this generation from its start; records the current
                # snapshot already folds are skipped as they stream past
                self._log_gen = gen
                self._log_version = version
                self._offset = header_end
                self._applied = 0
            eng = self._ix._eng
            ops, new_offset = scan_log_tail(
                self.log_path, eng.vectors.shape[1], eng.vectors.dtype,
                self._offset, self._log_version,
            )
            # the file may have been atomically replaced mid-scan, in which
            # case those bytes belong to a different generation — verify
            # before applying anything
            hdr2 = read_log_header(self.log_path)
            if hdr2 is None or hdr2[1] != gen:
                self._log_gen = None
                continue
            if ops:
                folded = 0
                if (self._snap_state is not None
                        and gen and self._snap_state[0] == gen):
                    folded = max(0, self._snap_state[1] - self._applied)
                fresh = ops[folded:]
                self._applied += len(ops)
                self._offset = new_offset
                if fresh:
                    self._ix._apply_log_ops(fresh)
                    total += len(fresh)
            return total
        return total

    def search(self, queries: np.ndarray, **kw):
        """Batched device search — see Index.search."""
        return self._ix.search(queries, **kw)

    def search_cpu(self, query: np.ndarray, k: int = 10, ef: int | None = None):
        return self._ix.search_cpu(query, k=k, ef=ef)

    def validate(self, full: bool = True):
        return self._ix.validate(full=full)

    @property
    def params(self):
        return self._ix.params

    @property
    def size(self) -> int:
        return self._ix.size

    @property
    def num_deleted(self) -> int:
        return self._ix.num_deleted

    # a follower is read-only: refuse the mutating surface explicitly
    def add(self, *a, **kw):
        raise TypeError("IndexFollower is read-only; writes go to the primary")

    delete = add
    compact = add
    save = add

    def __repr__(self):
        return (
            f"IndexFollower(n={self.size}, snapshot={self.snapshot_path!r}, "
            f"log={self.log_path!r}, applied={self._applied})"
        )
