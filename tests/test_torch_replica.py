"""The port's log-following replica (storage/replica.py, Index.follow):
tests/test_replica.py's five cases on the CPU, and a port replica of a
writer of the JAX package.

A writer Index appends to its insert log; an IndexFollower in the same or
another process tails it. Parity as the reference asserts it: the exact
flat scan returns equal labels (distances within 1e-5 rel + 1e-5 abs), the
host engines' searches the same label sets. Replays insert on one host
thread, so a follower and a writer that added on one thread from the same
snapshot hold equal engine arrays, and their graph searches are equal too.
"""

import os
import pathlib
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

import lantern_tpu
import lantern_tpu_torch
from lantern_tpu_torch.config import HnswParams
from lantern_tpu_torch.storage.snapshot import _LOG_REC_HDR

CPU = "cpu"
DIM = 24
P = HnswParams(dim=DIM, m=8, ef_construction=48, ef=64)
ROOT = pathlib.Path(__file__).resolve().parents[1]
ARRAYS = ("vectors", "neighbors0", "counts0", "levels", "labels", "deleted")


def Index(*a, **kw):
    return lantern_tpu_torch.Index(*a, device=CPU, **kw)


def follow(snap, log, **kw):
    return lantern_tpu_torch.Index.follow(snap, log, device=CPU, **kw)


def _queries(rng, n=8):
    return rng.standard_normal((n, DIM)).astype(np.float32)


def assert_query_parity(writer, follower, queries, k=10, ef=96):
    dw, lw = writer.search(queries, k=k, mode="flat")
    df, lf = follower.search(queries, k=k, mode="flat")
    np.testing.assert_array_equal(lw, lf)
    np.testing.assert_allclose(dw, df, rtol=1e-5, atol=1e-5)
    for q in queries[:4]:
        _, lw = writer.search_cpu(q, k=k, ef=ef)
        _, lf = follower.search_cpu(q, k=k, ef=ef)
        assert set(lw.tolist()) == set(lf.tolist())


def assert_same_engine(a, b):
    n = a.size
    assert (n, a.num_deleted) == (b.size, b.num_deleted)
    for name in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(a._eng, name))[:n],
                                      np.asarray(getattr(b._eng, name))[:n],
                                      name)


def test_follower_catchup_to_parity(tmp_path, rng):
    snap, log = str(tmp_path / "ix.snap"), str(tmp_path / "ix.log")
    base = rng.standard_normal((300, DIM)).astype(np.float32)
    writer = Index(P, capacity=512, seed=3, log_path=log)
    writer.add(base[:200], nthreads=1)
    writer.save(snap)

    follower = follow(snap, log)
    assert follower.size == 200
    qs = _queries(rng)
    assert_query_parity(writer, follower, qs)

    # live tail: the writer inserts and deletes without saving
    writer.add(base[200:260], nthreads=1)
    writer.delete(np.arange(10, 30, dtype=np.uint64))
    assert follower.catchup() == 60 + 20
    assert follower.size == writer.size == 260
    assert follower.num_deleted == writer.num_deleted == 20
    assert_query_parity(writer, follower, qs)

    # generation flip: save() truncates the log, the writer appends more
    writer.save(snap)
    writer.add(base[260:300], nthreads=1)
    follower.catchup()
    assert follower.size == 300
    assert_query_parity(writer, follower, qs)
    assert follower.catchup() == 0  # idempotent when nothing changed


def test_follower_fast_path_skips_reload(tmp_path, rng):
    """A save() that folds only records the follower already applied does
    not reload the snapshot."""
    snap, log = str(tmp_path / "ix.snap"), str(tmp_path / "ix.log")
    writer = Index(P, capacity=256, seed=3, log_path=log)
    writer.add(rng.standard_normal((50, DIM)).astype(np.float32), nthreads=1)
    writer.save(snap)
    follower = follow(snap, log)
    writer.add(rng.standard_normal((30, DIM)).astype(np.float32),
               labels=np.arange(50, 80, dtype=np.uint64), nthreads=1)
    assert follower.catchup() == 30
    inner_before = follower._ix
    writer.save(snap)  # folds exactly what the follower has
    writer.add(rng.standard_normal((5, DIM)).astype(np.float32),
               labels=np.arange(80, 85, dtype=np.uint64), nthreads=1)
    assert follower.catchup() == 5
    assert follower._ix is inner_before  # no reload
    assert follower.size == writer.size == 85
    for method in ("add", "delete", "compact", "save"):
        with pytest.raises(TypeError, match="read-only"):
            getattr(follower, method)()


def test_follower_tolerates_torn_tail(tmp_path, rng):
    """An in-flight record reads as 'not yet'; once complete it applies."""
    snap, log = str(tmp_path / "ix.snap"), str(tmp_path / "ix.log")
    writer = Index(P, capacity=256, seed=3, log_path=log)
    writer.add(rng.standard_normal((40, DIM)).astype(np.float32), nthreads=1)
    writer.save(snap)
    follower = follow(snap, log)

    vec = rng.standard_normal(DIM).astype(np.float32)
    raw = vec.tobytes()
    rec = struct.pack(_LOG_REC_HDR, 40, len(raw), zlib.crc32(raw)) + raw
    with open(log, "ab") as f:
        f.write(rec[: len(rec) // 2])
    assert follower.catchup() == 0
    assert follower.size == 40
    with open(log, "ab") as f:
        f.write(rec[len(rec) // 2:])
    assert follower.catchup() == 1
    assert follower.size == 41
    d, lab = follower.search(vec, k=1, mode="flat")
    assert lab[0, 0] == 40 and d[0, 0] < 1e-4


def test_follower_no_snapshot_yet(tmp_path, rng):
    """Before the first save the log is the only copy; params= bootstraps."""
    log, snap = str(tmp_path / "ix.log"), str(tmp_path / "ix.snap")
    writer = Index(P, capacity=256, seed=3, log_path=log)
    writer.add(rng.standard_normal((25, DIM)).astype(np.float32), nthreads=1)
    with pytest.raises(ValueError, match="params"):
        follow(snap, log)
    follower = follow(snap, log, params=P)
    assert follower.size == 25
    assert_query_parity(writer, follower, _queries(rng, 4))


_WRITER_SCRIPT = r"""
import sys

import numpy as np

from lantern_tpu_torch.config import HnswParams
from lantern_tpu_torch.index import Index
from lantern_tpu_torch.utils.failpoints import FailurePointError, failure_point_enable

snap, log = sys.argv[1], sys.argv[2]
rng = np.random.default_rng(0xA47E60DB)
base = rng.standard_normal((300, 24)).astype(np.float32)
p = HnswParams(dim=24, m=8, ef_construction=48, ef=64)
w = Index(p, capacity=512, seed=3, log_path=log, device="cpu")
w.add(base[:200], nthreads=1)
w.save(snap)
w.add(base[200:260], nthreads=1)
w.delete(np.arange(10, 30, dtype=np.uint64))
# die mid-append, leaving a torn tail (header written, payload missing)
failure_point_enable("insert_log_append", "mid_record")
try:
    w.add(base[260:261], nthreads=1)
except FailurePointError:
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "lantern_tpu"))
    print("TORN" if not bad else f"IMPORTED {bad}")
    sys.exit(0)
sys.exit(3)
"""


def test_follower_two_process(tmp_path, rng):
    """Process A (the port alone, on the CPU) builds, saves, inserts and
    deletes, and dies mid-append; this process catches up to parity and
    survives the torn tail."""
    snap, log = str(tmp_path / "ix.snap"), str(tmp_path / "ix.log")
    proc = subprocess.run(
        [sys.executable, "-c", _WRITER_SCRIPT, snap, log],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr
    assert "TORN" in proc.stdout, proc.stdout

    follower = follow(snap, log)
    assert follower.size == 260  # 200 in the snapshot + 60; the torn add absent
    assert follower.num_deleted == 20

    base = np.random.default_rng(0xA47E60DB).standard_normal(
        (300, DIM)).astype(np.float32)
    expected = Index(P, capacity=512, seed=3)
    expected.add(base[:200], nthreads=1)
    expected.add(base[200:260], nthreads=1)
    expected.delete(np.arange(10, 30, dtype=np.uint64))
    assert_query_parity(expected, follower, _queries(rng))

    # a recovering writer truncates the torn tail and appends; the follower
    # keeps following, and both replayed the same ops on one thread
    writer = lantern_tpu_torch.Index.load(snap, log_path=log, device=CPU)
    writer.add(base[260:300], nthreads=1)
    follower.catchup()
    assert follower.size == 300
    assert_query_parity(writer, follower, _queries(rng))
    assert_same_engine(writer, follower._ix)


def test_writer_and_follower_hold_equal_graphs(tmp_path, rng):
    """From one snapshot, a writer that adds on one thread and its follower
    (replaying on one thread) hold equal engines, so even their graph
    searches are equal; so does a writer reopened after a crash."""
    snap, log = str(tmp_path / "g.snap"), str(tmp_path / "g.log")
    base = rng.standard_normal((500, DIM)).astype(np.float32)
    Index(P, capacity=512).add(base[:300], nthreads=1).save(snap)
    writer = lantern_tpu_torch.Index.load(snap, log_path=log, device=CPU)
    follower = follow(snap, log)
    writer.add(base[300:], nthreads=1)
    writer.delete(np.arange(0, 500, 5, dtype=np.uint64))
    assert follower.catchup() == 200 + 100
    qs = _queries(rng, 16)
    want = writer.search(qs, k=10, mode="graph")
    assert_same_engine(writer, follower._ix)
    for got in (follower.search(qs, k=10, mode="graph"),):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    del writer  # crash: no save
    reopened = lantern_tpu_torch.Index.load(snap, log_path=log, device=CPU)
    assert_same_engine(reopened, follower._ix)
    got = reopened.search(qs, k=10, mode="graph")
    np.testing.assert_array_equal(got[1], want[1])


def test_port_follows_a_reference_writer(tmp_path, rng):
    """The two packages share the file formats: a port replica follows a
    writer of the JAX package through inserts, deletes and a save."""
    snap, log = str(tmp_path / "r.snap"), str(tmp_path / "r.log")
    base = rng.standard_normal((260, DIM)).astype(np.float32)
    writer = lantern_tpu.Index(P, capacity=512, seed=3, log_path=log)
    writer.add(base[:200], nthreads=1)
    writer.save(snap)
    follower = follow(snap, log)
    writer.add(base[200:240], nthreads=1)
    writer.delete(np.arange(0, 20, dtype=np.uint64))
    assert follower.catchup() == 40 + 20
    assert (follower.size, follower.num_deleted) == (240, 20)
    qs = _queries(rng)
    assert_query_parity(writer, follower, qs)
    writer.save(snap)
    writer.add(base[240:], nthreads=1)
    follower.catchup()
    assert follower.size == 260
    assert_query_parity(writer, follower, qs)
