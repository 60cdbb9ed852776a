"""Parity: the port's persistence layer (storage/snapshot.py, the insert log,
Index.save / load / log_path) against lantern_tpu's, and every storage and
crash case of tests/test_storage.py through the port on the CPU.

Both packages build the same engine (nthreads=1; PQ indexes take the
reference's codebook), so their snapshots are byte-equal, and a file
written by either loads in the other with equal engine arrays. Searches of
a loaded index equal those of the index that wrote it (same arrays, same
code); across the packages labels are equal up to exactly tied distances,
distances within 1e-5 relative + 1e-4 absolute (hamming: exactly equal).
Logs written by either package replay to equal ops.
"""

import pathlib
import struct
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest
import torch

import lantern_tpu_torch
from lantern_tpu_torch.config import HnswParams, Metric, QuantKind
from lantern_tpu_torch.costmodel import estimate_build_rows, estimate_search_cost
from lantern_tpu_torch.graph.host_build import HostHnsw
from lantern_tpu_torch.graph.validate import validate
from lantern_tpu_torch.native import NativeHnsw
from lantern_tpu_torch.storage import InsertLog, load_snapshot, save_snapshot
from lantern_tpu_torch.storage.snapshot import (
    _LOG_MAGIC,
    _LOG_REC_HDR,
    HEADER_VERSION,
)
from lantern_tpu_torch.utils.failpoints import (
    FailurePointError,
    failure_point_disable_all,
    failure_point_enable,
)

CPU = "cpu"
K = 10
ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "snapshot_v1.ldb"
ARRAYS = ("vectors", "neighbors0", "counts0", "upper_neighbors",
          "upper_counts", "upper_slot", "levels", "labels", "deleted")



def jax_ref():
    """The JAX package, imported by the CPU parity tests only: the card's
    machine has no jax, and runs this file's cuda-marked tests without it."""
    import lantern_tpu
    import lantern_tpu.storage.snapshot

    return lantern_tpu

def Index(*a, **kw):
    return lantern_tpu_torch.Index(*a, device=CPU, **kw)


def load(path, **kw):
    return lantern_tpu_torch.Index.load(str(path), device=CPU, **kw)


def assert_engines_equal(a, b):
    """Equal counts, entry, levels and the used part of every array."""
    n, nu = a.n, max(a.n_upper, 1)
    assert (n, a.n_upper, a.entry, a.max_level) == (
        b.n, b.n_upper, b.entry, b.max_level)
    for name in ARRAYS:
        rows = nu if name.startswith("upper_") and name != "upper_slot" else n
        np.testing.assert_array_equal(np.asarray(getattr(a, name))[:rows],
                                      np.asarray(getattr(b, name))[:rows],
                                      name)


def assert_same_results(got, want, exact=False):
    """(dists, labels) equal; labels up to the order of tied distances."""
    (d, lab), (wd, wl) = got, want
    if exact:
        np.testing.assert_array_equal(d, wd)
    else:
        np.testing.assert_allclose(d, wd, rtol=1e-5, atol=1e-4)
    tied = np.zeros(d.shape, bool)
    tied[:, 1:] |= d[:, 1:] == d[:, :-1]
    tied[:, :-1] |= d[:, :-1] == d[:, 1:]
    last = d[:, -1:]
    assert ((lab == wl) | tied | (d == last)).all(), (lab, wl)


# ---- the two packages' snapshots ----

PAIR_CONFIGS = {
    "f32": dict(),
    "cos": dict(metric=Metric.COS),
    "b1": dict(metric=Metric.HAMMING, quant=QuantKind.B1),
    "i8": dict(quant=QuantKind.I8),
    "pq": dict(pq=True, num_subvectors=8, num_centroids=32),
    "opq": dict(pq=True, num_subvectors=8, num_centroids=32, rotate=True),
}


@pytest.fixture(scope="module", params=sorted(PAIR_CONFIGS))
def pair(request):
    from lantern_tpu_torch.quant.pq import PQCodebook

    cfg = dict(PAIR_CONFIGS[request.param])
    rotate = cfg.pop("rotate", False)
    rng = np.random.default_rng(21)
    c = rng.standard_normal((12, 32)).astype(np.float32)
    base = (c[rng.integers(0, 12, 700)]
            + 0.4 * rng.standard_normal((700, 32))).astype(np.float32)
    q = (c[rng.integers(0, 12, 24)]
         + 0.4 * rng.standard_normal((24, 32))).astype(np.float32)
    labels = np.arange(700, dtype=np.uint64) * np.uint64(3) + np.uint64(5)
    p = HnswParams(dim=32, m=8, ef_construction=40, **cfg)
    ref = jax_ref().Index(p, capacity=64, seed=0)
    port = Index(p, capacity=64, seed=0)
    if p.pq:
        cb = ref.train_pq(base, iters=6, rotate=rotate, opq_iters=2)
        port._codebook = PQCodebook(
            np.array(cb.centroids),
            None if cb.rotation is None else np.array(cb.rotation))
    for ix in (ref, port):
        ix.add(base, labels=labels, nthreads=1)
        ix.delete(labels[::9])
    return request.param, ref, port, base, q


def test_snapshot_bytes_equal_reference(pair, tmp_path):
    name, ref, port, _, _ = pair
    ref.save(str(tmp_path / "ref.ldb"))
    port.save(str(tmp_path / "port.ldb"))
    assert (tmp_path / "port.ldb").read_bytes() == (
        tmp_path / "ref.ldb").read_bytes(), name


@pytest.mark.parametrize("engine", ["native", "python"])
def test_snapshots_load_across_packages(pair, tmp_path, engine):
    name, ref, port, base, q = pair
    ref_path, port_path = tmp_path / "ref.ldb", tmp_path / "port.ldb"
    ref.save(str(ref_path))
    port.save(str(port_path))
    hamming = name == "b1"
    modes = [dict(mode="flat")] + ([dict(rerank=60)] if port.params.pq else [])
    # the port opens the reference's file
    ported = load(ref_path, engine=engine)
    assert ported.size == port.size and ported.num_deleted == port.num_deleted
    assert_engines_equal(ported._eng, ref._eng)
    ported.validate().raise_if_failed()
    # the reference opens the port's file
    back = jax_ref().Index.load(str(port_path), engine=engine)
    assert_engines_equal(back._eng, port._eng)
    if port.params.pq:
        for cb in (ported._codebook, back._codebook):
            np.testing.assert_array_equal(np.asarray(cb.centroids),
                                          port._codebook.centroids)
            assert (cb.rotation is None) == (port._codebook.rotation is None)
            if cb.rotation is not None:
                np.testing.assert_array_equal(np.asarray(cb.rotation),
                                              port._codebook.rotation)
        for ix in (ported, back, port, ref):
            ix.set_rerank_source(base)
    for kw in modes:
        want = ref.search(q, k=K, **kw)
        assert_same_results(ported.search(q, k=K, **kw), port.search(
            q, k=K, **kw), exact=True)
        assert_same_results(back.search(q, k=K, **kw), want, exact=True)
        assert_same_results(ported.search(q, k=K, **kw), want, exact=hamming)
    # the host engines' own search (the same engine kind on both sides)
    for qq in base[:3] if not hamming else []:
        for a, b in zip(ported.search_cpu(qq, k=5), back.search_cpu(qq, k=5)):
            np.testing.assert_array_equal(a, b)


def test_load_v1_snapshot_fixture():
    """The checked-in HEADER_VERSION=1 snapshot loads (upgrade on load)."""
    ix = load_snapshot(str(FIXTURE))
    assert ix.n == 50 and ix.p.dim == 16 and ix.p.m == 8
    validate(ix).raise_if_failed()
    _, state = load_snapshot(str(FIXTURE), return_log_state=True)
    assert state == (0, 0)  # v1 has no log bookkeeping: replay everything
    ix2 = load(FIXTURE)
    assert ix2.size == 50
    d, labels = ix2.search(np.asarray(ix.vectors[3]), k=1, ef=32)
    assert labels[0, 0] == 3 and d[0, 0] < 1e-4


_BF16_PROBE = textwrap.dedent("""
    import sys
    sys.modules["ml_dtypes"] = None  # any import of it now fails
    import numpy as np
    import lantern_tpu_torch
    from lantern_tpu_torch.storage import load_snapshot
    path, want = sys.argv[1], np.load(sys.argv[2])
    for engine in ("native", "python"):
        eng = load_snapshot(path, engine=engine)
        got = np.asarray(eng.vectors[:eng.n])
        assert got.dtype == np.float32 and np.array_equal(got, want), engine
    ix = lantern_tpu_torch.Index.load(path, device="cpu")
    d, lab = ix.search(want[:4], k=1, mode="flat")
    assert (lab[:, 0] == np.arange(4)).all(), lab
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "lantern_tpu"))
    assert not bad, bad
    print("bf16 ok")
""")


def test_bf16_snapshot_of_reference_loads_without_ml_dtypes(tmp_path):
    """A snapshot whose rows the reference tagged "bfloat16" (its bf16
    tables) loads in a process that cannot import ml_dtypes: the bits are
    widened to f32 exactly."""
    import ml_dtypes

    from lantern_tpu.config import HnswParams as RefParams
    from lantern_tpu.graph.host_build import HostHnsw as RefHostHnsw

    rng = np.random.default_rng(22)
    base = rng.standard_normal((120, 16)).astype(np.float32)
    h = RefHostHnsw(RefParams(dim=16, m=6, ef_construction=24), seed=2)
    h.add(base)
    h.vectors = h.vectors.astype(ml_dtypes.bfloat16)
    path = tmp_path / "bf16.ldb"
    jax_ref().storage.snapshot.save_snapshot(h, str(path))
    assert b"bfloat16" in path.read_bytes()
    want = h.vectors[:h.n].astype(np.float32)
    np.save(tmp_path / "want.npy", want)
    out = subprocess.run(
        [sys.executable, "-c", _BF16_PROBE, str(path), str(tmp_path / "want.npy")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "bf16 ok" in out.stdout


# ---- tests/test_storage.py's cases through the port ----

@pytest.fixture(scope="module")
def small_engine():
    rng = np.random.default_rng(50)
    base = rng.standard_normal((1200, 24)).astype(np.float32)
    ix = NativeHnsw(HnswParams(dim=24, m=8, ef_construction=48),
                    capacity=1200, seed=7)
    ix.add(base, nthreads=1)
    return ix, base


def test_validate_good_graph(small_engine):
    ix, _ = small_engine
    rep = validate(ix, full=True)
    rep.raise_if_failed()
    assert rep.n_reachable >= 0.98 * rep.n


def test_validate_catches_corruption():
    import copy

    rng = np.random.default_rng(51)
    h = HostHnsw(HnswParams(dim=8, m=4, ef_construction=16), seed=1)
    h.add(rng.standard_normal((300, 8)).astype(np.float32))
    bad = copy.deepcopy(h)
    bad.neighbors0[5, 0] = 299999  # out of range
    assert not validate(bad).ok
    bad2 = copy.deepcopy(h)
    bad2.counts0[3] = 99
    assert not validate(bad2).ok
    bad3 = copy.deepcopy(h)
    bad3.neighbors0[7, 0] = 7  # self loop
    assert not validate(bad3, full=False).ok
    bad4 = copy.deepcopy(h)
    ups = np.nonzero(bad4.levels[: bad4.n] >= 1)[0]
    bad4.upper_slot[ups[0]] = bad4.n_upper + 99  # slot out of range
    rep = validate(bad4)
    assert not rep.ok and any("out of range" in e for e in rep.errors)


def test_snapshot_roundtrip(small_engine, tmp_path):
    ix, base = small_engine
    path = str(tmp_path / "ix.ldb")
    save_snapshot(ix, path)
    for engine in ("native", "python"):
        ix2 = load_snapshot(path, engine=engine)
        assert_engines_equal(ix2, ix)
        ids1, d1 = ix.search(base[3], k=5, ef=32)
        ids2, d2 = ix2.search(base[3], k=5, ef=32)
        np.testing.assert_array_equal(ids1, ids2)
        validate(ix2).raise_if_failed()


def test_snapshot_version_and_magic_check(small_engine, tmp_path):
    ix, _ = small_engine
    path = tmp_path / "bad.ldb"
    save_snapshot(ix, str(path))
    raw = bytearray(path.read_bytes())
    raw[4:8] = struct.pack("<I", 999)
    path.write_bytes(raw)
    with pytest.raises(ValueError, match="rebuild"):
        load_snapshot(str(path))
    raw[0:4] = struct.pack("<I", 0xDEADBEEF)
    path.write_bytes(raw)
    with pytest.raises(ValueError, match="magic"):
        load_snapshot(str(path))


def test_snapshot_crc_detects_corruption(small_engine, tmp_path):
    ix, _ = small_engine
    path = tmp_path / "corrupt.ldb"
    save_snapshot(ix, str(path))
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(raw)
    with pytest.raises(ValueError, match="crc"):
        load_snapshot(str(path))


def test_snapshot_truncation_always_clean_error(small_engine, tmp_path):
    ix, _ = small_engine
    path = tmp_path / "full.ldb"
    save_snapshot(ix, str(path))
    raw = path.read_bytes()
    rng = np.random.default_rng(70)
    cuts = sorted(set([3, 7, 8, 20, len(raw) - 1]
                      + [int(x) for x in rng.integers(1, len(raw), size=12)]))
    for cut in cuts:
        p = tmp_path / f"cut{cut}.ldb"
        p.write_bytes(raw[:cut])
        with pytest.raises(ValueError):
            load_snapshot(str(p))


def test_save_writes_current_header(small_engine, tmp_path):
    ix, _ = small_engine
    path = str(tmp_path / "cur.ldb")
    save_snapshot(ix, path, log_state=(1234, 7))
    _, version = struct.unpack("<II", open(path, "rb").read(8))
    assert version == HEADER_VERSION == 3
    _, state = load_snapshot(path, return_log_state=True)
    assert state == (1234, 7)
    # the reference reads the port's header the same way
    ref_snapshot = jax_ref().storage.snapshot
    _, state = ref_snapshot.load_snapshot(path, return_log_state=True)
    assert state == (1234, 7)


def test_insert_log_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "wal.log")
    log = InsertLog(path, width=4)
    vecs = np.arange(12, dtype=np.float32).reshape(3, 4)
    log.append(vecs, np.array([10, 11, 12], np.uint64))
    log.close()
    v, lab = InsertLog.replay(path, 4)
    np.testing.assert_array_equal(v, vecs)
    np.testing.assert_array_equal(lab, [10, 11, 12])
    with open(path, "ab") as f:
        f.write(b"\x01\x02\x03")  # torn tail
    v, lab = InsertLog.replay(path, 4)
    assert len(v) == 3
    # reopening truncates the torn tail before appending
    log2 = InsertLog(path, width=4)
    assert log2.count == 3
    log2.append(np.full((1, 4), 9.0, np.float32), np.array([13], np.uint64))
    log2.close()
    v, lab = InsertLog.replay(path, 4)
    assert len(v) == 4 and lab[-1] == 13
    # a corrupt last payload fails its crc: the record is dropped
    raw = bytearray(open(path, "rb").read())
    raw[-5] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    v, lab = InsertLog.replay(path, 4)
    assert len(v) == 3


def test_insert_log_v1_adoption_mints_generation(tmp_path):
    path = str(tmp_path / "v1.log")
    vec = np.arange(4, dtype=np.float32)
    with open(path, "wb") as f:
        f.write(struct.pack("<II", _LOG_MAGIC, 1))  # v1: no generation
        raw = vec.tobytes()
        f.write(struct.pack(_LOG_REC_HDR, 7, len(raw), zlib.crc32(raw)))
        f.write(raw)
    log = InsertLog(path, 4, np.float32)
    assert log.generation != 0 and log.count == 1
    log.close()
    vecs, labels = InsertLog.replay(path, 4, np.float32)
    np.testing.assert_array_equal(vecs[0], vec)
    assert labels[0] == 7
    vecs2, _ = InsertLog.replay(path, 4, np.float32,
                                snapshot_state=(log.generation, 1))
    assert len(vecs2) == 0  # the folded record is skipped


def test_insert_log_torn_header_recovers(tmp_path):
    for nbytes in (3, 11):
        path = str(tmp_path / f"torn{nbytes}.log")
        InsertLog(path, 4, np.float32).close()
        with open(path, "r+b") as f:
            f.truncate(nbytes)
        vecs, _ = InsertLog.replay(path, 4, np.float32)
        assert len(vecs) == 0
        log = InsertLog(path, 4, np.float32)
        assert log.generation != 0
        log.append(np.ones((1, 4), np.float32), np.array([9], np.uint64))
        log.close()
        vecs, labels = InsertLog.replay(path, 4, np.float32)
        assert len(vecs) == 1 and labels[0] == 9


def test_log_future_version_refused(tmp_path):
    path = str(tmp_path / "v9.log")
    with open(path, "wb") as f:
        f.write(struct.pack("<IIQ", _LOG_MAGIC, 9, 42))
    with pytest.raises(ValueError, match="newer than supported"):
        InsertLog(path, 8)
    with pytest.raises(ValueError, match="newer than supported"):
        InsertLog.replay(path, 8)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_replay_ops_across_packages(tmp_path, writer):
    """A log of adds and deletes written by either package replays to the
    same ops in both, with and without a snapshot state."""
    rng = np.random.default_rng(23)
    vecs = rng.standard_normal((9, 6)).astype(np.float32)
    path = str(tmp_path / "x.log")
    ref_snapshot = jax_ref().storage.snapshot
    mod = ref_snapshot if writer == "reference" else lantern_tpu_torch.storage
    log = mod.InsertLog(path, 6)
    log.append(vecs[:5], np.arange(5, dtype=np.uint64))
    log.append_delete(np.array([1, 3], np.uint64))
    log.append(vecs[5:], np.arange(5, 9, dtype=np.uint64) + 100)
    gen = log.generation
    log.close()
    for state in (None, (gen, 4), (gen + 1, 4)):
        got = InsertLog.replay_ops(path, 6, snapshot_state=state)
        want = ref_snapshot.InsertLog.replay_ops(path, 6,
                                                 snapshot_state=state)
        assert [op[:2] for op in got] == [op[:2] for op in want]
        for a, b in zip(got, want):
            if a[0] == "add":
                np.testing.assert_array_equal(a[2], b[2])
    assert [op[0] for op in got].count("del") == 2


def test_index_facade_end_to_end(tmp_path):
    rng = np.random.default_rng(52)
    base = rng.standard_normal((600, 16)).astype(np.float32)
    ix = Index(HnswParams(dim=16, m=8, ef_construction=48), capacity=64)
    ix.add(base[:500], labels=np.arange(500, dtype=np.uint64) + 1000, nthreads=1)
    assert ix.size == 500
    d, labels = ix.search(base[:4], k=3, ef=32)
    assert labels[0, 0] == 1000 and d[0, 0] < 1e-3
    assert ix.delete(np.array([1000], np.uint64)) == 1
    assert ix.num_deleted == 1
    _, labels = ix.search(base[:1], k=3, ef=32)
    assert 1000 not in labels[0]
    path = str(tmp_path / "facade.ldb")
    ix.save(path)
    ix2 = load(path)
    assert ix2.size == 500 and ix2.num_deleted == 1
    _, labels2 = ix2.search(base[:4], k=3, ef=32)
    np.testing.assert_array_equal(labels[0], labels2[0])
    ix2.validate().raise_if_failed()


def test_index_crash_resume_via_log(tmp_path):
    rng = np.random.default_rng(53)
    base = rng.standard_normal((300, 8)).astype(np.float32)
    snap, wal = str(tmp_path / "ix.ldb"), str(tmp_path / "ix.log")
    ix = Index(HnswParams(dim=8, m=4, ef_construction=16), capacity=512,
               log_path=wal)
    ix.add(base[:200], nthreads=1)
    ix.save(snap)  # truncates the log
    ix.add(base[200:], nthreads=1)  # only in the log
    del ix  # crash: no save
    ix2 = load(snap, log_path=wal, extra_capacity=256)
    assert ix2.size == 300
    d, labels = ix2.search(base[250:251], k=1, ef=16)
    assert labels[0, 0] == 250 and d[0, 0] < 1e-3
    ix2.validate().raise_if_failed()


@pytest.mark.parametrize("args", [(1_000_000, 128, 16, 64, 256),
                                  (5_000, 960, 8, 200, 64, 4, 2),
                                  (1, 8, 2, 1, 1)])
def test_cost_model_matches_reference(args):
    from lantern_tpu import costmodel as ref

    got, want = estimate_search_cost(*args), ref.estimate_search_cost(*args)
    for field in ("expected_levels", "expected_visited", "expected_iters",
                  "hbm_bytes_per_batch", "flops_per_batch", "summary"):
        assert getattr(got, field) == getattr(want, field), field
    assert "visited" in got.summary
    assert estimate_build_rows(args[2], args[0]) == ref.estimate_build_rows(
        args[2], args[0])
    assert estimate_build_rows(0, 0) == ref.estimate_build_rows(0, 0) == 1


def test_crash_atomicity_failure_points(tmp_path, rng):
    """A crash mid-save keeps the previous snapshot; a crash mid-append
    leaves a torn record that replay discards."""
    base = rng.standard_normal((100, 8)).astype(np.float32)
    snap, wal = str(tmp_path / "a.ldb"), str(tmp_path / "a.log")
    ix = Index(HnswParams(dim=8, m=4, ef_construction=16), capacity=256,
               log_path=wal)
    ix.add(base[:50], nthreads=1)
    ix.save(snap)
    try:
        ix.add(base[50:60], nthreads=1)
        failure_point_enable("save_snapshot", "before_rename")
        with pytest.raises(FailurePointError):
            ix.save(snap)
        failure_point_disable_all()
        assert load(snap).size == 50  # the old snapshot survives
        failure_point_enable("insert_log_append", "mid_record",
                             dont_trigger_first_nr=5)
        with pytest.raises(FailurePointError):
            ix.add(base[60:70], nthreads=1)
        failure_point_disable_all()
        recovered = load(snap, log_path=wal, extra_capacity=64)
        # 50 in the snapshot + 50..59; the 5 records before the torn one
        # sit in the writer's file buffer (the add never returned), on disk
        # or not depending on when it flushes
        assert recovered.size in (60, 65)
        recovered.validate().raise_if_failed()
    finally:
        failure_point_disable_all()


def test_crash_between_snapshot_and_log_truncate(tmp_path, rng):
    base = rng.standard_normal((80, 8)).astype(np.float32)
    snap, wal = str(tmp_path / "b.ldb"), str(tmp_path / "b.log")
    ix = Index(HnswParams(dim=8, m=4, ef_construction=16), capacity=256,
               log_path=wal)
    ix.add(base, nthreads=1)
    try:
        failure_point_enable("index_save", "before_log_truncate")
        with pytest.raises(FailurePointError):
            ix.save(snap)
    finally:
        failure_point_disable_all()
    del ix
    # the log still holds all 80 records, folded by the snapshot's state
    recovered = load(snap, log_path=wal, extra_capacity=64)
    assert recovered.size == 80
    assert len(np.unique(np.asarray(recovered._eng.labels[:80]))) == 80
    recovered.validate().raise_if_failed()
    recovered.add(base[:5] + 100.0, nthreads=1)
    del recovered
    assert load(snap, log_path=wal, extra_capacity=64).size == 85


def test_delete_is_wal_logged(tmp_path):
    rng = np.random.default_rng(71)
    base = rng.standard_normal((120, 8)).astype(np.float32)
    log, snap = str(tmp_path / "ix.log"), str(tmp_path / "ix.ldb")
    ix = Index(HnswParams(dim=8, m=4, ef_construction=16), capacity=128,
               log_path=log)
    ix.add(base[:100], nthreads=1)
    ix.save(snap)
    ix.add(base[100:110], labels=np.arange(100, 110, dtype=np.uint64), nthreads=1)
    ix.delete(np.array([5, 105], np.uint64))
    ix.add(base[110:], labels=np.arange(110, 120, dtype=np.uint64), nthreads=1)
    del ix  # crash: no save()
    ix2 = load(snap, log_path=log)
    assert ix2.size == 120 and ix2.num_deleted == 2
    _, labels = ix2.search(base[5], k=3, ef=32)
    assert 5 not in labels[0].tolist() and 105 not in labels[0].tolist()
    _, labels = ix2.search(base[115], k=1, ef=32)
    assert labels[0, 0] == 115
    ix2.save(snap)
    ix3 = load(snap, log_path=log)
    assert ix3.size == 120 and ix3.num_deleted == 2


def test_log_recovers_before_first_save(tmp_path):
    rng = np.random.default_rng(72)
    base = rng.standard_normal((40, 8)).astype(np.float32)
    log = str(tmp_path / "first.log")
    p = HnswParams(dim=8, m=4, ef_construction=16)
    ix = Index(p, capacity=64, log_path=log)
    ix.add(base, nthreads=1)
    ix.delete(np.array([3], np.uint64))
    del ix  # crash: no snapshot exists
    ix2 = Index(p, capacity=64, log_path=log)
    assert ix2.size == 40 and ix2.num_deleted == 1
    _, labels = ix2.search(base[5], k=1, ef=16)
    assert labels[0, 0] == 5
    snap = str(tmp_path / "first.ldb")
    ix2.save(snap)
    ix3 = load(snap, log_path=log)
    assert ix3.size == 40 and ix3.num_deleted == 1


def test_reference_writer_crash_recovers_in_port(tmp_path):
    """The reference writes a snapshot and logs adds and deletes after it,
    then crashes; the port recovers the same rows and tombstones."""
    rng = np.random.default_rng(73)
    base = rng.standard_normal((150, 8)).astype(np.float32)
    snap, log = str(tmp_path / "r.ldb"), str(tmp_path / "r.log")
    p = HnswParams(dim=8, m=4, ef_construction=16)
    ref = jax_ref().Index(p, capacity=256, log_path=log)
    ref.add(base[:100], nthreads=1)
    ref.save(snap)
    ref.add(base[100:], nthreads=1)
    ref.delete(np.array([7, 120], np.uint64))
    del ref  # crash
    want = jax_ref().Index.load(snap, log_path=str(tmp_path / "copy.log"))
    ix = load(snap, log_path=log)
    assert (ix.size, ix.num_deleted) == (150, 2)
    np.testing.assert_array_equal(np.asarray(ix._eng.labels[:150]),
                                  np.arange(150, dtype=np.uint64))
    assert want.size == 100  # the snapshot alone
    d, lab = ix.search(base[[7, 120, 130]], k=1, mode="flat")
    assert lab[0, 0] != 7 and lab[1, 0] != 120 and lab[2, 0] == 130


def test_rerank_refuses_misaligned_rows(tmp_path):
    """After load + add, the rerank rows cover only the post-load slots:
    rerank refuses instead of reading wrong rows."""
    rng = np.random.default_rng(64)
    base = rng.standard_normal((300, 32)).astype(np.float32)
    p = HnswParams(dim=32, m=8, ef_construction=48, pq=True,
                   num_subvectors=8, num_centroids=32)
    ix = Index(p, capacity=300)
    ix.train_pq(base)
    ix.add(base, nthreads=1)
    path = str(tmp_path / "pq.ldb")
    ix.save(path)
    ix2 = load(path)
    extra = rng.standard_normal((20, 32)).astype(np.float32)
    ix2.add(extra, labels=np.arange(1000, 1020, dtype=np.uint64), nthreads=1)
    with pytest.raises(ValueError, match="slot-aligned"):
        ix2.search(base[0], k=5, rerank=50)
    ix2.set_rerank_source(np.concatenate([base, extra]))
    _, labels = ix2.search(base[7], k=5, rerank=50)
    assert labels[0, 0] == 7


def test_python_engine_facade(tmp_path):
    """Index(engine="python") adds, deletes, logs, saves and loads like the
    native one; build="device" needs the native engine."""
    rng = np.random.default_rng(74)
    base = rng.standard_normal((200, 8)).astype(np.float32)
    p = HnswParams(dim=8, m=4, ef_construction=16)
    snap, log = str(tmp_path / "py.ldb"), str(tmp_path / "py.log")
    ix = Index(p, capacity=8, engine="python", log_path=log)
    ix.add(base[:150], nthreads=1)
    ix.save(snap)
    ix.add(base[150:], nthreads=1)
    ix.delete(np.array([3], np.uint64))
    with pytest.raises(ValueError, match="native engine"):
        ix.add(base[:2], build="device")
    d, lab = ix.search(base[:5], k=1, mode="graph")
    del ix
    for engine in ("python", "native"):
        ix2 = load(snap, log_path=log, engine=engine)
        assert (ix2.size, ix2.num_deleted) == (200, 1)
        assert ix2._engine_kind == engine
        np.testing.assert_array_equal(ix2.search(base[5:9], k=1)[1][:, 0],
                                      np.arange(5, 9))
    with pytest.raises(ValueError, match="unknown engine"):
        Index(p, engine="rust")


def test_search_takes_recall_target_sixth():
    """The reference's positional search(q, k, ef, params, mode,
    recall_target) means the same in the port (the target is ignored: the
    port's top-k is exact)."""
    rng = np.random.default_rng(75)
    base = rng.standard_normal((400, 16)).astype(np.float32)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    p = HnswParams(dim=16, m=8, ef_construction=32)
    ref = jax_ref().Index(p, capacity=400)
    port = Index(p, capacity=400)
    for ix in (ref, port):
        ix.add(base, nthreads=1)
    want = ref.search(q, 10, None, None, "flat", 0.9)
    got = port.search(q, 10, None, None, "flat", 0.9)
    assert_same_results(got, want)
    assert_same_results(port.search(q, 10, mode="flat", recall_target=0.5),
                        got, exact=True)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["native", "python"])
def test_save_load_search_on_card(cuda, tmp_path, engine):
    """On the card a loaded index searches exactly as the one that wrote
    it: the same engine arrays through the same kernels."""
    rng = np.random.default_rng(76)
    c = rng.standard_normal((16, 32)).astype(np.float32)
    base = (c[rng.integers(0, 16, 3000)]
            + 0.3 * rng.standard_normal((3000, 32))).astype(np.float32)
    q = (c[rng.integers(0, 16, 64)]
         + 0.3 * rng.standard_normal((64, 32))).astype(np.float32)
    ix = lantern_tpu_torch.Index(HnswParams(dim=32, m=8, ef_construction=48),
                                 capacity=3000, device=cuda)
    ix.add(base, nthreads=1)
    ix.delete(np.arange(0, 3000, 13, dtype=np.uint64))
    path = str(tmp_path / "card.ldb")
    ix.save(path)
    ix2 = lantern_tpu_torch.Index.load(path, engine=engine, device=cuda)
    assert ix2.device_graph.device.type == "cuda"
    for mode in ("flat", "graph"):
        d, lab = ix.search(q, k=K, mode=mode)
        d2, lab2 = ix2.search(q, k=K, mode=mode)
        np.testing.assert_array_equal(lab2, lab)
        np.testing.assert_array_equal(d2, d)
