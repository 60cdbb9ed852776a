"""The program's spans (``utils/bench.py::span``) inside ``Index.search``,
the flat scan and the beam.

Under a recording ``torch.profiler`` session each span is a
``record_function``, nested as the calls nest; with no session and the
LanternBench counters off a span enters nothing; with the counters on it
counts each entry once. The results are the same bits whichever is on. The
``cuda`` case profiles a search on the card and holds the benchmark's trace
reader (``portbench/trace.py``) to keeping no span's device image as work.
"""

import math

import numpy as np
import pytest
import torch

import lantern_tpu_torch
from lantern_tpu_torch.config import HnswParams, Metric, QuantKind
from lantern_tpu_torch.graph.search import _CHECK_EVERY
from lantern_tpu_torch.utils import bench

K = 10
SPANS = {"search", "search.upload", "search.filter", "search.dispatch",
         "search.flat", "search.graph", "search.rerank", "search.results",
         "flat.score", "flat.scale", "flat.topk", "beam.entry",
         "beam.iter"}
MODES = {"auto": dict(), "graph": dict(mode="graph"),
         "rerank": dict(rerank=40)}


def _data(seed=3, n=1200, dim=32, nq=24):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((20, dim)).astype(np.float32)
    base = c[rng.integers(0, 20, n)] + 0.35 * rng.standard_normal((n, dim))
    q = c[rng.integers(0, 20, nq)] + 0.35 * rng.standard_normal((nq, dim))
    return base.astype(np.float32), q.astype(np.float32)


def _index(device, pq=False, n=1200, **kw):
    base, q = _data(n=n)
    if pq:
        kw.update(pq=True, num_subvectors=8, num_centroids=32)
    ix = lantern_tpu_torch.Index(HnswParams(dim=32, m=8, ef_construction=48,
                                            **kw),
                                 capacity=256, seed=0, device=device)
    ix.add(base, nthreads=1)
    return ix, q


@pytest.fixture(scope="module")
def indexes():
    f32, q = _index("cpu")
    pq, _ = _index("cpu", pq=True)
    return {"auto": f32, "graph": f32, "rerank": pq}, q


@pytest.fixture
def counters_off(monkeypatch):
    monkeypatch.setattr(bench, "_enabled", False)


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _tree(events):
    """(span, its nearest enclosing span or None) in start order."""
    out = []
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.name not in SPANS:
            continue
        p = e.cpu_parent
        while p is not None and p.name not in SPANS:
            p = p.cpu_parent
        out.append((e.name, None if p is None else p.name))
    return out


def _children(tree, parent):
    return [name for name, p in tree if p == parent]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_search_span_tree(indexes, counters_off, mode):
    ixs, q = indexes
    _, events = _profiled(lambda: ixs[mode].search(q, k=K, **MODES[mode]))
    tree = _tree(events)
    assert _children(tree, None) == ["search"]
    inner = {"auto": ["search.dispatch", "search.flat"],
             "graph": ["search.graph"], "rerank": ["search.rerank"]}[mode]
    assert _children(tree, "search") == (["search.upload"] + inner
                                         + ["search.results"])
    for name in ("search.upload", "search.dispatch", "search.results",
                 "flat.score", "flat.topk", "beam.iter"):
        assert _children(tree, name) == []
    if mode == "graph":
        below = _children(tree, "search.graph")
        assert below[0] == "beam.entry" and len(below) > 1
        assert set(below[1:]) == {"beam.iter"}
        # the upper entry scan is a flat scan over the upper level
        assert _children(tree, "beam.entry") == ["flat.score", "flat.topk"]
    else:  # one block: one score, one top-k (the PQ shortlist's ADC scan)
        flat = "search.flat" if mode == "auto" else "search.rerank"
        assert _children(tree, flat) == ["flat.score", "flat.topk"]


def test_filter_span_under_search(indexes, counters_off):
    ixs, q = indexes
    allow = np.arange(600, dtype=np.uint64)
    (_, lab), events = _profiled(
        lambda: ixs["auto"].search(q, k=K, allow_labels=allow))
    assert set(lab.ravel().tolist()) <= set(allow.tolist())
    assert _children(_tree(events), "search") == [
        "search.upload", "search.filter", "search.dispatch", "search.flat",
        "search.results"]


def test_beam_iter_spans_count_the_loop(indexes, counters_off):
    """One ``beam.iter`` a level-0 iteration run: ``with_stats``'s
    iterations (those with a query active), then the no-op ones up to the
    next activity check, within the loop's bound."""
    ixs, q = indexes
    ef = 64
    for rows in (q, q[:1], q[:7]):
        (_, _, stats), events = _profiled(lambda: ixs["graph"].search(
            rows, k=K, ef=ef, mode="graph", with_stats=True))
        iters = int(stats["iterations"])
        ran = sum(1 for e in events if e.name == "beam.iter")
        every = _CHECK_EVERY
        assert iters > 0
        assert ran == min(every * math.ceil(iters / every), 2 * ef + 16)


def test_spans_off_enter_no_record_function(indexes, counters_off,
                                            monkeypatch):
    ixs, q = indexes
    entered = []
    real = bench.record_function

    def counted(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(bench, "record_function", counted)
    for mode, kw in MODES.items():
        ixs[mode].search(q, k=K, **kw)
    assert entered == []
    _profiled(lambda: ixs["auto"].search(q, k=K))  # the patch is live
    assert entered == ["search", "search.upload", "search.dispatch",
                       "search.flat", "flat.score", "flat.topk",
                       "search.results"]


def test_counters_count_each_span_once(indexes, monkeypatch):
    ixs, q = indexes
    monkeypatch.setattr(bench, "_enabled", False)
    bench.reset()
    bench.enable(True)
    try:
        for _ in range(3):
            ixs["auto"].search(q, k=K)
        ixs["graph"].search(q, k=K, mode="graph")
        got = bench.stats()
    finally:
        bench.enable(False)
        bench.reset()
    counts = {name: s["count"] for name, s in got.items()}
    assert counts["search"] == 4 and counts["search.upload"] == 4
    assert counts["search.results"] == 4
    assert counts["search.dispatch"] == counts["search.flat"] == 3
    assert counts["search.graph"] == counts["beam.entry"] == 1
    # three flat scans plus the beam's entry scan, one block each
    assert counts["flat.score"] == counts["flat.topk"] == 4
    assert counts["beam.iter"] > 0 and "search.rerank" not in counts
    assert all(s["total_s"] > 0 for s in got.values())


@pytest.mark.parametrize("kind,scaled", [
    ("cos", True), ("i8", True), ("l2sq", False), ("hamming", False)])
def test_scale_span_inside_score(counters_off, kind, scaled):
    """``flat.scale`` (the column scale and the mask after the GEMM) lies
    inside ``flat.score`` for cosine blocks off the card and i8 blocks, and
    is never entered where the GEMM's epilogue (l2sq) or K4 (hamming) forms
    the block."""
    if kind == "hamming":
        ix, q = _hamming_index("cpu")
    else:
        kw = {"cos": dict(metric=Metric.COS), "i8": dict(quant=QuantKind.I8),
              "l2sq": {}}[kind]
        ix, q = _index("cpu", **kw)
    _, events = _profiled(lambda: ix.search(q, k=K, mode="flat"))
    tree = _tree(events)
    assert _children(tree, "search.flat") == ["flat.score", "flat.topk"]
    if scaled:
        assert _children(tree, "flat.score") == ["flat.scale"]
        assert _children(tree, "flat.scale") == []
    else:
        assert _children(tree, "flat.score") == []
        assert "flat.scale" not in {name for name, _ in tree}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_results_equal_with_spans_on_and_off(indexes, monkeypatch, mode):
    ixs, q = indexes
    monkeypatch.setattr(bench, "_enabled", False)
    off = ixs[mode].search(q, k=K, **MODES[mode])
    profiled, _ = _profiled(lambda: ixs[mode].search(q, k=K, **MODES[mode]))
    bench.enable(True)
    try:
        counted = ixs[mode].search(q, k=K, **MODES[mode])
    finally:
        bench.enable(False)
        bench.reset()
    for on in (profiled, counted):
        for a, b in zip(off, on):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_launch_record_is_an_op_only_under_a_profiler():
    assert bench.launch("k4.launch") is bench.span("x")  # the shared no-op
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with bench.span("flat.score"), bench.launch("k4.launch"):
            torch.ones(2)
    ev = {e.name: e for e in prof.events()}
    # an op, so the profiler links the kernels it launches to it
    assert not ev["k4.launch"].is_user_annotation
    assert ev["flat.score"].is_user_annotation
    assert ev["k4.launch"].cpu_parent.name == "flat.score"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' device images are read "
                    "from a CUDA trace")
    return torch.device("cuda")


def _hamming_index(device, n=1200, words=8):
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2**32, (n + 24, words), dtype=np.uint64)
    rows = bits.astype(np.uint32)
    ix = lantern_tpu_torch.Index(
        HnswParams(dim=32 * words, m=8, ef_construction=48,
                   metric=Metric.HAMMING, quant=QuantKind.B1),
        capacity=256, seed=0, device=device)
    ix.add(rows[:n], nthreads=1)
    return ix, rows[n:]


@pytest.mark.cuda
def test_span_images_are_no_device_work_on_card(cuda, counters_off):
    """No device interval the benchmark keeps bears a span's name, and each
    span holds the device time of the kernels launched in it, the
    hand-written ones (K1, K4, the PQ decode, the f32 cosine block's
    kernel, which leaves ``flat.scale`` unentered) included, and the passes
    of bf16 cosine and i8 blocks inside ``flat.scale``."""
    from portbench import trace

    ixs = {"f32": _index(cuda), "pq": _index(cuda, pq=True),
           "b1": _hamming_index(cuda), "cos": _index(cuda, metric=Metric.COS),
           "cos_bf16": _index(cuda, metric=Metric.COS, quant=QuantKind.F16),
           "i8": _index(cuda, quant=QuantKind.I8)}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, kw, span, kernel in (
            ("f32", {}, "flat.score", None),
            ("b1", {}, "flat.score", "hamming_kernel"),
            ("f32", dict(mode="graph"), "beam.iter", "gather_dists"),
            ("pq", dict(rerank=40), "flat.score", "pq_decode"),
            ("cos", {}, "flat.score", "cos_block_kernel"),
            ("cos_bf16", {}, "flat.scale", None),
            ("i8", {}, "flat.scale", None)):
        ix, q = ixs[name]
        ix.search(q, k=K, **kw)  # the kernels' builds, outside the trace
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            ix.search(q, k=K, **kw)
            torch.cuda.synchronize()
        rec = trace._record(list(prof.events()), 1, {})
        assert rec.device, "the trace holds the search's kernels"
        assert not SPANS & {e.name for e in rec.device}
        assert SPANS & {e.name for e in rec.host}
        under = rec.host_device_s.get(span, 0.0)
        assert under > 0, (name, span)
        if kernel is not None:
            took = sum(e.end - e.start for e in rec.device
                       if kernel in e.name)
            assert took > 0 and under >= took * (1 - 1e-6), (name, kernel)
        if name == "b1":  # K4's epilogue scores: the span's one kernel
            assert under == pytest.approx(took, rel=1e-6)
        if name == "cos":  # the divide and the mask are the kernel's
            assert "flat.scale" not in rec.host_device_s
