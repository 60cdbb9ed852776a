"""The benchmark's readers of the program's spans
(``portbench/metrics/{dispatch.host_ms,flat.score_ms,search.idle_ms,
flat.scale_ms,flat.score_roofline,flat.select_ms}.py``) on synthetic trace
records, each
against a value computed by hand, and the score block's operations and
bytes (``portbench/roofline/score_block.py``).

A record without the spans (the trace of a program that has none) and a
run without a trace read None, never 0.
"""

import pytest

from portbench import spec, trace

READERS = ("dispatch.host_ms", "flat.score_ms", "search.idle_ms")
CELLS = ["sift1m.auto", "cohere1m-b1.auto"]
# the cosine cell's readers
COS_READERS = ("flat.scale_ms", "flat.score_roofline")
COS_CELLS = ["openai1m.auto"]
iv = trace.Interval


class _Ctx:
    def __init__(self, rec):
        self.record, self.root = rec, spec.ROOT


def _read(name, rec):
    return spec.load_module(spec.ROOT, "metrics", name).read(_Ctx(rec))


def _rec(spans=True):
    """Two calls in the window [1, 2]: ``search`` [1.0, 1.4] and
    [1.5, 1.9]. Device: 1.02-1.20 and a copy 1.38-1.45 across the first
    span's end; 1.45-1.53 across the second's start, then 1.52-1.70."""
    device = [iv("sgemm", 1.02, 1.10), iv("topk", 1.10, 1.20),
              iv("Memcpy DtoH", 1.38, 1.45), iv("hamming_kernel", 1.45, 1.53),
              iv("topk", 1.52, 1.70), iv("outside", 5.0, 6.0)]
    host = [iv("portbench.call", 1.0, 1.45), iv("portbench.call", 1.5, 1.95),
            iv("aten::topk", 1.1, 1.15)]
    if spans:
        host += [iv("search", 1.0, 1.4), iv("search.dispatch", 1.0, 1.02),
                 iv("search", 1.1, 1.2),  # a nested search: counted once
                 iv("flat.score", 1.03, 1.05), iv("search", 1.5, 1.9),
                 iv("search.dispatch", 1.5, 1.51),
                 iv("flat.score", 1.51, 1.52),
                 # outside the window: not read
                 iv("search", 4.0, 4.5), iv("search.dispatch", 4.0, 4.3)]
    dev = {"aten::topk": 0.28}
    if spans:
        dev.update({"flat.score": 0.16, "search": 0.46})
    return trace.Record(2, iv(trace.WINDOW_SPAN, 1.0, 2.0), device, host,
                        dev, {})


def test_dispatch_host_ms_sums_the_spans_in_the_window():
    assert _read("dispatch.host_ms", _rec()) == pytest.approx(
        (0.02 + 0.01) * 1e3 / 2, abs=1e-9)


def test_flat_score_ms_is_the_kernels_under_the_span():
    assert _read("flat.score_ms", _rec()) == pytest.approx(0.16 * 1e3 / 2,
                                                           abs=1e-9)


def test_search_idle_ms_clips_the_device_to_each_span():
    # first span: busy 1.02-1.20 and 1.38-1.40 (clipped) -> idle 0.40 - 0.20
    # second: busy 1.50-1.70 (1.45-1.53 clipped, merged) -> idle 0.40 - 0.20
    assert _read("search.idle_ms", _rec()) == pytest.approx(
        (0.20 + 0.20) * 1e3 / 2, abs=1e-9)


def test_search_idle_ms_of_a_span_with_no_device_work():
    rec = _rec()
    rec.device = []
    assert _read("search.idle_ms", rec) == pytest.approx(
        (0.4 + 0.4) * 1e3 / 2, abs=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_span(name):
    assert _read(name, _rec(spans=False)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_trace(name):
    assert _read(name, None) is None


@pytest.mark.parametrize("name", READERS)
def test_benchmark_lists_the_reader(name):
    entry = next(m for m in spec.benchmark()["per_layer"]
                 if m["name"] == name)
    assert entry["workloads"] == CELLS
    assert entry["unit"] == "ms/batch" and entry["source"] == "device_trace"
    for cell in CELLS:
        assert name in [m["name"] for m in spec.cell(cell).per_layer]


def _tensor(shape, itemsize=4):
    return {"shape": shape, "itemsize": itemsize}


# ``flat._scores(vectors, sq_norms, queries_f32, metric, vec_scales,
# excluded)`` at openai1m.auto's block: 1M x 1536 f32 rows, 1024 queries,
# the tombstone mask
SCORE_CALL = {"args": [_tensor((1_000_000, 1536)), _tensor((1_000_000,)),
                       _tensor((1024, 1536)), 1, None,
                       _tensor((1_000_000,), 1)], "kwargs": {}}


def _cos_rec(scale=True, score=True, calls=2):
    rec = _rec()
    if scale:
        rec.host_device_s["flat.scale"] = 0.01
    if not score:
        del rec.host_device_s["flat.score"]
    rec.launches = {"score": [SCORE_CALL] * calls}
    return rec


def test_score_block_operations_and_bytes():
    roof = spec.load_module(spec.ROOT, "roofline", "score_block")
    ops, kind, nbytes = roof.cost(SCORE_CALL)
    assert kind == "tf32" and ops == 2 * 1024 * 1_000_000 * 1536
    assert round(ops / 1e12, 3) == 3.146
    assert round(nbytes / 1e9, 2) == 10.25
    peaks = spec.load_module(spec.ROOT, "roofline", "peaks")
    # bound by its operations: 6.36 ms against the bytes' 3.06 ms
    assert round(peaks.bound_s(ops, kind, nbytes) * 1e3, 2) == 6.36
    assert round(nbytes / peaks.HBM_BYTES_PER_S * 1e3, 2) == 3.06
    # no mask, bf16 rows: the mask's N bytes go, the rows' halve
    bare = {"args": [_tensor((1_000_000, 1536), 2), _tensor((1_000_000,)),
                     _tensor((1024, 1536))], "kwargs": {"metric": 1}}
    assert roof.cost(bare)[2] == nbytes - 1_000_000 - 1_000_000 * 1536 * 2
    empty = {"args": [_tensor((0, 1536)), _tensor((0,)),
                      _tensor((1024, 1536)), 1], "kwargs": {}}
    assert roof.cost(empty) is None


def test_flat_scale_ms_is_the_kernels_under_the_span():
    assert _read("flat.scale_ms", _cos_rec()) == pytest.approx(
        0.01 * 1e3 / 2, abs=1e-9)


def test_flat_score_roofline_is_the_bounds_over_the_span():
    # two blocks' least times over the 0.16 s under ``flat.score``
    bound = 2 * 2 * 1024 * 1_000_000 * 1536 / 495e12
    assert _read("flat.score_roofline", _cos_rec()) == pytest.approx(
        100 * bound / 0.16, rel=1e-12)


@pytest.mark.parametrize("name,rec", [
    ("flat.scale_ms", _cos_rec(scale=False)),  # an l2sq or parent's trace
    ("flat.scale_ms", _rec(spans=False)),
    ("flat.score_roofline", _cos_rec(score=False)),
    ("flat.score_roofline", _cos_rec(calls=0)),  # no block probed
    ("flat.score_roofline", _rec(spans=False))],
    ids=["scale-absent", "scale-empty", "roofline-no-span",
         "roofline-no-block", "roofline-empty"])
def test_cos_readers_none_where_nothing_was_recorded(name, rec):
    assert _read(name, rec) is None


@pytest.mark.parametrize("name", COS_READERS)
def test_cos_readers_none_without_a_trace(name):
    assert _read(name, None) is None


@pytest.mark.parametrize("name", COS_READERS)
def test_benchmark_lists_the_cos_reader(name):
    entry = next(m for m in spec.benchmark()["per_layer"]
                 if m["name"] == name)
    assert entry["workloads"] == COS_CELLS
    assert entry["source"] == "device_trace"
    assert entry["layer"] == "flat scan (flat.py)"
    for cell in COS_CELLS:
        assert name in [m["name"] for m in spec.cell(cell).per_layer]
    for cell in CELLS:
        assert name not in [m["name"] for m in spec.cell(cell).per_layer]


# the select's reader, in every cell: it reads ``flat.topk`` (torch.topk's
# kernels on a program before the row_topk kernel, row_topk's after it)
SELECT_CELLS = CELLS + COS_CELLS


def test_flat_select_ms_is_the_kernels_under_the_span():
    rec = _rec()
    rec.host_device_s["flat.topk"] = 0.05
    assert _read("flat.select_ms", rec) == pytest.approx(0.05 * 1e3 / 2,
                                                         abs=1e-9)


def test_flat_select_ms_none_without_the_span_or_a_trace():
    assert _read("flat.select_ms", _rec()) is None
    assert _read("flat.select_ms", None) is None


def test_benchmark_lists_the_select_reader():
    entry = next(m for m in spec.benchmark()["per_layer"]
                 if m["name"] == "flat.select_ms")
    assert entry["workloads"] == SELECT_CELLS
    assert entry["unit"] == "ms/batch" and entry["source"] == "device_trace"
    assert entry["layer"] == "flat scan (flat.py)" and entry["moves"] == "qps"
    for cell in SELECT_CELLS:
        assert "flat.select_ms" in [m["name"] for m in spec.cell(cell).per_layer]
