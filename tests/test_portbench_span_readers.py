"""The benchmark's readers of the program's spans
(``portbench/metrics/{dispatch.host_ms,flat.score_ms,search.idle_ms}.py``)
on synthetic trace records, each against a value computed by hand.

A record without the spans (the trace of a program that has none) and a
run without a trace read None.
"""

import pytest

from portbench import spec, trace

READERS = ("dispatch.host_ms", "flat.score_ms", "search.idle_ms")
CELLS = ["sift1m.auto", "cohere1m-b1.auto"]
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
