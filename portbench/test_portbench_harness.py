"""Tests of the benchmark's harness, on the CPU at tiny sizes.

    python -m pytest portbench -q -p no:cacheprovider

The card's test (marked ``cuda``) decides inside a fixture and skips here.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import card, control, reference, run, spec, trace

ROOT = spec.ROOT
PKG = ROOT / spec.PACKAGE
CPU = torch.device("cpu")
TINY = {"rows": 600, "queries": 96, "batch": 32}
SEED = 2**31 + 11  # the driver's seeds pass 32 signed bits
FORBIDDEN = set(card.FORBIDDEN)
# files of the yardstick that may not touch the program
PLAIN = ["reference.py", "control.py", "spec.py", "card.py"] + [
    f"{d}/{p.name}" for d in ("data", "roofline")
    for p in sorted((PKG / d).glob("*.py"))]


def _bench():
    return spec.benchmark()


def _workloads():
    return [w["name"] for w in _bench()["workloads"]]


# ---- found by name -------------------------------------------------------

@pytest.mark.parametrize("workload", _workloads())
def test_cell_files_found_by_name(workload):
    cell = spec.cell(workload)
    spec.load_module(ROOT, "data", cell.config["generator"]).make
    spec.load_module(ROOT, "builds", cell.config["build"]).build
    spec.load_module(ROOT, "drivers", cell.traffic["driver"]).Loop
    assert cell.checks, "a cell compares at least one number"
    for m in cell.end_to_end + cell.per_layer:
        reader = spec.load_module(ROOT, "metrics", m["name"])
        assert callable(reader.read)
        for target in getattr(reader, "PROBES", {}).values():
            mod, attr = target.split(":")
            assert callable(getattr(__import__(mod, fromlist=[attr]), attr))
        for name in getattr(reader, "ROOFLINES", {}).values():
            assert spec.load_module(ROOT, "roofline", name).KERNEL


def test_benchmark_names_and_units():
    bench = _bench()
    ok_name = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                  "0123456789_.-")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
        for n in names:
            assert set(n) <= ok_name and len(n) <= 64
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m["unit"]) <= ok_name | set("/%") and len(m["unit"]) <= 16
    assert {m["name"] for m in bench["end_to_end"]} >= {
        "qps", "p95_ms", "recall_at_10", "setup_s"}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_added_as_files_runs(tmp_path):
    """A configuration, a mix, a generator, a build, a filter, a metric, a
    roofline count and a cell added as new files and entries in a copy run
    with no file edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / spec.PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / spec.PACKAGE)
    new = tmp_path / spec.PACKAGE
    (new / "configs" / "uniform8.json").write_text(json.dumps({
        "rows": 400, "queries": 64, "dim": 8, "metric": "l2sq",
        "quant": "f32", "m": 8, "ef_construction": 32, "ef": 16, "k": 10,
        "seeds": 8, "build": "host1", "generator": "uniform",
        "hnsw": {"strict_dim_cap": True}}))
    (new / "builds" / "host1.py").write_text(
        "from portbench import system\n\n\n"
        "def build(cfg, rows, seed, device):\n"
        "    return system.index(cfg, rows, seed, device, build='host',\n"
        "                        nthreads=1)\n")
    (new / "filters").mkdir()
    (new / "filters" / "odd_out.py").write_text(
        "import torch\n\n\n"
        "def make(cfg, traffic, seed, rows):\n"
        "    return torch.arange(rows) % 2 == 0\n")
    (new / "data" / "uniform.py").write_text(
        "import torch\n\n\n"
        "def make(cfg, seed, device, rows, queries):\n"
        "    g = torch.Generator(device=device)\n"
        "    g.manual_seed(seed)\n"
        "    return {'rows': torch.rand((rows, cfg['dim']), generator=g,\n"
        "                               device=device),\n"
        "            'queries': torch.rand((queries, cfg['dim']), generator=g,\n"
        "                                  device=device)}\n")
    (new / "traffic" / "flat32.json").write_text(json.dumps({
        "driver": "closed_loop", "batch": 32, "mode": "flat",
        "warmup_calls": 1, "trace_calls": 2, "params": {"expand": 1},
        "filter": "odd_out"}))
    (new / "checks" / "uniform8.flat32.json").write_text(json.dumps({
        "miss_share": {"limit": 0}}))
    (new / "roofline" / "k9.py").write_text(
        "KERNEL = 'k9_kernel'\n\n\ndef cost(call):\n    return None\n")
    (new / "metrics" / "window.calls.py").write_text(
        "def read(ctx):\n    return len(ctx.window['latencies'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "uniform8", "source": "test",
                             "file": "portbench/configs/uniform8.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "uniform8.flat32", "config": "uniform8",
                               "traffic": "flat32", "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "window.calls", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "driver", "moves": "qps",
        "workloads": ["uniform8.flat32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("uniform8.flat32", root=tmp_path)
    assert spec.load_module(tmp_path, "roofline", "k9").KERNEL == "k9_kernel"
    res = run.run_cell(cell, SEED, 0.2, True, CPU)
    assert res["correct"] and res["metrics"]["window.calls"]["value"] >= 1
    res = run.run_cell(cell, SEED, 0.2, False, CPU)
    assert res["correct"] and set(res["metrics"]) >= {"qps", "p95_ms",
                                                      "recall_at_10",
                                                      "setup_s"}
    assert res["metrics"]["recall_at_10"]["value"] == 1.0
    # the filter holds both sides: the control in the filtered reference's
    # place reads no filtered-out row
    full = control.readings(cell, SEED, CPU, lower=False)
    assert full["correct"] and full["recall"] == 1.0
    after = _digest(tmp_path / spec.PACKAGE)
    assert all(after[f] == h for f, h in before.items())


# ---- the reference -------------------------------------------------------

def _brute(metric, rows, queries, k):
    if metric == "hamming":
        x = np.bitwise_xor(queries[:, None, :].view(np.uint32),
                           rows[None].view(np.uint32))
        d = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.float64)
    else:
        r, q = rows.astype(np.float64), queries.astype(np.float64)
        if metric == "l2sq":
            d = ((q[:, None] - r[None]) ** 2).sum(-1)
        else:
            d = 1 - (q @ r.T) / np.outer(np.linalg.norm(q, axis=1),
                                         np.linalg.norm(r, axis=1))
    return np.sort(d, axis=1)[:, :k]


@pytest.mark.parametrize("metric", ["l2sq", "cos", "hamming"])
def test_reference_against_numpy(metric, monkeypatch):
    monkeypatch.setattr(reference, "ROW_BLOCK", 256)  # several row blocks
    monkeypatch.setattr(reference, "QUERY_BLOCK", 16)
    g = torch.Generator().manual_seed(5)
    if metric == "hamming":
        rows = torch.randint(-2**31, 2**31, (700, 4), generator=g,
                             dtype=torch.int32)
        queries = torch.randint(-2**31, 2**31, (40, 4), generator=g,
                                dtype=torch.int32)
    else:
        rows = torch.randn((700, 12), generator=g)
        queries = torch.randn((40, 12), generator=g)
    d, ids = reference.exact_knn(metric, rows, queries, 10)
    want = _brute(metric, rows.numpy(), queries.numpy(), 10)
    np.testing.assert_allclose(d.numpy(), want, rtol=1e-12, atol=1e-12)
    # the ids hold the distances they are returned with
    np.testing.assert_allclose(
        reference.pair_dist(metric, rows, queries, ids).numpy(), d.numpy(),
        rtol=1e-12, atol=1e-12)


def test_tie_aware_recall_and_misses():
    # one query, rows at hamming distances 0, 1, 1, 1, 2, 3 from it
    q = torch.tensor([[0]], dtype=torch.int32)
    rows = torch.tensor([[0], [1], [2], [4], [3], [7]], dtype=torch.int32)
    kth = torch.tensor([1.0])  # k = 2: the 2nd nearest is at distance 1
    qidx = torch.tensor([0, 0, 0, 0])
    labels = torch.tensor([[0, 3], [2, 1], [0, 4], [1, 1]])
    dists = torch.tensor([[0.0, 1.0], [1.0, 1.0], [0.0, 2.0], [1.0, 1.0]])
    got = reference.compare("hamming", rows, q, kth, qidx, dists, labels)
    # tied rows 1, 2, 3 all count; row 4 (distance 2) does not; a repeated
    # row counts once, its repeat as a miss
    assert got["recall"] == (2 + 2 + 1 + 1) / 8
    assert got["miss_share"] == 2 / 8 and got["dist_gap"] == 0.0
    bad = dists.clone()
    bad[1, 0] = 2.0
    assert reference.compare("hamming", rows, q, kth, qidx, bad,
                             labels)["dist_gap"] == 1.0
    gone = labels.clone()
    gone[3, 1] = 99  # no such row
    out = reference.compare("hamming", rows, q, kth, qidx, dists, gone)
    assert out["dist_gap"] == float("inf") and out["miss_share"] == 2 / 8


# ---- rooflines ------------------------------------------------------------

def _tensor(shape, itemsize=4):
    return {"shape": shape, "itemsize": itemsize}


def test_k4_bytes_reproduce_the_kernel_table():
    k4 = spec.load_module(ROOT, "roofline", "k4")
    dist = {"args": [_tensor((1024, 32)), _tensor((1_000_000, 32)), None,
                     False], "kwargs": {}}
    _, kind, nbytes = k4.cost(dist)
    assert round(nbytes / 1e9, 2) == 4.22 and kind == "int8"
    score = {"args": [_tensor((1024, 32)), _tensor((1_000_000, 32)),
                      _tensor((1_000_000,), 1)], "kwargs": {"scores": True}}
    assert k4.cost(score)[2] == nbytes + 1_000_000
    peaks = spec.load_module(ROOT, "roofline", "peaks")
    # bytes bound it: 1.26 ms against the int8 work's 1.06 ms
    assert round(peaks.bound_s(*k4.cost(dist)) * 1e3, 2) == 1.26


# ---- the trace's reading ---------------------------------------------------

class _Ctx:
    def __init__(self, rec):
        self.record, self.root = rec, ROOT


K4_CALL = {"args": [_tensor((1024, 32)), _tensor((1_000_000, 32)),
                    _tensor((1_000_000,), 1)], "kwargs": {"scores": True}}


def _rec():
    iv = trace.Interval
    device = [iv("hamming_kernel<1>", 1.0, 1.1),
              iv("void at::native::sort", 1.05, 1.2),
              iv("Memcpy DtoH (Device -> Pageable)", 1.5, 1.6),
              iv("hamming_kernel<1>", 1.7, 1.8),
              iv("outside", 5.0, 6.0)]
    host = [iv("aten::sort", 1.2, 1.45), iv("portbench.call", 0.9, 1.95),
            iv("aten::topk", 1.3, 1.4)]
    return trace.Record(2, iv(trace.WINDOW_SPAN, 1.0, 2.0), device, host,
                        {"aten::topk": 0.004}, {"k4": [K4_CALL, K4_CALL]})


class _Event:
    def __init__(self, name, device, start_us, end_us, annotation=False):
        self.name, self.is_user_annotation = name, annotation
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)
        self.time_range = type("R", (), {"start": start_us, "end": end_us})
        self.device_time_total = 0.0


def test_span_images_on_the_device_are_no_work():
    events = [_Event(trace.WINDOW_SPAN, False, 0, 100),
              _Event(trace.WINDOW_SPAN, True, 0, 100, annotation=True),
              _Event(trace.CALL_SPAN, True, 0, 90),
              _Event("ProfilerStep#1", True, 0, 100),
              _Event("hamming_kernel", True, 10, 30)]
    rec = trace._record(events, 1, {})
    assert [e.name for e in rec.device] == ["hamming_kernel"]
    assert abs(trace.busy_s(rec) - 20e-6) < 1e-15


def test_trace_readers():
    rec = _rec()
    assert trace.complete(rec, {"k4": "hamming_kernel"})
    assert not trace.complete(rec, {"k4": "sort"})
    assert abs(trace.busy_s(rec) - 0.4) < 1e-12
    ctx = _Ctx(rec)
    read = {n: spec.load_module(ROOT, "metrics", n).read for n in (
        "device.idle_share", "flat.topk_ms", "k4_roofline")}
    assert abs(read["device.idle_share"](ctx) - 60.0) < 1e-9
    assert abs(read["flat.topk_ms"](ctx) - 2.0) < 1e-12
    nbytes = 1024 * 32 * 4 + 1_000_000 * (32 * 4 + 1) + 1024 * 1_000_000 * 4
    bound = 2 * nbytes / 3.35e12  # two launches over the bytes' peak
    assert abs(read["k4_roofline"](ctx) - 100 * bound / 0.2) < 1e-9
    gaps = dict(trace.idle_gaps(rec))
    assert abs(gaps["aten::topk"] - 0.3) < 1e-12  # 1.2-1.5: innermost op
    assert abs(gaps["portbench.call"] - 0.3) < 1e-12  # 1.6-1.7, 1.8-2.0
    assert abs(sum(gaps.values()) - 0.6) < 1e-12
    assert [n for n, _ in trace.device_ops(rec)][0] == "hamming_kernel<1>"
    empty = _Ctx(None)
    assert all(f(empty) is None for f in read.values())


# ---- correctness: the control fails, faults fail, the program passes -----

@pytest.mark.parametrize("workload", _workloads())
def test_control_fails_reference_passes(workload):
    cell = spec.cell(workload)
    sizes = dict(rows=20000, queries=256)
    low = control.readings(cell, SEED, CPU, **sizes)
    full = control.readings(cell, SEED, CPU, lower=False, **sizes)
    assert not low["correct"], low
    assert full["correct"], full


@pytest.fixture(scope="module")
def built():
    """Each cell's tiny index, built once through the port; faulty runs
    reuse it (the build is set-up, not the path that is broken)."""
    from portbench import system
    out = {}
    for w in _workloads():
        cfg = spec.cell(w).config
        gen = spec.load_module(ROOT, "data", cfg["generator"])
        data = gen.make(cfg, SEED, CPU, TINY["rows"], TINY["queries"])
        out[w] = spec.load_module(ROOT, "builds", cfg["build"]).build(
            cfg, system.index_rows(data["rows"]), SEED, CPU)
    return out


def _reuse(monkeypatch, ix):
    """Runs take ``ix`` in place of their build."""
    load = spec.load_module

    def loader(root, kind, name):
        if kind == "builds":
            return types.SimpleNamespace(build=lambda *a, **k: ix)
        return load(root, kind, name)
    monkeypatch.setattr(spec, "load_module", loader)


def _faulty(kind):
    """``Index.search`` broken where its answer is produced."""
    from lantern_tpu_torch.index import Index
    orig = Index.search
    last = {}

    def search(self, queries, *a, **kw):
        out = orig(self, queries, *a, **kw)
        d, lab = out[0].copy(), out[1].copy()
        if kind == "unchanged":  # the state of the call before comes back
            prev = last.get("out")
            last["out"] = (d.copy(), lab.copy())
            if prev is not None:
                d, lab = prev
        elif kind == "half":  # half of the batch left out
            d[len(d) // 2:] = np.inf
            lab[len(lab) // 2:] = 0
        elif kind == "altered":  # one answer altered where it is produced
            lab[0, 0] = (lab[0, 0] + len(d) // 2 + 1) % TINY["rows"]
        elif kind == "duplicated":  # the nearest row k times, exact distance
            d[:, 1:], lab[:, 1:] = d[:, :1], lab[:, :1]
        return (d, lab, *out[2:])
    return search


@pytest.mark.parametrize("workload", _workloads())
def test_sound_run_is_correct(workload, built, monkeypatch):
    _reuse(monkeypatch, built[workload])
    res = run.run_cell(spec.cell(workload), SEED, 0.3, False, CPU, TINY)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] > 0


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered",
                                  "duplicated"])
@pytest.mark.parametrize("workload", _workloads())
def test_fault_makes_run_incorrect(workload, kind, built, monkeypatch):
    from lantern_tpu_torch.index import Index

    _reuse(monkeypatch, built[workload])
    monkeypatch.setattr(Index, "search", _faulty(kind))
    res = run.run_cell(spec.cell(workload), SEED, 0.3, False, CPU, TINY)
    assert not res["correct"], res["checks"]


# ---- isolation and the card ------------------------------------------------

def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in sorted(PKG.rglob("*.py")):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("name", PLAIN)
def test_yardstick_imports_nothing_of_the_program(name):
    tops = {n.split(".")[0] for n in _imports(PKG / name)}
    assert "lantern_tpu_torch" not in tops and not tops & FORBIDDEN


def _python(code: str, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_reference_loads_no_program_module():
    out = _python("import sys, portbench.reference, portbench.control; "
                  "print(sorted({m.split('.')[0] for m in sys.modules}))")
    tops = set(json.loads(out.stdout.replace("'", '"')))
    assert "lantern_tpu_torch" not in tops and not tops & FORBIDDEN


def test_dry_run_loads_no_jax():
    """A CPU dry run of both cells' pieces, traced and not; then every name
    in ``sys.modules``, compared whole by its top-level part."""
    code = (
        "import sys, torch\n"
        "from portbench import spec, run\n"
        f"for w in {_workloads()!r}:\n"
        "    for t in (0, 1):\n"
        "        r = run.run_cell(spec.cell(w), 3, 0.2, bool(t),\n"
        "                         torch.device('cpu'),\n"
        "                         {'rows': 400, 'queries': 64, 'batch': 32})\n"
        "        assert r['correct'], r\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(out.stdout.split())
    assert "lantern_tpu_torch" in tops and not tops & FORBIDDEN


def test_run_without_a_card_fails_with_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    args = [sys.executable, "-m", "portbench.run", "--workload",
            _workloads()[0], "--seed", str(SEED), "--seconds", "1"]
    out = subprocess.run(args, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    # a folder holding only BENCHMARK.json and the benchmark's files
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / spec.PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(args, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.fixture()
def card_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _workloads())
def test_control_fails_on_the_card(workload, card_device):
    cell = spec.cell(workload)
    sizes = dict(rows=100_000, queries=2048)
    assert not control.readings(cell, SEED, card_device, **sizes)["correct"]
    assert control.readings(cell, SEED, card_device, lower=False,
                            **sizes)["correct"]
