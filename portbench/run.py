"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the checkout's root, on a machine with the cards the cell asks for
(without them it exits 1 and prints no result). In order: the caches into
fixed folders of the checkout; the configuration's rows and query pool from
the seed, on the card; the index built through the port; warm-up at the
window's one shape; with ``--trace 1`` a profiled sub-window of whole calls;
the window, ``--seconds`` of calls; then, outside set-up and the window, the
plain reference over the same rows and queries, which decides ``correct``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics, or with
``--trace 1`` the per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its limit.
The last lines of standard error repeat the checks.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import sys
import time

import numpy as np

from portbench import card, spec

# the slowest calls of the window that the log names
TOP_CALLS = 5


@dataclasses.dataclass
class Context:
    """What the metric readers read."""

    root: object
    cfg: dict
    traffic: dict
    setup_s: float = 0.0
    build_s: float = 0.0
    window: dict | None = None
    record: object = None  # trace.Record of the traced sub-window
    numbers: dict = dataclasses.field(default_factory=dict)


def _free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _read(ctx: Context, metrics: list[dict]) -> dict:
    """Each metric's reader; one that finds nothing is left out."""
    out = {}
    for m in metrics:
        value = spec.load_module(ctx.root, "metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _probes(cell: spec.Cell):
    """Probes and kernel names that the cell's per-layer readers ask for."""
    probes, kernels = {}, {}
    for m in cell.per_layer:
        reader = spec.load_module(cell.root, "metrics", m["name"])
        probes.update(getattr(reader, "PROBES", {}))
        for probe, name in getattr(reader, "ROOFLINES", {}).items():
            kernels[probe] = spec.load_module(cell.root, "roofline",
                                              name).KERNEL
    return probes, kernels


def _device_allocs(device) -> int:
    """The caching allocator's device allocations so far (0 on the CPU)."""
    import torch

    if device.type != "cuda":
        return 0
    return torch.cuda.memory_stats(device).get("num_device_alloc", 0)


@contextlib.contextmanager
def _gc_pauses(out: list):
    """Appends (start, end, generation) of each cyclic collection of the
    garbage collector while the block runs."""
    began = []

    def note(phase, info):
        if phase == "start":
            began.append(time.perf_counter())
        elif began:
            out.append((began.pop(), time.perf_counter(), info["generation"]))

    gc.callbacks.append(note)
    try:
        yield out
    finally:
        gc.callbacks.remove(note)


def _log_window(w: dict, pauses: list, allocs: int) -> None:
    """Where the window's time went on the host: the latencies' spread, the
    collector's pauses, the caching allocator's new device allocations, and
    what the calling thread did during the slowest calls."""
    lat = np.array(w["latencies"]) * 1e3
    card.log(f"window: {len(lat)} calls, {w['queries']} queries in "
             f"{w['seconds']:.2f} s; ms p50 {np.percentile(lat, 50):.2f} p90 "
             f"{np.percentile(lat, 90):.2f} p95 {np.percentile(lat, 95):.2f} "
             f"p99 {np.percentile(lat, 99):.2f} max {lat.max():.2f}")
    for part in np.array_split(lat, 3):
        card.log(f"  a third of the calls: {len(part)}, ms min "
                 f"{part.min():.1f} median {np.median(part):.1f} max "
                 f"{part.max():.1f}")
    gen2 = [p for p in pauses if p[2] == 2]
    card.log(f"gc in the window: {len(pauses)} collections, "
             f"{sum(e - s for s, e, _ in pauses) * 1e3:.1f} ms; generation 2: "
             f"{len(gen2)}, {sum(e - s for s, e, _ in gen2) * 1e3:.1f} ms")
    card.log(f"device allocations (cudaMalloc) in the window: {allocs}")
    for i in np.argsort(-lat)[:TOP_CALLS]:
        s, e = w["calls"][i]
        in_gc = sum(max(0.0, min(e, pe) - max(s, ps)) for ps, pe, _ in pauses)
        cpu, switches = w["host"][i]
        card.log(f"  slow call {i} at {s - w['calls'][0][0]:.2f} s: "
                 f"{lat[i]:.1f} ms, {in_gc * 1e3:.1f} ms of it in gc, "
                 f"{cpu * 1e3:.1f} ms on the thread's CPU, {switches} "
                 "involuntary switches")


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, sizes: dict | None = None) -> dict:
    """Set-up, window and reference of one run; returns the result line.
    ``sizes`` (tests only) shrinks rows, queries and the batch."""
    import torch

    from portbench import reference, system

    cfg, traffic = cell.config, cell.traffic
    sizes = sizes or {}
    n_rows = sizes.get("rows", cfg["rows"])
    n_pool = sizes.get("queries", cfg["queries"])
    batch = sizes.get("batch", traffic["batch"])
    ctx = Context(cell.root, cfg, traffic)

    gen = spec.load_module(cell.root, "data", cfg["generator"])
    data = gen.make(cfg, seed, device, rows=n_rows, queries=n_pool)
    # the harness keeps its own copy on the host for the reference
    rows, pool = data["rows"].cpu(), data["queries"].cpu()
    del data
    _free(device)
    card.log(f"{cell.name}: {n_rows} rows, {n_pool} queries from seed {seed}")
    allowed, extra = None, {}
    if "filter" in traffic:
        filt = spec.load_module(cell.root, "filters", traffic["filter"])
        allowed = filt.make(cfg, traffic, seed, n_rows)
        extra["allow_labels"] = np.flatnonzero(allowed.numpy()).astype(
            np.uint64)

    t0 = time.perf_counter()
    builder = spec.load_module(cell.root, "builds", cfg["build"])
    ix = builder.build(cfg, system.index_rows(rows), seed, device)
    ctx.build_s = time.perf_counter() - t0
    card.log(f"build ({cfg['build']}): {ctx.build_s:.1f} s")
    driver = spec.load_module(cell.root, "drivers", traffic["driver"])
    loop = driver.Loop(ix, cfg, traffic, system.index_rows(pool), batch,
                       card.log, extra)
    loop.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ctx.setup_s = card.process_age_s()
    card.log(f"set-up: {ctx.setup_s:.1f} s")

    if traced:
        ctx.record = loop.traced(*_probes(cell), device)
        if ctx.record is None:
            card.log("every profiler session lost launches: the trace's "
                     "metrics are left out")
    allocs = _device_allocs(device)
    with _gc_pauses([]) as pauses:
        ctx.window = loop.window(seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    w = ctx.window
    _log_window(w, pauses, _device_allocs(device) - allocs)

    # the reference, after the window, with the program's state freed
    qidx, dists, labels = loop.answers()
    del loop, ix
    _free(device)
    t0 = time.perf_counter()
    rows_t, pool_t = rows.to(device), pool.to(device)
    allowed_t = None if allowed is None else allowed.to(device)
    kth = reference.exact_knn(cfg["metric"], rows_t, pool_t, cfg["k"],
                              allowed=allowed_t)[0][:, cfg["k"] - 1]
    ctx.numbers = reference.compare(
        cfg["metric"], rows_t, pool_t, kth, torch.from_numpy(qidx),
        torch.from_numpy(dists), torch.from_numpy(labels), allowed_t)
    card.log(f"reference: {len(qidx)} answers in "
             f"{time.perf_counter() - t0:.1f} s")

    checks = {name: {"value": ctx.numbers[name], "limit": c["limit"]}
              for name, c in cell.checks.items()}
    correct = w["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": correct,
        "attempted": w["attempted"],
        "failed": w["failed"],
        "metrics": _read(ctx, cell.per_layer if traced else cell.end_to_end),
        "device": dict(card.describe(device), memory_peak_bytes=peak),
    }
    rec = ctx.record
    if rec is not None:
        from portbench import trace

        result["device"]["busy_s"] = trace.busy_s(rec)
        result["device"]["window_s"] = rec.window.end - rec.window.start
        result["breakdown"] = {"device_ops": trace.device_ops(rec),
                               "idle_gaps": trace.idle_gaps(rec)}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    card.point_caches(spec.ROOT)
    cell = spec.cell(args.workload)
    card.require_cards(cell.chips)
    import torch

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    bad = card.forbidden_modules()
    if bad:
        print(f"portbench: the run holds forbidden modules: {bad}",
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
