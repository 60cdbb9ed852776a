"""What ``BENCHMARK.json`` says about one cell, and the files it names.

Everything that belongs to one configuration, traffic mix, per-layer metric,
data generator, kernel or cell sits in a file of its own under the
benchmark's folder, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the configuration (the entry's ``file``);
- ``traffic/<mix>.json``: the traffic mix; its ``driver`` names
  ``drivers/<kind>.py``;
- ``data/<generator>.py``: the configuration's ``generator``;
- ``builds/<build>.py``: the configuration's ``build``, which makes the
  index from the rows (a device build; a PQ training step or shards);
- ``filters/<filter>.py``: the traffic's ``filter``, where it has one: the
  rows a filtered search may return, from the seed;
- ``metrics/<metric>.py``: one reader a per-layer metric;
- ``roofline/<kernel>.py``: a kernel's operations and bytes;
- ``checks/<workload>.json``: the numbers that decide ``correct`` in a cell,
  each with its limit.

A later change adds a configuration, a mix, a metric or a cell by adding
files and entries; no file that is there needs an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

# the checkout's root: the folder above this package
ROOT = Path(__file__).resolve().parent.parent
PACKAGE = "portbench"


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    run_seconds: int
    root: Path


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def folder(root: Path, kind: str) -> Path:
    return root / PACKAGE / kind


def load_json(root: Path, kind: str, name: str) -> dict:
    with open(folder(root, kind) / f"{name}.json") as f:
        return json.load(f)


def load_module(root: Path, kind: str, name: str):
    """The module ``<root>/portbench/<kind>/<name>.py``, loaded by its path
    (names may hold dots)."""
    path = folder(root, kind) / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        names = [w["name"] for w in bench["workloads"]]
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {names}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    return Cell(
        name=workload,
        chips=entry["chips"],
        config=config,
        traffic=load_json(root, "traffic", entry["traffic"]),
        checks=load_json(root, "checks", workload),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        run_seconds=bench["run_seconds"],
        root=root,
    )
