"""The control of a cell's comparison: the plain reference put in the
program's place, one precision below what the configuration states, held to
the same checks. It has to come out as not correct. The benchmark's runs do
not run it.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 \
        [--rows N --queries Q]

On a card it answers the cell's whole query pool (every query a run answers,
each once) at the cell's own sizes, from each seed's rows, and prints one
JSON line a seed with each check's value and limit, the control's recall,
and ``correct``; then one line with the reference's own answers at full
precision, which must read as correct.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import card, reference, spec


def readings(cell: spec.Cell, seed: int, device, rows: int | None = None,
             queries: int | None = None, lower: bool = True) -> dict:
    """The checks of the reference's answers over the pool (``lower``: in the
    precision below), against the exact reference."""
    cfg = cell.config
    gen = spec.load_module(cell.root, "data", cfg["generator"])
    data = gen.make(cfg, seed, device, rows=rows or cfg["rows"],
                    queries=queries or cfg["queries"])
    x, pool, k = data["rows"], data["queries"], cfg["k"]
    allowed = None
    if "filter" in cell.traffic:
        allowed = spec.load_module(cell.root, "filters", cell.traffic[
            "filter"]).make(cfg, cell.traffic, seed, x.shape[0]).to(device)
    truth_d, _ = reference.exact_knn(cfg["metric"], x, pool, k,
                                     allowed=allowed)
    d, ids = reference.exact_knn(cfg["metric"], x, pool, k, lower=lower,
                                 allowed=allowed)
    import torch

    numbers = reference.compare(
        cfg["metric"], x, pool, truth_d[:, k - 1],
        torch.arange(pool.shape[0], device=device), d.float(), ids, allowed)
    checks = {name: {"value": numbers[name], "limit": c["limit"]}
              for name, c in cell.checks.items()}
    return {"seed": seed, "lower": lower, "recall": numbers["recall"],
            "correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--rows", type=int)
    p.add_argument("--queries", type=int)
    args = p.parse_args(argv)
    card.point_caches(spec.ROOT)
    cell = spec.cell(args.workload)
    card.require_cards(cell.chips)
    import torch

    device = torch.device("cuda", 0)
    print(json.dumps({"device": card.describe(device)}), flush=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        print(json.dumps(readings(cell, seed, device, args.rows,
                                  args.queries)), flush=True)
    print(json.dumps(readings(cell, seeds[0], device, args.rows, args.queries,
                              lower=False)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
