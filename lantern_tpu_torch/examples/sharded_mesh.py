"""A sharded index: ``examples/sharded_mesh.py`` on the port.

The reference lays 8 shards over a mesh of 8 (virtual) devices; here the 8
shards are a leading tensor axis of one card's tensors (``make_mesh(8,
device=)``). ``build_sharded_device`` builds every subgraph by the device
insert rounds, ``search_sharded`` runs each shard's beam (the gather-distance
kernel, ``csrc/gather_dists.cu``) and one top-k merge, held to an exact scan.

With ``--ranks R`` (2 or 4) the same build and search also run on R gloo
ranks started by this script, joined through a ``file://`` store
(``init_multihost``), each holding 8/R shards on the same device; rank 0
holds the merged results to the one-process run's, bit for bit.

    python -m lantern_tpu_torch.examples.sharded_mesh [--device cpu] [--n N]
        [--ranks R]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from lantern_tpu_torch import HnswParams, resolve_device
from lantern_tpu_torch.examples._common import (
    check,
    emit,
    example_n,
    launches,
    launches_since,
    parser,
)
from lantern_tpu_torch.ops.distance import exact_search
from lantern_tpu_torch.parallel import (
    build_sharded_device,
    init_multihost,
    make_mesh,
    search_sharded,
)

N, DIM, QUERIES = 4000, 32, 16  # examples/sharded_mesh.py:30-35
SHARDS = 8  # the reference's 8-device virtual mesh (:13, :37)
RANKS = (1, 2, 4)  # rank counts that divide the shards evenly
RANK_TIMEOUT_S = 120.0  # wall limit of the ranks, startup included
_DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
             "LOCAL_WORLD_SIZE")


def data(n: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(0)
    vectors = rng.standard_normal((n, DIM)).astype(np.float32)
    return vectors, rng.standard_normal((QUERIES, DIM)).astype(np.float32)


def build_and_search(vectors, queries, mesh):
    """(dists, global ids, labels) of the reference's build and search
    (:40-41) as host arrays."""
    ix = build_sharded_device(vectors, HnswParams(dim=DIM, m=8,
                                                  ef_construction=48), mesh)
    return tuple(t.cpu().numpy()
                 for t in search_sharded(ix, queries, k=10, ef=48))


def main(device=None, n: int | None = None, ranks: int = 1) -> dict:
    dev = resolve_device(device)
    if ranks not in RANKS:
        raise ValueError(f"ranks={ranks}; expected one of {RANKS}")
    n = example_n(n, N)
    t0, before = time.perf_counter(), launches()
    vectors, queries = data(n)
    mesh = make_mesh(SHARDS, device=dev)
    print("mesh:", mesh.shape, mesh.device)
    d, gids, labels = build_and_search(vectors, queries, mesh)

    _, true_ids = exact_search(torch.from_numpy(queries).to(dev),
                               torch.from_numpy(vectors).to(dev), k=10)
    rec = float(np.mean([
        len(set(a[a >= 0].tolist()) & set(b.tolist())) / 10
        for a, b in zip(gids, true_ids.cpu().numpy())]))  # :44-47
    print(f"sharded recall@10 = {rec:.3f} over {mesh.shape['shard']} shards")
    check(rec > 0.8, f"sharded recall@10 {rec}")  # :49
    out = {"example": "sharded_mesh", "device": str(dev), "n": n,
           "shards": mesh.shape["shard"], "recall": rec,
           "global_ids": gids.tolist(), "launches": launches_since(before)}
    if ranks > 1:
        out["ranks"] = run_ranks(ranks, dev, n, (d, gids, labels))
    out["seconds"] = time.perf_counter() - t0
    return out


def run_ranks(world: int, dev: torch.device, n: int, one) -> dict:
    """Start ``world`` ranks of this module on ``dev`` and wait for them;
    a rank's failure, or the wall limit, kills the others and raises.
    Returns the ranks' report: the ids check and their launches, summed."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {k: v for k, v in os.environ.items() if k not in _DIST_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as work:
        np.savez(os.path.join(work, "one.npz"), d=one[0], g=one[1], l=one[2])
        logs = [open(os.path.join(work, f"r{r}.log"), "w+")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "lantern_tpu_torch.examples.sharded_mesh",
             "--device", str(dev), "--n", str(n), "--rank", str(r),
             "--world", str(world), "--work", work],
            env=env, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]
        try:
            deadline = time.monotonic() + RANK_TIMEOUT_S
            while any(p.poll() is None for p in procs):
                if (any(p.poll() not in (None, 0) for p in procs)
                        or time.monotonic() > deadline):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        codes = [p.returncode for p in procs]
        tails = []
        for r, f in enumerate(logs):
            f.seek(0)
            tails.append(f"--- rank {r} ---\n" + f.read()[-4000:])
            f.close()
        if any(codes):
            raise RuntimeError(f"ranks exited {codes}\n" + "\n".join(tails))
        reports = []
        for r in range(world):
            with open(os.path.join(work, f"r{r}.json")) as f:
                reports.append(json.load(f))
    total = {k: sum(rep["launches"][k] for rep in reports)
             for k in reports[0]["launches"]}
    return {"world": world, "shards_per_rank": SHARDS // world,
            "ids_equal": reports[0]["equal"], "launches": total,
            "seconds": time.perf_counter() - t0}


def rank_main(rank: int, world: int, work: str, device: str, n: int) -> None:
    """One rank: joins the gloo group, builds and searches its shards, and
    (rank 0) holds the merged results to the one-process run's."""
    import torch.distributed as dist

    before = launches()
    dev = init_multihost(None, world, rank, backend="gloo", device=device,
                         init_method=f"file://{work}/store",
                         timeout_s=RANK_TIMEOUT_S)
    vectors, queries = data(n)
    mesh = make_mesh(SHARDS, device=dev)
    check(len(mesh.local_shards) == SHARDS // world, f"{mesh.local_shards}")
    got = build_and_search(vectors, queries, mesh)
    equal = None
    if rank == 0:
        one = np.load(os.path.join(work, "one.npz"))
        equal = all(a.tobytes() == one[k].tobytes()
                    for a, k in zip(got, ("d", "g", "l")))
        check(equal, "the ranks' results differ from one process's")
    with open(os.path.join(work, f"r{rank}.json"), "w") as f:
        json.dump({"equal": equal, "launches": launches_since(before)}, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--ranks", type=int, default=1, choices=RANKS,
                    help="also run on this many gloo ranks (default 1: no)")
    # one rank, started by run_ranks
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.world, args.work, args.device,
                  example_n(args.n, N))
    else:
        emit(main(args.device, args.n, args.ranks))
