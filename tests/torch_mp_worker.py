"""One rank of tests/test_torch_multiprocess.py.

    python torch_mp_worker.py LAYOUT STORE WORLD RANK OUT_DIR [DEVICE]

Joins a gloo group of WORLD ranks through the ``file://`` STORE
(``parallel.init_multihost``), runs the sharded legs of LAYOUT ("two": two
ranks, data=1; "grid": four ranks, data=2 x 2 shard ranks) on DEVICE
(default cpu) and writes this rank's results to OUT_DIR/r<RANK>.npz: the
index arrays of its shards, every search result (the whole [Q, k] on every
rank), the PQ codebook, the merge's bytes and which calls raised. Imports
lantern_tpu_torch only; the data comes from the generators below, which
the test calls too.
"""

import os
import sys

import numpy as np
import torch

FIELDS = ("vectors", "sq_norms", "neighbors0", "upper_neighbors",
          "upper_slot", "levels", "labels", "deleted", "upper_ids",
          "vec_scales", "global_ids", "entry", "max_level", "num_nodes",
          "rerank_rows", "rerank_sqn")
# the reference's multi-process test (tests/test_multiprocess.py)
REF_N, REF_DIM, REF_Q, REF_K, REF_EF = 800, 16, 4, 5, 32
# the lifecycle legs: a device build of LIFE_N rows over LIFE_S shards,
# LIFE_EXTRA inserted rows, every DEAD_EVERY-th label deleted
LIFE_N, LIFE_EXTRA, LIFE_Q, LIFE_S, DEAD_EVERY = 1200, 200, 8, 4, 7
LIFE_K, LIFE_EF = 10, 48


def ref_params(cls):
    return cls(dim=REF_DIM, m=8, ef_construction=32)


def life_params(cls):
    return cls(dim=REF_DIM, m=8, ef_construction=48)


def ref_data():
    rng = np.random.default_rng(40)
    base = rng.standard_normal((REF_N, REF_DIM)).astype(np.float32)
    return base, rng.standard_normal((REF_Q, REF_DIM)).astype(np.float32)


def ham_params(cls, metric, quant):
    return cls(dim=64, metric=metric.HAMMING, quant=quant.B1, m=8,
               ef_construction=32)


def ham_data():
    """64-bit rows: hamming distances tie as a rule, so the merge's tie
    order shows."""
    rng = np.random.default_rng(42)
    rows = rng.integers(0, 2**32, (600, 2), dtype=np.uint64).astype(np.uint32)
    return rows, rng.integers(0, 2**32, (6, 2), dtype=np.uint64).astype(np.uint32)


def life_data():
    rng = np.random.default_rng(41)
    base = rng.standard_normal((LIFE_N + LIFE_EXTRA, REF_DIM)).astype(np.float32)
    q = rng.standard_normal((LIFE_Q, REF_DIM)).astype(np.float32)
    dead = np.arange(0, LIFE_N + LIFE_EXTRA, DEAD_EVERY, dtype=np.uint64)
    excl = np.zeros(LIFE_N, bool)
    excl[::3] = True
    return base[:LIFE_N], base[LIFE_N:], q, dead, excl


def index_arrays(prefix, ix, out):
    for name in FIELDS:
        v = getattr(ix, name)
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            v = (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
        out[f"{prefix}/{name}"] = np.asarray(v)


def result(prefix, res, out):
    for name, t in zip(("d", "g", "l"), res):
        out[f"{prefix}/{name}"] = t.cpu().numpy()


def raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def leg_two(mesh_of, dev, out_dir, out):
    from lantern_tpu_torch.config import HnswParams, Metric, QuantKind
    from lantern_tpu_torch.parallel import (
        _dist, build_sharded, build_sharded_device, compact_sharded,
        delete_sharded, flat_search_sharded, flat_search_sharded_rerank,
        insert_sharded, load_sharded, quantize_sharded, save_sharded,
        search_sharded)

    # (i) the reference's multi-process shape: 2 ranks x 4 shards
    base, q = ref_data()
    ix = build_sharded(base, ref_params(HnswParams), mesh_of(8), seed=0,
                       nthreads=1)
    _dist.reset_merge_stats()
    result("i/search", search_sharded(ix, q, k=REF_K, ef=REF_EF), out)
    out["i/merge_bytes"] = np.int64(_dist.merge_stats["bytes"])
    result("i/flat", flat_search_sharded(ix, q, k=REF_K, exact=True), out)
    hb, hq = ham_data()
    ixh = build_sharded(hb, ham_params(HnswParams, Metric, QuantKind),
                        mesh_of(4), seed=0, nthreads=1)
    result("i/ham_search", search_sharded(ixh, hq, k=LIFE_K, ef=REF_EF), out)
    result("i/ham_flat", flat_search_sharded(ixh, hq, k=LIFE_K), out)
    # (vii) layouts the group cannot hold
    out["vii/shards_not_multiple"] = raises(lambda: mesh_of(3))
    out["vii/data_not_dividing"] = raises(lambda: mesh_of(4, data=3))

    # (iii) the device build over ranks
    mesh = mesh_of(LIFE_S)
    b, extra, lq, dead, excl = life_data()
    p = life_params(HnswParams)
    ixd = build_sharded_device(b, p, mesh, batch=64, seed=0)
    index_arrays("iii/build", ixd, out)
    result("iii/search", search_sharded(ixd, lq, k=LIFE_K, ef=LIFE_EF), out)
    result("iii/flat", flat_search_sharded(ixd, lq, k=LIFE_K, exact=True), out)
    result("iii/excluded", search_sharded(
        ixd, lq, k=LIFE_K, ef=LIFE_EF, exclude_gids=torch.from_numpy(excl)), out)
    # (iv) PQ: the sample gathered, rank 0 trains, the codebook broadcast
    ixq = quantize_sharded(ixd, mesh, quant="pq", train_rows=512, seed=0)
    out["iv/centroids"] = ixq.pq_codebook.cpu().numpy()
    out["iv/rotation"] = ixq.pq_rotation.cpu().numpy()
    index_arrays("iv/pq", ixq, out)
    result("iv/rerank", flat_search_sharded_rerank(ixq, lq, k=LIFE_K,
                                                   shortlist=40), out)
    result("iv/adc_beam", search_sharded(ixq, lq, k=LIFE_K, ef=LIFE_EF), out)
    # (v) insert, delete, compact
    ixi = insert_sharded(ixd, extra, mesh, batch=32, seed=1)
    index_arrays("v/insert", ixi, out)
    ixx = delete_sharded(ixi, dead)
    index_arrays("v/delete", ixx, out)
    result("v/search", search_sharded(ixx, lq, k=LIFE_K, ef=LIFE_EF), out)
    ixc = compact_sharded(ixx, mesh, batch=64, seed=0)
    index_arrays("v/compact", ixc, out)
    result("v/compact_search", search_sharded(ixc, lq, k=LIFE_K, ef=LIFE_EF),
           out)
    # (vi) a save over ranks; the one-process save loaded on the ranks
    save_sharded(ixx, os.path.join(out_dir, "ranks"))
    one = load_sharded(os.path.join(out_dir, "one"), mesh)
    index_arrays("vi/load_one", one, out)
    result("vi/load_one_search", search_sharded(one, lq, k=LIFE_K,
                                                ef=LIFE_EF), out)


def leg_grid(mesh_of, dev, out_dir, out):
    from lantern_tpu_torch.config import HnswParams
    from lantern_tpu_torch.parallel import (
        _dist, build_sharded, flat_search_sharded, load_sharded,
        search_sharded)

    # (ii) data=2 x 2 shard ranks, S=4: the reference's Mesh(reshape(2, 4))
    mesh = mesh_of(4, data=2)
    base, q = ref_data()
    ix = build_sharded(base, ref_params(HnswParams), mesh, seed=0, nthreads=1)
    _dist.reset_merge_stats()
    result("ii/search", search_sharded(ix, q, k=REF_K, ef=REF_EF), out)
    out["ii/merge_bytes"] = np.int64(_dist.merge_stats["bytes"])
    result("ii/flat", flat_search_sharded(ix, q, k=REF_K, exact=True), out)
    out["ii/odd_queries"] = raises(
        lambda: search_sharded(ix, q[:3], k=REF_K, ef=REF_EF))
    _, _, lq, _, _ = life_data()
    one = load_sharded(os.path.join(out_dir, "one"), mesh)
    result("ii/load_one_search", search_sharded(one, lq, k=LIFE_K,
                                                ef=LIFE_EF), out)


def main():
    layout, store, world, rank, out_dir = sys.argv[1:6]
    device = sys.argv[6] if len(sys.argv) > 6 else "cpu"
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    from lantern_tpu_torch.parallel import init_multihost, make_mesh

    dev = init_multihost(None, world, rank, backend="gloo", device=device,
                         init_method=store, timeout_s=120)
    out = {"rank": np.int64(rank)}

    def mesh_of(n, data=1):
        return make_mesh(n, data=data, device=dev)

    {"two": leg_two, "grid": leg_grid}[layout](mesh_of, dev, out_dir, out)
    out["imports_clean"] = not any(
        m.split(".")[0] in ("jax", "jaxlib", "lantern_tpu") for m in sys.modules)
    np.savez(os.path.join(out_dir, f"r{rank}.npz"), **out)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
