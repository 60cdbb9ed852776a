"""The sharded index over the ranks of a process group, on the CPU.

Gloo ranks spawned from here (``tests/torch_mp_worker.py``, which imports
lantern_tpu_torch only) join through a ``file://`` store in the test's
temporary directory, each under a subprocess timeout. One spawn per layout
runs every leg and writes each rank's results; each test below holds one
leg:

- two ranks x 4 shards (the reference's tests/test_multiprocess.py shape:
  800 x 16, m=8, efc=32, 4 queries, k=5, ef=32, rng 40): both ranks
  return the same results, equal to the port's one-process S=8 search and
  to the reference's one-process 8-device mesh (ids exact, distances at
  rtol 1e-5);
- four ranks, data=2 x 2 shard ranks, S=4: equal to the reference's
  ``Mesh(devs.reshape(2, 4))`` search and flat scan;
- two ranks, S=4: ``build_sharded_device`` graphs, the PQ codebook (the
  same bits on both ranks and in one process) and its rerank, insert,
  delete and compact equal to one process exactly; a two-rank save is
  byte-equal to a one-process save and each loads where the other was
  written;
- layouts the group cannot hold raise, and so does NCCL with more ranks
  on a host than cards.

The test marked ``cuda`` runs two gloo ranks sharing the card.
"""

import filecmp
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_mp_worker as w
from lantern_tpu_torch.config import HnswParams, Metric, QuantKind
from lantern_tpu_torch.parallel import (
    build_sharded,
    build_sharded_device,
    compact_sharded,
    delete_sharded,
    flat_search_sharded,
    flat_search_sharded_rerank,
    init_multihost,
    insert_sharded,
    load_sharded,
    make_mesh,
    quantize_sharded,
    save_sharded,
    search_sharded,
)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPAWN_TIMEOUT_S = 240
CPU = "cpu"


def spawn(layout: str, world: int, out_dir, device: str = CPU) -> list[dict]:
    """Run ``world`` ranks of the worker; every rank must exit 0 within
    SPAWN_TIMEOUT_S (a rank that fails or hangs kills the rest). Returns
    each rank's results."""
    store = f"file://{out_dir}/store_{layout}"
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(key, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mp_worker.py"), layout,
         store, str(world), str(r), str(out_dir), device],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{layout}: a rank outlived {SPAWN_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(logs)
    return [dict(np.load(os.path.join(out_dir, f"r{r}.npz")))
            for r in range(world)]


def results(out: dict, prefix: str):
    return tuple(out[f"{prefix}/{n}"] for n in ("d", "g", "l"))


def assert_same_results(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def one_arrays(ix) -> dict:
    out = {}
    w.index_arrays("x", ix, out)
    return {k[2:]: v for k, v in out.items()}


def rank_arrays(ranks, prefix) -> dict:
    """Every rank's arrays of ``prefix`` joined along the shard axis."""
    names = {k[len(prefix) + 1:] for k in ranks[0] if k.startswith(prefix + "/")}
    return {n: np.concatenate([np.atleast_1d(r[f"{prefix}/{n}"]) for r in ranks])
            for n in names}


def assert_same_arrays(got: dict, want: dict):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for name in want:
        np.testing.assert_array_equal(got[name], np.atleast_1d(want[name]),
                                      err_msg=name)


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    """The legs in this process (no group), and its save for the ranks."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out_dir = tmp_path_factory.mktemp("mp")
        res = {}
        base, q = w.ref_data()
        ix = build_sharded(base, w.ref_params(HnswParams),
                           make_mesh(8, device=CPU), seed=0, nthreads=1)
        res["i/search"] = tuple(t.numpy() for t in search_sharded(
            ix, q, k=w.REF_K, ef=w.REF_EF))
        hb, hq = w.ham_data()
        ixh = build_sharded(hb, w.ham_params(HnswParams, Metric, QuantKind),
                            make_mesh(4, device=CPU), seed=0, nthreads=1)
        res["i/ham_search"] = tuple(t.numpy() for t in search_sharded(
            ixh, hq, k=w.LIFE_K, ef=w.REF_EF))
        res["i/ham_flat"] = tuple(t.numpy() for t in flat_search_sharded(
            ixh, hq, k=w.LIFE_K))
        mesh = make_mesh(w.LIFE_S, device=CPU)
        b, extra, lq, dead, excl = w.life_data()

        def srch(x):
            return tuple(t.numpy() for t in search_sharded(
                x, lq, k=w.LIFE_K, ef=w.LIFE_EF))

        ixd = build_sharded_device(b, w.life_params(HnswParams), mesh,
                                   batch=64, seed=0)
        res["iii/build"] = one_arrays(ixd)
        res["iii/search"] = srch(ixd)
        res["iii/flat"] = tuple(t.numpy() for t in flat_search_sharded(
            ixd, lq, k=w.LIFE_K, exact=True))
        res["iii/excluded"] = tuple(t.numpy() for t in search_sharded(
            ixd, lq, k=w.LIFE_K, ef=w.LIFE_EF,
            exclude_gids=torch.from_numpy(excl)))
        ixq = quantize_sharded(ixd, mesh, quant="pq", train_rows=512, seed=0)
        res["iv/pq"] = one_arrays(ixq)
        res["iv/rerank"] = tuple(t.numpy() for t in flat_search_sharded_rerank(
            ixq, lq, k=w.LIFE_K, shortlist=40))
        res["iv/adc_beam"] = srch(ixq)
        ixi = insert_sharded(ixd, extra, mesh, batch=32, seed=1)
        res["v/insert"] = one_arrays(ixi)
        ixx = delete_sharded(ixi, dead)
        res["v/delete"] = one_arrays(ixx)
        res["v/search"] = srch(ixx)
        ixc = compact_sharded(ixx, mesh, batch=64, seed=0)
        res["v/compact"] = one_arrays(ixc)
        res["v/compact_search"] = srch(ixc)
        save_sharded(ixx, str(out_dir / "one"))
        res["mesh"] = mesh
        return out_dir, res
    finally:
        torch.set_num_threads(n_threads)


@pytest.fixture(scope="module")
def two(one):
    return spawn("two", 2, one[0])


@pytest.fixture(scope="module")
def grid(one):
    return spawn("grid", 4, one[0])


# ---- (i) the reference's two-process shape ----

def test_ranks_return_the_same_results(two):
    assert [int(r["rank"]) for r in two] == [0, 1]
    for prefix in ("i/search", "i/flat", "iii/search", "v/search"):
        assert_same_results(results(two[1], prefix), results(two[0], prefix))
    assert all(bool(r["imports_clean"]) for r in two)


def test_two_ranks_equal_one_process(two, one):
    assert_same_results(results(two[0], "i/search"), one[1]["i/search"])


def test_two_ranks_equal_reference_mesh(two):
    """As tests/test_multiprocess.py holds the reference's two processes
    against its one-process 8-device mesh."""
    import jax.numpy as jnp

    from lantern_tpu.config import HnswParams as RParams
    from lantern_tpu.parallel.sharded import (
        build_sharded as ref_build, make_mesh as ref_mesh,
        search_sharded as ref_search)

    base, q = w.ref_data()
    rix = ref_build(base, w.ref_params(RParams), ref_mesh(n_shards=8), seed=0,
                    nthreads=1)
    d, gids, _ = ref_search(rix, jnp.asarray(q), k=w.REF_K, ef=w.REF_EF)
    got_d, got_g, _ = results(two[0], "i/search")
    np.testing.assert_array_equal(got_g, np.asarray(gids))
    np.testing.assert_allclose(got_d, np.asarray(d), rtol=1e-5)


def test_merge_moves_the_stated_bytes(two, grid):
    """The search merge's all-gathers receive ShardedSearchStats'
    collective bytes over the data rows together, plus the [Q/D, k]
    results over the shard column."""
    q, k = w.REF_Q, w.REF_K
    assert int(two[0]["i/merge_bytes"]) == 8 * q * k * 16 + q * k * 16
    per_row = q // 2
    assert int(grid[0]["ii/merge_bytes"]) == 4 * per_row * k * 16 + 2 * per_row * k * 16


# ---- (ii) data=2 x 2 shard ranks ----

@pytest.fixture(scope="module")
def ref_grid():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from lantern_tpu.config import HnswParams as RParams
    from lantern_tpu.parallel.sharded import (
        build_sharded as ref_build, flat_search_sharded as ref_flat,
        search_sharded as ref_search)

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "shard"))
    base, q = w.ref_data()
    rix = ref_build(base, w.ref_params(RParams), mesh, seed=0, nthreads=1)
    qj = jnp.asarray(q)
    return (ref_search(rix, qj, k=w.REF_K, ef=w.REF_EF),
            ref_flat(rix, qj, k=w.REF_K, exact=True))


@pytest.mark.parametrize("leg", ["search", "flat"])
def test_grid_equals_reference_mesh(grid, ref_grid, leg):
    want = ref_grid[0] if leg == "search" else ref_grid[1]
    for r in grid:
        d, g, _ = results(r, f"ii/{leg}")
        np.testing.assert_array_equal(g, np.asarray(want[1]))
        np.testing.assert_allclose(d, np.asarray(want[0]), rtol=1e-5)


def test_grid_loads_a_one_process_save(grid, one):
    for r in grid:
        assert_same_results(results(r, "ii/load_one_search"),
                            one[1]["v/search"])


def test_grid_refuses_queries_that_do_not_split(grid):
    assert all(bool(r["ii/odd_queries"]) for r in grid)


# ---- (iii)-(vi) the lifecycle on two ranks ----

def test_device_build_graphs_equal_one_process(two, one):
    assert_same_arrays(rank_arrays(two, "iii/build"), one[1]["iii/build"])


def test_merge_keeps_the_tie_order_of_one_process(two, one):
    """Hamming distances tie: the all-gather in rank order is shard order,
    so the stable merge orders equal distances as one process does."""
    for leg in ("i/ham_search", "i/ham_flat"):
        d = one[1][leg][0]
        assert (d[:, 1:] == d[:, :-1]).sum() >= d.shape[0]  # ties to order
        for r in two:
            assert_same_results(results(r, leg), one[1][leg])


@pytest.mark.parametrize("leg", ["iii/search", "iii/flat", "iii/excluded",
                                 "iv/rerank", "iv/adc_beam", "v/search",
                                 "v/compact_search"])
def test_searches_equal_one_process(two, one, leg):
    for r in two:
        assert_same_results(results(r, leg), one[1][leg])


def test_pq_codebook_bits_equal_everywhere(two, one):
    for name in ("centroids", "rotation"):
        np.testing.assert_array_equal(two[0][f"iv/{name}"], two[1][f"iv/{name}"])
    assert_same_arrays(rank_arrays(two, "iv/pq"), one[1]["iv/pq"])


@pytest.mark.parametrize("leg", ["v/insert", "v/delete", "v/compact"])
def test_lifecycle_equals_one_process(two, one, leg):
    assert_same_arrays(rank_arrays(two, leg), one[1][leg])


def test_two_rank_save_is_byte_equal(two, one):
    out_dir = one[0]
    names = sorted(os.listdir(out_dir / "one"))
    assert names == sorted(os.listdir(out_dir / "ranks"))
    assert "manifest.json" in names and len(names) == 2 * w.LIFE_S + 1
    match, mismatch, errors = filecmp.cmpfiles(
        out_dir / "one", out_dir / "ranks", names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_saves_load_both_ways(two, one):
    out_dir, res = one
    want = one_arrays(load_sharded(str(out_dir / "one"), res["mesh"]))
    for r in two:  # the one-process save on two ranks
        assert_same_results(results(r, "vi/load_one_search"), res["v/search"])
    assert_same_arrays(rank_arrays(two, "vi/load_one"), want)
    back = load_sharded(str(out_dir / "ranks"), res["mesh"])  # and back
    assert_same_arrays(one_arrays(back), want)
    got = search_sharded(back, w.life_data()[2], k=w.LIFE_K, ef=w.LIFE_EF)
    assert_same_results(tuple(t.numpy() for t in got), res["v/search"])


# ---- (vii) what raises ----

def test_layouts_the_group_cannot_hold_raise(two):
    for r in two:
        assert bool(r["vii/shards_not_multiple"])
        assert bool(r["vii/data_not_dividing"])
    with pytest.raises(ValueError):  # no group: one rank
        make_mesh(2, data=2, device=CPU)


def test_nccl_refuses_ranks_sharing_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for key in ("LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="gloo"):
        init_multihost("127.0.0.1:29500", 2, 0, backend="nccl")
    with pytest.raises(ValueError, match="gloo"):
        init_multihost(num_processes=2, process_id=1, backend="nccl",
                       init_method=f"file://{tmp_path}/store")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="gloo"):
        init_multihost("10.0.0.1:29500", 6, 4, backend="nccl")
    assert not torch.distributed.is_initialized()


def test_init_multihost_needs_a_coordinator_and_a_device(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        init_multihost(num_processes=2, process_id=0, device=CPU)
    with pytest.raises(ValueError, match="outside"):
        init_multihost("127.0.0.1:29500", 2, 2, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            init_multihost("127.0.0.1:29500", 1, 0, backend="gloo")
    assert not torch.distributed.is_initialized()


# ---- on the card ----

@pytest.mark.cuda
def test_two_gloo_ranks_share_the_card(tmp_path):
    """Two gloo ranks on one card run the two-rank legs (K1 in the
    beams, the decode kernel in the PQ scans): the device build's graphs
    and the searches after insert and delete equal one process on the
    card, and their save is byte-equal to its save."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = make_mesh(w.LIFE_S, device="cuda")
    b, extra, lq, dead, _ = w.life_data()
    ixd = build_sharded_device(b, w.life_params(HnswParams), mesh, batch=64,
                               seed=0)
    ixx = delete_sharded(insert_sharded(ixd, extra, mesh, batch=32, seed=1),
                         dead)
    save_sharded(ixx, str(tmp_path / "one"))
    want_build = one_arrays(ixd)
    want = tuple(t.cpu().numpy() for t in search_sharded(
        ixx, lq, k=w.LIFE_K, ef=w.LIFE_EF))
    ranks = spawn("two", 2, tmp_path, device="cuda")
    assert_same_arrays(rank_arrays(ranks, "iii/build"), want_build)
    for r in ranks:
        assert_same_results(results(r, "v/search"), want)
    names = sorted(os.listdir(tmp_path / "one"))
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "one", tmp_path / "ranks",
                                           names, shallow=False)
    assert not mismatch and not errors
