"""Parity: the port's sharded index against lantern_tpu.parallel.sharded.

The reference runs on conftest's 8-device CPU mesh
(``lantern_tpu.parallel.make_mesh(n_shards=S)``, S in {4, 8}); the port
puts the same S shards on a leading axis of CPU tensors. Both get the same
numpy inputs. Held exactly: every stacked array (vectors, squared norms,
level-0 and upper adjacency with their dummy rows, upper slots and ids,
levels, labels, tombstones, global ids) and the per-shard entry, maximum
level and node count of ``build_sharded`` (``nthreads=1``, F1), of
``build_sharded_device`` (f32 flat pools, ``store="bf16"``, hybrid, and at
S=4 inside ``compact_sharded``; hamming too, the flat pools keeping the
lower ids of a tie), of ``insert_sharded`` (a
capacity-growing insert, then a second one), ``delete_sharded`` and
``compact_sharded``; the merge on tied distances; ``local_exclude_masks``;
the shard files and manifest ``save_sharded`` writes (byte-equal), each
package loading the other's. Searches (``search_sharded``,
``flat_search_sharded``, with both mask forms) agree on ids and labels up
to tied distances, distances within 1e-5 relative (1e-5 absolute around
0). The reference's ValueErrors are the port's. The port's
``insert_sharded`` reads no more than 4 bytes a row from the device. The
test marked ``cuda`` searches a sharded index on the card against the
port on the CPU. jax is imported only inside the CPU parity tests, so
``pytest --noconftest -m cuda`` runs this file on a machine without jax.
"""

import os

import numpy as np
import pytest
import torch

from lantern_tpu_torch.config import HnswParams, Metric, QuantKind
from lantern_tpu_torch.parallel import sharded as ps
from lantern_tpu_torch.parallel import (
    build_sharded,
    build_sharded_device,
    compact_sharded,
    delete_sharded,
    flat_search_sharded,
    insert_sharded,
    load_sharded,
    local_exclude_masks,
    make_mesh,
    save_sharded,
    search_sharded,
)

CPU = "cpu"
FIELDS = ("vectors", "sq_norms", "neighbors0", "upper_neighbors",
          "upper_slot", "levels", "labels", "deleted", "upper_ids",
          "vec_scales", "global_ids", "entry", "max_level", "num_nodes",
          "rerank_rows", "rerank_sqn")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the rounds' many small ops run faster on one,
    and the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- conversions and comparisons ----

def _np(a):
    """A reference array as numpy in the port's conventions (bf16 widened
    to f32, uint32 words as int32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a


def ref_arrays(rix) -> dict:
    from lantern_tpu.graph.device import join_labels

    g = rix.graphs
    out = {name: _np(getattr(g, name)) for name in FIELDS
           if getattr(g, name, None) is not None and name != "labels"}
    out["labels"] = join_labels(np.asarray(g.labels)).view(np.int64)
    out["global_ids"] = np.asarray(rix.global_ids)
    for name in ("rerank_rows", "rerank_sqn"):
        if getattr(rix, name) is not None:
            out[name] = _np(getattr(rix, name))
    return out


def port_arrays(ix) -> dict:
    out = {}
    for name in FIELDS:
        v = getattr(ix, name)
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            v = v.float() if v.dtype == torch.bfloat16 else v
            out[name] = v.cpu().numpy()
        else:
            out[name] = np.asarray(v)
    return out


def assert_same_index(ix, rix):
    """Every array equal."""
    got, want = port_arrays(ix), ref_arrays(rix)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for name in want:
        if name == "vec_scales":
            # i8 scales max|x| / 127: the reference's, computed inside its
            # jitted shard program, can differ from an eager division by an
            # ulp (its own save/load test allows 1e-6 relative)
            np.testing.assert_allclose(got[name], want[name], rtol=1e-6)
        else:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # a bf16 table is quant F16 in the port (as its build_on_device and
    # to_device label it); the reference's sharded build leaves F32
    want_quant = int(rix.graphs.quant)
    if ix.vectors.dtype == torch.bfloat16 and want_quant == int(QuantKind.F32):
        want_quant = int(QuantKind.F16)
    assert ix.quant == want_quant
    assert ix.metric == int(rix.graphs.metric) and ix.m == rix.graphs.m


def ref_result(res):
    from lantern_tpu.graph.device import join_labels

    d, g, lab = res
    return (np.asarray(d), np.asarray(g),
            join_labels(np.asarray(lab)).view(np.int64))


def port_result(res):
    return tuple(t.cpu().numpy() for t in res)


def assert_results_match(got, want, rtol=1e-5, atol=1e-5):
    """Distances within rtol (and atol: a self-match's l2sq |q|^2 - 2<q,x>
    + |x|^2 cancels to a few ulps of |q|^2 around 0); ids and labels equal,
    except that inside a group of tied distances the ids may come in
    another order (and a group that reaches the k-th column may hold other
    members of the tie)."""
    gd, gi, gl = got
    wd, wi, wl = want
    np.testing.assert_allclose(gd, wd, rtol=rtol, atol=atol)
    k = gd.shape[1]
    for r in range(gd.shape[0]):
        j = 0
        while j < k:
            e = j + 1
            while e < k and np.isclose(wd[r, e], wd[r, j], rtol=1e-6, atol=1e-6):
                e += 1
            if e - j == 1 or e < k:
                assert sorted(gi[r, j:e]) == sorted(wi[r, j:e]), (r, j, gi[r], wi[r])
            j = e
        same = gi[r] == wi[r]
        np.testing.assert_array_equal(gl[r][same], wl[r][same])


def _recall(found, truth):
    return np.mean([len(set(f[f >= 0].tolist()) & set(t.tolist())) / len(t)
                    for f, t in zip(found, truth)])


def _meshes(s):
    from lantern_tpu.parallel import make_mesh as ref_mesh

    return make_mesh(n_shards=s, device=CPU), ref_mesh(n_shards=s)


def _params(**kw):
    from lantern_tpu.config import HnswParams as RParams

    base = dict(dim=16, m=8, ef_construction=48)
    base.update(kw)
    return HnswParams(**base), RParams(**base)


def _base(seed=30, n=2400, dim=16):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


@pytest.fixture(scope="module", params=[4, 8], ids=["S4", "S8"])
def host_pair(request):
    """The reference tests' fixture shape (2400 x 16), built by both
    packages' build_sharded on one host thread."""
    from lantern_tpu.parallel import build_sharded as ref_build

    s = request.param
    base = _base()
    mesh, rmesh = _meshes(s)
    p, rp = _params()
    ix = build_sharded(base, p, mesh, seed=0, nthreads=1)
    rix = ref_build(base, rp, rmesh, seed=0, nthreads=1)
    return ix, rix, base, mesh, rmesh


# ---- the layout ----

def test_make_mesh():
    mesh = make_mesh(n_shards=5, device=CPU)
    assert mesh.shape == {"data": 1, "shard": 5}
    assert mesh.device == torch.device("cpu")
    assert make_mesh(device=CPU).shape["shard"] == 1  # no card, one shard
    with pytest.raises(ValueError):
        make_mesh(n_shards=2, data=2, device=CPU)
    with pytest.raises(ValueError):
        make_mesh(n_shards=0, device=CPU)


def test_shard_views_share_storage(host_pair):
    ix = host_pair[0]
    for si in range(ix.n_shards):
        g = ix.shard(si)
        for name in ("vectors", "neighbors0", "upper_neighbors", "labels"):
            t = getattr(g, name)
            assert t.is_contiguous()
            assert t.untyped_storage().data_ptr() == \
                getattr(ix, name).untyped_storage().data_ptr()
        assert (g.entry, g.num_nodes) == (ix.entry[si], ix.num_nodes[si])
    own = ps._unstack_shard(ix, 1)
    assert own.vectors.data_ptr() != ix.vectors[1].data_ptr()
    np.testing.assert_array_equal(own.neighbors0.numpy(), ix.neighbors0[1].numpy())


# ---- builds ----

def test_build_sharded_matches_reference(host_pair):
    ix, rix = host_pair[:2]
    assert_same_index(ix, rix)
    assert ix.params.m == 8


def test_build_sharded_python_engine_matches_reference():
    from lantern_tpu.parallel import build_sharded as ref_build

    base = _base(31, 400)
    mesh, rmesh = _meshes(4)
    p, rp = _params()
    assert_same_index(build_sharded(base, p, mesh, seed=2, use_native=False),
                      ref_build(base, rp, rmesh, seed=2, use_native=False))


def _bits(seed, n, dim=64):
    from lantern_tpu_torch.ops.distance import pack_bits

    raw = np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)
    return pack_bits(torch.from_numpy(raw)).numpy().view(np.uint32)


DEVICE_BUILDS = {
    "f32_S8": dict(s=8, kw={}),
    "bf16_S8": dict(s=8, kw=dict(store="bf16")),
    "hybrid_S8": dict(s=8, kw=dict(candidates="hybrid", flat_until=64)),
    "hamming_S8": dict(s=8, kw={}, hamming=True),
}


@pytest.mark.parametrize("case", sorted(DEVICE_BUILDS))
def test_build_sharded_device_matches_reference(case):
    """One schedule over all shards: every stacked array equal after the
    whole build (ramped rounds with -1 lanes for the shorter shards).

    Hamming: the adjacency too. Integer distances tie as a rule, and the
    flat pools' top-k (``ops/row_topk.py``) keeps the lower ids of a tie at
    its efc-th place, as the reference's does, so every edge is equal.
    Searches are then held to the host's popcount and to the reference's
    tie-aware recall. bf16: the graph exactly, the searches as noted
    below."""
    from lantern_tpu.parallel import build_sharded_device as ref_build
    from lantern_tpu.parallel import search_sharded as ref_search

    spec = DEVICE_BUILDS[case]
    hamming = spec.get("hamming", False)
    mesh, rmesh = _meshes(spec["s"])
    if hamming:
        base = _bits(41, 800)
        p, rp = _params(dim=64, metric=Metric.HAMMING, quant=QuantKind.B1)
    else:
        base = _base(40, 1200)
        p, rp = _params()
    ix = build_sharded_device(base, p, mesh, batch=128, seed=0, **spec["kw"])
    rix = ref_build(base, rp, rmesh, batch=128, seed=0, **spec["kw"])
    assert_same_index(ix, rix)
    if spec["kw"].get("store") == "bf16":
        assert ix.vectors.dtype == torch.bfloat16
    q = base[:16]
    got = port_result(search_sharded(ix, q, k=10, ef=48))
    want = ref_result(ref_search(rix, q, k=10, ef=48))
    np.testing.assert_array_equal(got[1][:, 0], np.arange(16))  # self hits
    if spec["kw"].get("store") == "bf16":
        # the reference's beam adds the stored norms of the f32 rows to a
        # product with the bf16 rows; K1 takes |x|^2 of the bf16 row itself
        np.testing.assert_allclose(got[0], want[0], atol=0.1)
        assert _recall(got[1], want[1]) >= 0.95
        return
    if not hamming:
        assert_results_match(got, want)
        return
    dist = np.bitwise_count(q[:, None, :] ^ base[None, :, :]).sum(-1)
    ids = np.maximum(got[1], 0)
    np.testing.assert_array_equal(got[0], np.take_along_axis(dist, ids, 1))
    kth = np.sort(dist, axis=1)[:, 9:10]

    def tie_recall(found):
        return np.mean(np.take_along_axis(dist, np.maximum(found, 0), 1) <= kth)

    assert tie_recall(got[1]) >= tie_recall(want[1]) - 0.02


def test_build_rejects_fewer_rows_than_shards():
    from lantern_tpu.parallel import build_sharded as ref_host
    from lantern_tpu.parallel import build_sharded_device as ref_dev

    base = _base(33, 4, 8)
    mesh, rmesh = _meshes(8)
    p, rp = _params(dim=8, m=4, ef_construction=16)
    for port_fn, ref_fn in ((build_sharded, ref_host),
                            (build_sharded_device, ref_dev)):
        with pytest.raises(ValueError, match="at least one vector per shard"):
            ref_fn(base, rp, rmesh)
        with pytest.raises(ValueError, match="at least one vector per shard"):
            port_fn(base, p, mesh)
    with pytest.raises(ValueError, match="candidates"):
        build_sharded_device(_base(33, 16, 8), p, mesh, candidates="walk")


# ---- searches and the merge ----

@pytest.mark.parametrize("k", [10, 20])
def test_search_sharded_matches_reference(host_pair, k):
    from lantern_tpu.parallel import search_sharded as ref_search

    ix, rix, base = host_pair[:3]
    q = np.random.default_rng(31).standard_normal((16, 16)).astype(np.float32)
    got = port_result(search_sharded(ix, q, k=k, ef=48))
    assert_results_match(got, ref_result(ref_search(rix, q, k=k, ef=48)))
    assert got[1].dtype == np.int32 and got[2].dtype == np.int64
    valid = got[1] >= 0
    np.testing.assert_array_equal(got[2][valid], got[1][valid])  # labels = gids


def test_flat_search_sharded_matches_reference(host_pair):
    from lantern_tpu.parallel import flat_search_sharded as ref_flat
    from lantern_tpu_torch.ops.distance import exact_search

    ix, rix, base = host_pair[:3]
    q = np.random.default_rng(32).standard_normal((12, 16)).astype(np.float32)
    got = port_result(flat_search_sharded(ix, q, k=10, exact=True))
    assert_results_match(got, ref_result(ref_flat(rix, q, k=10, exact=True)))
    truth = exact_search(torch.from_numpy(q), torch.from_numpy(base), 10)[1]
    np.testing.assert_array_equal(got[1], truth.numpy())


@pytest.mark.parametrize("host_pair", [8], indirect=True, ids=["S8"])
@pytest.mark.parametrize("form", ["global", "local"])
def test_filtered_searches_match_reference(host_pair, form):
    """exclude_gids as a [n_global] mask or as precomputed [S, cap] masks,
    on the beam and the flat scan."""
    import jax.numpy as jnp

    from lantern_tpu.parallel import flat_search_sharded as ref_flat
    from lantern_tpu.parallel import local_exclude_masks as ref_masks
    from lantern_tpu.parallel import search_sharded as ref_search

    ix, rix, base = host_pair[:3]
    mask = np.zeros(len(base), bool)
    mask[:50] = True
    mask[1000:1100] = True
    if form == "global":
        excl, rexcl = torch.from_numpy(mask), jnp.asarray(mask)
    else:
        excl = local_exclude_masks(ix, torch.from_numpy(mask))
        rexcl = ref_masks(rix, jnp.asarray(mask))
    q = base[:8]
    got = port_result(search_sharded(ix, q, k=5, ef=48, exclude_gids=excl))
    assert_results_match(got, ref_result(
        ref_search(rix, q, k=5, ef=48, exclude_gids=rexcl)))
    assert not np.isin(got[1], np.nonzero(mask)[0]).any()
    got = port_result(flat_search_sharded(ix, q, k=5, exact=True,
                                          exclude_gids=excl))
    assert_results_match(got, ref_result(
        ref_flat(rix, q, k=5, exact=True, exclude_gids=rexcl)))


@pytest.mark.parametrize("host_pair", [8], indirect=True, ids=["S8"])
def test_local_exclude_masks_match_reference(host_pair):
    """Blank gid slots always excluded; gids past a short mask not."""
    import jax.numpy as jnp

    from lantern_tpu.parallel import local_exclude_masks as ref_masks

    ix, rix, base = host_pair[:3]
    short = np.zeros(16, bool)
    short[15] = True
    full = np.random.default_rng(3).random(len(base)) < 0.3
    for mask in (short, full):
        got = local_exclude_masks(ix, torch.from_numpy(mask)).numpy()
        want = np.asarray(ref_masks(rix, jnp.asarray(mask)))
        np.testing.assert_array_equal(got, want)
    masks = local_exclude_masks(ix, torch.from_numpy(short)).numpy()
    gids = ix.global_ids[:, :ix.cap].numpy()
    assert masks[(gids >= 0) & (gids < 16)].sum() == 1
    assert not masks[gids >= 16].any() and masks[gids < 0].all()


@pytest.mark.parametrize("s", [4, 8])
def test_merge_topk_orders_ties_as_the_reference(s):
    """Integer distances (hamming's rule): equal values keep the lower
    shard-major column first, as jax.lax.top_k; blank gids never win."""
    import jax.numpy as jnp

    from lantern_tpu.parallel.sharded import _merge_topk as ref_merge

    rng = np.random.default_rng(s)
    q, k = 6, 10
    d = np.sort(rng.integers(0, 6, (s, q, k)).astype(np.float32), axis=2)
    gid = rng.permutation(s * q * k).reshape(s, q, k).astype(np.int32)
    gid[rng.random((s, q, k)) < 0.2] = -1
    d[..., -2:] = np.inf
    gid[..., -2:] = -1
    lab = gid.astype(np.int64) + 1000
    lab2 = np.stack([lab.astype(np.uint32), np.zeros_like(lab, np.uint32)], -1)
    got = port_result(ps._merge_topk(torch.from_numpy(d), torch.from_numpy(gid),
                                     torch.from_numpy(lab), k))
    want = ref_result(ref_merge(jnp.asarray(d), jnp.asarray(gid),
                                jnp.asarray(lab2), k))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---- one shard: the single graph's plan ----

PLAN_ARRAYS = ("levels", "upper_slot", "upper_ids", "neighbors0",
               "upper_neighbors")


def assert_shard_is_graph(ix, g):
    """Shard 0 of ``ix`` holds ``g``'s plan and graph exactly."""
    for name in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(ix, name)[0].numpy(),
                                      getattr(g, name).numpy(), err_msg=name)
    assert (ix.entry[0], ix.max_level[0], ix.num_nodes[0]) == (
        g.entry, g.max_level, g.num_nodes)


@pytest.mark.parametrize("metric", [Metric.L2SQ, Metric.COS], ids=["l2sq", "cos"])
def test_one_shard_runs_the_single_graph_plan(metric):
    """build_sharded_device and insert_sharded at S=1 give build_on_device
    and device_insert's graph (f32, flat pools): levels, upper slots and
    ids, both adjacency tables with their dummy rows, entry, maximum level
    and count, after the build and after an insert that grows the
    capacity."""
    from lantern_tpu_torch.graph.build_device import build_on_device, device_insert

    base = _base(5, 1300)
    p = HnswParams(dim=16, m=8, ef_construction=48, metric=metric)
    mesh = make_mesh(n_shards=1, device=CPU)
    ix = build_sharded_device(base[:1000], p, mesh, batch=128, seed=5)
    g = build_on_device(base[:1000], p, batch=128, seed=5, device=CPU)
    assert_shard_is_graph(ix, g)
    assert g.max_level >= 2 and g.upper_ids.shape[0] > 8
    ix = insert_sharded(ix, base[1000:], mesh, batch=128, seed=6)
    g = device_insert(g, base[1000:], batch=128, seed=6, ef_construction=48)
    assert g.cap == ix.cap == 2000 and g.num_nodes == 1300
    assert_shard_is_graph(ix, g)


# ---- lifecycle ----

INSERTS = {"grow": (400, 1600, 64)}


@pytest.mark.parametrize("case", sorted(INSERTS))
def test_insert_sharded_matches_reference(case):
    """Routing to gid % S, the level draws, capacity and upper-capacity
    growth and the rounds: every array equal (after a growing insert, a
    second insert too)."""
    from lantern_tpu.parallel import build_sharded as ref_build
    from lantern_tpu.parallel import insert_sharded as ref_insert
    from lantern_tpu.parallel import search_sharded as ref_search

    n0, b, batch = INSERTS[case]
    base = _base(77, n0 + b)
    extra = _base(78, 64)
    mesh, rmesh = _meshes(8)
    p, rp = _params()
    ix0 = build_sharded(base[:n0], p, mesh, seed=0, nthreads=1)
    rix = ref_build(base[:n0], rp, rmesh, seed=0, nthreads=1)
    before = port_arrays(ix0)
    ix = insert_sharded(ix0, base[n0:], mesh, batch=batch, seed=1)
    rix = ref_insert(rix, base[n0:], rmesh, batch=batch, seed=1)
    assert_same_index(ix, rix)
    for name, a in port_arrays(ix0).items():  # the input index is untouched
        np.testing.assert_array_equal(a, before[name])
    q = base[n0:n0 + 8]
    if case == "grow":  # then a second insert composes
        assert ix.cap > ix0.cap and sum(ix.num_nodes) == n0 + b
        ix = insert_sharded(ix, extra, mesh, batch=32, seed=2)
        rix = ref_insert(rix, extra, rmesh, batch=32, seed=2)
        assert_same_index(ix, rix)
        q = np.concatenate([q, extra[:8]])
    got = port_result(search_sharded(ix, q, k=5, ef=32))
    assert_results_match(got, ref_result(ref_search(rix, q, k=5, ef=32)))
    np.testing.assert_array_equal(
        got[1][:8, 0], np.arange(n0, n0 + 8))
    np.testing.assert_array_equal(got[1][8:, 0], n0 + b + np.arange(len(q) - 8))


@pytest.mark.parametrize("host_pair", [8], indirect=True, ids=["S8"])
def test_delete_sharded_matches_reference(host_pair):
    """Duplicates tombstone every row of the label; unknown labels nothing."""
    from lantern_tpu.parallel import delete_sharded as ref_delete
    from lantern_tpu.parallel import flat_search_sharded as ref_flat

    ix, rix, base = host_pair[:3]
    dead = np.r_[np.arange(0, 2400, 7), 5, 5, 10**9].astype(np.uint64)
    ix2, rix2 = delete_sharded(ix, dead), ref_delete(rix, dead)
    assert_same_index(ix2, rix2)
    assert not ix.deleted[ix.global_ids[:, :-1] == 7].any()  # input untouched
    q = base[:8]
    got = port_result(flat_search_sharded(ix2, q, k=5, exact=True))
    assert_results_match(got, ref_result(ref_flat(rix2, q, k=5, exact=True)))
    assert not np.isin(got[1], dead.astype(np.int64)).any()


@pytest.mark.parametrize("host_pair", [4], indirect=True, ids=["S4"])
def test_compact_sharded_matches_reference(host_pair):
    """Half deleted, then the device rebuild of the live rows (at S=4, the
    device build's second shard count): equal arrays (the live rows'
    global ids assigned anew, labels kept)."""
    from lantern_tpu.parallel import compact_sharded as ref_compact
    from lantern_tpu.parallel import delete_sharded as ref_delete

    ix, rix, base, mesh, rmesh = host_pair
    n = len(base)
    dead = np.arange(0, n // 2, dtype=np.uint64)
    ix3 = compact_sharded(delete_sharded(ix, dead), mesh, batch=128, seed=0)
    rix3 = ref_compact(ref_delete(rix, dead), rmesh, batch=128, seed=0)
    assert_same_index(ix3, rix3)
    live = ~ix3.deleted & (ix3.global_ids[:, :-1] >= 0)
    assert int(live.sum()) == n - n // 2
    lab = ix3.labels[live].numpy()
    assert lab.min() == n // 2 and len(np.unique(lab)) == n - n // 2
    with pytest.raises(ValueError, match="cannot change dim"):
        compact_sharded(ix, mesh, params=HnswParams(dim=8, m=8))


# ---- persistence ----

def _files(d):
    return sorted(f for f in os.listdir(d) if not f.endswith(".tmp"))


@pytest.mark.parametrize("host_pair", [8], indirect=True, ids=["S8"])
@pytest.mark.parametrize("engine", ["native", "python"])
def test_save_sharded_across_packages(host_pair, tmp_path, engine):
    """Both packages write the same bytes for equal indexes; each loads the
    other's directory and searches as the original."""
    from lantern_tpu.parallel import load_sharded as ref_load
    from lantern_tpu.parallel import save_sharded as ref_save
    from lantern_tpu.parallel import search_sharded as ref_search

    ix, rix, base, mesh, rmesh = host_pair
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    save_sharded(ix, mine)
    ref_save(rix, theirs)
    assert _files(mine) == _files(theirs)
    for name in _files(mine):
        with open(os.path.join(mine, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    q = base[:8]
    want = ref_result(ref_search(rix, q, k=5, ef=48))
    for d in (mine, theirs):  # the same directory into both packages
        assert_same_index(load_sharded(d, mesh, engine=engine),
                          ref_load(d, rmesh, engine=engine))
    back = load_sharded(theirs, mesh, engine=engine)
    assert_results_match(port_result(search_sharded(back, q, k=5, ef=48)), want)
    with pytest.raises(ValueError, match="shards but mesh"):
        load_sharded(mine, make_mesh(n_shards=3, device=CPU))
    with pytest.raises(ValueError, match="shards but mesh"):
        ref_load(mine, _meshes(3)[1])


def test_save_sharded_bf16_store_across_packages(tmp_path):
    """bf16 tables are written as "bfloat16"-tagged bits by both packages
    (byte-equal files) and widen exactly on load."""
    from lantern_tpu.parallel import build_sharded_device as ref_build
    from lantern_tpu.parallel import load_sharded as ref_load
    from lantern_tpu.parallel import save_sharded as ref_save

    base = _base(43, 600)
    mesh, rmesh = _meshes(4)
    p, rp = _params()
    ix = build_sharded_device(base, p, mesh, batch=128, seed=0, store="bf16")
    rix = ref_build(base, rp, rmesh, batch=128, seed=0, store="bf16")
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    save_sharded(ix, mine)
    ref_save(rix, theirs)
    for name in _files(mine):
        with open(os.path.join(mine, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    back = load_sharded(theirs, mesh)
    assert back.vectors.dtype == torch.float32
    np.testing.assert_array_equal(back.vectors.numpy(), ix.vectors.float().numpy())
    assert_same_index(back, ref_load(mine, rmesh))


# ---- host traffic of an insert ----

def test_insert_makes_no_full_graph_host_copy(monkeypatch):
    """Every tensor -> host conversion during insert_sharded is metadata:
    none reaches a quarter of the vector or adjacency table (levels are 4
    bytes a row against 64 here), as the reference's own test holds it."""
    base = _base(79, 1600)
    mesh = make_mesh(n_shards=8, device=CPU)
    ix = build_sharded(base[:1200], HnswParams(dim=16, m=8, ef_construction=48),
                       mesh, seed=0, nthreads=1)
    limit = min(ix.vectors.nbytes, ix.neighbors0.nbytes) // 4
    seen = []
    for name in ("cpu", "numpy", "tolist", "item"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, **kw):
            seen.append(self.nbytes)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)
    ix2 = insert_sharded(ix, base[1200:], mesh, batch=64, seed=1)
    monkeypatch.undo()
    assert seen and max(seen) < limit, (max(seen), limit)
    got = search_sharded(ix2, base[1200:1208], k=1, ef=32)[1]
    np.testing.assert_array_equal(got[:, 0].numpy(), np.arange(1200, 1208))


# ---- on the card ----

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sharded_search_on_card_matches_cpu(cuda):
    """A sharded index built on the card searches (beam, K1) and scans
    (exact flat) as the same build on the CPU; K1 counts its launches."""
    import importlib

    gd = importlib.import_module("lantern_tpu_torch.ops.gather_dists").gather_dists
    base = _base(44, 3000, 32)
    q = _base(45, 64, 32)
    p = HnswParams(dim=32, m=8, ef_construction=48)
    out = {}
    for dev in (cuda, CPU):
        mesh = make_mesh(n_shards=4, device=dev)
        ix = build_sharded(base, p, mesh, seed=0, nthreads=1)
        assert ix.vectors.device.type == torch.device(dev).type
        k1 = gd.launches
        beam = port_result(search_sharded(ix, q, k=10, ef=64))
        if dev == cuda:
            assert gd.launches > k1
        out[str(dev)] = beam, port_result(flat_search_sharded(ix, q, k=10,
                                                              exact=True))
    (cb, cf), (pb, pf) = out[str(cuda)], out[CPU]
    assert_results_match(cb, pb, rtol=1e-4)
    assert_results_match(cf, pf, rtol=1e-4)


def test_port_reaches_sharded_golden():
    """G1: the port's ``build_sharded`` (8 shards, native per-shard build,
    ``nthreads=1``, F1) and ``search_sharded`` at ef=64 on the pinned 10k x
    128 fixture reach the reference's ``sharded`` golden recall@10 (0.984,
    tol 0.01; tests/test_recall_golden.py:132-140)."""
    import pathlib

    from lantern_tpu_torch.io import parse_fvecs

    fixtures = pathlib.Path(__file__).parent / "fixtures"
    base = parse_fvecs(str(fixtures / "golden_base.fvecs.gz"))
    queries = parse_fvecs(str(fixtures / "golden_query.fvecs.gz"))
    assert base.shape == (10000, 128) and queries.shape == (100, 128)
    b_sq = np.einsum("nd,nd->n", base, base)
    gt = np.argsort(b_sq[None, :] - 2.0 * (queries @ base.T), axis=1,
                    kind="stable")[:, :10]
    ix = build_sharded(base, HnswParams(dim=128, m=16, ef_construction=64),
                       make_mesh(8, device=CPU), seed=0, nthreads=1)
    _, gids, _ = search_sharded(ix, torch.from_numpy(queries), k=10, ef=64)
    hits = sum(len(set(f[f >= 0].tolist()) & set(t.tolist()))
               for f, t in zip(gids.numpy(), gt))
    assert hits / gt.size >= 0.984 - 0.01
