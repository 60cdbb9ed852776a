"""Parity: the port's device builder against lantern_tpu.graph.build_device.

Both packages get the same numpy inputs; the reference runs on the CPU,
where its f32 products run at full precision and ``approx_max_k`` is an
exact top-k. Held exactly: the round schedule and its groups, the level
plan (levels, upper slots, per-level id lists with the UPPER_POOL_CAP
subsample, the hybrid switch, the progress reports), the selection
heuristic and ``_mask_to_ids`` on pools with ties and masked columns,
``_scatter_reverse`` on distinct distances, the hamming pair distances on
words >= 2^31, and one insert round (flat and beam) from one state: the
level-0 rows, the upper rows, the entry, the maximum level and the count.
l2sq / cos pair distances agree within 1e-5 relative (1e-6 absolute: the
products are summed in another order). A whole build at the reference
tests' shape (2000 x 16, m=8, efc=48, batch 128) has the same levels, slots
and entry, level-0 edge sets that agree on at least 0.98 of the edges
(1.0 measured here: every row equal), recall@10 within 0.01, and passes
``validate_device``. No exception was found: every round of every build
and insert in these files gave the reference's rows exactly.

The rest mirrors tests/test_build_device.py on the port alone: cosine,
hamming, ``store="bf16"``, n < batch, the progress callback, hybrid and
beam pools, incremental inserts into f32, bf16, i8, PQ (old codes come back
unchanged) and hamming graphs, with capacity growth. No row but a dummy is
written twice in one scatter. The tests marked ``cuda`` build on the card:
the same structure checks and recall within 0.01 of the CPU build, K1's and
K4's launch counts rising in beam and hamming builds, and no plain version
run for a CUDA input. jax is imported only inside the CPU parity tests, so
``pytest --noconftest -m cuda`` runs this file on a machine without jax.
"""

import numpy as np
import pytest
import torch

from lantern_tpu_torch.config import HnswParams, Metric, QuantKind
from lantern_tpu_torch.graph import build_device as bd
from lantern_tpu_torch.graph.build_device import build_on_device, device_insert
from lantern_tpu_torch.graph.device import to_device
from lantern_tpu_torch.graph.search import search_batched
from lantern_tpu_torch.graph.validate import validate_device
from lantern_tpu_torch.native import LMAX, NativeHnsw
from lantern_tpu_torch.ops.distance import exact_search

FIX_N, FIX_DIM, FIX_EFC, FIX_BATCH = 2000, 16, 48, 128
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the builder's many small ops
    run faster on one, and the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recall(found, truth):
    found, truth = np.asarray(found), np.asarray(truth)
    return np.mean([len(set(f[f >= 0].tolist()) & set(t.tolist())) / len(t)
                    for f, t in zip(found, truth)])


def _truth(q, base, metric=Metric.L2SQ, k=10):
    return exact_search(torch.from_numpy(q), torch.from_numpy(base), k,
                        metric)[1].numpy()


def _search(g, q, k=10, ef=64):
    return search_batched(g, torch.from_numpy(np.asarray(q)), k=k, ef=ef)


def _edges(nb):
    rows = np.repeat(np.arange(nb.shape[0]), nb.shape[1])
    flat = nb.reshape(-1)
    return set(zip(rows[flat >= 0].tolist(), flat[flat >= 0].tolist()))


@pytest.fixture(scope="module")
def ref():
    import lantern_tpu.graph.build_device as rbd

    return rbd


@pytest.fixture(scope="module")
def fix_base():
    return np.random.default_rng(60).standard_normal(
        (FIX_N, FIX_DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def fix_params():
    return HnswParams(dim=FIX_DIM, m=8, ef_construction=FIX_EFC)


@pytest.fixture(scope="module")
def port_fix(fix_base, fix_params):
    return build_on_device(fix_base, fix_params, batch=FIX_BATCH, seed=0,
                           device=CPU)


@pytest.fixture(scope="module")
def ref_fix(ref, fix_base):
    from lantern_tpu.config import HnswParams as RParams

    g = ref.build_on_device(fix_base, RParams(dim=FIX_DIM, m=8,
                                              ef_construction=FIX_EFC),
                            batch=FIX_BATCH, seed=0)
    return {k: np.asarray(getattr(g, k)) for k in (
        "neighbors0", "upper_neighbors", "upper_slot", "levels", "upper_ids",
        "entry", "max_level")}, g


# ---- the pure parts ----

@pytest.mark.parametrize("n,batch", [(5, 256), (300, 64), (2000, 128),
                                     (100_003, 1024), (1, 1), (40_000, 100)])
def test_round_schedule_matches(ref, n, batch):
    assert list(bd.ramped_batches(n, batch)) == list(ref.ramped_batches(n, batch))
    # one shard: the groups of the build's plan
    got = [(ids[:, 0], done) for ids, _, done in
           bd.build_groups(n, [n], batch, "flat", 0)]
    want = list(ref._grouped_round_ids(n, batch))
    assert len(got) == len(want)
    for (a, da), (b, db) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert da == db


def test_level_plan_matches(ref, monkeypatch):
    """Levels, slots, the planned upper_ids, the first entry, the per-level
    id lists (level 1 above UPPER_POOL_CAP, so subsampled from the same
    generator), each group's ids and pool route, and the progress reports:
    the rounds themselves are replaced by recorders."""
    from lantern_tpu.config import HnswParams as RParams

    n = 70_000  # m=2: ~35k nodes of level >= 1
    x = np.random.default_rng(3).standard_normal((n, 2)).astype(np.float32)
    calls = {"port": [], "ref": []}

    def recorder(st, ids2d, level_ids, efc, max_in, flat_cand=False):
        calls["ref"].append((np.asarray(ids2d), [np.asarray(v) for v in level_ids],
                             efc, max_in, flat_cand))
        return st

    def port_recorder(states, level_ids, groups, efc, max_in):
        # one shard: a group's rounds and the level lists of shard 0
        for rounds, flat_cand in groups:
            calls["port"].append((np.stack(rounds)[:, 0],
                                  [v[0] for v in level_ids], efc, max_in,
                                  flat_cand))

    monkeypatch.setattr(bd, "insert_rounds", port_recorder)
    monkeypatch.setattr(ref, "insert_rounds", recorder)
    fr = {"port": [], "ref": []}
    kw = dict(batch=1024, seed=7, candidates="hybrid", flat_until=50_000)
    g = build_on_device(x, HnswParams(dim=2, m=2, ef_construction=16),
                        progress_cb=fr["port"].append, device=CPU, **kw)
    gr = ref.build_on_device(x, RParams(dim=2, m=2, ef_construction=16),
                             progress_cb=fr["ref"].append, **kw)
    assert fr["port"] == fr["ref"] and fr["port"][-1] == 1.0
    for name in ("levels", "upper_slot", "upper_ids"):
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      np.asarray(getattr(gr, name)))
    assert (g.entry, g.max_level) == (int(gr.entry), int(gr.max_level))
    assert len(calls["port"]) == len(calls["ref"]) > 1
    assert len(calls["port"][0][1][0]) == bd.UPPER_POOL_CAP
    for (a, la, *ra), (b, lb, *rb) in zip(calls["port"], calls["ref"]):
        np.testing.assert_array_equal(a, b)
        assert ra == rb
        assert len(la) == len(lb)
        for u, v in zip(la, lb):
            np.testing.assert_array_equal(u, v)
    assert {c[-1] for c in calls["port"]} == {True, False}  # both routes


def _tied_pools(rng, b, c):
    """Pools with ties (distances on a 0.25 grid) and masked columns."""
    pool_d = np.sort(np.round(rng.uniform(0, 4, (b, c)) * 4) / 4, axis=1)
    pair = np.round(rng.uniform(0, 4, (b, c, c)) * 4) / 4
    pair = np.minimum(pair, pair.transpose(0, 2, 1)).astype(np.float32)
    keep = rng.random((b, c)) < 0.8
    return pool_d.astype(np.float32), pair, keep


@pytest.mark.parametrize("m", [1, 3, 8])
def test_select_heuristic_and_mask_to_ids_match(ref, rng, m):
    import jax.numpy as jnp

    pool_d, pair, keep = _tied_pools(rng, 6, 40)
    ids = rng.permutation(1000)[:240].reshape(6, 40).astype(np.int32)
    got = bd.select_heuristic_batch(torch.from_numpy(pool_d),
                                    torch.from_numpy(pair),
                                    torch.from_numpy(keep), m)
    want = ref.select_heuristic_batch(jnp.asarray(pool_d), jnp.asarray(pair),
                                      jnp.asarray(keep), m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.sum(1) <= m).all()
    for mask in (got, torch.from_numpy(keep)):
        np.testing.assert_array_equal(
            bd._mask_to_ids(torch.from_numpy(ids), mask, m).numpy(),
            np.asarray(ref._mask_to_ids(jnp.asarray(ids),
                                        jnp.asarray(mask.numpy()), m)))


def _distinct_rows(rng, n, d, gap=1e-4):
    """Gaussian rows (sd 4) whose pairwise squared distances differ by >
    gap."""
    x = (4 * rng.standard_normal((n, d))).astype(np.float32)
    dist = ((x[:, None] - x[None]) ** 2).sum(-1)[np.triu_indices(n, 1)]
    assert np.diff(np.sort(dist)).min() > gap
    return x


@pytest.mark.parametrize("chunk,budget", [(16, None), (1024, None), (8, 12)])
def test_scatter_reverse_matches(ref, chunk, budget):
    """One reverse pass: targets appear up to 5 times (over max_in), rows
    overflow, an incomer repeats a forward neighbour, -1 edges are skipped;
    the lane budget (8, 12) cuts targets off as the reference does."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    n, deg, max_in = 40, 6, 4
    x = _distinct_rows(rng, n, 8)
    adj = np.full((n + 1, deg), -1, np.int32)
    for r in range(n):
        k = rng.integers(0, deg + 1)
        adj[r, :k] = rng.choice(np.delete(np.arange(n), r), k, replace=False)
    targets = rng.integers(-1, n // 2, 60).astype(np.int32)
    sources = rng.integers(n // 2, n, 60).astype(np.int32)
    targets[0], sources[0] = 3, adj[3, 0]  # an incomer already in the row
    got = torch.from_numpy(adj.copy())
    bd._scatter_reverse(got, lambda t: t, n, torch.from_numpy(targets),
                        torch.from_numpy(sources), torch.from_numpy(x),
                        Metric.L2SQ, deg, max_in, lane_chunk=chunk,
                        lane_budget=budget)
    want = ref._scatter_reverse(jnp.asarray(adj), lambda t: t, n,
                                jnp.asarray(targets), jnp.asarray(sources),
                                jnp.asarray(x), ref.Metric.L2SQ, deg, max_in,
                                lane_chunk=chunk, lane_budget=budget)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != adj).any()


@pytest.mark.parametrize("w", [1, 3, 32])
def test_pair_dists_hamming_exact(ref, rng, w):
    import jax.numpy as jnp

    a = rng.integers(0, 2**32, (3, 7, w), dtype=np.uint32)
    b = rng.integers(0, 2**32, (3, 5, w), dtype=np.uint32)
    a[0, 0] = 0xFFFFFFFF  # words >= 2^31 are negative as int32
    assert (a >= 2**31).any() and (b >= 2**31).any()
    z = np.zeros((3, 7), np.float32)
    got = bd._pair_dists(torch.from_numpy(a.view(np.int32)), None,
                         torch.from_numpy(b.view(np.int32)), None,
                         Metric.HAMMING).numpy()
    want = np.asarray(ref._pair_dists(jnp.asarray(a), jnp.asarray(z),
                                      jnp.asarray(b), jnp.asarray(z[:, :5]),
                                      ref.Metric.HAMMING))
    np.testing.assert_array_equal(got, want)
    bits = np.unpackbits((a[:, :, None] ^ b[:, None]).view(np.uint8), axis=-1)
    np.testing.assert_array_equal(got, bits.sum(-1))


@pytest.mark.parametrize("metric", [Metric.L2SQ, Metric.COS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_dists_float(ref, rng, metric, dtype):
    import jax.numpy as jnp

    a = rng.standard_normal((4, 9, 24)).astype(np.float32)
    b = rng.standard_normal((4, 6, 24)).astype(np.float32)
    ta, tb = torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype)
    ja, jb = (jnp.asarray(ta.float().numpy()), jnp.asarray(tb.float().numpy()))
    if dtype == torch.bfloat16:
        ja, jb = ja.astype(jnp.bfloat16), jb.astype(jnp.bfloat16)
    got = bd._pair_dists(ta, bd._sq_of(ta, metric), tb, bd._sq_of(tb, metric),
                         metric).numpy()
    want = np.asarray(ref._pair_dists(ja, ref._sq_of(ja, metric), jb,
                                      ref._sq_of(jb, metric), metric))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---- one insert round from one state ----

def _state_arrays(seed=5, n0=512, b=128, dim=16, m=8):
    """A mid-build state: a port-built graph of n0 rows, then b planned rows
    (levels drawn, upper slots and upper_ids assigned, a dummy slot)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n0 + b, dim)).astype(np.float32)
    p = HnswParams(dim=dim, m=m, ef_construction=32)
    g = build_on_device(x[:n0], p, batch=64, seed=seed, device=CPU)
    new_lv = bd._draw_levels(rng, b, p.level_lambda)
    levels = np.concatenate([g.levels.numpy(), new_lv])
    slots = g.upper_slot.numpy()
    nu0 = int(slots.max()) + 1
    new_slots = np.full(b, -1, np.int32)
    new_slots[new_lv >= 1] = nu0 + np.arange((new_lv >= 1).sum())
    slots = np.concatenate([slots, new_slots]).astype(np.int32)
    ucap = int(slots.max()) + 2
    upper = np.full((ucap, LMAX, m), -1, np.int32)
    upper[:nu0] = g.upper_neighbors.numpy()[:nu0]
    nb0 = np.full((n0 + b + 1, 2 * m), -1, np.int32)
    nb0[:n0] = g.neighbors0.numpy()[:n0]
    from lantern_tpu_torch.graph.device import upper_ids_from_slots

    lids = [np.nonzero(levels >= lv)[0].astype(np.int32)
            for lv in range(1, int(levels.max()) + 1)]
    padded = []
    for ids in lids:
        size = max(8, 1 << int(np.ceil(np.log2(len(ids)))))
        padded.append(np.concatenate([ids, np.full(size - len(ids), -1, np.int32)]))
    return dict(
        vectors=x, sq_norms=(x * x).sum(1), neighbors0=nb0,
        upper_neighbors=upper, upper_slot=slots, levels=levels.astype(np.int32),
        upper_ids=upper_ids_from_slots(slots, ucap), entry=g.entry,
        max_level=g.max_level, n=n0, m=m, dim=dim, level_ids=padded,
        ids=np.arange(n0, n0 + b, dtype=np.int32))


@pytest.mark.parametrize("flat", [True, False])
def test_one_insert_round_matches(ref, flat):
    import jax.numpy as jnp

    s = _state_arrays()
    t = {k: torch.from_numpy(np.array(s[k])) for k in (
        "vectors", "sq_norms", "neighbors0", "upper_neighbors", "upper_slot",
        "levels", "upper_ids")}
    st = bd.BuildState(**t, host_levels=s["levels"], entry=s["entry"],
                       max_level=s["max_level"], n=s["n"], m=s["m"],
                       dim=s["dim"], metric=int(Metric.L2SQ))
    # one shard, one group of one round
    bd.insert_rounds([st], [v[None] for v in s["level_ids"]],
                     [([s["ids"][None]], flat)], efc=32, max_in=4)
    rst = ref.BuildState(
        **{k: jnp.asarray(s[k]) for k in (
            "vectors", "sq_norms", "neighbors0", "upper_neighbors",
            "upper_slot", "levels", "upper_ids")},
        entry=jnp.asarray(s["entry"], jnp.int32),
        max_level=jnp.asarray(s["max_level"], jnp.int32),
        n=jnp.asarray(s["n"], jnp.int32), m=s["m"], dim=s["dim"],
        metric=int(Metric.L2SQ))
    # the reference's jitted group of one round (eager op-by-op is slow)
    out = ref.insert_rounds(rst, jnp.asarray(s["ids"])[None],
                            tuple(jnp.asarray(v) for v in s["level_ids"]),
                            efc=32, max_in=4, flat_cand=flat)
    np.testing.assert_array_equal(st.neighbors0.numpy(),
                                  np.asarray(out.neighbors0))
    np.testing.assert_array_equal(st.upper_neighbors.numpy(),
                                  np.asarray(out.upper_neighbors))
    assert (st.entry, st.max_level, st.n) == (
        int(out.entry), int(out.max_level), int(out.n))
    assert (st.neighbors0.numpy()[s["ids"]] >= 0).any(1).all()


# ---- whole builds ----

def test_build_matches_reference(ref_fix, port_fix, fix_base, rng):
    want, rg = ref_fix
    g = port_fix
    for name in ("levels", "upper_slot", "upper_ids"):
        np.testing.assert_array_equal(getattr(g, name).numpy(), want[name])
    assert (g.entry, g.max_level) == (int(want["entry"]), int(want["max_level"]))
    e_port = _edges(g.neighbors0.numpy()[:FIX_N])
    e_ref = _edges(want["neighbors0"][:FIX_N])
    assert len(e_port & e_ref) / len(e_ref) >= 0.98
    assert len(e_port & e_ref) / len(e_port) >= 0.98
    import jax.numpy as jnp
    from lantern_tpu.graph.search import search_batched as rsearch

    q = rng.standard_normal((32, FIX_DIM)).astype(np.float32)
    truth = _truth(q, fix_base)
    r_port = _recall(_search(g, q)[1].numpy(), truth)
    r_ref = _recall(np.asarray(rsearch(rg, jnp.asarray(q), k=10, ef=64)[1]), truth)
    assert abs(r_port - r_ref) <= 0.01 and r_port >= 0.85
    validate_device(g, full=True).raise_if_failed()
    nb = g.neighbors0.numpy()[:FIX_N]
    assert ((nb != np.arange(FIX_N)[:, None]) | (nb < 0)).all(), "self loops"
    assert ((nb >= 0).sum(1) >= 1).all()


def test_no_row_written_twice(monkeypatch):
    """Every scatter of a flat build and of a beam insert names each row at
    most once among its active lanes, and never the dummy: only the dummy
    rows can receive more than one write."""
    calls = []
    real = bd._masked_set

    def checked(table, idx, values, active, dummy):
        live = idx[active].long()
        assert live.unique().numel() == live.numel()
        assert (live != dummy).all()
        calls.append(int(active.sum()))
        real(table, idx, values, active, dummy)

    monkeypatch.setattr(bd, "_masked_set", checked)
    x = np.random.default_rng(8).standard_normal((600, 8)).astype(np.float32)
    p = HnswParams(dim=8, m=4, ef_construction=16)
    g = build_on_device(x[:400], p, batch=64, seed=0, device=CPU)
    dummy0 = g.neighbors0[g.cap].clone()
    g2 = device_insert(g, x[400:], batch=64, seed=1, ef_construction=16,
                       candidates="beam")
    assert len(calls) > 50 and sum(calls) > 0
    assert (dummy0 == -1).all() and (g2.neighbors0[g2.cap] == -1).all()


def test_device_build_cosine():
    rng = np.random.default_rng(63)
    base = rng.standard_normal((800, 16)).astype(np.float32)
    p = HnswParams(dim=16, m=8, ef_construction=48, metric=Metric.COS)
    g = build_on_device(base, p, batch=128, seed=0, device=CPU)
    q = rng.standard_normal((16, 16)).astype(np.float32)
    assert _recall(_search(g, q)[1], _truth(q, base, Metric.COS)) >= 0.85
    validate_device(g).raise_if_failed()


def test_device_build_hamming():
    rng = np.random.default_rng(65)
    base = rng.integers(0, 2**32, size=(800, 2), dtype=np.uint32)
    p = HnswParams(dim=64, m=8, ef_construction=48, metric=Metric.HAMMING)
    g = build_on_device(base, p, batch=128, seed=0, device=CPU)
    assert g.num_nodes == 800 and g.vectors.dtype == torch.int32
    d, ids, _ = search_batched(g, torch.from_numpy(base[:8].view(np.int32)),
                               k=3, ef=32)
    assert (ids[:, 0].numpy() == np.arange(8)).all() and (d[:, 0] == 0).all()
    q = base[:8].view(np.int32)
    truth = _truth(q, base.view(np.int32), Metric.HAMMING)
    assert _recall(_search(g, q)[1], truth) >= 0.8
    validate_device(g).raise_if_failed()


def test_device_build_bf16_store(port_fix, fix_base, fix_params, rng):
    """store="bf16" from a bf16 tensor, donated: a bf16 graph within 0.03
    recall of the f32 build, structure valid."""
    x = torch.from_numpy(fix_base).to(torch.bfloat16)
    g16 = build_on_device(x, fix_params, batch=FIX_BATCH, seed=0, donate=True,
                          store="bf16", device=CPU)
    assert g16.vectors is x and g16.quant == int(QuantKind.F16)
    assert g16.num_nodes == FIX_N
    q = rng.standard_normal((32, FIX_DIM)).astype(np.float32)
    truth = _truth(q, fix_base)
    r32 = _recall(_search(port_fix, q)[1], truth)
    r16 = _recall(_search(g16, q)[1], truth)
    assert r16 >= r32 - 0.03, (r16, r32)
    validate_device(g16).raise_if_failed()
    # not donated: the caller's tensor is copied
    g = build_on_device(x[:200], fix_params, batch=64, store="bf16", device=CPU)
    assert g.vectors.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("candidates", ["hybrid", "beam"])
def test_device_build_beam_and_hybrid(port_fix, fix_base, fix_params, rng,
                                      candidates):
    g = build_on_device(fix_base, fix_params, batch=FIX_BATCH, seed=0,
                        candidates=candidates, flat_until=800, device=CPU)
    assert g.num_nodes == FIX_N
    validate_device(g).raise_if_failed()
    q = rng.standard_normal((32, FIX_DIM)).astype(np.float32)
    truth = _truth(q, fix_base)
    rf = _recall(_search(port_fix, q)[1], truth)
    rh = _recall(_search(g, q)[1], truth)
    assert rh >= rf - 0.08 and rh >= 0.8, (rh, rf)


def test_device_build_tiny():
    base = np.random.default_rng(64).standard_normal((5, 8)).astype(np.float32)
    g = build_on_device(base, HnswParams(dim=8, m=4, ef_construction=16),
                        batch=256, seed=0, device=CPU)
    assert (_search(g, base, k=5, ef=8)[1][:, 0].numpy() == np.arange(5)).all()


def test_build_progress_callback():
    base = np.random.default_rng(72).standard_normal((300, 8)).astype(np.float32)
    fracs = []
    build_on_device(base, HnswParams(dim=8, m=4, ef_construction=16), batch=64,
                    seed=0, progress_cb=fracs.append, device=CPU)
    assert fracs and abs(fracs[-1] - 1.0) < 1e-9
    assert all(b >= a for a, b in zip(fracs, fracs[1:]))


def test_bad_arguments_raise(fix_params):
    x = np.zeros((10, FIX_DIM), np.float32)
    with pytest.raises(ValueError, match="candidates"):
        build_on_device(x, fix_params, candidates="exact", device=CPU)
    with pytest.raises(ValueError, match="store"):
        build_on_device(x, fix_params, store="i8", device=CPU)


# ---- incremental inserts ----

def test_device_insert_hybrid_routes_to_beam(monkeypatch):
    rng = np.random.default_rng(67)
    base = rng.standard_normal((800, 16)).astype(np.float32)
    p = HnswParams(dim=16, m=8, ef_construction=48)
    g = build_on_device(base, p, batch=128, seed=0, device=CPU)
    routes = []
    real = bd.insert_rounds

    def spy(states, level_ids, groups, efc, max_in):
        groups = list(groups)
        routes.extend(flat_cand for _, flat_cand in groups)
        return real(states, level_ids, groups, efc, max_in)

    monkeypatch.setattr(bd, "insert_rounds", spy)
    extra = rng.standard_normal((300, 16)).astype(np.float32)
    g2 = device_insert(g, extra, batch=128, seed=1, candidates="hybrid",
                       flat_until=1)
    assert routes == [False]
    assert g2.num_nodes == 1100 and g.num_nodes == 800
    allv = np.concatenate([base, extra])
    q = rng.standard_normal((24, 16)).astype(np.float32)
    assert _recall(_search(g2, q)[1], _truth(q, allv)) >= 0.8


def test_device_insert_incremental():
    """Inserts with capacity growth (800 -> 1600 rows): the input graph is
    left as it was, new rows find themselves, old labels stay."""
    rng = np.random.default_rng(70)
    base = rng.standard_normal((1200, 16)).astype(np.float32)
    p = HnswParams(dim=16, m=8, ef_construction=48)
    g = build_on_device(base[:800], p, batch=128, seed=0, device=CPU)
    before = g.neighbors0.clone()
    labels = np.arange(5000, 5400, dtype=np.uint64)
    g2 = device_insert(g, base[800:], labels=labels, batch=128, seed=1,
                       ef_construction=48)
    assert torch.equal(g.neighbors0, before) and g.num_nodes == 800
    assert g2.num_nodes == 1200 and g2.cap == 1600
    assert g2.neighbors0.shape[0] == 1601
    q = base[::97]
    assert _recall(_search(g2, q)[1], _truth(q, base)) >= 0.85
    _, ids, lab = _search(g2, base[800:808], k=1, ef=32)
    np.testing.assert_array_equal(ids[:, 0].numpy(), np.arange(800, 808))
    np.testing.assert_array_equal(lab[:, 0].numpy(), labels[:8].view(np.int64))
    np.testing.assert_array_equal(g2.labels[:800].numpy(), np.arange(800))
    validate_device(g2).raise_if_failed()


@pytest.mark.parametrize("kind", ["bf16", "i8"])
def test_device_insert_quantized(kind):
    rng = np.random.default_rng(66)
    base = rng.standard_normal((900, 16)).astype(np.float32)
    p = HnswParams(dim=16, m=8, ef_construction=48)
    eng = NativeHnsw(p, capacity=600, seed=0)
    eng.add(base[:600], nthreads=1)
    kw = {"dtype": torch.bfloat16} if kind == "bf16" else {"quant": QuantKind.I8}
    g = to_device(eng, device=CPU, **kw)
    g2 = device_insert(g, base[600:], batch=128, seed=1, ef_construction=48)
    assert g2.num_nodes == 900 and g2.vectors.dtype == g.vectors.dtype
    assert (g2.vec_scales is not None) == (kind == "i8")
    # the old rows come back exactly
    assert torch.equal(g2.vectors[:600], g.vectors[:600])
    _, ids, _ = _search(g2, base[600:608], k=1, ef=32)
    np.testing.assert_array_equal(ids[:, 0].numpy(), np.arange(600, 608))
    q = base[::91]
    assert _recall(_search(g2, q)[1], _truth(q, base)) >= 0.8


def test_device_insert_pq_graph():
    """Into a PQ graph (OPQ rotation too): the old codes come back
    unchanged, the new rows are found through the ADC beam."""
    from lantern_tpu_torch.graph.device import QUANT_PQ
    from lantern_tpu_torch.index import Index
    from lantern_tpu_torch.quant.pq import pq_decode

    rng = np.random.default_rng(91)
    base = rng.standard_normal((600, 32)).astype(np.float32)
    p = HnswParams(dim=32, m=8, ef_construction=48, pq=True,
                   num_subvectors=8, num_centroids=64)
    for rotate in (False, True):
        ix = Index(p, capacity=600, device=CPU)
        ix.train_pq(base, rotate=rotate, opq_iters=2)
        ix.add(base, nthreads=1)
        g = ix.device_graph
        assert g.quant == QUANT_PQ
        old = g.vectors[:600].clone()
        extra = rng.standard_normal((40, 32)).astype(np.float32)
        g2 = device_insert(g, extra, labels=np.arange(1000, 1040, dtype=np.uint64),
                           batch=16, seed=1)
        assert g2.quant == QUANT_PQ and g2.num_nodes == 640
        assert torch.equal(g2.vectors[:600], old)
        assert (g2.pq_rotation is not None) == rotate
        dec = pq_decode(g2.vectors[:640].numpy(), ix._codebook)
        q = extra[:8]
        _, ids, lab = _search(g2, q, k=3, ef=48)
        want = np.argmin(((dec[None] - q[:, None]) ** 2).sum(-1), axis=1)
        assert (ids[:, 0].numpy() == want).mean() >= 0.75
        assert (lab[:, 0].numpy()[ids[:, 0].numpy() >= 600] >= 1000).all()
        validate_device(g2).raise_if_failed()


def test_device_insert_hamming():
    rng = np.random.default_rng(67)
    base = rng.integers(0, 2**32, size=(500, 2), dtype=np.uint32)
    p = HnswParams(dim=64, m=8, ef_construction=32, metric=Metric.HAMMING)
    g = build_on_device(base[:300], p, batch=128, seed=0, device=CPU)
    g2 = device_insert(g, base[300:], batch=64, seed=1, ef_construction=32)
    assert g2.num_nodes == 500
    d, ids, _ = search_batched(g2, torch.from_numpy(base[300:306].view(np.int32)),
                               k=1, ef=16)
    np.testing.assert_array_equal(ids[:, 0].numpy(), np.arange(300, 306))
    assert (d[:, 0] == 0).all()
    validate_device(g2).raise_if_failed()


# ---- on the card ----

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _clustered(seed, n, dim=32):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((40, dim)).astype(np.float32)
    x = c[rng.integers(0, 40, n)] + 0.35 * rng.standard_normal((n, dim))
    return x.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("candidates", ["flat", "beam"])
def test_build_on_card_matches_cpu(cuda, candidates):
    x = _clustered(1, 3000)
    q = _clustered(2, 64)
    p = HnswParams(dim=32, m=8, ef_construction=48)
    truth = _truth(q, x)
    recalls, plans = [], []
    for dev in (cuda, CPU):
        g = build_on_device(x, p, batch=256, seed=0, candidates=candidates,
                            device=dev)
        assert g.vectors.device.type == torch.device(dev).type
        validate_device(g).raise_if_failed()
        ids = search_batched(g, torch.from_numpy(q).to(dev), k=10, ef=64)[1]
        recalls.append(_recall(ids.cpu().numpy(), truth))
        plans.append((g.levels.cpu().numpy(), g.upper_slot.cpu().numpy(),
                      g.num_nodes))
    assert abs(recalls[0] - recalls[1]) <= 0.01, recalls
    assert min(recalls) >= 0.9
    for a, b in zip(plans[0], plans[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_card_builds_launch_k1_and_k4(cuda, monkeypatch):
    """Beam rounds launch K1, hamming flat rounds K4; a plain version is
    never run for a CUDA input."""
    import importlib

    # the modules (the package exports functions of the same names)
    gd = importlib.import_module("lantern_tpu_torch.ops.gather_dists")
    hm = importlib.import_module("lantern_tpu_torch.ops.hamming")

    def refuse(*a, **k):
        raise AssertionError("plain version run for a CUDA input")

    for mod, name in ((gd, "gather_dists_ref"), (hm, "hamming_block_ref"),
                      (hm, "hamming_scores_ref")):
        monkeypatch.setattr(mod, name, refuse)
    x = _clustered(3, 2000)
    k1 = gd.gather_dists.launches
    g = build_on_device(x, HnswParams(dim=32, m=8, ef_construction=48),
                        batch=256, seed=0, candidates="beam", device=cuda)
    assert gd.gather_dists.launches > k1
    k1 = gd.gather_dists.launches
    device_insert(g, _clustered(4, 300), batch=128, seed=1, candidates="beam")
    assert gd.gather_dists.launches > k1
    words = np.random.default_rng(5).integers(0, 2**32, (2000, 32), dtype=np.uint32)
    k4 = hm.hamming_block.launches
    g = build_on_device(words, HnswParams(dim=1024, m=8, ef_construction=48,
                                          metric=Metric.HAMMING),
                        batch=256, seed=0, device=cuda)
    assert hm.hamming_block.launches > k4
    validate_device(g).raise_if_failed()
