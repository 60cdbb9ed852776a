"""Parity: quantised sharded indexes (PQ, i8, b1) against the reference.

The reference runs on conftest's 8-device CPU mesh, the port on CPU
tensors, both from the same numpy inputs and the same host-built shards
(``nthreads=1``). Given the reference's trained codebook,
``quantize_sharded`` gives the same PQ codes, bf16 rerank rows and norms;
``"i8"`` the same codes and scales; the port's own training takes the
reference's cross-shard sample with the reference's arguments. Searches
over the quantised shards (the ADC beam, the ADC flat scan, the rerank,
the i8 beam and flat scan) agree up to tied distances. ``insert_sharded``
into PQ shards (old codes unchanged, the rerank copy extended by the true
rows) and i8 shards, ``delete_sharded`` and ``compact_sharded`` (encoded
again with the old codebook) give equal arrays; into b1 shards too, the
adjacency included (the flat pools keep the lower ids of a hamming tie).
``save_sharded`` of PQ indexes writes the reference's bytes (i8: the
manifest's; the reference's i8 scales can differ by an ulp), and each
package loads the other's directory to equal codes. The reference's
ValueErrors (double quantisation, hamming shards, a rerank without rows)
are the port's.
"""

import os

import numpy as np
import pytest
import torch

from lantern_tpu_torch.config import Metric, QuantKind
from lantern_tpu_torch.graph.device import QUANT_PQ
from lantern_tpu_torch.parallel import (
    build_sharded,
    compact_sharded,
    delete_sharded,
    flat_search_sharded,
    flat_search_sharded_rerank,
    insert_sharded,
    load_sharded,
    quantize_sharded,
    save_sharded,
    search_sharded,
)
from lantern_tpu_torch.quant.pq import PQCodebook
from test_torch_sharded import (
    _base,
    _bits,
    _files,
    _meshes,
    _params,
    assert_results_match,
    assert_same_index,
    port_result,
    ref_result,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clustered(seed, n, dim=32, centers=64, jitter=0.3):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, dim)).astype(np.float32)
    return (c[rng.integers(0, centers, n)]
            + jitter * rng.standard_normal((n, dim))).astype(np.float32)


def _ref_codebook(rix) -> PQCodebook:
    g = rix.graphs
    return PQCodebook(
        centroids=np.asarray(g.pq_codebook[0], np.float32),
        rotation=(None if g.pq_rotation is None
                  else np.asarray(g.pq_rotation[0], np.float32)))


@pytest.fixture(scope="module")
def pq_pair():
    """The reference tests' PQ fixture: 4000 x 32 clustered rows over 8
    shards, 8 subvectors; the reference trains (rotate=True), the port
    takes its codebook."""
    from lantern_tpu.parallel import build_sharded as ref_build
    from lantern_tpu.parallel import quantize_sharded as ref_quant

    base = _clustered(50, 4000)
    mesh, rmesh = _meshes(8)
    p, rp = _params(dim=32, ef_construction=64)
    ix_f32 = build_sharded(base, p, mesh, seed=0, nthreads=1)
    rix_f32 = ref_build(base, rp, rmesh, seed=0, nthreads=1)
    rix = ref_quant(rix_f32, rmesh, quant="pq", seed=0)
    ix = quantize_sharded(ix_f32, mesh, quant="pq", codebook=_ref_codebook(rix))
    return ix, rix, ix_f32, rix_f32, base, mesh, rmesh


@pytest.fixture(scope="module")
def i8_pair():
    from lantern_tpu.parallel import build_sharded as ref_build
    from lantern_tpu.parallel import quantize_sharded as ref_quant

    base = _base(60, 1600)
    mesh, rmesh = _meshes(8)
    p, rp = _params()
    ix = quantize_sharded(build_sharded(base[:1200], p, mesh, seed=0, nthreads=1),
                          mesh, quant="i8")
    rix = ref_quant(ref_build(base[:1200], rp, rmesh, seed=0, nthreads=1),
                    rmesh, quant="i8")
    return ix, rix, base, mesh, rmesh


# ---- quantisation ----

def test_pq_quantize_matches_reference(pq_pair):
    ix, rix = pq_pair[:2]
    assert_same_index(ix, rix)  # codes, rerank rows and norms, the graph
    assert ix.quant == QUANT_PQ and ix.vectors.dtype == torch.uint8
    assert ix.vectors.shape[2] == 8 and ix.rerank_rows.dtype == torch.bfloat16
    cb = _ref_codebook(rix)
    np.testing.assert_array_equal(ix.pq_codebook.numpy(), cb.centroids)
    np.testing.assert_array_equal(ix.pq_rotation.numpy(), cb.rotation)
    assert ix.params.pq and ix.params.num_subvectors == 8
    assert ix.params.num_centroids == rix.params.num_centroids


def test_pq_training_takes_the_reference_sample(pq_pair, monkeypatch):
    """Without a codebook both packages train on the same rows with the
    same arguments (the trainers themselves differ in their init's
    generator): recorded, not run."""
    import lantern_tpu.quant.pq as ref_pq
    import lantern_tpu_torch.quant.pq as port_pq
    from lantern_tpu.parallel import quantize_sharded as ref_quant

    ix, rix, ix_f32, rix_f32, base, mesh, rmesh = pq_pair
    calls = {}

    def recorder(key, cb):
        def train(data, **kw):
            kw.pop("device", None)
            calls[key] = (np.asarray(data), kw)
            return cb
        return train

    cb = _ref_codebook(rix)
    monkeypatch.setattr(port_pq, "train_codebook", recorder("port", cb))
    monkeypatch.setattr(ref_pq, "train_codebook", recorder("ref", cb))
    for rows in (1000, 65536):
        quantize_sharded(ix_f32, mesh, quant="pq", train_rows=rows, seed=3)
        ref_quant(rix_f32, rmesh, quant="pq", train_rows=rows, seed=3)
        np.testing.assert_array_equal(calls["port"][0], calls["ref"][0])
        assert calls["port"][1] == calls["ref"][1]
        assert len(calls["port"][0]) == min(rows, len(base))


def test_i8_quantize_matches_reference(i8_pair):
    ix, rix = i8_pair[:2]
    assert_same_index(ix, rix)  # int8 codes and f32 scales
    assert ix.vectors.dtype == torch.int8 and ix.params.quant == QuantKind.I8


def test_quantize_errors_match_reference(i8_pair, pq_pair):
    from lantern_tpu.parallel import build_sharded_device as ref_dev
    from lantern_tpu.parallel import flat_search_sharded_rerank as ref_rerank
    from lantern_tpu.parallel import quantize_sharded as ref_quant
    from lantern_tpu_torch.parallel import build_sharded_device

    ix, rix, base, mesh, rmesh = i8_pair
    for fn, a, m in ((quantize_sharded, ix, mesh), (ref_quant, rix, rmesh)):
        with pytest.raises(ValueError, match="already quantized"):
            fn(a, m, quant="pq")
    words = _bits(63, 64)
    p, rp = _params(dim=64, metric=Metric.HAMMING, quant=QuantKind.B1)
    for fn, build, params, m in ((quantize_sharded, build_sharded_device, p, mesh),
                                 (ref_quant, ref_dev, rp, rmesh)):
        with pytest.raises(ValueError, match="bit-packed"):
            fn(build(words, params, m, batch=32), m, quant="i8")
    pix, prix, ix_f32, rix_f32 = pq_pair[:4]
    with pytest.raises(ValueError, match="expected 'pq' or 'i8'"):
        quantize_sharded(ix_f32, mesh, quant="pq4")
    lean = quantize_sharded(ix_f32, mesh, quant="pq", keep_rerank=False,
                            codebook=_ref_codebook(prix))
    assert lean.rerank_rows is None and lean.rerank_sqn is None
    lean_ref = ref_quant(rix_f32, rmesh, quant="pq", keep_rerank=False,
                         codebook=_ref_codebook(prix))
    for fn, a in ((flat_search_sharded_rerank, lean), (ref_rerank, lean_ref)):
        with pytest.raises(ValueError, match="keep_rerank=True"):
            fn(a, pq_pair[4][:2])


# ---- searches over quantised shards ----

def test_pq_beam_search_matches_reference(pq_pair):
    """ADC distances in every shard's beam, the PQ flat entry scan."""
    from lantern_tpu.parallel import search_sharded as ref_search

    ix, rix = pq_pair[:2]
    q = _clustered(51, 16)
    got = port_result(search_sharded(ix, q, k=10, ef=64))
    assert_results_match(got, ref_result(ref_search(rix, q, k=10, ef=64)))


def test_pq_flat_and_rerank_match_reference(pq_pair):
    from lantern_tpu.parallel import flat_search_sharded as ref_flat
    from lantern_tpu.parallel import flat_search_sharded_rerank as ref_rerank

    ix, rix = pq_pair[:2]
    q = _clustered(52, 16)
    adc = port_result(flat_search_sharded(ix, q, k=10))
    assert_results_match(adc, ref_result(ref_flat(rix, q, k=10)))
    rr = port_result(flat_search_sharded_rerank(ix, q, k=10, shortlist=64))
    assert_results_match(rr, ref_result(ref_rerank(rix, q, k=10, shortlist=64)))


def test_i8_searches_match_reference(i8_pair):
    from lantern_tpu.parallel import flat_search_sharded as ref_flat
    from lantern_tpu.parallel import search_sharded as ref_search

    ix, rix = i8_pair[:2]
    q = _base(61, 16)
    assert_results_match(port_result(search_sharded(ix, q, k=10, ef=64)),
                         ref_result(ref_search(rix, q, k=10, ef=64)))
    assert_results_match(port_result(flat_search_sharded(ix, q, k=10, exact=True)),
                         ref_result(ref_flat(rix, q, k=10, exact=True)))


# ---- lifecycle of quantised shards ----

def test_pq_insert_matches_reference(pq_pair):
    """Decode, rounds over the decoded rows with the new rows snapped to
    their centroids, encode again; the rerank copy takes the true rows."""
    from lantern_tpu.parallel import flat_search_sharded_rerank as ref_rerank
    from lantern_tpu.parallel import insert_sharded as ref_insert

    ix, rix, _, _, base, mesh, rmesh = pq_pair
    extra = _clustered(55, 64)
    ix2 = insert_sharded(ix, extra, mesh, batch=32, seed=9)
    rix2 = ref_insert(rix, extra, rmesh, batch=32, seed=9)
    assert_same_index(ix2, rix2)
    nn = ix.num_nodes
    for si in range(ix.n_shards):  # old codes unchanged
        np.testing.assert_array_equal(ix2.vectors[si, :nn[si]].numpy(),
                                      ix.vectors[si, :nn[si]].numpy())
    q = extra[:8]
    got = port_result(flat_search_sharded_rerank(ix2, q, k=1, shortlist=16))
    # self-matches against bf16 rows: ~1e-4 left after cancelling |q|^2 ~ 40
    assert_results_match(got, ref_result(ref_rerank(rix2, q, k=1, shortlist=16)),
                         atol=1e-4)
    np.testing.assert_array_equal(got[1][:, 0], np.arange(4000, 4008))


def test_i8_insert_matches_reference(i8_pair):
    from lantern_tpu.parallel import insert_sharded as ref_insert
    from lantern_tpu.parallel import search_sharded as ref_search

    ix, rix, base, mesh, rmesh = i8_pair
    ix2 = insert_sharded(ix, base[1200:], mesh, batch=64, seed=3)
    rix2 = ref_insert(rix, base[1200:], rmesh, batch=64, seed=3)
    assert_same_index(ix2, rix2)
    q = base[1200:1208]
    got = port_result(search_sharded(ix2, q, k=1, ef=32))
    assert_results_match(got, ref_result(ref_search(rix2, q, k=1, ef=32)))
    np.testing.assert_array_equal(got[1][:, 0], np.arange(1200, 1208))


def test_b1_insert_matches_reference():
    """Hamming shards built on the host by both packages (equal), then
    inserted into: every array equal, the adjacency too (the rounds' flat
    pools keep the lower ids of a tie, as the reference's do)."""
    from lantern_tpu.parallel import build_sharded as ref_build
    from lantern_tpu.parallel import insert_sharded as ref_insert

    words = _bits(63, 1600)
    mesh, rmesh = _meshes(8)
    p, rp = _params(dim=64, metric=Metric.HAMMING, quant=QuantKind.B1)
    ix = build_sharded(words[:1200], p, mesh, seed=0, nthreads=1)
    rix = ref_build(words[:1200], rp, rmesh, seed=0, nthreads=1)
    assert_same_index(ix, rix)
    ix = insert_sharded(ix, words[1200:], mesh, batch=64, seed=1)
    rix = ref_insert(rix, words[1200:], rmesh, batch=64, seed=1)
    assert_same_index(ix, rix)
    qi = np.r_[0:8, 1200:1208]
    d, gids, _ = port_result(search_sharded(ix, words[qi], k=10, ef=48))
    np.testing.assert_array_equal(gids[:, 0], qi)
    assert (d[:, 0] == 0).all()


def test_pq_delete_and_compact_match_reference(pq_pair):
    from lantern_tpu.parallel import compact_sharded as ref_compact
    from lantern_tpu.parallel import delete_sharded as ref_delete

    ix, rix, _, _, base, mesh, rmesh = pq_pair
    dead = np.arange(8, dtype=np.uint64)
    ix_del, rix_del = delete_sharded(ix, dead), ref_delete(rix, dead)
    assert_same_index(ix_del, rix_del)
    gids = flat_search_sharded_rerank(ix_del, base[:8], k=3, shortlist=32)[1]
    assert not np.isin(gids.numpy(), np.arange(8)).any()
    ix_c = compact_sharded(ix_del, mesh, batch=64, seed=2)
    rix_c = ref_compact(rix_del, rmesh, batch=64, seed=2)
    assert_same_index(ix_c, rix_c)
    assert ix_c.quant == QUANT_PQ and sum(ix_c.num_nodes) == len(base) - 8


# ---- persistence of quantised shards ----

@pytest.mark.parametrize("kind", ["pq", "i8"])
def test_quantized_save_across_packages(pq_pair, i8_pair, tmp_path, kind):
    """Source rows (bf16 rerank rows tagged "bfloat16", dequantised i8 rows)
    and the codebook: byte-equal files; each package loads the other's
    directory to codes equal to the original's."""
    from lantern_tpu.parallel import load_sharded as ref_load
    from lantern_tpu.parallel import save_sharded as ref_save

    if kind == "pq":
        ix, rix, mesh, rmesh = (*pq_pair[:2], *pq_pair[5:])
    else:
        ix, rix, _, mesh, rmesh = i8_pair
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    save_sharded(ix, mine)
    ref_save(rix, theirs)
    assert _files(mine) == _files(theirs)
    # i8 shard files hold rows dequantised with scales that can differ by
    # an ulp (see assert_same_index): their bytes are not compared
    names = _files(mine) if kind == "pq" else ["manifest.json"]
    for name in names:
        with open(os.path.join(mine, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    for d in (mine, theirs):  # the same directory into both packages
        assert_same_index(load_sharded(d, mesh), ref_load(d, rmesh))
    back = load_sharded(theirs, mesh)
    assert back.quant == ix.quant
    if kind == "i8":  # dequantised at save, quantised at load: exact
        np.testing.assert_array_equal(back.vectors.numpy(), ix.vectors.numpy())
        np.testing.assert_allclose(back.vec_scales.numpy(),
                                   ix.vec_scales.numpy(), rtol=1e-6)
    else:  # codes of the bf16 source rows, the rerank copy kept
        assert back.rerank_rows is not None
