"""Parity: the port's HTTP collections API (service/http_api.py) against
lantern_tpu's, and the HTTP cases of tests/test_ecosystem.py through the
port on the CPU.

One request script runs against both packages' ``HttpApi``: f32 (l2sq),
cosine text and hamming collections, row inserts and deletes, ``/compact``,
re-parametrised ``/index`` rebuilds, ``/index {"external": true}`` (the
device builder), ``/pq`` and searches with a rerank shortlist as large as
the collection. Every response is equal: ids exactly except where
distances tie (the order inside a tie is the top-k's), distances within
1e-5 relative + 1e-4 absolute (hamming: exactly). Small collections
search flat (the cost model), so the engines' thread timing does not enter.
A ``data_dir`` written by either package loads in the other.
"""

import base64
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from lantern_tpu_torch.embeddings import text_embedding
from lantern_tpu_torch.service.http_api import HttpApi

CPU = "cpu"


def _req(method, url, body=None, auth=None, timeout=120):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    if auth:
        req.add_header("Authorization",
                       "Basic " + base64.b64encode(auth.encode()).decode())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def ref_api(**kw):
    from lantern_tpu.service.http_api import HttpApi as RefHttpApi

    return RefHttpApi(port=0, **kw).start()


@pytest.fixture()
def apis():
    port, ref = HttpApi(port=0, device=CPU).start(), ref_api()
    yield port, ref
    port.stop()
    ref.stop()


def url(api):
    return f"http://127.0.0.1:{api.port}"


def assert_results_equal(got, want, exact=False):
    """Search results: the same rows, ids up to the order inside ties."""
    assert len(got) == len(want)
    gd = np.array([r["distance"] for r in got])
    wd = np.array([r["distance"] for r in want])
    if exact:
        np.testing.assert_array_equal(gd, wd)
    else:
        np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)
    for i, (g, w) in enumerate(zip(got, want)):
        # a row at the last distance may tie with one that was cut off
        tied = (np.isclose(wd, wd[i], rtol=1e-5, atol=1e-4).sum() > 1
                or np.isclose(wd[i], wd[-1], rtol=1e-5, atol=1e-4))
        if not tied:
            assert g == {**w, "distance": g["distance"]}, (g, w)


def assert_same_response(got, want, exact=False):
    assert got[0] == want[0], (got, want)
    g, w = got[1], want[1]
    if isinstance(w, dict) and "results" in w:
        assert_results_equal(g["results"], w["results"], exact)
    else:
        assert g == w


def run_script(api, steps):
    out = []
    for method, path, body in steps:
        out.append(_req(method, url(api) + path, body))
    return out


def _rows(vecs, **extra):
    return [{"vector": v.tolist(), "i": i, **extra} for i, v in enumerate(vecs)]


def _searches(name, queries, **kw):
    return [("POST", f"/collections/{name}/search",
             {"vector": q.tolist(), "k": 5, **kw}) for q in queries]


def f32_script(rng):
    vecs = rng.standard_normal((120, 16)).astype(np.float32)
    qs = vecs[[3, 50, 99]] + 0.05 * rng.standard_normal((3, 16)).astype(
        np.float32)
    c = "/collections/f32c"
    s = [("POST", "/collections", {"name": "f32c", "metric": "l2sq"}),
         ("POST", c + "/rows", {"rows": _rows(vecs, tag="row")})]
    s += _searches("f32c", qs)
    s += [("DELETE", c + "/rows", {"ids": list(range(1, 21))})]
    s += _searches("f32c", qs)
    s += [("POST", c + "/compact", {})]
    s += _searches("f32c", qs)
    s += [("POST", c + "/index", {"m": 24, "ef_construction": 64})]
    s += _searches("f32c", qs, ef=32)
    s += [("POST", c + "/index", {"external": True, "m": 8,
                                  "ef_construction": 32})]
    s += _searches("f32c", qs)
    s += [("GET", "/collections", None),
          ("POST", c + "/pq", {"num_subvectors": 4, "num_centroids": 16})]
    s += _searches("f32c", qs, rerank=120)
    s += [("POST", c + "/rows", {"rows": _rows(qs, tag="late")})]
    s += [("DELETE", c, None), ("GET", "/collections", None)]
    return s


def hamming_script(rng):
    vecs = np.sign(rng.standard_normal((60, 64))).astype(np.float32)
    c = "/collections/bits"
    s = [("POST", "/collections", {"name": "bits", "metric": "hamming"}),
         ("POST", c + "/rows", {"rows": _rows(vecs)})]
    s += _searches("bits", vecs[[9, 30]])
    s += [("DELETE", c + "/rows", {"ids": [10, 31]})]
    s += _searches("bits", vecs[[9, 30]])
    s += [("POST", c + "/compact", {})]
    s += _searches("bits", vecs[[9, 30]])
    s += [("GET", "/collections", None)]
    return s


def text_script():
    texts = ["the quick brown fox", "lazy dogs sleep all day",
             "vector search on a card", "quick brown dogs"]
    rows = [{"vector": text_embedding("hash", t, dim=64).tolist(), "text": t}
            for t in texts]
    return [("POST", "/collections", {"name": "docs", "metric": "cosine"}),
            ("POST", "/collections/docs/rows", {"rows": rows}),
            ("POST", "/collections/docs/search", {"text": "quick fox", "k": 2}),
            ("GET", "/", None), ("GET", "/models", None),
            ("GET", "/runtimes", None),
            ("POST", "/collections/none/search", {"vector": [0.0]}),
            ("POST", "/collections", {"name": "bad name!"})]


@pytest.mark.parametrize("script", ["f32", "hamming", "text"])
def test_request_script_gives_equal_json(apis, rng, script):
    steps = {"f32": lambda: f32_script(rng),
             "hamming": lambda: hamming_script(rng),
             "text": text_script}[script]()
    port, ref = apis
    got, want = run_script(port, steps), run_script(ref, steps)
    for step, g, w in zip(steps, got, want):
        assert g[0] in (200, 201) or step[1] in (
            "/collections/none/search", "/collections"), (step, g)
        assert_same_response(g, w, exact=script == "hamming")


def test_engine_arrays_of_hamming_and_pq_collections(apis, rng):
    """The routes read ``_eng.vectors / labels / deleted``: a hamming
    collection holds the reference's uint32 words, labels and tombstones;
    a PQ collection the same shapes and types (its rows decoded under its
    own codebook), labels and tombstones."""
    port, ref = apis
    bits = np.sign(rng.standard_normal((40, 96))).astype(np.float32)
    rows = rng.standard_normal((64, 16)).astype(np.float32)
    for api in (port, ref):
        run_script(api, [
            ("POST", "/collections", {"name": "b", "metric": "hamming"}),
            ("POST", "/collections/b/rows", {"rows": _rows(bits)}),
            ("DELETE", "/collections/b/rows", {"ids": [2, 5]}),
            ("POST", "/collections", {"name": "p", "metric": "l2sq"}),
            ("POST", "/collections/p/rows", {"rows": _rows(rows)}),
            ("POST", "/collections/p/pq", {"num_subvectors": 4,
                                           "num_centroids": 8}),
            ("DELETE", "/collections/p/rows", {"ids": [1, 64]})])
    for name in ("b", "p"):
        pe = port.state.collections[name].index._eng
        re_ = ref.state.collections[name].index._eng
        n = pe.n
        assert n == re_.n
        for attr in ("vectors", "labels", "deleted"):
            a = np.asarray(getattr(pe, attr)[:n])
            b = np.asarray(getattr(re_, attr)[:n])
            assert a.dtype == b.dtype and a.shape == b.shape, attr
            if name == "b" or attr != "vectors":
                np.testing.assert_array_equal(a, b, attr)
    pix = port.state.collections["p"].index
    from lantern_tpu_torch.quant.pq import pq_decode, pq_encode

    np.testing.assert_allclose(
        np.asarray(pix._eng.vectors[:64]),
        pq_decode(pq_encode(rows, pix._codebook, device=CPU), pix._codebook),
        rtol=1e-6, atol=1e-6)


def test_rerank_zero_means_none(rng):
    """F4 mirrored: over HTTP ``"rerank": 0`` is no rerank (the reference's
    ``rerank or None``); the CLI's meaning is pinned in test_torch_cli."""
    api = HttpApi(port=0, device=CPU).start()
    try:
        vecs = rng.standard_normal((200, 16)).astype(np.float32)
        run_script(api, [
            ("POST", "/collections", {"name": "pq0", "metric": "l2sq"}),
            ("POST", "/collections/pq0/rows", {"rows": _rows(vecs)}),
            ("POST", "/collections/pq0/pq", {"num_subvectors": 4,
                                             "num_centroids": 16})])
        for q in vecs[:4]:
            base = {"vector": q.tolist(), "k": 5}
            _, none = _req("POST", url(api) + "/collections/pq0/search", base)
            _, zero = _req("POST", url(api) + "/collections/pq0/search",
                           {**base, "rerank": 0})
            _, full = _req("POST", url(api) + "/collections/pq0/search",
                           {**base, "rerank": 200})
            assert zero == none
            assert zero != full  # the ADC distances, not the exact ones
            assert full["results"][0]["distance"] < 1e-3
    finally:
        api.stop()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_data_dir_loads_in_the_other_package(tmp_path, rng, writer):
    d = str(tmp_path / "apidata")
    make = {"port": lambda: HttpApi(port=0, data_dir=d, device=CPU).start(),
            "ref": lambda: ref_api(data_dir=d)}
    reader = "ref" if writer == "port" else "port"
    vecs = rng.standard_normal((40, 8)).astype(np.float32)
    bits = np.sign(rng.standard_normal((30, 64))).astype(np.float32)
    w = make[writer]()
    steps = [("POST", "/collections", {"name": "keep", "metric": "l2sq"}),
             ("POST", "/collections/keep/rows", {"rows": _rows(vecs)}),
             ("DELETE", "/collections/keep/rows", {"ids": [3, 4]}),
             ("POST", "/collections", {"name": "kbits", "metric": "hamming"}),
             ("POST", "/collections/kbits/rows", {"rows": _rows(bits)}),
             ("POST", "/save", None)]
    assert all(code in (200, 201) for code, _ in run_script(w, steps))
    checks = (_searches("keep", vecs[[0, 7, 20]])
              + _searches("kbits", bits[[1, 2]])
              + [("GET", "/collections", None)])
    want = run_script(w, checks)
    w.stop()
    r = make[reader]()
    try:
        got = run_script(r, checks)
        for g, wnt, step in zip(got, want, checks):
            if step[1] == "/collections":  # a load lists them by file name
                g, wnt = ((c, sorted(r, key=lambda x: x["name"]))
                          for c, r in (g, wnt))
            assert_same_response(g, wnt, exact="kbits" in step[1])
        # inserts continue after the stored next id
        code, res = _req("POST", url(r) + "/collections/keep/rows",
                         {"rows": [{"vector": vecs[0].tolist()}]})
        assert code == 200 and res["ids"] == [41]
    finally:
        r.stop()


def test_http_auth():
    api = HttpApi(port=0, username="admin", password="secret",
                  device=CPU).start()
    try:
        code, _ = _req("GET", url(api) + "/collections")
        assert code == 401
        code, _ = _req("GET", url(api) + "/collections", auth="admin:secret")
        assert code == 200
    finally:
        api.stop()


def test_http_index_reparam_and_drop(rng):
    api = HttpApi(port=0, device=CPU).start()
    try:
        vecs = rng.standard_normal((40, 8)).astype(np.float32)
        run_script(api, [
            ("POST", "/collections", {"name": "rp", "metric": "l2sq"}),
            ("POST", "/collections/rp/rows",
             {"rows": [{"vector": v.tolist()} for v in vecs]}),
            ("POST", "/collections/rp/index", {"m": 24,
                                               "ef_construction": 200})])
        col = api.state.collections["rp"]
        assert (col.index.params.m, col.index.params.ef_construction) == (
            24, 200)
        assert col.index.device.type == "cpu"
        _, res = _req("POST", url(api) + "/collections/rp/search",
                      {"vector": vecs[4].tolist(), "k": 1})
        assert res["results"][0]["id"] == 5  # ids start at 1
        code, res = _req("DELETE", url(api) + "/collections/rp/index")
        assert code == 200 and col.index is None
        code, res = _req("POST", url(api) + "/collections/rp/search",
                         {"vector": vecs[4].tolist()})
        assert code == 400
    finally:
        api.stop()
