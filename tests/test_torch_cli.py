"""Parity: the port's command line (cli.py) against lantern_tpu's on the
CPU, and the CLI case of tests/test_ecosystem.py through the port.

The same pipeline runs through both CLIs, the port's with ``--device
cpu``: ``build-index`` (the device builder, equal to the reference's on
the CPU, so the snapshots are byte-equal), ``search`` (one JSON row a
query: flat labels equal up to ties, distances within 1e-5 relative +
1e-4 absolute; the graph's labels overlap, its distances the flat's),
``pq-table`` (the chunked path: codebook within 1e-5, codes >= 99.9%
equal; the in-RAM path draws its own init, so shapes and quality only),
``create-embeddings`` (byte-equal). ``--rerank 0`` is a rerank of depth k
in both CLIs (F4: the HTTP API reads 0 as none).
"""

import json

import numpy as np
import pytest
import torch

import lantern_tpu_torch
from lantern_tpu_torch.cli import build_parser, main
from lantern_tpu_torch.config import HnswParams

CPU = ["--device", "cpu"]


def ref_main(argv):
    from lantern_tpu.cli import main as rmain

    rmain(argv)


def _clustered(rng, n, dim):
    c = rng.standard_normal((16, dim)).astype(np.float32)
    return (c[rng.integers(0, 16, n)]
            + 0.3 * rng.standard_normal((n, dim))).astype(np.float32)


def rows_of(out: str):
    return [json.loads(line) for line in out.strip().splitlines()]


def assert_rows_equal(got, want):
    """Labels equal except inside ties (also with a row past the cut)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        d = np.array([r["dist"] for r in w])
        np.testing.assert_allclose([r["dist"] for r in g], d, rtol=1e-5,
                                   atol=1e-4)
        for i, (a, b) in enumerate(zip(g, w)):
            near = np.isclose(d, d[i], rtol=1e-5, atol=1e-4)
            if near.sum() == 1 and not near[-1]:
                assert a["label"] == b["label"], (g, w)


def test_pipeline_equals_the_reference_cli(tmp_path, rng, capsys):
    vecs = _clustered(rng, 600, 16)
    np.save(tmp_path / "data.npy", vecs)
    np.save(tmp_path / "q.npy", vecs[:5] + 0.01)
    out = {}
    for pkg, run, extra in (("port", main, CPU), ("ref", ref_main, [])):
        run(["build-index", "--input", str(tmp_path / "data.npy"),
             "--output", str(tmp_path / f"ix_{pkg}.ldb"), "--m", "8",
             "--efc", "32", *extra])
        assert "built 600" in capsys.readouterr().out
        for mode in ("graph", "flat"):
            run(["search", "--index", str(tmp_path / f"ix_{pkg}.ldb"),
                 "--queries", str(tmp_path / "q.npy"), "--k", "5",
                 "--mode", mode, *extra])
            out[pkg, mode] = rows_of(capsys.readouterr().out)
    assert ((tmp_path / "ix_port.ldb").read_bytes()
            == (tmp_path / "ix_ref.ldb").read_bytes())
    assert_rows_equal(out["port", "flat"], out["ref", "flat"])
    # the reference's graph mode scores the beam from a bf16 copy of the
    # rows, so its distances carry bf16 error; the port's beam is f32 and
    # prints the flat scan's distances
    for g, w, f in zip(out["port", "graph"], out["ref", "graph"],
                       out["port", "flat"]):
        assert len({r["label"] for r in g} & {r["label"] for r in w}) >= 4
        np.testing.assert_allclose([r["dist"] for r in g],
                                   [r["dist"] for r in f], rtol=1e-5,
                                   atol=1e-5)
    for mode in ("graph", "flat"):
        assert [r[0]["label"] for r in out["port", mode]] == list(range(5))


@pytest.mark.parametrize("flag", ["fvecs", "chunk-rows"])
def test_pq_table_chunked_equals_the_reference(tmp_path, rng, capsys, flag):
    from lantern_tpu_torch.io.dotvecs import write_fvecs

    vecs = rng.standard_normal((3000, 16)).astype(np.float32)
    np.save(tmp_path / "data.npy", vecs)
    write_fvecs(str(tmp_path / "data.fvecs"), vecs)
    inp = (["--input", str(tmp_path / "data.fvecs")] if flag == "fvecs"
           else ["--input", str(tmp_path / "data.npy"), "--chunk-rows",
                 "700"])
    for pkg, run, extra in (("port", main, CPU), ("ref", ref_main, [])):
        run(["pq-table", *inp, "--output", str(tmp_path / f"{pkg}.npz"),
             "--clusters", "16", "--splits", "4", "--iters", "4",
             "--resume", str(tmp_path / f"{pkg}.state"), *extra])
        assert "(chunked)" in capsys.readouterr().out
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "ref.npz")
    assert sorted(got.files) == sorted(want.files)
    np.testing.assert_allclose(got["codebook"], want["codebook"], rtol=1e-5,
                               atol=1e-5)
    assert got["codes"].shape == want["codes"].shape == (3000, 4)
    assert (got["codes"] == want["codes"]).mean() >= 0.999
    assert got["rotation"].shape == want["rotation"].shape == (0,)


def test_pq_table_in_ram_and_embeddings(tmp_path, rng, capsys):
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    np.save(tmp_path / "data.npy", vecs)
    main(["pq-table", "--input", str(tmp_path / "data.npy"), "--output",
          str(tmp_path / "pq.npz"), "--clusters", "16", "--splits", "4",
          *CPU])
    z = np.load(tmp_path / "pq.npz")
    assert z["codebook"].shape == (4, 16, 4) and z["codes"].shape == (300, 4)
    from lantern_tpu_torch.quant.pq import PQCodebook, pq_encode

    np.testing.assert_array_equal(
        z["codes"], pq_encode(vecs, PQCodebook(z["codebook"]), device="cpu"))
    inp = tmp_path / "texts.txt"
    inp.write_text("a\nb c\n\nd e f\n")
    main(["create-embeddings", "--input", str(inp), "--output",
          str(tmp_path / "e.npy"), "--runtime", "hash", "--runtime-params",
          '{"dim": 24}'])
    ref_main(["create-embeddings", "--input", str(inp), "--output",
              str(tmp_path / "r.npy"), "--runtime", "hash",
              "--runtime-params", '{"dim": 24}'])
    assert ((tmp_path / "e.npy").read_bytes()
            == (tmp_path / "r.npy").read_bytes())
    assert "embedded 3 rows dim=24" in capsys.readouterr().out


def test_rerank_zero_is_a_rerank(tmp_path, rng, capsys):
    """F4 mirrored: the CLI's ``--rerank 0`` reranks a shortlist of k in
    both packages (HTTP reads 0 as none): every distance it prints is the
    exact one to the row's bf16 copy, not the ADC estimate. Across the
    packages a shortlist of k can differ inside ADC ties at its cut, so the
    packages are compared at a shortlist of every row and without rerank."""
    vecs = _clustered(rng, 400, 16)
    p = HnswParams(dim=16, m=8, ef_construction=32, pq=True,
                   num_subvectors=4, num_centroids=16)
    ix = lantern_tpu_torch.Index(p, capacity=400, device="cpu")
    ix.add(vecs, nthreads=1)
    ix.save(str(tmp_path / "pq.ldb"))
    np.save(tmp_path / "rows.npy", vecs)
    q = vecs[:4] + 0.01
    np.save(tmp_path / "q.npy", q)
    out = {}
    for pkg, run, extra in (("port", main, CPU), ("ref", ref_main, [])):
        for rerank in ("0", "400", None):
            run(["search", "--index", str(tmp_path / "pq.ldb"), "--queries",
                 str(tmp_path / "q.npy"), "--k", "5", "--mode", "flat",
                 "--rows", str(tmp_path / "rows.npy"), *extra]
                + (["--rerank", rerank] if rerank else []))
            out[pkg, rerank] = rows_of(capsys.readouterr().out)
    rows_bf16 = torch.from_numpy(vecs).to(torch.bfloat16).float().numpy()
    for pkg in ("port", "ref"):
        for qi, row in enumerate(out[pkg, "0"]):
            exact = ((rows_bf16[[r["label"] for r in row]] - q[qi]) ** 2).sum(1)
            np.testing.assert_allclose([r["dist"] for r in row], exact,
                                       rtol=1e-4, atol=1e-5)
        assert out[pkg, "0"] != out[pkg, None]
    assert_rows_equal(out["port", "400"], out["ref", "400"])
    assert_rows_equal(out["port", None], out["ref", None])
    _, lab = ix.search(q, k=5, mode="flat", rerank=5)
    assert [[r["label"] for r in row] for row in out["port", "0"]] \
        == lab.tolist()


def test_every_index_subcommand_takes_a_device():
    ap = build_parser()
    takes = {"start-indexing-server": [], "start-server": [],
             "start-daemon": [], "autotune-index": ["--input", "x"],
             "start-bgworkers": [], "pq-table": ["--input", "x", "--output",
                                                 "y"],
             "build-index": ["--input", "x", "--output", "y"],
             "search": ["--index", "x", "--queries", "y"]}
    for cmd, req in takes.items():
        assert ap.parse_args([cmd, *req]).device == "cuda", cmd
        assert ap.parse_args([cmd, *req, "--device", "cpu"]).device == "cpu"
    for cmd, req in (("start-router", ["--target-host", "h",
                                       "--target-port", "1"]),
                     ("create-embeddings", ["--input", "x", "--output", "y"]),
                     ("measure-model-speed", [])):
        assert not hasattr(ap.parse_args([cmd, *req]), "device"), cmd


def test_search_without_a_device_raises_without_a_card(monkeypatch, tmp_path,
                                                       rng):
    vecs = rng.standard_normal((50, 8)).astype(np.float32)
    np.save(tmp_path / "data.npy", vecs)
    main(["build-index", "--input", str(tmp_path / "data.npy"), "--output",
          str(tmp_path / "ix.ldb"), "--m", "4", "--build", "host", *CPU])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["search", "--index", str(tmp_path / "ix.ldb"), "--queries",
              str(tmp_path / "data.npy")])
