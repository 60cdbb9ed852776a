"""Parity: the port's streamed, resumable PQ training
(quant/pq.py::train_codebook_chunked) and pqvec codecs against
lantern_tpu's on the CPU, and the chunked cases of tests/test_quant.py
through the port.

Both packages draw the init from the seed with numpy over the same first
rows, so they train from the same centroids; the passes are exact Lloyd /
OPQ steps. Tolerances: centroids (and rotations) within 1e-5 relative +
1e-5 absolute, codes of the data under either codebook >= 99.9% equal,
resume files and pqvec bytes equal.
"""

import os

import numpy as np
import pytest
import torch

from lantern_tpu_torch.io.dotvecs import write_fvecs
from lantern_tpu_torch.quant.pq import (
    PQCodebook,
    array_to_pqvec,
    dequantize_vector,
    pq_decode,
    pq_encode,
    pqvec_to_array,
    quantize_vector,
    train_codebook,
    train_codebook_chunked,
)

CPU = "cpu"


def ref_pq():
    from lantern_tpu.quant import pq

    return pq


def _mse(x, cb):
    return float(np.mean((pq_decode(pq_encode(x, cb, device=CPU), cb) - x)
                         ** 2))


def _correlated(rng, n, dim, rank=8):
    z = rng.standard_normal((n, rank)).astype(np.float32)
    return (z @ rng.standard_normal((rank, dim)).astype(np.float32)).astype(
        np.float32)


def _blocks(x, rows):
    def chunks():
        for i in range(0, len(x), rows):
            yield x[i:i + rows]

    return chunks


def assert_codebooks_close(got, want, x):
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=1e-5,
                               atol=1e-5)
    assert (got.rotation is None) == (want.rotation is None)
    if got.rotation is not None:
        np.testing.assert_allclose(got.rotation, want.rotation, rtol=1e-5,
                                   atol=1e-5)
    codes = pq_encode(x, got, device=CPU)
    ref_codes = np.asarray(ref_pq().pq_encode(x, PQCodebook(
        want.centroids, want.rotation)))
    assert (codes == ref_codes).mean() >= 0.999


@pytest.mark.parametrize("source", ["callable", "npy", "fvecs"])
@pytest.mark.parametrize("rotate", [False, True])
def test_chunked_training_equals_the_reference(rng, tmp_path, source, rotate):
    # full rank: a rank-deficient X^T Y leaves the rotation's null space
    # to the SVD's choice
    x = (_correlated(rng, 3000, 32, rank=32) if rotate
         else rng.standard_normal((3000, 32)).astype(np.float32))
    chunks = {"callable": _blocks(x, 700),
              "npy": str(tmp_path / "x.npy"),
              "fvecs": str(tmp_path / "x.fvecs")}[source]
    np.save(tmp_path / "x.npy", x)
    write_fvecs(str(tmp_path / "x.fvecs"), x)
    kw = dict(num_subvectors=8, num_centroids=32, iters=5, seed=3,
              rotate=rotate, chunk_rows=700)
    got = train_codebook_chunked(chunks, device=CPU, **kw)
    want = ref_pq().train_codebook_chunked(chunks, **kw)
    assert_codebooks_close(got, want, x)


def test_chunked_training_matches_in_ram(rng):
    """Streamed Lloyd is in-RAM Lloyd's quality (the chunk sums are exact),
    and every pass reads the stream anew."""
    x = rng.standard_normal((2048, 32)).astype(np.float32)
    loads = []

    def chunks():
        loads.append(0)
        for i in range(0, len(x), 300):  # uneven chunks with a short tail
            yield x[i:i + 300]

    cb_chunked = train_codebook_chunked(chunks, num_subvectors=8,
                                        num_centroids=32, iters=8, seed=0,
                                        device=CPU)
    cb_ram = train_codebook(x, num_subvectors=8, num_centroids=32, iters=8,
                            seed=0, device=CPU)
    assert _mse(x, cb_chunked) <= _mse(x, cb_ram) * 1.15
    assert len(loads) >= 8


@pytest.mark.parametrize("rotate", [False, True])
def test_resume_is_bit_identical(rng, tmp_path, rotate):
    """Stopped after 3 passes and resumed, training ends where an unbroken
    run does, bit for bit."""
    x = _correlated(rng, 1024, 16)
    chunks = _blocks(x, 200)
    kw = dict(num_subvectors=4, num_centroids=16, seed=1, rotate=rotate,
              device=CPU)
    full = train_codebook_chunked(chunks, iters=6, **kw)
    st = str(tmp_path / "pqtrain.state")
    train_codebook_chunked(chunks, iters=3, resume_path=st, **kw)
    with np.load(st) as f:
        assert int(f["next_pass"]) == 3
    resumed = train_codebook_chunked(chunks, iters=6, resume_path=st, **kw)
    np.testing.assert_array_equal(full.centroids, resumed.centroids)
    if rotate:
        np.testing.assert_array_equal(full.rotation, resumed.rotation)
    assert not os.path.exists(st + ".tmp")


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_state_file_resumes_in_the_other_package(rng, tmp_path, writer):
    """The state file is the reference's np.savez: the same keys and types,
    and a state one package wrote resumes in the other."""
    x = _correlated(rng, 1024, 16, rank=16)
    chunks = _blocks(x, 256)
    kw = dict(num_subvectors=4, num_centroids=16, seed=2, rotate=True)
    st_port, st_ref = str(tmp_path / "p.state"), str(tmp_path / "r.state")
    train_codebook_chunked(chunks, iters=2, resume_path=st_port, device=CPU,
                           **kw)
    ref_pq().train_codebook_chunked(chunks, iters=2, resume_path=st_ref, **kw)
    with np.load(st_port) as a, np.load(st_ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-5)
    st = st_port if writer == "port" else st_ref
    if writer == "port":
        resumed = ref_pq().train_codebook_chunked(chunks, iters=4,
                                                  resume_path=st, **kw)
        full = ref_pq().train_codebook_chunked(chunks, iters=4, **kw)
    else:
        resumed = train_codebook_chunked(chunks, iters=4, resume_path=st,
                                         device=CPU, **kw)
        full = train_codebook_chunked(chunks, iters=4, device=CPU, **kw)
    assert_codebooks_close(PQCodebook(np.asarray(resumed.centroids),
                                      np.asarray(resumed.rotation)),
                           PQCodebook(np.asarray(full.centroids),
                                      np.asarray(full.rotation)), x)


def test_resume_rejects_mismatched_arguments(rng, tmp_path):
    x = rng.standard_normal((256, 16)).astype(np.float32)
    chunks = _blocks(x, 256)
    st = str(tmp_path / "s.state")
    train_codebook_chunked(chunks, 4, 16, iters=1, seed=1, resume_path=st,
                           device=CPU)
    for kw in (dict(seed=2), dict(num_centroids=8), dict(num_subvectors=8)):
        args = {**dict(num_subvectors=4, num_centroids=16, seed=1), **kw}
        with pytest.raises(ValueError, match="does not match"):
            train_codebook_chunked(chunks, iters=2, resume_path=st,
                                   device=CPU, **args)
    with pytest.raises(ValueError, match="uint8"):
        train_codebook_chunked(chunks, 4, 300, device=CPU)
    with pytest.raises(ValueError, match="divisible"):
        train_codebook_chunked(chunks, 5, 16, device=CPU)
    with pytest.raises(ValueError, match="empty"):
        train_codebook_chunked(lambda: iter(()), 4, 16, device=CPU)
    with pytest.raises(ValueError, match="callable"):
        train_codebook_chunked("rows.csv", 4, 16, device=CPU)


def test_chunked_opq_rotation_is_orthogonal_and_helps(rng):
    x = _correlated(rng, 2048, 32)
    chunks = _blocks(x, 512)
    cb_rot = train_codebook_chunked(chunks, 8, 32, iters=6, seed=0,
                                    rotate=True, device=CPU)
    cb_plain = train_codebook_chunked(chunks, 8, 32, iters=6, seed=0,
                                      device=CPU)
    r = cb_rot.rotation
    np.testing.assert_allclose(r @ r.T, np.eye(32), atol=1e-4)
    assert _mse(x, cb_rot) <= _mse(x, cb_plain) * 1.05


def test_pqvec_codecs_byte_equal(rng):
    pq = ref_pq()
    data = rng.standard_normal((300, 16)).astype(np.float32)
    cb = train_codebook(data, num_subvectors=4, num_centroids=16, iters=8,
                        device=CPU)
    for row in data[:20]:
        raw = quantize_vector(row, cb, device=CPU)
        assert raw == pq.quantize_vector(row, cb)
        codes = pqvec_to_array(raw)
        assert codes.dtype == np.uint8 and codes.shape == (4,)
        np.testing.assert_array_equal(codes, pq.pqvec_to_array(raw))
        assert array_to_pqvec(codes) == pq.array_to_pqvec(codes) == raw
        rec = dequantize_vector(raw, cb)
        np.testing.assert_array_equal(rec, pq.dequantize_vector(raw, cb))
        assert np.linalg.norm(rec - row) < np.linalg.norm(row)
    for bad, match in ((b"\x00\x00\x04\x00abcd", "magic"),
                       (array_to_pqvec(np.arange(4))[:-1], "truncated")):
        with pytest.raises(ValueError, match=match):
            pqvec_to_array(bad)
    with pytest.raises(ValueError, match="one vector"):
        array_to_pqvec(np.zeros((2, 4), np.uint8))


def test_chunked_training_without_a_device_raises(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_codebook_chunked(_blocks(x, 32), 2, 8)
