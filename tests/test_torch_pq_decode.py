"""PQ decode: the port's kernel K2/K3/K5/K6 against the reference's four.

On the CPU the wrapper runs its plain version, pq_decode_ref, which must be
BIT-EQUAL to every reference kernel run in interpret mode: K2
(pq_decode_mxu_hilo over codebook_hilo), K3 (pq_decode_mxu over
codebook_blockdiag), K5 (benchmarks/exp_hilo_v2, both reductions) and K6
(benchmarks/exp_hilo_v3, all three spreads, with its |x|^2 output held
within 1e-5 relative: the same f32 squares summed in another order). Row
counts are not multiples of the tile. The tests marked ``cuda`` hold the
CUDA kernel bit-equal to pq_decode_ref on the card and skip where there is
no card; jax is imported only inside the CPU parity tests.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from lantern_tpu_torch.ops.pq_decode import codebook_bf16, pq_decode, pq_decode_ref


@pytest.fixture()
def rng():
    """The conftest's seeded generator, repeated here so that ``pytest
    --noconftest -m cuda`` runs this file on a machine without jax."""
    return np.random.default_rng(0xA47E60DB)


ROOT = pathlib.Path(__file__).resolve().parents[1]
HILO = [(32, 256, 4), (240, 256, 4)]  # K = 256: the hi/lo kernels' shapes
SHAPES = HILO + [(24, 16, 40), (8, 32, 4)]
N, TILE = 97, 32  # 97 rows: no multiple of the tile


@functools.cache
def _bench(name):
    """Load benchmarks/<name>.py by path (benchmarks/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"_lantern_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(shape, n=N, seed=3, code_max=None):
    s, k, dsub = shape
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((s, k, dsub)).astype(np.float32)
    codes = rng.integers(0, code_max or k, (n, s)).astype(np.uint8)
    return codes, cents


def _port(codes, cents, want_xsq=False):
    pq_decode.launches = 0
    dec, xsq = pq_decode(torch.from_numpy(codes),
                         codebook_bf16(torch.from_numpy(cents)), want_xsq)
    assert pq_decode.launches == 0  # CPU tensors: plain version, no launch
    return dec.view(torch.int16).numpy(), xsq


def _bits(a):
    return np.asarray(a).view(np.int16)


def _reference(kernel, codes, cents):
    """(decoded bf16 bits, xsq or None) of one reference kernel."""
    import jax.numpy as jnp

    from lantern_tpu.ops import pallas_kernels as pk

    c, cb = jnp.asarray(codes), jnp.asarray(cents)
    if kernel == "K2":
        return _bits(pk.pq_decode_mxu_hilo(c, pk.codebook_hilo(cb), tile=TILE,
                                           interpret=True)), None
    if kernel == "K3":
        return _bits(pk.pq_decode_mxu(c, pk.codebook_blockdiag(cb), tile=TILE,
                                      interpret=True)), None
    if kernel.startswith("K5"):
        v2 = _bench("exp_hilo_v2")
        return _bits(v2.pq_decode_hilo_v2(
            c, v2.codebook_hilo_v2(cb), tile=TILE, interpret=True,
            reduce_kind=kernel.split("-")[1])), None
    v3 = _bench("exp_hilo_v3")
    dec, xsq = v3.pq_decode_hilo_v3(
        c, v3.codebook_hilo_gen(cb, 16, 16, 8), lo_w=16, grp=8, tile=TILE,
        interpret=True, spread=kernel.split("-")[1], xsq=True)
    return _bits(dec), np.asarray(xsq)


CASES = (
    [("K2", sh) for sh in HILO]
    + [("K3", sh) for sh in SHAPES]
    + [(f"K5-{kind}", sh) for kind in ("roll", "slice") for sh in HILO]
    + [(f"K6-{spread}", sh) for spread in ("dot", "dot128", "bcast")
       for sh in HILO]
)


@pytest.mark.parametrize("kernel,shape", CASES,
                         ids=[f"{k}-{s[0]}x{s[1]}x{s[2]}" for k, s in CASES])
def test_ref_bit_equal_to_reference_kernel(kernel, shape):
    codes, cents = _inputs(shape)
    want, want_xsq = _reference(kernel, codes, cents)
    got, xsq = _port(codes, cents, want_xsq=True)
    np.testing.assert_array_equal(got, want)
    if want_xsq is not None:
        np.testing.assert_allclose(xsq.numpy(), want_xsq, rtol=1e-5, atol=0)


def test_codes_beyond_k_decode_to_zero_like_k3():
    """K3's one-hot matches no column for a code >= K: a zero entry."""
    codes, cents = _inputs((8, 32, 4), code_max=256)
    assert (codes >= 32).any()
    want, _ = _reference("K3", codes, cents)
    np.testing.assert_array_equal(_port(codes, cents)[0], want)


def test_xsq_is_sum_of_squares_of_decoded():
    codes, cents = _inputs((24, 16, 40))
    dec, xsq = pq_decode_ref(torch.from_numpy(codes),
                             codebook_bf16(torch.from_numpy(cents)), True)
    assert dec.dtype == torch.bfloat16 and dec.shape == (N, 24 * 40)
    np.testing.assert_array_equal(xsq.numpy(), (dec.float() ** 2).sum(1).numpy())


def test_rejects_bad_inputs():
    codes, cents = map(torch.from_numpy, _inputs((4, 16, 2)))
    with pytest.raises(ValueError, match="uint8"):
        pq_decode(codes.int(), codebook_bf16(cents))
    with pytest.raises(ValueError, match="bf16"):
        pq_decode(codes, cents)
    with pytest.raises(ValueError, match="K <= 256"):
        pq_decode(codes, torch.zeros((4, 300, 2), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="subspaces"):
        pq_decode(codes, codebook_bf16(cents[:3]))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# the listed shapes, plus every access width: dsub*2 = 16 (uint4), 8, 4, 6
# (2-byte path); codebooks in and beyond shared memory (240 x 256 x 4)
CUDA_SHAPES = SHAPES + [(16, 256, 8), (64, 256, 2), (10, 64, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES,
                         ids=[f"{s}x{k}x{d}" for s, k, d in CUDA_SHAPES])
@pytest.mark.parametrize("n", [1, 97, 4099])
def test_kernel_bit_equal_to_ref_on_card(cuda, shape, n):
    codes, cents = _inputs(shape, n=n, code_max=256)  # codes >= K included
    c = torch.from_numpy(codes).to(cuda)
    cb = codebook_bf16(torch.from_numpy(cents).to(cuda))
    before = pq_decode.launches
    dec, xsq = pq_decode(c, cb, want_xsq=True)
    torch.cuda.synchronize()
    assert pq_decode.launches == before + 1
    want, want_xsq = pq_decode_ref(c, cb, want_xsq=True)
    assert torch.equal(dec.view(torch.int16), want.view(torch.int16))
    torch.testing.assert_close(xsq, want_xsq, rtol=1e-5, atol=0)
    dec2, none = pq_decode(c, cb)
    assert none is None and torch.equal(dec2.view(torch.int16),
                                        want.view(torch.int16))


@pytest.mark.cuda
def test_kernel_rejects_mixed_devices_on_card(cuda):
    codes, cents = _inputs((4, 16, 2))
    with pytest.raises(ValueError, match="centroids are on"):
        pq_decode(torch.from_numpy(codes).to(cuda),
                  codebook_bf16(torch.from_numpy(cents)))
