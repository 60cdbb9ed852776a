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


def _card_inputs(cuda, shape, n, offset=0, seed=5):
    """codes as rows [offset, offset + n) of a larger table (a view whose
    pointer is aligned only to offset * S bytes), codes >= K included."""
    codes, cents = _inputs(shape, n=n + offset, seed=seed, code_max=256)
    c = torch.from_numpy(codes).to(cuda)[offset:]
    assert c.is_contiguous() and c.shape == (n, shape[0])
    return c, codebook_bf16(torch.from_numpy(cents).to(cuda))


def _check_on_card(c, cb):
    before = pq_decode.launches
    dec, xsq = pq_decode(c, cb, want_xsq=True)
    torch.cuda.synchronize()
    assert pq_decode.launches == before + 1
    want, want_xsq = pq_decode_ref(c, cb, want_xsq=True)
    assert torch.equal(dec.view(torch.int16), want.view(torch.int16))
    torch.testing.assert_close(xsq, want_xsq, rtol=1e-5, atol=0)
    return dec, xsq


# (S, K, dsub, rows): the phase-4 shapes and S = 10, each with rows enough
# that every block of the persistent grid refills its ring of code tiles
VIEW_CASES = [(10, 256, 4, 1_000_003), (24, 64, 4, 300_001),
              (24, 16, 40, 100_003), (32, 256, 4, 300_001),
              (240, 256, 4, 200_003)]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", VIEW_CASES,
                         ids=[f"{s}x{k}x{d}-{n}" for s, k, d, n in VIEW_CASES])
def test_kernel_reads_code_views_on_card(cuda, case, offset):
    s, k, dsub, n = case
    _check_on_card(*_card_inputs(cuda, (s, k, dsub), n, offset))


EDGE_SHAPES = [(32, 256, 4), (240, 256, 4), (24, 16, 40), (10, 64, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES,
                         ids=[f"{s}x{k}x{d}" for s, k, d in EDGE_SHAPES])
def test_kernel_rows_at_tile_edges_on_card(cuda, shape):
    """Row counts T-1, T, T+1 and 2T+1 of the smallest tile (few rows) and
    of the largest (many rows), each with a code view at row offset 1."""
    from lantern_tpu_torch.ops.pq_decode import decode_plan

    small = decode_plan(1, *shape)["tile_rows"]
    big = decode_plan(10**9, *shape)["tile_rows"]  # the largest tile
    counts = [small - 1, small, small + 1, 2 * small + 1,
              2000 * big - 1, 2000 * big, 2000 * big + 1]
    for n in counts:
        want_tile = small if n <= 2 * small + 1 else big
        assert decode_plan(n, *shape)["tile_rows"] == want_tile, n
        _check_on_card(*_card_inputs(cuda, shape, n, offset=1))


@pytest.mark.cuda
def test_kernel_codebook_beyond_960d_on_card(cuda):
    """S=384, K=256, dsub=4: a 768 KiB codebook, in four slices or more
    (each at most a block's 227 KiB of shared memory)."""
    from lantern_tpu_torch.ops.pq_decode import decode_plan

    plan = decode_plan(50_001, 384, 256, 4)
    assert plan["slices"] >= 4 and plan["cluster"] == 1
    for offset in (0, 1):
        _check_on_card(*_card_inputs(cuda, (384, 256, 4), 50_001, offset))


@pytest.mark.cuda
@pytest.mark.parametrize("case", VIEW_CASES + [(384, 256, 4, 50_001)],
                         ids=[f"{s}x{k}x{d}" for s, k, d, _ in VIEW_CASES]
                         + ["384x256x4"])
def test_kernel_xsq_same_on_every_call_on_card(cuda, case):
    s, k, dsub, n = case
    c, cb = _card_inputs(cuda, (s, k, dsub), n, offset=1)
    dec, xsq = _check_on_card(c, cb)
    dec2, xsq2 = pq_decode(c, cb, want_xsq=True)
    assert torch.equal(xsq2.view(torch.int32), xsq.view(torch.int32))
    assert torch.equal(dec2.view(torch.int16), dec.view(torch.int16))


@pytest.mark.cuda
def test_kernel_plan_holds_the_codebook_in_shared_memory_on_card(cuda):
    """Every phase-4 shape keeps its codebook in shared memory: one slice at
    the main shape, slices of the 960-d codebook in one cluster with
    |x|^2, 16-byte stores at dsub = 4 and 40."""
    from lantern_tpu_torch.ops.pq_decode import decode_plan

    optin = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    for s, k, dsub, n in [(32, 256, 4, 1_000_000), (240, 256, 4, 200_000),
                          (24, 16, 40, 200_000), (24, 64, 4, 100_000)]:
        for want_xsq in (True, False):
            plan = decode_plan(n, s, k, dsub, want_xsq)
            assert plan["slices"] * plan["slice_subs"] >= s
            assert plan["slice_subs"] * k * dsub * 2 <= plan["smem"] <= optin
            assert plan["vec"] == 16
            assert plan["cluster"] == int(want_xsq and plan["slices"] > 1)
            assert plan["blocks"] % plan["slices"] == 0
            assert plan["tile_rows"] % (plan["threads"] // plan["lanes"]) == 0
    assert decode_plan(1_000_000, 32, 256, 4)["slices"] == 1
    assert decode_plan(200_000, 240, 256, 4)["slices"] > 1
