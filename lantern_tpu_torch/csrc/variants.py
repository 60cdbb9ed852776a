"""Compare text-patched variants of the PQ decode kernel on the card.

    python -m lantern_tpu_torch.csrc.variants VARIANTS.json

VARIANTS.json maps a variant's name to a list of ``[old, new]`` text
replacements applied to ``csrc/pq_decode.cu`` (for example its constants
``kThreads``, ``kMaxStages``, ``kTileOutBytes``). Each variant is built with
``build_shared`` into ``_build/variants/`` beside the unpatched source
("base"), held bit-equal to ``pq_decode_ref`` (|x|^2 within 1e-5 relative)
at each shape, then timed with CUDA events over 40 back-to-back launches,
the variants in turn and then in reverse order (two times each). Prints the
card's name and power limit, and one JSON line a shape: each variant's two
ms and its best share of the bytes bound.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

from lantern_tpu_torch.csrc.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, build_shared, find_nvcc
from lantern_tpu_torch.ops.pq_decode import codebook_bf16, pq_decode_ref

# (rows, S, K, dsub): chip_smoke.py's phase-4 shapes and the PQ path's block
SHAPES = [(1_000_000, 32, 256, 4), (200_000, 240, 256, 4),
          (200_000, 24, 16, 40), (100_000, 24, 64, 4), (250_000, 32, 256, 4)]
PEAK_BYTES_PER_S = 3.35e12  # one H100 SXM's HBM
REPS = 40


def build(variants: dict) -> dict:
    """name -> the variant's ldb_pq_decode, "base" the unpatched source."""
    with open(os.path.join(CSRC_DIR, "pq_decode.cu")) as f:
        src = f.read()
    out_dir = os.path.join(BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    fns = {}
    for name, subs in {"base": [], **variants}.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"pq_decode_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        fn = ctypes.CDLL(build_shared(path, [find_nvcc()] + NVCC_FLAGS,
                                      f"pq_decode_{name}")).ldb_pq_decode
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fns[name] = fn
    return fns


def launch(fn, codes, cb, out, xsq):
    n, s = codes.shape
    _, k, dsub = cb.shape
    rc = fn(codes.data_ptr(), cb.data_ptr(), out.data_ptr(), xsq.data_ptr(), n,
            s, k, dsub, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def compare(fns: dict, seed: int = 1) -> None:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    order = list(fns) + list(fns)[::-1]
    for n, s, k, dsub in SHAPES:
        cb = codebook_bf16(torch.randn((s, k, dsub), generator=gen, device="cuda"))
        # two code sets and outputs: the decoded rows exceed the L2 cache
        codes = [torch.randint(0, k, (n, s), generator=gen, device="cuda",
                               dtype=torch.uint8) for _ in range(2)]
        outs = [torch.empty((n, s * dsub), dtype=torch.bfloat16, device="cuda")
                for _ in range(2)]
        xsqs = [torch.empty((n,), dtype=torch.float32, device="cuda")
                for _ in range(2)]
        want, want_xsq = pq_decode_ref(codes[0], cb, want_xsq=True)
        times = {name: [] for name in fns}
        for name in order:
            fn = fns[name]
            launch(fn, codes[0], cb, outs[0], xsqs[0])
            torch.cuda.synchronize()
            if not torch.equal(outs[0].view(torch.int16), want.view(torch.int16)):
                raise AssertionError(f"{name} disagrees with pq_decode_ref")
            torch.testing.assert_close(xsqs[0], want_xsq, rtol=1e-5, atol=0)
            for i in range(4):
                launch(fn, codes[i % 2], cb, outs[i % 2], xsqs[i % 2])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(REPS):
                launch(fn, codes[i % 2], cb, outs[i % 2], xsqs[i % 2])
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / REPS)
        nbytes = n * s + s * k * dsub * 2 + n * s * dsub * 2 + n * 4
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        print(json.dumps({"shape": [n, s, k, dsub], "bound_ms": bound_ms, **{
            name: {"ms": ts, "share_of_bound": bound_ms / min(ts)}
            for name, ts in times.items()}}), flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    with open(argv[0]) as f:
        variants = json.load(f)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    compare(build(variants))


if __name__ == "__main__":
    main()
