"""One dense score block of the flat scan (``flat._scores``): operations and
bytes from its arguments.

``_scores(vectors [N, d], sq_norms [N], queries_f32 [Q, d], metric,
vec_scales=None, excluded=None)`` forms the [Q, N] f32 block of Q queries
against N rows, whatever kernels form it (a GEMM with its bias epilogue,
a GEMM and in-place passes, a later fused kernel). Operations: the product,
2 Q N d. Bytes: each input byte read once (the f32 queries, the rows at
their stored width, the f32 norms, the i8 scales and the bool mask when
given) and the block written once.

The operations are counted at the TF32 peak, not at the f32 CUDA-core one:
TF32's rate bounds every f32-accurate way to form the block on this card,
the FFMA GEMM of today as much as a split-TF32 or bf16 scheme on the tensor
cores later, and such a scheme would read over 105% against the CUDA-core
peak. At Q=1024, N=1M, d=1536 (f32, masked): 3.146e12 operations, 6.36 ms
at 495 TFLOP/s; 10.25 GB, 3.06 ms at 3.35 TB/s; so bound by operations.
"""

ARGS = ("vectors", "sq_norms", "queries_f32", "metric", "vec_scales",
        "excluded")


def _bytes_of(arg, n: int) -> int:
    """Bytes of an optional [N] tensor argument (0 where it was None)."""
    return n * arg["itemsize"] if isinstance(arg, dict) else 0


def cost(call: dict) -> tuple[float, str, float] | None:
    a = dict(zip(ARGS, call["args"]), **call["kwargs"])
    n, d = a["vectors"]["shape"]
    q = a["queries_f32"]["shape"][0]
    if q == 0 or n == 0:
        return None
    nbytes = (q * d * 4 + n * d * a["vectors"]["itemsize"] + n * 4
              + _bytes_of(a.get("vec_scales"), n)
              + _bytes_of(a.get("excluded"), n) + q * n * 4)
    return 2.0 * q * n * d, "tf32", float(nbytes)
