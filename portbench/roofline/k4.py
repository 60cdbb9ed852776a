"""K4, the hamming block (``ops/hamming.py``, ``csrc/hamming.cu``):
operations and bytes of one launch.

``_launch(queries [Q, W], base [N, W], deleted [N] | None, scores)``, the
one launch behind ``hamming_block`` (distances) and ``hamming_scores`` (the
flat scan's negated, masked scores): each input byte read once (the query
and base words, the tombstone mask when given) and each output byte written
once (the [Q, N] f32 block); the +-1 product, 2 int8 operations a bit pair.
At Q=1024, N=1M, W=32 the distance launch moves 4.22 GB (PERF.md, the
kernel table); the score launch reads the N-byte mask too.
"""

KERNEL = "hamming_kernel"
ARGS = ("queries", "base", "deleted", "scores")


def cost(call: dict) -> tuple[float, str, float] | None:
    a = dict(zip(ARGS, call["args"]), **call["kwargs"])
    q, w = a["queries"]["shape"]
    n = a["base"]["shape"][0]
    if q == 0 or n == 0:
        return None
    mask = n if isinstance(a.get("deleted"), dict) else 0
    nbytes = q * w * 4 + n * w * 4 + mask + q * n * 4
    return 2.0 * q * n * w * 32, "int8", float(nbytes)
