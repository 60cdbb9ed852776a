"""What the examples share: the row count, the checks, the kernels'
launch counters and the command line."""

from __future__ import annotations

import argparse
import json
import os

from lantern_tpu_torch.ops.gather_dists import gather_dists
from lantern_tpu_torch.ops.hamming import hamming_block
from lantern_tpu_torch.ops.pq_decode import pq_decode


def example_n(n: int | None, default: int) -> int:
    """``n``, else ``EXAMPLE_N`` from the environment (as the reference
    scripts read it), else the reference's ``default``."""
    return int(n if n is not None else os.environ.get("EXAMPLE_N", default))


def check(cond: bool, msg: str) -> None:
    """The reference's ``assert``, kept under ``python -O``."""
    if not cond:
        raise AssertionError(msg)


def launches() -> dict:
    """Each kernel's CUDA launches so far in this process (the wrappers
    count nothing on CPU tensors)."""
    return {"gather_dists": gather_dists.launches,
            "pq_decode": pq_decode.launches,
            "hamming_block": hamming_block.launches}


def launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launches().items()}


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path on the host)")
    ap.add_argument("--n", type=int, default=None,
                    help="rows (default EXAMPLE_N, else the reference's)")
    return ap


def emit(result: dict) -> None:
    """The result as the last line of standard output."""
    print(json.dumps(result), flush=True)
