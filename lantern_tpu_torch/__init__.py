"""lantern_tpu_torch: the PyTorch/CUDA port of lantern-tpu for NVIDIA Hopper.

A second package beside ``lantern_tpu`` (the JAX reference). It keeps the
reference's module names so each function has a counterpart to read:

- ``config``            index/search parameters (own copy of the reference's)
- ``native``            the C++ HNSW host engine, bound with ctypes
- ``graph.device``      ``DeviceGraph``: the graph arrays as torch tensors
- ``graph.search``      the batched HNSW beam search (ADC for PQ graphs)
- ``graph.build_device`` the batched graph builder on the device
                        (``build_on_device``, ``device_insert``)
- ``graph.host_build``  ``HostHnsw``, the numpy host engine
                        (``Index(engine="python")``)
- ``graph.validate``    structural validation of an engine or DeviceGraph
- ``graph.reorder``     BFS renumbering of a DeviceGraph
- ``flat``              the dense matmul + top-k scan (i8, hamming), the PQ
                        scan and rerank
- ``quant.pq``          PQ codebook training, encode/decode, ADC tables
- ``quant.scalar``      i8 quantisation and 1-bit packing (b1 rows)
- ``ops.distance``      distances and the exact-search oracle
- ``ops.gather_dists``  the beam's gather-distance kernel (CUDA, csrc/)
- ``ops.pq_decode``     the PQ decode kernel (CUDA, csrc/)
- ``ops.hamming``       the all-pairs hamming kernel and its exact top-k
                        (CUDA, csrc/)
- ``costmodel``         flat-vs-graph dispatch and the analytic search cost
- ``storage.snapshot``  snapshot files and the insert log (``InsertLog``),
                        the JAX package's format
- ``storage.replica``   ``IndexFollower``, a log-following read replica
- ``utils.failpoints``  failure-point fault injection
- ``index``             the ``Index`` facade

It imports torch and numpy only, never jax or lantern_tpu. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; with no card and no
explicit CPU device they raise instead of quietly running on the host.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``cuda``.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no card is present; the CPU runs only when named.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lantern_tpu_torch needs a CUDA device (none found); pass "
            "device='cpu' to run the plain PyTorch path on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


from lantern_tpu_torch.config import (  # noqa: E402,F401
    HnswParams,
    Metric,
    QuantKind,
    SearchParams,
)
from lantern_tpu_torch.graph.host_build import HostHnsw  # noqa: E402,F401
from lantern_tpu_torch.index import Index  # noqa: E402,F401
from lantern_tpu_torch.storage import (  # noqa: E402,F401
    HEADER_MAGIC,
    HEADER_VERSION,
    IndexFollower,
    InsertLog,
    load_snapshot,
    read_log_header,
    read_snapshot_header,
    save_snapshot,
    scan_log_tail,
)
from lantern_tpu_torch.utils import (  # noqa: E402,F401
    FailurePointError,
    failure_point,
    failure_point_disable_all,
    failure_point_enable,
)
