"""Device-resident graph arrays (port of lantern_tpu/graph/device.py).

A ``DeviceGraph`` holds the host engine's graph as flat tensors on one device:

- ``vectors[cap, dim]``        f32 or bf16 rows; int8 codes (``quant == I8``,
                               with per-row f32 ``vec_scales[cap]``);
                               ``[cap, W]`` int32 words carrying the uint32
                               bits for hamming (``W = ceil(dim/32)``); or
                               ``[cap, S]`` uint8 PQ codes (``quant ==
                               QUANT_PQ``, with ``pq_codebook`` ``[S, K,
                               dsub]`` f32 and the optional OPQ
                               ``pq_rotation`` ``[dim, dim]``)
- ``sq_norms[cap]``            f32 |x|^2 (of the decoded rows for PQ, of the
                               dequantised rows for i8; zeros for hamming)
- ``neighbors0[cap+1, 2M]``    level-0 adjacency, -1 padded; row ``cap`` is the
                               all-invalid dummy row that expands to nothing
- ``upper_neighbors[ucap, LMAX, M]`` adjacency of the nodes with level >= 1
- ``upper_slot[cap]``          node id -> upper slot (-1 for level-0 nodes)
- ``upper_ids[ucap]``          upper slot -> node id (-1 blanks), or None
- ``levels[cap]``, ``labels[cap]`` (int64 holding the u64 bits),
  ``deleted[cap]`` (bool tombstones)
- ``entry / max_level / num_nodes``   host-side ints

seqid is the array index. ``vectors`` has no sentinel row: callers clip ids
before gathering (the JAX docstring's ``[cap+1, dim+4]`` for its norm-folded
table is wrong; that table has ``cap`` rows).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lantern_tpu_torch import resolve_device
from lantern_tpu_torch.config import Metric, QuantKind

# DeviceGraph.quant of product-quantised graphs (the reference's QUANT_PQ;
# PQ is a separate option from the scalar QuantKind, as there)
QUANT_PQ = 100


@dataclasses.dataclass
class DeviceGraph:
    vectors: torch.Tensor          # [cap, dim] f32/bf16/i8, [cap, W] i32, [cap, S] u8
    sq_norms: torch.Tensor         # [cap] f32
    neighbors0: torch.Tensor       # [cap+1, m0] int32
    upper_neighbors: torch.Tensor  # [ucap, LMAX, m] int32
    upper_slot: torch.Tensor       # [cap] int32
    levels: torch.Tensor           # [cap] int32
    labels: torch.Tensor           # [cap] int64 (u64 bits)
    deleted: torch.Tensor          # [cap] bool
    entry: int
    max_level: int
    num_nodes: int
    upper_ids: torch.Tensor | None = None      # [ucap] int32
    # cached upper-subset tables for the entry scan (vectors[max(upper_ids,
    # 0)] and sq_norms[...]); attached only by with_aug_norms
    upper_vectors: torch.Tensor | None = None  # [ucap, dim]
    upper_sq: torch.Tensor | None = None       # [ucap] f32
    vec_scales: torch.Tensor | None = None     # [cap] f32 per-row i8 scales
    pq_codebook: torch.Tensor | None = None    # [S, K, dsub] f32
    pq_rotation: torch.Tensor | None = None    # [dim, dim] f32 (OPQ)
    m: int = 16
    dim: int = 0
    metric: int = int(Metric.L2SQ)
    quant: int = int(QuantKind.F32)

    @property
    def cap(self) -> int:
        return self.vectors.shape[0]

    @property
    def m0(self) -> int:
        return self.neighbors0.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def labels_at(self, ids: torch.Tensor) -> torch.Tensor:
        """labels[ids] as int64 (u64 bits); 0 where ids < 0."""
        lab = self.labels[torch.clamp(ids, 0, self.cap - 1).long()]
        return torch.where(ids >= 0, lab, torch.zeros_like(lab))

    def to(self, device) -> "DeviceGraph":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


def with_aug_norms(g: DeviceGraph) -> DeviceGraph:
    """Attach the cached upper-subset tables of the entry scan (l2sq over
    f32/bf16 storage, as in the reference; a no-op for PQ codes).
    Idempotent.

    The reference also attaches a norm-folded row table here for its einsum
    beam; the port's beam reads |x|^2 from the gathered row inside K1
    (ops/gather_dists.py), so only the upper tables are kept.
    """
    if g.upper_vectors is not None:
        return g
    if Metric(g.metric) != Metric.L2SQ or g.vec_scales is not None:
        return g
    if g.quant not in (int(QuantKind.F32), int(QuantKind.F16)):
        return g
    if g.upper_ids is None or g.upper_ids.shape[0] <= 1:
        return g
    safe = torch.clamp(g.upper_ids, min=0).long()
    return dataclasses.replace(
        g, upper_vectors=g.vectors[safe], upper_sq=g.sq_norms[safe]
    )


def upper_ids_from_slots(upper_slot: np.ndarray, ucap: int) -> np.ndarray:
    """Invert a node->slot map to slot->node ids ([ucap] int32, -1 blanks)."""
    slots = np.asarray(upper_slot, np.int32)
    ids = np.full(ucap, -1, np.int32)
    has = slots >= 0
    ids[slots[has]] = np.nonzero(has)[0].astype(np.int32)
    return ids


def _sq_norms_np(vectors: np.ndarray, metric: Metric) -> np.ndarray:
    if metric == Metric.HAMMING:
        return np.zeros(vectors.shape[0], np.float32)
    v = vectors.astype(np.float32)
    return np.einsum("nd,nd->n", v, v).astype(np.float32)


def _check_scope(metric: Metric, quant: int) -> None:
    if quant not in (int(QuantKind.F32), int(QuantKind.F16),
                     int(QuantKind.I8), QUANT_PQ):
        raise NotImplementedError(
            f"quant={quant}: the port stores f32, bf16 or int8 rows, packed "
            "bit words (quant F32, as the reference), or PQ codes")
    if metric == Metric.HAMMING and quant != int(QuantKind.F32):
        raise ValueError("hamming graphs store packed bit words with quant "
                         f"F32, as the reference's do, not quant={quant}")


def to_device(host, dtype: torch.dtype | None = None,
              device: str | torch.device | None = None,
              pq_codebook=None,
              quant: QuantKind | int | None = None) -> DeviceGraph:
    """Copy a NativeHnsw into a DeviceGraph on ``device`` (default cuda).

    ``dtype=torch.bfloat16`` stores bf16 rows (QuantKind.F16, as the
    reference's bf16 mirror). ``quant=QuantKind.I8`` stores int8 codes and
    per-row scales, re-encoding the engine's rows (already dequantised i8
    values, so the encoding is exact). ``pq_codebook`` (quant.pq.PQCodebook)
    stores only the rows' uint8 codes, ``vectors [cap, S]`` (QUANT_PQ),
    beside the codebook. ``sq_norms`` are those of the engine's rows (the
    decoded rows for PQ, zeros for hamming). Hamming engines' uint32 words
    are stored as int32 words with no dtype cast. The engine's arrays are
    zero-copy views of C++ memory that dangle after grow(); every array is
    copied before it becomes a tensor.
    """
    dev = resolve_device(device)
    metric = Metric(host.metric)
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise NotImplementedError(f"dtype {dtype}: the port stores f32 or bf16")
    if pq_codebook is not None:
        quant = QUANT_PQ
    elif quant is None:
        quant = (QuantKind.F16 if dtype == torch.bfloat16
                 and metric != Metric.HAMMING else QuantKind.F32)
    quant = int(quant)
    _check_scope(metric, quant)
    n = host.n
    nu = max(host.n_upper, 1)
    vectors = np.array(host.vectors[:n])
    upper_slot = np.array(host.upper_slot[:n], np.int32)
    nbr0 = np.concatenate(
        [host.neighbors0[:n], np.full((1, host.p.m0), -1, np.int32)], axis=0
    )

    def t(a):
        return torch.from_numpy(np.require(a, requirements=("C", "W"))).to(dev)

    pq_cb = pq_rot = scales = None
    if metric == Metric.HAMMING:
        vec = t(vectors.view(np.int32))
    elif quant == int(QuantKind.I8):
        from lantern_tpu_torch.quant.scalar import quantize_i8

        vec, scales = quantize_i8(t(vectors))
    elif pq_codebook is not None:
        from lantern_tpu_torch.quant.pq import pq_encode

        vec = t(pq_encode(vectors, pq_codebook, device=dev))  # [n, S] u8
        pq_cb = t(np.asarray(pq_codebook.centroids, np.float32))
        if pq_codebook.rotation is not None:
            pq_rot = t(np.asarray(pq_codebook.rotation, np.float32))
    else:
        vec = t(vectors)
        if dtype is not None:
            vec = vec.to(dtype)
    return DeviceGraph(
        vectors=vec,
        sq_norms=t(_sq_norms_np(vectors, metric)),
        neighbors0=t(nbr0),
        upper_neighbors=t(np.array(host.upper_neighbors[:nu], np.int32)),
        upper_slot=t(upper_slot),
        levels=t(np.array(host.levels[:n], np.int32)),
        labels=t(np.array(host.labels[:n], np.uint64).view(np.int64)),
        deleted=t(np.array(host.deleted[:n], bool)),
        entry=int(host.entry),
        max_level=int(host.max_level),
        num_nodes=int(n),
        upper_ids=t(upper_ids_from_slots(upper_slot, nu)),
        vec_scales=scales,
        pq_codebook=pq_cb,
        pq_rotation=pq_rot,
        m=host.p.m,
        dim=host.p.dim,
        metric=int(metric),
        quant=quant,
    )


def _tensor_from_np(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """numpy -> tensor, including JAX's bfloat16 arrays (ml_dtypes), which
    torch.from_numpy cannot read: their bits go across as int16; uint32 bit
    words become int32 words with the same bits. Copies, so the tensor never
    aliases the (possibly read-only) source."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev)


def from_jax_arrays(arrays: dict[str, np.ndarray], *, m: int, dim: int,
                    metric: Metric | int, quant: QuantKind | int,
                    device: str | torch.device | None = None) -> DeviceGraph:
    """The port's DeviceGraph from the fields of a reference DeviceGraph,
    given as numpy arrays (so both packages can search the same graph).

    ``labels`` ``[cap, 2]`` u32 (lo, hi) become int64 u64 bits;
    ``neighbors0`` keeps its ``cap+1`` dummy row; hamming graphs' uint32
    ``vectors`` become int32 words; ``entry``, ``max_level`` and
    ``num_nodes`` may be 0-d arrays. Optional fields (``upper_ids``,
    ``upper_vectors``, ``upper_sq``, ``vec_scales`` of i8 graphs, and for PQ
    graphs ``pq_codebook`` and ``pq_rotation``) are taken when present.
    """
    dev = resolve_device(device)
    metric = Metric(metric)
    _check_scope(metric, int(quant))
    lab = np.asarray(arrays["labels"], np.uint32)
    lab64 = lab[..., 0].astype(np.uint64) | (lab[..., 1].astype(np.uint64) << 32)
    tensors = {
        name: _tensor_from_np(np.asarray(arrays[name]), dev)
        for name in ("vectors", "sq_norms", "neighbors0", "upper_neighbors",
                     "upper_slot", "levels", "deleted", "upper_ids",
                     "upper_vectors", "upper_sq", "vec_scales",
                     "pq_codebook", "pq_rotation")
        if arrays.get(name) is not None
    }
    tensors["labels"] = torch.from_numpy(lab64.view(np.int64)).to(dev)
    return DeviceGraph(
        **tensors,
        entry=int(arrays["entry"]),
        max_level=int(arrays["max_level"]),
        num_nodes=int(arrays["num_nodes"]),
        m=int(m),
        dim=int(dim),
        metric=int(metric),
        quant=int(quant),
    )
