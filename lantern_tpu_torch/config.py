"""Index parameters, metric kinds, and validation.

Mirrors the reference's option system (lantern_hnsw/src/hnsw/options.c and
options.h): per-index reloptions ``dim / m / ef_construction / ef / pq /
quant_bits`` with the same defaults and bounds, plus the search-time GUCs
``lantern_hnsw.init_k`` and ``lantern_hnsw.ef``.  The wire-protocol numeric
codes for metric and quantization kinds match the reference
(lantern_cli/src/external_index/cli.rs:56-69 UMetricKind,
lantern_hnsw/src/hnsw/external_index_socket.h:24-38 init frame).
"""

from __future__ import annotations

import dataclasses
import enum
import math


class Metric(enum.IntEnum):
    """Distance metric, with the reference's u32 wire codes.

    cos=1, l2sq=3, hamming=8 (reference: external_index/cli.rs:56-69).
    """

    COS = 1
    L2SQ = 3
    HAMMING = 8

    @classmethod
    def from_string(cls, s: str) -> "Metric":
        # reference: utils.c:267-278 metric-from-string
        table = {
            "l2sq": cls.L2SQ,
            "l2": cls.L2SQ,
            "euclidean": cls.L2SQ,
            "cos": cls.COS,
            "cosine": cls.COS,
            "hamming": cls.HAMMING,
        }
        key = s.strip().lower()
        if key not in table:
            raise ValueError(f"unknown metric {s!r}; expected one of {sorted(table)}")
        return table[key]


class QuantKind(enum.IntEnum):
    """Scalar-quantization kind of stored vectors, with reference wire codes.

    f32=0 (also 1), f64=2, f16=3, i8=4, b1=5
    (reference: external_index_socket.h:24-38; options.c:137-158 quant_bits
    enum 1/2/4/8/16/32 maps: 32->f32, 16->f16, 8->i8, 1->b1).
    """

    F32 = 0
    F64 = 2
    F16 = 3
    I8 = 4
    B1 = 5

    @classmethod
    def from_quant_bits(cls, bits: int) -> "QuantKind":
        table = {32: cls.F32, 16: cls.F16, 8: cls.I8, 1: cls.B1}
        if bits not in table:
            raise ValueError(
                f"quant_bits={bits} unsupported; expected one of {sorted(table)}"
            )
        return table[bits]

    @property
    def bits(self) -> int:
        return {self.F32: 32, self.F64: 64, self.F16: 16, self.I8: 8, self.B1: 1}[self]


# Bounds from the reference (options.h:14-25). dim may exceed the reference's
# 2000 cap (that cap exists only because a node must fit one 8 KB Postgres
# page); we keep it as a soft default ceiling but allow opting out.
LDB_DIM_MAX = 2000
LDB_M_DEFAULT, LDB_M_MIN, LDB_M_MAX = 16, 2, 128
LDB_EFC_DEFAULT, LDB_EFC_MIN, LDB_EFC_MAX = 128, 1, 400
LDB_EF_DEFAULT, LDB_EF_MIN, LDB_EF_MAX = 64, 1, 400
LDB_INIT_K_DEFAULT = 10  # GUC lantern_hnsw.init_k (options.c:324-340)
LDB_SCAN_K_MAX = 1000  # hard streaming cap (scan.c:249-251)


@dataclasses.dataclass(frozen=True)
class HnswParams:
    """Build-time index parameters (reference reloptions, options.c:163-197)."""

    dim: int
    m: int = LDB_M_DEFAULT
    ef_construction: int = LDB_EFC_DEFAULT
    ef: int = LDB_EF_DEFAULT  # default search ef persisted with the index
    metric: Metric = Metric.L2SQ
    quant: QuantKind = QuantKind.F32
    pq: bool = False
    num_centroids: int = 256
    num_subvectors: int = 0  # 0 -> auto (dim // 4 like lantern defaults elsewhere)
    strict_dim_cap: bool = False  # enforce the reference's 2000-dim page cap

    def __post_init__(self):
        if self.dim <= 0:
            raise ValueError(f"dim must be positive, got {self.dim}")
        if self.strict_dim_cap and self.dim > LDB_DIM_MAX:
            raise ValueError(f"dim {self.dim} exceeds reference cap {LDB_DIM_MAX}")
        if not (LDB_M_MIN <= self.m <= LDB_M_MAX):
            raise ValueError(f"m={self.m} out of range [{LDB_M_MIN},{LDB_M_MAX}]")
        if not (LDB_EFC_MIN <= self.ef_construction <= LDB_EFC_MAX):
            raise ValueError(
                f"ef_construction={self.ef_construction} out of range "
                f"[{LDB_EFC_MIN},{LDB_EFC_MAX}]"
            )
        if not (LDB_EF_MIN <= self.ef <= LDB_EF_MAX):
            raise ValueError(f"ef={self.ef} out of range [{LDB_EF_MIN},{LDB_EF_MAX}]")
        if self.pq:
            if self.num_centroids < 1 or self.num_centroids > 65536:
                raise ValueError(f"num_centroids={self.num_centroids} out of range")
            nsub = self.effective_num_subvectors
            if self.dim % nsub != 0:
                raise ValueError(
                    f"dim={self.dim} not divisible by num_subvectors={nsub}"
                )
        if self.metric == Metric.HAMMING and self.quant not in (
            QuantKind.F32,
            QuantKind.B1,
        ):
            raise ValueError("hamming metric requires b1 (or raw f32 bit) storage")
        if self.quant == QuantKind.B1 and self.metric != Metric.HAMMING:
            # l2sq over 1-bit values IS hamming ((0-1)^2 = 1); make the user
            # say so explicitly rather than silently switching semantics
            raise ValueError("quant=B1 requires metric=HAMMING")

    @property
    def effective_num_subvectors(self) -> int:
        if self.num_subvectors:
            return self.num_subvectors
        # auto: subvectors of ~4 dims, at least 1
        nsub = max(1, self.dim // 4)
        while self.dim % nsub != 0:
            nsub -= 1
        return nsub

    @property
    def m0(self) -> int:
        """Max degree at level 0 = 2*M (reference: validate_index.c:151)."""
        return 2 * self.m

    @property
    def level_lambda(self) -> float:
        """Level-draw multiplier 1/ln(M) (reference: insert.c:32-46)."""
        return 1.0 / math.log(self.m)


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Query-time knobs (reference GUCs lantern_hnsw.init_k / .ef)."""

    k: int = LDB_INIT_K_DEFAULT
    ef: int | None = None  # None -> use index's ef
    # batched-search engine knobs (no reference analog; TPU-specific):
    expand: int = 1  # beam entries expanded per iteration
    max_iters: int | None = None  # None -> derived bound
    # upper-scan entry seeds placed in the initial beam: the dense entry
    # scan prices top-8 like top-1, and multiple separated seeds raise
    # recall at every iteration budget (BASELINE.md round 11). 1 restores
    # the single-entry semantics of the serial reference.
    seeds: int = 8

    def __post_init__(self):
        if not (1 <= self.k <= LDB_SCAN_K_MAX):
            raise ValueError(f"k={self.k} out of range [1,{LDB_SCAN_K_MAX}]")
        if self.ef is not None and not (LDB_EF_MIN <= self.ef <= LDB_EF_MAX):
            raise ValueError(f"ef={self.ef} out of range")


def expected_levels(n: int, m: int) -> float:
    """E[max level] = ln(1+n)*mL with mL=1/ln(M).

    Reference cost model: hnsw.c:89-145.
    """
    return math.log(1 + max(n, 1)) / math.log(m)
