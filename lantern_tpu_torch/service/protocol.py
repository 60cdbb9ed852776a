"""External-index wire protocol: framing, constants, and codecs.

Byte-for-byte parity with the reference's protocol (SURVEY.md §5.8;
lantern_hnsw/src/hnsw/external_index_socket.h:10-38,
lantern_cli/src/external_index/server.rs:27-35,77-157):

- little-endian; magics INIT=0x13333337, END=0x31333337, ERR=0x37333337
- handshake: server -> u32 protocol_version, u32 server_type (1=indexing,
  2=router); router flow: client sends u32 0x3 get-server, router replies
  u32 is_secure, u32 addr_len, addr bytes, u32 port
- client INIT frame: magic + 11 x u32 {pq, metric_kind(cos=1,l2sq=3,
  hamming=8), quantization(f32=0, f64=2, f16=3, i8=4, b1=5), dim, m,
  ef_construction, ef, num_centroids, num_subvectors, estimated_capacity,
  element_bits}
- if pq: num_centroids codebook rows of dim*4 bytes each, then END
- tuple frames: 8-byte label + vector payload (f32*dim, or ceil(bits/8))
- finish: END -> server sends u64 count, u64 file_size, raw index file
- error frame: ERR magic + u32 len + utf8 message
"""

from __future__ import annotations

import dataclasses
import struct

from lantern_tpu_torch.config import HnswParams, Metric, QuantKind

PROTOCOL_VERSION = 1
INIT_MSG = 0x13333337
END_MSG = 0x31333337
ERR_MSG = 0x37333337
GET_SERVER_MSG = 0x3
SERVER_TYPE_INDEXING = 0x1
SERVER_TYPE_ROUTER = 0x2
PROTOCOL_HEADER_SIZE = 4

_INIT_FMT = "<I11I"  # magic + 11 params


@dataclasses.dataclass
class InitParams:
    pq: int
    metric_kind: int
    quantization: int
    dim: int
    m: int
    ef_construction: int
    ef: int
    num_centroids: int
    num_subvectors: int
    estimated_capacity: int
    element_bits: int

    @classmethod
    def from_hnsw_params(cls, p: HnswParams, estimated_capacity: int) -> "InitParams":
        # the wire always carries f32 rows (element_bits=32) except packed
        # binary — matching the reference, whose client streams raw f32 and
        # lets the engine quantize at insert (external_index_socket.c:517-536
        # payload is "f32*dim, or ceil(bits/8) for binary"); the
        # `quantization` field still tells the server the STORAGE kind
        bits = 1 if p.quant == QuantKind.B1 else 32
        return cls(
            pq=int(p.pq),
            metric_kind=int(p.metric),
            quantization=int(p.quant),
            dim=p.dim,
            m=p.m,
            ef_construction=p.ef_construction,
            ef=p.ef,
            num_centroids=p.num_centroids if p.pq else 0,
            num_subvectors=p.effective_num_subvectors if p.pq else 0,
            estimated_capacity=estimated_capacity,
            element_bits=bits,
        )

    def to_hnsw_params(self) -> HnswParams:
        return HnswParams(
            dim=self.dim,
            m=self.m,
            ef_construction=self.ef_construction,
            ef=self.ef,
            metric=Metric(self.metric_kind),
            quant=QuantKind(self.quantization),
            pq=bool(self.pq),
            num_centroids=self.num_centroids or 256,
            num_subvectors=self.num_subvectors,
        )

    def pack(self) -> bytes:
        return struct.pack(
            _INIT_FMT, INIT_MSG, self.pq, self.metric_kind, self.quantization,
            self.dim, self.m, self.ef_construction, self.ef,
            self.num_centroids, self.num_subvectors, self.estimated_capacity,
            self.element_bits,
        )

    @classmethod
    def unpack(cls, buf: bytes) -> "InitParams":
        vals = struct.unpack(_INIT_FMT, buf)
        if vals[0] != INIT_MSG:
            raise ProtocolError(f"expected INIT magic, got {vals[0]:#x}")
        return cls(*vals[1:])

    @property
    def tuple_payload_bytes(self) -> int:
        if self.element_bits == 1:
            # packed bits; payload word-aligned to u32 like the storage
            # (ref: ceil(bits/8) — identical whenever dim % 32 == 0)
            return (-(-self.dim // 32)) * 4
        if self.element_bits != 32:
            raise ProtocolError(
                f"unsupported element_bits {self.element_bits}: the wire "
                "carries f32 rows (32) or packed binary (1)"
            )
        return self.dim * 4


class ProtocolError(RuntimeError):
    pass


def pack_handshake(server_type: int) -> bytes:
    return struct.pack("<II", PROTOCOL_VERSION, server_type)


def unpack_handshake(buf: bytes) -> tuple[int, int]:
    version, stype = struct.unpack("<II", buf)
    if version != PROTOCOL_VERSION:
        raise ProtocolError(f"protocol version {version} != {PROTOCOL_VERSION}")
    return version, stype


def pack_tuple(label: int, payload: bytes) -> bytes:
    return struct.pack("<Q", label) + payload


def pack_end() -> bytes:
    return struct.pack("<I", END_MSG)


def pack_error(msg: str) -> bytes:
    raw = msg.encode()
    return struct.pack("<II", ERR_MSG, len(raw)) + raw


def pack_router_redirect(host: str, port: int, is_secure: bool = False) -> bytes:
    raw = host.encode()
    return struct.pack("<II", int(is_secure), len(raw)) + raw + struct.pack("<I", port)
