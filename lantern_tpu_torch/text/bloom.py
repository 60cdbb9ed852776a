"""Bloom filter (own copy of lantern_tpu/text/bloom.py; numpy only) — parity
with lantern_extras' `bloom` type (X6, bloom.rs).

The reference wraps the fastbloom crate's bitmap with casts from integer
arrays (bloom.rs:8-41) and uses it for BM25 doc-membership approximation.
Double-hashing (Kirsch–Mitzenmacher) over a vectorized splitmix64 finalizer
— the BM25 popular-term path exists precisely because postings are huge, so
hashing must not loop per doc id in Python.
"""

from __future__ import annotations

import math

import numpy as np

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (public-domain mixing constants)."""
    with np.errstate(over="ignore"):
        z = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK
        z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _MASK
        z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _MASK
        return z ^ (z >> np.uint64(31))


class Bloom:
    def __init__(self, num_bits: int, num_hashes: int):
        self.num_bits = max(int(num_bits), 8)
        self.num_hashes = max(int(num_hashes), 1)
        self.bits = np.zeros((self.num_bits + 31) // 32, np.uint32)

    @classmethod
    def for_items(cls, n: int, fp_rate: float = 0.01) -> "Bloom":
        n = max(n, 1)
        m = int(-n * math.log(fp_rate) / (math.log(2) ** 2)) + 1
        k = max(1, round(m / n * math.log(2)))
        return cls(m, k)

    def _hashes(self, items: np.ndarray) -> np.ndarray:
        """[n] uint64 items -> [n, k] bit positions (fully vectorized)."""
        items = np.asarray(items, np.uint64)
        h1 = _splitmix64(items)
        h2 = _splitmix64(items ^ np.uint64(0xA5A5A5A5A5A5A5A5)) | np.uint64(1)
        k = np.arange(self.num_hashes, dtype=np.uint64)
        with np.errstate(over="ignore"):
            mixed = (h1[:, None] + k[None, :] * h2[:, None]) & _MASK
        return (mixed % np.uint64(self.num_bits)).astype(np.int64)

    def add(self, items) -> "Bloom":
        pos = self._hashes(np.atleast_1d(np.asarray(items, np.uint64))).ravel()
        np.bitwise_or.at(self.bits, pos // 32, (np.uint32(1) << (pos % 32).astype(np.uint32)))
        return self

    def contains(self, items) -> np.ndarray:
        items = np.atleast_1d(np.asarray(items, np.uint64))
        pos = self._hashes(items)
        word = self.bits[pos // 32]
        bit = (word >> (pos % 32).astype(np.uint32)) & 1
        return bit.all(axis=1)

    @classmethod
    def from_array(cls, items, fp_rate: float = 0.01) -> "Bloom":
        """array_to_bloom cast analog."""
        items = np.atleast_1d(np.asarray(items, np.uint64))
        b = cls.for_items(len(items), fp_rate)
        return b.add(items)

    # serialization (the reference's bloom is a varlena value)
    def to_bytes(self) -> bytes:
        import struct

        return struct.pack("<II", self.num_bits, self.num_hashes) + self.bits.tobytes()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Bloom":
        import struct

        num_bits, num_hashes = struct.unpack("<II", raw[:8])
        b = cls(num_bits, num_hashes)
        bits = np.frombuffer(raw[8:], np.uint32).copy()
        want = (num_bits + 31) // 32
        if len(bits) != want:
            # catch truncation at load time, not as an IndexError deep
            # inside a later contains() whose hash lands past the tail
            raise ValueError(
                f"bloom payload has {len(bits)} words, header implies {want}"
            )
        b.bits = bits
        return b
