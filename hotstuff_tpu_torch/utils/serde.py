"""Compact deterministic binary codec for the port's wire messages.

A copy of `hotstuff_tpu/utils/serde.py` (`Writer`, `Reader`,
`SerdeError`): a schema-less little-endian binary format driven by
explicit per-type encode/decode methods, so the port's QC, AggQC and
ingress messages encode byte for byte as the reference's.
"""

from __future__ import annotations

import struct


class Writer:
    """Append-only byte sink with primitive writers."""

    __slots__ = ("_parts",)

    def __init__(self) -> None:
        self._parts: list[bytes] = []

    def bytes(self) -> bytes:
        return b"".join(self._parts)

    def raw(self, b: bytes) -> None:
        self._parts.append(b)

    def u8(self, v: int) -> None:
        self._parts.append(struct.pack("<B", v))

    def u32(self, v: int) -> None:
        self._parts.append(struct.pack("<I", v))

    def u64(self, v: int) -> None:
        self._parts.append(struct.pack("<Q", v))

    def var_bytes(self, b: bytes) -> None:
        """Length-prefixed variable byte string."""
        self._parts.append(struct.pack("<I", len(b)))
        self._parts.append(b)

    def fixed(self, b: bytes, n: int) -> None:
        if len(b) != n:
            raise ValueError(f"expected {n} bytes, got {len(b)}")
        self._parts.append(b)

    def seq(self, items, write_one) -> None:
        self.u32(len(items))
        for it in items:
            write_one(self, it)


class Reader:
    """Cursor over an immutable byte buffer with primitive readers."""

    __slots__ = ("_buf", "_pos")

    def __init__(self, buf: bytes) -> None:
        self._buf = buf
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._buf):
            raise SerdeError(
                f"buffer underrun: need {n} bytes at offset {self._pos}, have {len(self._buf)}"
            )
        out = self._buf[self._pos : self._pos + n]
        self._pos += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def var_bytes(self) -> bytes:
        n = self.u32()
        return self._take(n)

    def fixed(self, n: int) -> bytes:
        return self._take(n)

    def seq(self, read_one) -> list:
        n = self.u32()
        return [read_one(self) for _ in range(n)]

    def done(self) -> bool:
        return self._pos == len(self._buf)

    def expect_done(self) -> None:
        if not self.done():
            raise SerdeError(f"trailing garbage: {len(self._buf) - self._pos} bytes")


class SerdeError(Exception):
    """Malformed wire bytes (truncation, trailing data, bad tags)."""
