"""Byte wrappers for digests, ed25519 public keys and signatures.

A trimmed copy of `hotstuff_tpu/crypto/primitives.py` (reference crypto
crate, crypto/src/lib.rs:20-224): only the value types the backend seam,
the certificate codec (`consensus/messages.py`) and the ingress messages
pass around. Signing and single verification live in `pysigner`."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass


def sha512_32(data: bytes) -> bytes:
    """SHA-512 truncated to 32 bytes, the reference's digest function."""
    return hashlib.sha512(data).digest()[:32]


@dataclass(frozen=True, slots=True)
class Digest:
    """32-byte content hash (reference crypto/src/lib.rs:20-59)."""

    data: bytes

    SIZE = 32

    def __post_init__(self) -> None:
        if len(self.data) != self.SIZE:
            raise ValueError(f"Digest must be {self.SIZE} bytes, got {len(self.data)}")


@dataclass(frozen=True, slots=True)
class PublicKey:
    """ed25519 public key, 32 bytes."""

    data: bytes

    SIZE = 32

    def __post_init__(self) -> None:
        if len(self.data) != self.SIZE:
            raise ValueError(f"PublicKey must be {self.SIZE} bytes")


@dataclass(frozen=True, slots=True)
class Signature:
    """ed25519 signature (R || S), 64 bytes."""

    data: bytes

    SIZE = 64

    def __post_init__(self) -> None:
        if len(self.data) != self.SIZE:
            raise ValueError(f"Signature must be {self.SIZE} bytes")
