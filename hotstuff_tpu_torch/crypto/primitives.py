"""Byte wrappers for ed25519 public keys and signatures.

A trimmed copy of `hotstuff_tpu/crypto/primitives.py` (reference crypto
crate, crypto/src/lib.rs:62-224): only the value types the backend seam
passes around. Signing and single verification live in `pysigner`."""

from __future__ import annotations

from dataclasses import dataclass


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
