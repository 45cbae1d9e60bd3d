"""Core crypto value types: digests, ed25519 keys and signatures.

A copy of `hotstuff_tpu/crypto/primitives.py` (reference crypto crate,
crypto/src/lib.rs:20-224) for the port:
  * Digest        -- 32-byte content hash with base64 display   (lib.rs:20-59)
  * PublicKey     -- 32-byte ed25519 public key, base64 serde   (lib.rs:62-108)
  * SecretKey     -- ed25519 secret key (32-byte seed)          (lib.rs:110-164)
  * Signature     -- 64-byte ed25519 signature over a Digest    (lib.rs:166-224)
  * generate_keypair(seeded rng) / generate_production_keypair  (lib.rs:156-164)

Host signing and single verification take OpenSSL (the `cryptography`
package) where it imports, else the port's exact-integer `pysigner`; both
give the same signatures (ed25519 is deterministic) and the same verdicts
(`backend.host_backend`). The batch paths (`Signature.verify_batch` /
`verify_batch_alt`, lib.rs:194-220) dispatch through the active
`CryptoBackend` (`backend.get_backend`), which a node sets to `TorchBackend`.
"""

from __future__ import annotations

import base64
import hashlib
import os
from dataclasses import dataclass
from typing import Iterable, Sequence


def sha512_32(data: bytes) -> bytes:
    """SHA-512 truncated to 32 bytes, the reference's digest function."""
    return hashlib.sha512(data).digest()[:32]


def _b64(data: bytes) -> str:
    return base64.standard_b64encode(data).decode("ascii")


@dataclass(frozen=True, slots=True)
class Digest:
    """32-byte content hash (reference crypto/src/lib.rs:20-59)."""

    data: bytes

    SIZE = 32

    def __post_init__(self) -> None:
        if len(self.data) != self.SIZE:
            raise ValueError(f"Digest must be {self.SIZE} bytes, got {len(self.data)}")

    @staticmethod
    def of(data: bytes) -> "Digest":
        return Digest(sha512_32(data))

    @staticmethod
    def zero() -> "Digest":
        return Digest(bytes(Digest.SIZE))

    def __str__(self) -> str:  # base64 like the reference Display impl
        return _b64(self.data)

    def short(self) -> str:
        """First 8 chars of base64, for log lines."""
        return _b64(self.data)[:8]

    def __repr__(self) -> str:
        return f"Digest({_b64(self.data)})"


@dataclass(frozen=True, slots=True)
class PublicKey:
    """ed25519 public key, 32 bytes (reference crypto/src/lib.rs:62-108)."""

    data: bytes

    SIZE = 32

    def __post_init__(self) -> None:
        if len(self.data) != self.SIZE:
            raise ValueError(f"PublicKey must be {self.SIZE} bytes")

    def encode_base64(self) -> str:
        return _b64(self.data)

    @staticmethod
    def decode_base64(s: str) -> "PublicKey":
        return PublicKey(base64.standard_b64decode(s))

    def __str__(self) -> str:
        return self.encode_base64()

    def short(self) -> str:
        return self.encode_base64()[:8]

    def __lt__(self, other: "PublicKey") -> bool:
        return self.data < other.data


class SecretKey:
    """ed25519 secret key (32-byte seed). Best-effort zeroized on drop, as
    the reference's Drop impl (crypto/src/lib.rs:146-153)."""

    SIZE = 32

    def __init__(self, seed: bytes) -> None:
        if len(seed) != self.SIZE:
            raise ValueError(f"SecretKey must be {self.SIZE} bytes")
        self._seed = bytearray(seed)

    @property
    def data(self) -> bytes:
        return bytes(self._seed)

    def encode_base64(self) -> str:
        return _b64(bytes(self._seed))

    @staticmethod
    def decode_base64(s: str) -> "SecretKey":
        return SecretKey(base64.standard_b64decode(s))

    def signer(self):
        """A callable signing message bytes with this key: OpenSSL where
        `cryptography` imports, else the exact `pysigner.sign`."""
        seed = bytes(self._seed)
        try:
            from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey
        except ImportError:
            from . import pysigner

            public = pysigner.keypair_from_seed(seed)[0]
            return lambda message: pysigner.sign(seed, message, public)
        return Ed25519PrivateKey.from_private_bytes(seed).sign

    def public_key(self) -> "PublicKey":
        seed = bytes(self._seed)
        try:
            from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey
        except ImportError:
            from . import pysigner

            return PublicKey(pysigner.keypair_from_seed(seed)[0])
        return PublicKey(Ed25519PrivateKey.from_private_bytes(seed).public_key().public_bytes_raw())

    def __del__(self) -> None:
        for i in range(len(self._seed)):
            self._seed[i] = 0


KeyPair = tuple[PublicKey, SecretKey]


def generate_keypair(rng) -> KeyPair:
    """Deterministic keypair from a seeded `random.Random` (or any object
    with `.randbytes`), as generate_keypair(csprng) (crypto/src/lib.rs:
    156-158): the same rng state gives the reference's keypair."""
    sk = SecretKey(rng.randbytes(32))
    return sk.public_key(), sk


def generate_production_keypair() -> KeyPair:
    """OS-entropy keypair (crypto/src/lib.rs:161-164)."""
    # graftlint: allow[determinism] production entropy by contract; seeded paths use generate_keypair(rng)
    sk = SecretKey(os.urandom(32))
    return sk.public_key(), sk


@dataclass(frozen=True, slots=True)
class Signature:
    """ed25519 signature (R || S), 64 bytes, over a Digest's 32 bytes
    (crypto/src/lib.rs:166-224)."""

    data: bytes

    SIZE = 64

    def __post_init__(self) -> None:
        if len(self.data) != self.SIZE:
            raise ValueError(f"Signature must be {self.SIZE} bytes")

    @staticmethod
    def new(digest: Digest, secret: SecretKey) -> "Signature":
        return Signature(secret.signer()(digest.data))

    def flatten(self) -> bytes:
        return self.data

    def verify(self, digest: Digest, public_key: PublicKey) -> bool:
        """Single verification on the host (crypto/src/lib.rs:186-192):
        OpenSSL where it imports, else the exact verifier with the same
        verdicts (`backend.host_backend`)."""
        return _host_verifier().verify_batch_mask([digest.data], [public_key], [self])[0]

    @staticmethod
    def verify_batch(digest: Digest, votes: Iterable[tuple[PublicKey, "Signature"]]) -> bool:
        """Many signatures over ONE message, the QC::verify path
        (crypto/src/lib.rs:194-207), through the active CryptoBackend."""
        from .backend import get_backend

        votes = list(votes)
        return get_backend().verify_batch(
            [digest.data] * len(votes), [pk for pk, _ in votes], [sig for _, sig in votes]
        )

    @staticmethod
    def verify_batch_alt(
        messages: Sequence[bytes], keys_sigs: Sequence[tuple[PublicKey, "Signature"]]
    ) -> bool:
        """Many signatures over DISTINCT messages, the fork's mempool
        workload (crypto/src/lib.rs:209-220), through the active
        CryptoBackend."""
        from .backend import get_backend

        if len(messages) != len(keys_sigs):
            raise ValueError("messages and signatures length mismatch")
        return get_backend().verify_batch(
            list(messages), [pk for pk, _ in keys_sigs], [sig for _, sig in keys_sigs]
        )


_HOST = None


def _host_verifier():
    global _HOST
    if _HOST is None:
        from .backend import host_backend

        _HOST = host_backend(None)
    return _HOST
