"""Crypto seam of the port: value types, the host signer/verifier, the
signing actor and the `CryptoBackend` that verifies on the card
(`torch_backend.TorchBackend`); the exact BLS12-381 code of aggregate
certificates (`aggsig`). The exports are the reference's
(`hotstuff_tpu/crypto/__init__.py`); the backend's are resolved at first
use, since `backend` imports the kernels' modules, which import this
package's `native_staging`."""

from .primitives import (
    Digest,
    KeyPair,
    PublicKey,
    SecretKey,
    Signature,
    generate_keypair,
    generate_production_keypair,
    sha512_32,
)
from .service import SignatureService

_BACKEND_EXPORTS = ("CryptoBackend", "CpuBackend", "get_backend", "set_backend")


def __getattr__(name: str):
    if name in _BACKEND_EXPORTS:
        from . import backend

        return getattr(backend, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Digest",
    "KeyPair",
    "PublicKey",
    "SecretKey",
    "Signature",
    "generate_keypair",
    "generate_production_keypair",
    "sha512_32",
    "CryptoBackend",
    "CpuBackend",
    "get_backend",
    "set_backend",
    "SignatureService",
]
