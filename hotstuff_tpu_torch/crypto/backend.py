"""The `CryptoBackend` seam: pluggable batch signature verification.

A copy of `hotstuff_tpu/crypto/backend.py:19-83` for the port. The
reference hard-wires ed25519_dalek's `verify_batch`
(crypto/src/lib.rs:194-220); here every batch verification dispatches
through an interchangeable backend — the host (`HostBackend`, exact
Python integers with the card's verdicts; `CpuBackend`, OpenSSL through
the `cryptography` package, the reference's host path), the card
(`torch_backend.TorchBackend`) or a sidecar (`remote.RemoteBackend`),
made by `make_backend`.
"""

from __future__ import annotations

import abc
import threading
from typing import Sequence

from .primitives import PublicKey, Signature


class CryptoBackend(abc.ABC):
    """Batch signature verification engine.

    Contract (matching ed25519_dalek `verify_batch`): returns True iff ALL
    (message, key, signature) triples verify. `verify_batch_mask`
    additionally reports per-item validity."""

    name: str = "abstract"

    @abc.abstractmethod
    def verify_batch_mask(
        self,
        messages: Sequence[bytes],
        keys: Sequence[PublicKey],
        signatures: Sequence[Signature],
    ) -> list[bool]: ...

    def verify_batch(
        self,
        messages: Sequence[bytes],
        keys: Sequence[PublicKey],
        signatures: Sequence[Signature],
    ) -> bool:
        if not messages:
            return True
        return all(self.verify_batch_mask(messages, keys, signatures))


# After CryptoBackend: pysigner's PurePythonBackend derives from it.
from . import pysigner  # noqa: E402


class HostBackend(CryptoBackend):
    """Host verification, one signature at a time, in exact integers with
    the card's semantics (`pysigner.verify_device_semantics`): the same
    verdict for every triple as the kernels and as the reference's
    OpenSSL `CpuBackend`, so the crossover decides where a batch runs,
    never what it returns."""

    name = "host"

    def verify_batch_mask(
        self,
        messages: Sequence[bytes],
        keys: Sequence[PublicKey],
        signatures: Sequence[Signature],
    ) -> list[bool]:
        return [
            pysigner.verify_device_semantics(pk.data, msg, sig.data)
            for msg, pk, sig in zip(messages, keys, signatures, strict=True)
        ]


class CpuBackend(CryptoBackend):
    """Host verification through OpenSSL (the `cryptography` package), the
    reference's `CpuBackend` (`hotstuff_tpu/crypto/backend.py:48-67`): the
    same verdict for every triple as `HostBackend`, and far faster. The
    package is imported here only, so the port imports without it; making
    one where it is missing raises ImportError."""

    name = "cpu"

    def __init__(self) -> None:
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey

        self._invalid = (InvalidSignature, ValueError)
        self._from_public_bytes = Ed25519PublicKey.from_public_bytes

    def verify_batch_mask(
        self,
        messages: Sequence[bytes],
        keys: Sequence[PublicKey],
        signatures: Sequence[Signature],
    ) -> list[bool]:
        out = []
        for msg, pk, sig in zip(messages, keys, signatures, strict=True):
            try:
                self._from_public_bytes(pk.data).verify(sig.data, msg)
                out.append(True)
            except self._invalid:
                out.append(False)
        return out


HOST_ROUTES = ("openssl", "exact")


def host_backend(host: str | None) -> CryptoBackend:
    """The host verifier of a backend that routes batches off the card
    (`TorchBackend` below its crossover, `RemoteBackend` below its crossover
    and through sidecar outages): `"openssl"` is `CpuBackend` (raises
    ImportError where `cryptography` is missing), `"exact"` is
    `HostBackend`, and None takes OpenSSL where it imports, else exact."""
    if host is None:
        try:
            return CpuBackend()
        except ImportError:
            return HostBackend()
    if host == "openssl":
        return CpuBackend()
    if host == "exact":
        return HostBackend()
    raise ValueError(f"host must be one of {HOST_ROUTES} or None, got {host!r}")


def host_route(backend: CryptoBackend) -> str:
    """The name in HOST_ROUTES of a verifier made by `host_backend`."""
    return "openssl" if isinstance(backend, CpuBackend) else "exact"


_lock = threading.Lock()
_backend: CryptoBackend = HostBackend()


def get_backend() -> CryptoBackend:
    return _backend


def set_backend(backend: CryptoBackend) -> CryptoBackend:
    """Install the active backend (e.g. TorchBackend); returns the previous one."""
    global _backend
    with _lock:
        prev, _backend = _backend, backend
    return prev


def make_backend(kind: str, **kwargs) -> CryptoBackend:
    """The backend of `kind` (`host` | `cpu` | `torch` | `remote`), made with
    `kwargs`, as the reference's factory (`hotstuff_tpu/crypto/backend.py:
    86-98`); e.g. `make_backend("torch", sharded=True)` splits batches over
    every visible GPU."""
    if kind == "host":
        return HostBackend(**kwargs)
    if kind == "cpu":
        return CpuBackend(**kwargs)
    if kind == "torch":
        from .torch_backend import TorchBackend

        return TorchBackend(**kwargs)
    if kind == "remote":
        from .remote import RemoteBackend

        return RemoteBackend(**kwargs)
    raise ValueError(f"unknown crypto backend {kind!r}")
