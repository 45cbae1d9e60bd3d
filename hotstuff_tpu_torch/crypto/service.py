"""SignatureService: the signing actor.

A copy of `hotstuff_tpu/crypto/service.py` (the reference's
SignatureService, crypto/src/lib.rs:226-252): an actor owns the secret key
and serves signing requests over a channel with one-shot replies. It signs
with OpenSSL where `cryptography` imports, else with the exact `pysigner`
(`SecretKey.signer`); both give the same signature.
"""

from __future__ import annotations

import asyncio

from ..utils.actors import spawn
from .primitives import Digest, SecretKey, Signature


class SignatureService:
    """Clone-able signing handle backed by a single signer task."""

    def __init__(self, secret: SecretKey) -> None:
        self._queue: asyncio.Queue = asyncio.Queue(100)
        self._task = spawn(self._run(secret), name="signature-service")

    async def _run(self, secret: SecretKey) -> None:
        sign = secret.signer()
        while True:
            digest, fut = await self._queue.get()
            if not fut.cancelled():
                fut.set_result(Signature(sign(digest.data)))

    async def request_signature(self, digest: Digest) -> Signature:
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put((digest, fut))
        return await fut
