"""ed25519 (RFC 8032) in exact host integers.

The port's copy of `hotstuff_tpu/crypto/pysigner.py`: `keypair_from_seed`,
`sign` and strict `verify`, the scheme seam the chaos plane switches
(`install_scheme`, `active_scheme`; `keypair_exact`, `sign_exact` and
`verify_exact` always take the RFC 8032 arithmetic), `PurePythonBackend`
and `PySignatureService` (the chaos runner's backend and signer), plus
`verify_device_semantics`, the port's host verifier (`HostBackend`, which
`TorchBackend` runs below its crossover). It signs the test and smoke
corpora and needs no `cryptography` wheel; its key decoder is the one
`CommitteeTable` uses (`ops/ed25519.py:decompress_int`).

Strict `verify`: s >= L, undecompressable or non-canonical A and R, and
x = 0 with the sign bit set all reject. `verify_device_semantics` gives the
card's verdicts (ops/ed25519.py:decompress and the cofactorless equation):
a key's y is reduced mod p and x = 0 takes either sign, so keys that decode
to the identity accept R = enc([s]B) for any message, as OpenSSL (the
reference's `CpuBackend`) does; R must still equal the canonical encoding
byte for byte. `verify_device_semantics` ignores the installed scheme.
"""

from __future__ import annotations

import asyncio
import hashlib

from typing import Sequence

from ..ops.ed25519 import decompress_int
from ..utils import metrics
from ..utils.actors import spawn
from .backend import CryptoBackend
from .primitives import Digest, PublicKey, Signature

_M_REJECTS = metrics.counter("verifier.rejected_sigs")

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P

_BY = 4 * pow(5, P - 2, P) % P


def _sqrt_mod_p(x2: int) -> int | None:
    """Square root mod P (P = 5 mod 8), or None when x2 is a non-residue."""
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * pow(2, (P - 1) // 4, P) % P
    if (x * x - x2) % P != 0:
        return None
    return x


def _recover_x(y: int, sign_bit: int) -> int | None:
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    x = _sqrt_mod_p(x2)
    if x is None:
        return None
    if x == 0 and sign_bit:
        return None  # -0 is not canonical
    if x & 1 != sign_bit:
        x = P - x
    return x


# Extended homogeneous coordinates (X:Y:Z:T) with x=X/Z, y=Y/Z, xy=T/Z.
_IDENT = (0, 1, 1, 0)


def _pt_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _pt_mul(k: int, pt):
    acc = _IDENT
    while k:
        if k & 1:
            acc = _pt_add(acc, pt)
        pt = _pt_add(pt, pt)
        k >>= 1
    return acc


def _pt_double_mul(a: int, p, b: int, q):
    """[a]p + [b]q with one shared chain of doublings (Straus): the host
    verifier's hot path. Strict `verify`, which checks the signer and the
    corpora, keeps its two `_pt_mul` chains as the reference has them."""
    pq = _pt_add(p, q)
    acc = _IDENT
    for i in range(max(a.bit_length(), b.bit_length()) - 1, -1, -1):
        acc = _pt_add(acc, acc)
        bits = (a >> i & 1, b >> i & 1)
        if bits != (0, 0):
            acc = _pt_add(acc, pq if bits == (1, 1) else p if bits[0] else q)
    return acc


def _pt_compress(pt) -> bytes:
    x, y, z, _ = pt
    zinv = pow(z, P - 2, P)
    x, y = x * zinv % P, y * zinv % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _pt_decompress(data: bytes):
    """Compressed 32 bytes -> extended point, or None (off-curve / non-
    canonical y)."""
    if len(data) != 32:
        return None
    enc = int.from_bytes(data, "little")
    y = enc & ((1 << 255) - 1)
    x = _recover_x(y, enc >> 255)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


_BX = _recover_x(_BY, 0)
_B_POINT = (_BX, _BY, 1, _BX * _BY % P)


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


# ---------------------------------------------------------------------------
# Scheme seam. The chaos plane's trusted-crypto mode (chaos/trusted_crypto.py)
# swaps signatures for keyed-hash stubs at hundred-node committee sizes.
# Everything that signs or verifies through this module (PySignatureService,
# PurePythonBackend, the byzantine policies, EpochChange.new_from_seed, the
# SafetyChecker audit) follows one installed scheme, so a run is never
# half-stubbed. The `*_exact` names always take the RFC 8032 arithmetic.

_SCHEME = None  # None = exact RFC 8032 (the default)


def install_scheme(scheme):
    """Install a signature scheme (None for exact RFC 8032); returns the
    previously installed one so callers can restore it. A scheme supplies
    keypair_from_seed/sign/verify with this module's shapes (32-byte seeds
    and keys, 64-byte signatures)."""
    global _SCHEME
    prev = _SCHEME
    _SCHEME = scheme
    return prev


def active_scheme():
    return _SCHEME


def keypair_from_seed(seed: bytes) -> tuple[bytes, bytes]:
    """32-byte seed -> (public key, seed) under the active scheme. The
    seed IS the secret; signing re-derives what the scheme needs."""
    if _SCHEME is not None:
        return _SCHEME.keypair_from_seed(seed)
    return keypair_exact(seed)


def sign(seed: bytes, message: bytes, public_key: bytes | None = None) -> bytes:
    """64-byte signature over `message` under the active scheme (exact RFC
    8032 unless a chaos scheme is installed). Passing the seed's exact
    `public_key` saves re-deriving it (one scalar multiplication)."""
    if _SCHEME is not None:
        return _SCHEME.sign(seed, message)
    return sign_exact(seed, message, public_key)


def verify(public_key: bytes, message: bytes, signature: bytes) -> bool:
    """Verify under the active scheme: strict RFC 8032 by default; a stub
    scheme recomputes its keyed hash and compares byte for byte."""
    if _SCHEME is not None:
        return _SCHEME.verify(public_key, message, signature)
    return verify_exact(public_key, message, signature)


def keypair_exact(seed: bytes) -> tuple[bytes, bytes]:
    """32-byte seed -> (compressed public key, seed). The seed IS the
    secret (RFC 8032 private key); signing re-derives the scalar."""
    if len(seed) != 32:
        raise ValueError("ed25519 seed must be 32 bytes")
    h = hashlib.sha512(seed).digest()
    return _pt_compress(_pt_mul(_clamp(h), _B_POINT)), seed


def sign_exact(seed: bytes, message: bytes, public_key: bytes | None = None) -> bytes:
    """RFC 8032 Ed25519 signature (64 bytes) over `message`."""
    if len(seed) != 32:
        raise ValueError("ed25519 seed must be 32 bytes")
    h = hashlib.sha512(seed).digest()
    a, prefix = _clamp(h), h[32:]
    pk = public_key or _pt_compress(_pt_mul(a, _B_POINT))
    r = int.from_bytes(hashlib.sha512(prefix + message).digest(), "little") % L
    r_enc = _pt_compress(_pt_mul(r, _B_POINT))
    k = int.from_bytes(hashlib.sha512(r_enc + pk + message).digest(), "little") % L
    s = (r + k * a) % L
    return r_enc + s.to_bytes(32, "little")


# Decompressed-key memo: committee keys recur on every certificate check,
# and decompression dominates small verifies. Bounded so key floods cannot
# grow it.
_KEY_CACHE: dict[bytes, tuple] = {}
_KEY_CACHE_MAX = 4096


def verify_exact(public_key: bytes, message: bytes, signature: bytes) -> bool:
    """STRICT verification: canonical s < L, on-curve canonical A and R,
    full sB == R + hA."""
    if len(signature) != 64 or len(public_key) != 32:
        return False
    a_pt = _KEY_CACHE.get(public_key)
    if a_pt is None:
        a_pt = _pt_decompress(public_key)
        if a_pt is None:
            return False
        if len(_KEY_CACHE) >= _KEY_CACHE_MAX:
            _KEY_CACHE.clear()
        _KEY_CACHE[public_key] = a_pt
    r_enc = signature[:32]
    r_pt = _pt_decompress(r_enc)
    if r_pt is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    h = int.from_bytes(hashlib.sha512(r_enc + public_key + message).digest(), "little") % L
    lhs = _pt_compress(_pt_mul(s, _B_POINT))
    rhs = _pt_compress(_pt_add(r_pt, _pt_mul(h, a_pt)))
    return lhs == rhs


def verify_device_semantics(public_key: bytes, message: bytes, signature: bytes) -> bool:
    """The card's verdict in exact integers: s < L, A decoded as
    `ops.ed25519.decompress_int`, h = SHA-512(R||A||M) mod L, and
    enc([s]B - [h]A) == R byte for byte (so a non-canonical R, or R with
    x = 0 and the sign bit, rejects)."""
    if len(signature) != 64 or len(public_key) != 32:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    a = decompress_int(public_key)
    if a is None:
        return False
    r_enc = signature[:32]
    h = int.from_bytes(hashlib.sha512(r_enc + public_key + message).digest(), "little") % L
    x, y = P - a[0], a[1]
    neg_a = (x, y, 1, x * y % P)
    return _pt_compress(_pt_double_mul(s, _B_POINT, h, neg_a)) == r_enc


class PurePythonBackend(CryptoBackend):
    """`CryptoBackend` over this module's `verify` (exact integers by
    default, the active scheme under a chaos trusted-crypto run). The chaos
    runner installs it, so its scenarios run the real verification flow
    (`BatchVerificationService` -> backend) on the host."""

    name = "pure-python"

    def verify_batch_mask(
        self,
        messages: Sequence[bytes],
        keys: Sequence[PublicKey],
        signatures: Sequence[Signature],
    ) -> list[bool]:
        out = []
        for msg, pk, sig in zip(messages, keys, signatures, strict=True):
            ok = verify(pk.data, msg, sig.data)
            if not ok:
                _M_REJECTS.inc()
            out.append(ok)
        return out


class PySignatureService:
    """Drop-in for `crypto.service.SignatureService` that signs with this
    module: the same actor shape (queue + futures), no OpenSSL."""

    def __init__(self, seed: bytes) -> None:
        self._queue: asyncio.Queue = asyncio.Queue(100)
        self._task = spawn(self._run(seed), name="py-signature-service")

    async def _run(self, seed: bytes) -> None:
        while True:
            digest, fut = await self._queue.get()
            if not fut.cancelled():
                fut.set_result(Signature(sign(seed, digest.data)))

    async def request_signature(self, digest: Digest) -> Signature:
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put((digest, fut))
        return await fut
