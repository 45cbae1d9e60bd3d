"""Trusted-crypto chaos mode: seeded keyed-hash signature stubs.

The chaos plane's scenarios are bounded by PYTHON work per virtual
second, and at hundred-node committees that work is dominated by
signatures: exact-int pysigner costs ~20 ms per operation on this class
of box, and one 64-node round re-verifies a ~43-vote QC on every node —
near a minute of wall time per committed round. That makes the fleet
sizes ROADMAP items 2-4 claim wins at (64-128 nodes) unmeasurable.

This module swaps the signature SCHEME, not the protocol: installed via
`pysigner.install_scheme`, every path that signs or verifies through the
pysigner seam — PySignatureService, PurePythonBackend (and therefore
BatchVerificationService and every consensus certificate check),
byzantine policies, EpochChange construction, and the SafetyChecker's
committed-QC audit — runs the same keyed-hash stub:

    pk         = sha512(DOMAIN || "pk:" || seed)[:32]
    sig(msg)   = sha512(DOMAIN || "sig:" || pk || msg)   (64 bytes)
    verify     = byte-exact recomputation of sig(msg)

Properties that matter:

  * **Cost**: one sha512 per sign/verify — a 100-node round costs
    milliseconds of wall time instead of minutes, so scenario-matrix
    cells at committee sizes {64, 100+} are routine.
  * **Exact audit**: verification is an exact recomputation, never a
    tolerance check. A corrupted signature, wrong author, or tampered
    message ALWAYS rejects — so the SafetyChecker's committed-QC audit
    (chaos/invariants.py) keeps its zero-false-accept contract under the
    stub: flip one byte anywhere in a committed QC and the audit flags
    it, exactly as the exact-int RFC 8032 audit does in the default
    mode.
  * **Determinism**: the stub is a pure function of (seed, message), so
    same-seed runs stay bit-identical — fault trace, commits, telemetry
    rings and all.

TRUST MODEL — read before using in a new scenario: the stub is NOT a
signature scheme. Anyone who knows a public key can compute a "valid"
stub signature for any message; the mode is called *trusted* because it
assumes no adversary in the run forges structurally-valid stubs. It
models crash/timing/partition/topology faults at scale. The shipped
adversaries remain meaningful — SigForger floods garbage bytes and
StaleReplayer replays genuinely-signed material, both of which behave
identically under the stub — but a scenario whose THREAT is signature
forgery (can an adversary fabricate a quorum?) must run the exact
scheme. `run_scenario(..., trusted_crypto=True)` is therefore opt-in
per cell, never a global default.
"""

from __future__ import annotations

import hashlib

from ..utils import metrics

__all__ = ["TrustedCryptoScheme", "TrustedAggScheme", "stub_signature"]

DOMAIN = b"hotstuff-trusted-crypto-v1:"
AGG_DOMAIN = b"hotstuff-trusted-agg-v1:"

_M_SIGNS = metrics.counter("chaos.stub_signs")
_M_VERIFIES = metrics.counter("chaos.stub_verifies")
_M_REJECTS = metrics.counter("chaos.stub_rejects")
_M_AGG_SIGNS = metrics.counter("chaos.stub_agg_signs")
_M_AGG_VERIFIES = metrics.counter("chaos.stub_agg_verifies")
_M_AGG_REJECTS = metrics.counter("chaos.stub_agg_rejects")


def stub_signature(public_key: bytes, message: bytes) -> bytes:
    """The 64-byte keyed-hash stub for (pk, msg) — the single definition
    both sign and verify recompute."""
    return hashlib.sha512(DOMAIN + b"sig:" + public_key + message).digest()


class TrustedCryptoScheme:
    """pysigner-shaped scheme object (`install_scheme` target): 32-byte
    seeds and public keys, 64-byte signatures. One instance per chaos
    run (the orchestrator installs it for the run's duration and
    restores the previous scheme on teardown)."""

    name = "trusted-stub"

    def __init__(self) -> None:
        # seed -> pk memo: sign() derives the public key per call, and a
        # node signs with one seed thousands of times per scenario.
        self._pk_of_seed: dict[bytes, bytes] = {}

    def keypair_from_seed(self, seed: bytes) -> tuple[bytes, bytes]:
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        pk = self._pk_of_seed.get(seed)
        if pk is None:
            pk = hashlib.sha512(DOMAIN + b"pk:" + seed).digest()[:32]
            self._pk_of_seed[seed] = pk
        return pk, seed

    def sign(self, seed: bytes, message: bytes) -> bytes:
        pk, _ = self.keypair_from_seed(seed)
        _M_SIGNS.inc()
        return stub_signature(pk, message)

    def verify(self, public_key: bytes, message: bytes, signature: bytes) -> bool:
        """Byte-exact recomputation — the property the SafetyChecker's
        committed-QC audit relies on: any corruption rejects."""
        _M_VERIFIES.inc()
        ok = signature == stub_signature(public_key, message)
        if not ok:
            _M_REJECTS.inc()
        return ok


def _agg_member_sig(public_key: bytes, message: bytes) -> bytes:
    return hashlib.sha512(AGG_DOMAIN + b"sig:" + public_key + message).digest()


class TrustedAggScheme:
    """Aggregate-signature analogue of TrustedCryptoScheme, installed
    through the `crypto.aggsig.install_agg_scheme` seam (the pysigner.install_scheme pattern)
    so 100+-node virtual-time fleets pay one sha512 per member instead
    of a ~0.4 s pairing per certificate.

    The aggregate of member stubs is their XOR — like curve point
    addition it is associative, commutative, and order-independent, so
    Handel-style out-of-order in-overlay merging produces byte-identical
    aggregates on every path (the bit-identity pin relies on this).
    Verification XORs the recomputed member stubs for exactly the bitmap
    members and compares byte-exact, preserving the zero-false-accept
    audit contract: flip any signature/bitmap/message byte and the
    certificate rejects. Same trust model as the base stub (see module
    docstring): verification cost is honest, unforgeability is not —
    scenarios whose threat is quorum fabrication must run the exact
    BLS scheme."""

    name = "trusted-agg"
    pk_bytes = 32
    sig_bytes = 64

    def __init__(self) -> None:
        self._pk_of_seed: dict[bytes, bytes] = {}

    def keypair_from_seed(self, seed: bytes) -> tuple[bytes, bytes]:
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        pk = self._pk_of_seed.get(seed)
        if pk is None:
            pk = hashlib.sha512(AGG_DOMAIN + b"pk:" + seed).digest()[:32]
            self._pk_of_seed[seed] = pk
        return pk, seed

    def sign(self, seed: bytes, message: bytes) -> bytes:
        pk, _ = self.keypair_from_seed(seed)
        _M_AGG_SIGNS.inc()
        return _agg_member_sig(pk, message)

    def combine(self, a: bytes, b: bytes) -> bytes:
        if len(a) != 64 or len(b) != 64:
            raise ValueError("trusted-agg signatures are 64 bytes")
        return bytes(x ^ y for x, y in zip(a, b))

    def aggregate(self, sigs) -> bytes:
        acc = bytes(64)
        for s in sigs:
            acc = self.combine(acc, s)
        return acc

    def verify(self, pks, message: bytes, signature: bytes) -> bool:
        return self.verify_groups([(list(pks), message)], signature)

    def verify_groups(self, groups, signature: bytes) -> bool:
        _M_AGG_VERIFIES.inc()
        expect = bytes(64)
        for pks, message in groups:
            if not pks:
                _M_AGG_REJECTS.inc()
                return False
            for pk in pks:
                expect = self.combine(expect, _agg_member_sig(pk, message))
        ok = signature == expect
        if not ok:
            _M_AGG_REJECTS.inc()
        return ok
