"""Client ingress wire messages: per-client signed transactions and the
responses the ingress returns for them.

A copy of `hotstuff_tpu/ingress/messages.py` for the port, byte for byte
the reference's encoding. Every transaction is ed25519-signed by its
submitting client over a domain-separated digest of (client, nonce, fee,
body), and every submission gets an explicit response: ACCEPTED after the
signature verified and the body was handed on, or a typed rejection (SHED
carries a retry-after hint). The fee is part of the signed content: it
selects the admission lane (`admission.py`).

`ClientTransaction.new_signed` signs with the port's exact RFC 8032
`pysigner.sign` unless given another `sign` (the load generator passes
OpenSSL's where it imports, `loadgen.make_signer`); RFC 8032 signatures
are deterministic, so the bytes are the same either way.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..crypto import pysigner
from ..crypto.primitives import Digest, PublicKey, Signature
from ..utils.serde import Reader, SerdeError, Writer

TX_DOMAIN = b"HSINGRESSTX"

# Response statuses (IngressResponse.status).
ACCEPTED = 0  # signature verified, body forwarded to the mempool
SHED = 1  # admission lane full: back off for retry_after_ms
BAD_SIGNATURE = 2  # signature failed verification
REPLAY = 3  # (client, nonce) already seen inside the replay window
MALFORMED = 4  # undecodable frame / oversized body / unknown shape

STATUS_NAMES = {
    ACCEPTED: "accepted",
    SHED: "shed",
    BAD_SIGNATURE: "bad_signature",
    REPLAY: "replay",
    MALFORMED: "malformed",
}

TAG_TX = 0
TAG_RESPONSE = 1


@dataclass(frozen=True, slots=True)
class ClientTransaction:
    """One signed client submission. `nonce` is client-chosen and must be
    unique per client (the admission replay filter rejects repeats);
    `fee` selects the admission lane; `body` is the opaque transaction
    payload that — once the signature verifies — flows into the
    PayloadMaker exactly like a Front-submitted transaction (so the
    sample-tx latency convention of node/client.py keeps working)."""

    client: PublicKey
    nonce: int
    fee: int
    body: bytes
    signature: Signature
    _digest: Digest | None = field(
        default=None, init=False, repr=False, compare=False
    )

    @staticmethod
    def make_digest(client: PublicKey, nonce: int, fee: int, body: bytes) -> Digest:
        h = hashlib.sha512()
        h.update(TX_DOMAIN)
        h.update(client.data)
        h.update(nonce.to_bytes(8, "little"))
        h.update(fee.to_bytes(8, "little"))
        h.update(len(body).to_bytes(4, "little"))  # keeps the encoding injective
        h.update(body)
        return Digest(h.digest()[:32])

    @staticmethod
    def new_signed(
        seed: bytes, nonce: int, fee: int, body: bytes,
        public_key: bytes | None = None, sign=pysigner.sign,
    ) -> "ClientTransaction":
        """Sign with `sign(seed, message, public_key)`, the exact RFC 8032
        signer (crypto/pysigner) by default. Passing the seed's
        `public_key` saves re-deriving it."""
        pk = public_key or pysigner.keypair_from_seed(seed)[0]
        client = PublicKey(pk)
        digest = ClientTransaction.make_digest(client, nonce, fee, body)
        sig = Signature(sign(seed, digest.data, pk))
        tx = ClientTransaction(client, nonce, fee, body, sig)
        object.__setattr__(tx, "_digest", digest)  # seed the cache
        return tx

    def digest(self) -> Digest:
        if self._digest is None:
            object.__setattr__(
                self,
                "_digest",
                ClientTransaction.make_digest(
                    self.client, self.nonce, self.fee, self.body
                ),
            )
        return self._digest

    def encode(self, w: Writer) -> None:
        w.fixed(self.client.data, 32)
        w.u64(self.nonce)
        w.u64(self.fee)
        w.var_bytes(self.body)
        w.fixed(self.signature.data, 64)

    @staticmethod
    def decode(r: Reader) -> "ClientTransaction":
        client = PublicKey(r.fixed(32))
        nonce = r.u64()
        fee = r.u64()
        body = r.var_bytes()
        sig = Signature(r.fixed(64))
        return ClientTransaction(client, nonce, fee, body, sig)


@dataclass(frozen=True, slots=True)
class IngressResponse:
    """Per-transaction outcome, correlated by the echoed nonce (nonces
    are client-unique, so responses may arrive out of order). A SHED
    response carries `retry_after_ms` — the node's estimate of when the
    rejected lane will have drained enough to admit again; clients that
    ignore it just burn their own round trips on further sheds."""

    nonce: int
    status: int
    retry_after_ms: int = 0

    @property
    def status_name(self) -> str:
        return STATUS_NAMES.get(self.status, f"status-{self.status}")

    def encode(self, w: Writer) -> None:
        w.u64(self.nonce)
        w.u8(self.status)
        w.u32(self.retry_after_ms)

    @staticmethod
    def decode(r: Reader) -> "IngressResponse":
        return IngressResponse(r.u64(), r.u8(), r.u32())


def encode_ingress_message(msg) -> bytes:
    w = Writer()
    if isinstance(msg, ClientTransaction):
        w.u8(TAG_TX)
    elif isinstance(msg, IngressResponse):
        w.u8(TAG_RESPONSE)
    else:
        raise TypeError(f"not an ingress message: {msg!r}")
    msg.encode(w)
    return w.bytes()


def decode_ingress_message(data: bytes):
    r = Reader(data)
    tag = r.u8()
    if tag == TAG_TX:
        out = ClientTransaction.decode(r)
    elif tag == TAG_RESPONSE:
        out = IngressResponse.decode(r)
    else:
        raise SerdeError(f"unknown ingress tag {tag}")
    r.expect_done()
    return out
