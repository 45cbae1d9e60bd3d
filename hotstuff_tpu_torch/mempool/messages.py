"""Mempool wire messages (reference mempool/src/messages.rs:10-55).

Payload{transactions, author, signature}: a signed batch of raw client
transactions. Consensus orders only the payload's 32-byte digest; these bytes
travel on the mempool plane -- the dissemination/ordering split that keeps
blocks small (SURVEY.md section 1).

The port's copy of `hotstuff_tpu/mempool/messages.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field

from ..crypto import Digest, PublicKey, SecretKey, Signature
from ..utils.serde import Reader, SerdeError, Writer

Transaction = bytes


@dataclass(frozen=True, slots=True)
class Payload:
    transactions: tuple[Transaction, ...]
    author: PublicKey
    signature: Signature
    # digest cache: a payload's digest is read on every store/queue/verify/
    # log touch (a ~30-hash recompute per touch dominated the mempool
    # profile); length-prefixed single-pass hash, computed once.
    _digest: Digest | None = field(
        default=None, init=False, repr=False, compare=False
    )

    @staticmethod
    def make_digest(author: PublicKey, transactions) -> Digest:
        h = hashlib.sha512()
        h.update(b"HSPAYLOAD")
        h.update(author.data)
        h.update(struct.pack("<I", len(transactions)))
        for tx in transactions:
            h.update(struct.pack("<I", len(tx)))  # keeps the encoding injective
            h.update(tx)
        return Digest(h.digest()[:32])

    @staticmethod
    def new_from_key(
        transactions: list[Transaction], author: PublicKey, secret: SecretKey
    ) -> "Payload":
        digest = Payload.make_digest(author, transactions)
        payload = Payload(tuple(transactions), author, Signature.new(digest, secret))
        object.__setattr__(payload, "_digest", digest)  # seed the cache
        return payload

    def digest(self) -> Digest:
        if self._digest is None:
            object.__setattr__(
                self, "_digest", Payload.make_digest(self.author, self.transactions)
            )
        return self._digest

    def size(self) -> int:
        return sum(len(tx) for tx in self.transactions)

    def verify(self, committee) -> bool:
        return self.signature.verify(self.digest(), self.author)

    async def verify_async(self, committee, service) -> bool:
        """Signature check through the BatchVerificationService, declared
        on the scheduler's SYNC lane: consensus blocks on payload
        AVAILABILITY (MempoolDriver verify -> Wait,
        consensus/src/mempool.rs:45-60) for both gossiped and sync-
        re-fetched payloads, so this check must never queue behind a bulk
        flush timer — the sync class drains first among the batched lanes
        with a 1 ms deadline, without riding the preemptive critical lane
        QC/TC checks own."""
        return await service.verify(
            self.digest().data, self.author, self.signature, source="sync"
        )

    def sample_tx_ids(self) -> list[int]:
        """Sample transactions start with a zero byte followed by a u64 id
        (node/src/client.rs:121-137); used for end-to-end latency tracking."""
        out = []
        for tx in self.transactions:
            if len(tx) >= 9 and tx[0] == 0:
                out.append(struct.unpack(">Q", tx[1:9])[0])
        return out

    def encode(self, w: Writer) -> None:
        w.seq(list(self.transactions), lambda wr, tx: wr.var_bytes(tx))
        w.fixed(self.author.data, 32)
        w.fixed(self.signature.data, 64)

    @staticmethod
    def decode(r: Reader) -> "Payload":
        txs = tuple(r.seq(lambda rd: rd.var_bytes()))
        return Payload(txs, PublicKey(r.fixed(32)), Signature(r.fixed(64)))

    def __str__(self) -> str:
        return f"Payload({self.digest().short()}, {len(self.transactions)} txs)"


# ---------------------------------------------------------------------------
# Wire envelope for the mempool port (reference MempoolMessage enum).

TAG_PAYLOAD = 0
TAG_PAYLOAD_REQUEST = 1


@dataclass(frozen=True, slots=True)
class PayloadRequest:
    digests: tuple[Digest, ...]
    requester: PublicKey


@dataclass(frozen=True, slots=True)
class OwnPayload:
    """Internal-only: a freshly made payload from the PayloadMaker."""

    payload: Payload


def encode_mempool_message(msg) -> bytes:
    w = Writer()
    if isinstance(msg, Payload):
        w.u8(TAG_PAYLOAD)
        msg.encode(w)
    elif isinstance(msg, PayloadRequest):
        w.u8(TAG_PAYLOAD_REQUEST)
        w.seq(list(msg.digests), lambda wr, d: wr.fixed(d.data, 32))
        w.fixed(msg.requester.data, 32)
    else:
        raise TypeError(f"not a mempool message: {msg!r}")
    return w.bytes()


def decode_mempool_message(data: bytes):
    r = Reader(data)
    tag = r.u8()
    if tag == TAG_PAYLOAD:
        out = Payload.decode(r)
    elif tag == TAG_PAYLOAD_REQUEST:
        digests = tuple(r.seq(lambda rd: Digest(rd.fixed(32))))
        out = PayloadRequest(digests, PublicKey(r.fixed(32)))
    else:
        raise SerdeError(f"unknown mempool tag {tag}")
    r.expect_done()
    return out
