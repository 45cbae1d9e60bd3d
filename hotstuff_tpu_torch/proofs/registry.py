"""ProofRegistry: the per-node commit-proof index.

Watches the consensus commit path (`Core._commit` calls `note_commit`
with each committed block and its CERTIFYING certificate — the
successor's QC) and maintains three bounded maps that together close the
submit→commit→proof loop:

  * payload digest → CommitProof, over a bounded ring of the newest
    committed blocks (eviction is by commit order; `proofs.evicted`
    counts dropped payload entries);
  * (client, nonce) → transaction digest, fed by the ingress pipeline
    at admission (`note_tx`), bounded like the admission replay window;
  * transaction digest → payload digest, fed by the PayloadMaker at
    flush (`note_payload`) — in the chaos plane, where transaction
    digests ride blocks DIRECTLY as payload digests, the identity
    mapping applies and this map stays empty.

Every bound is explicit and every overflow is counted: a proof plane
that leaked memory per never-committed nonce would hand Byzantine
clients a free resource-exhaustion lever (the nonce-squatting scenario
pins this). Persistence covers the newest window of the ring only — a
restarted node re-serves recent proofs immediately and regrows the rest
from new commits; old proofs are reconstructible from the chain, not
precious state.

Determinism: chaos-reachable — no wall clock, no ambient randomness;
waiter wake-ups ride the commit path itself.

The port's copy of `hotstuff_tpu/proofs/registry.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import asyncio
import logging
from collections import OrderedDict, deque

from ..crypto import Digest, PublicKey
from ..utils import metrics
from ..utils.serde import Reader, SerdeError, Writer
from .messages import CommitProof

log = logging.getLogger("hotstuff.proofs")

_M_INDEXED = metrics.counter("proofs.indexed")
_M_RESOLVED = metrics.counter("proofs.resolved")
_M_EVICTED = metrics.counter("proofs.evicted")
_M_MISMATCH = metrics.counter("proofs.cert_mismatch")
_M_SUBS_SHED = metrics.counter("proofs.subs_shed")
_M_SIZE = metrics.gauge("proofs.registry_size")

# Store blob holding the persisted newest-window of the proof ring.
_RING_KEY = b"proof-ring"


class ProofRegistry:
    """One per node. `store` (store/store.py) is optional — without it
    the ring is memory-only (the chaos default)."""

    def __init__(
        self,
        store=None,
        capacity: int = 1_024,
        persist_window: int = 64,
        tx_window: int = 65_536,
        max_waiters: int = 1_024,
    ) -> None:
        self.store = store
        self.capacity = capacity
        self.persist_window = persist_window
        self.tx_window = tx_window
        self.max_waiters = max_waiters
        # Commit-ordered ring of (payload digests, proof); oldest evicts.
        self._ring: deque[tuple[tuple[Digest, ...], CommitProof]] = deque()
        self._by_payload: dict[Digest, CommitProof] = {}
        # (client bytes, nonce) -> tx digest, admission-fed, bounded FIFO.
        self._tx_of: OrderedDict[tuple[bytes, int], Digest] = OrderedDict()
        self._key_of_tx: dict[Digest, tuple[bytes, int]] = {}
        # Body bytes -> FIFO of admitted tx digests awaiting their flush
        # (real-node path: the PayloadMaker sees BODIES, not digests, so
        # the pairing happens here). Bounded by total queued digests.
        self._pending_bodies: OrderedDict[bytes, deque[Digest]] = OrderedDict()
        self._n_pending_bodies = 0
        # payload digest -> ingress tx digests flushed into it (resolved
        # and dropped at commit). Bounded by tx_window alongside.
        self._txs_of_payload: OrderedDict[Digest, list[Digest]] = OrderedDict()
        # Resolved (client, nonce) -> proof, bounded FIFO.
        self._resolved: OrderedDict[tuple[bytes, int], CommitProof] = OrderedDict()
        # Commit waiters (subscribe-until-commit), bounded GLOBALLY.
        self._waiters: dict[tuple[bytes, int], list[asyncio.Future]] = {}
        self._n_waiters = 0
        self.stats = {
            "indexed": 0, "resolved": 0, "evicted": 0, "mismatch": 0,
        }

    # -- ingress feed --------------------------------------------------------

    def note_tx(
        self,
        client: PublicKey,
        nonce: int,
        tx_digest: Digest,
        body: bytes | None = None,
    ) -> None:
        """Record an ADMITTED (signature-verified) transaction's digest
        under its (client, nonce). Called by the ingress pipeline just
        before the body is handed to the mempool lane. `body` threads
        the real-node path: the PayloadMaker reports flushes by BODY
        (note_payload), and this FIFO pairs each flushed body back to
        its tx digest. Chaos drivers, where the tx digest rides blocks
        directly, omit it."""
        key = (client.data, nonce)
        self._tx_of[key] = tx_digest
        self._key_of_tx[tx_digest] = key
        while len(self._tx_of) > self.tx_window:
            old_key, old_digest = self._tx_of.popitem(last=False)
            if self._key_of_tx.get(old_digest) == old_key:
                del self._key_of_tx[old_digest]
        if body is not None:
            self._pending_bodies.setdefault(body, deque()).append(tx_digest)
            self._n_pending_bodies += 1
            while self._n_pending_bodies > self.tx_window:
                _, old = self._pending_bodies.popitem(last=False)
                self._n_pending_bodies -= len(old)

    def note_payload(self, bodies: list[bytes], payload_digest: Digest) -> None:
        """Record which payload a flushed batch of transaction bodies
        rode (PayloadMaker._make). Ingress bodies pair FIFO against
        their admitted digests; Front bodies have no pending entry and
        are simply not provable by (client, nonce), by design."""
        tx_digests: list[Digest] = []
        for body in bodies:
            queue = self._pending_bodies.get(body)
            if not queue:
                continue
            tx_digests.append(queue.popleft())
            self._n_pending_bodies -= 1
            if not queue:
                del self._pending_bodies[body]
        if not tx_digests:
            return
        self._txs_of_payload.setdefault(payload_digest, []).extend(tx_digests)
        while len(self._txs_of_payload) > self.tx_window:
            self._txs_of_payload.popitem(last=False)

    # -- commit feed ---------------------------------------------------------

    async def note_commit(self, block, cert) -> None:
        """Index one committed block under its certifying certificate
        (the successor's QC: cert.hash == block.digest()). Builds the
        CommitProof, indexes every payload digest, resolves any
        (client, nonce) keys and wakes their waiters, then persists the
        newest window."""
        proof = CommitProof(
            author=block.author,
            round=block.round,
            payload=tuple(block.payload),
            parent_hash=block.qc.hash,
            parent_round=block.qc.round,
            cert=cert,
            reconfig_digest=(
                block.reconfig.digest() if block.reconfig is not None else None
            ),
        )
        if cert.hash != block.digest() or cert.round != block.round:
            # Defensive: a certificate that does not certify this block
            # would serve clients an unverifiable proof. Never index it.
            self.stats["mismatch"] += 1
            _M_MISMATCH.inc()
            log.error(
                "proof registry: certificate %s does not certify committed "
                "block B%s — proof not indexed", cert, block.round,
            )
            return
        payloads = tuple(block.payload)
        self._ring.append((payloads, proof))
        for pd in payloads:
            self._by_payload[pd] = proof
            self.stats["indexed"] += 1
            _M_INDEXED.inc()
            self._resolve(pd, proof)
        while len(self._ring) > self.capacity:
            old_payloads, old_proof = self._ring.popleft()
            for pd in old_payloads:
                if self._by_payload.get(pd) is old_proof:
                    del self._by_payload[pd]
                    self.stats["evicted"] += 1
                    _M_EVICTED.inc()
        _M_SIZE.set(self.size())
        if self.store is not None:
            await self._persist()

    def _resolve(self, payload_digest: Digest, proof: CommitProof) -> None:
        """Map one committed payload digest back to the (client, nonce)
        keys it carries: the tx digests flushed into it (real-node path)
        plus the digest ITSELF as a tx digest (chaos identity path)."""
        tx_digests = self._txs_of_payload.pop(payload_digest, [])
        tx_digests.append(payload_digest)
        for txd in tx_digests:
            key = self._key_of_tx.pop(txd, None)
            if key is None:
                continue
            self._tx_of.pop(key, None)
            self._resolved[key] = proof
            self.stats["resolved"] += 1
            _M_RESOLVED.inc()
            while len(self._resolved) > self.tx_window:
                self._resolved.popitem(last=False)
            for fut in self._waiters.pop(key, ()):
                self._n_waiters -= 1
                if not fut.done():
                    fut.set_result(proof)

    # -- lookups -------------------------------------------------------------

    def proof_for_payload(self, payload_digest: Digest) -> CommitProof | None:
        return self._by_payload.get(payload_digest)

    def proof_for_client(
        self, client: PublicKey, nonce: int
    ) -> tuple[CommitProof | None, bool]:
        """(proof | None, known): `known` is True when the (client,
        nonce) was admitted here (proof pending) or already resolved."""
        key = (client.data, nonce)
        proof = self._resolved.get(key)
        if proof is not None:
            return proof, True
        return None, key in self._tx_of

    def add_waiter(self, client: PublicKey, nonce: int) -> asyncio.Future | None:
        """Park a subscribe-until-commit future for a KNOWN-pending key.
        Returns None when the global waiter table is full — the caller
        sheds with a retry hint instead of queueing unboundedly."""
        if self._n_waiters >= self.max_waiters:
            _M_SUBS_SHED.inc()
            return None
        key = (client.data, nonce)
        fut = asyncio.get_running_loop().create_future()
        self._waiters.setdefault(key, []).append(fut)
        self._n_waiters += 1
        return fut

    def drop_waiter(self, client: PublicKey, nonce: int, fut) -> None:
        """Release a cancelled/abandoned subscription's slot."""
        key = (client.data, nonce)
        queue = self._waiters.get(key)
        if queue and fut in queue:
            queue.remove(fut)
            self._n_waiters -= 1
            if not queue:
                del self._waiters[key]

    def size(self) -> int:
        """Bounded-memory pin read by the Byzantine scenarios: total
        entries across every map (all individually bounded)."""
        return (
            len(self._by_payload)
            + len(self._tx_of)
            + self._n_pending_bodies
            + len(self._txs_of_payload)
            + len(self._resolved)
            + self._n_waiters
        )

    def waiters(self) -> int:
        return self._n_waiters

    # -- persistence ---------------------------------------------------------

    async def _persist(self) -> None:
        """Write the newest `persist_window` ring entries under
        `proof-ring`: enough for a restarted node to re-serve the recent
        past immediately; everything older regrows from new commits."""
        w = Writer()
        window = list(self._ring)[-self.persist_window:]
        w.seq(window, _encode_ring_entry)
        await self.store.write(_RING_KEY, w.bytes())

    async def load(self) -> int:
        """Reload the persisted window (node restart). Returns the
        number of ring entries restored; 0 when nothing was persisted."""
        if self.store is None:
            return 0
        raw = await self.store.read(_RING_KEY)
        if raw is None:
            return 0
        try:
            r = Reader(raw)
            window = r.seq(_decode_ring_entry)
            r.expect_done()
        except SerdeError as e:
            log.warning("proof ring blob undecodable (%s); starting empty", e)
            return 0
        for payloads, proof in window:
            self._ring.append((payloads, proof))
            for pd in payloads:
                self._by_payload[pd] = proof
        _M_SIZE.set(self.size())
        return len(window)


def _encode_ring_entry(
    w: Writer, entry: tuple[tuple[Digest, ...], CommitProof]
) -> None:
    payloads, proof = entry
    w.seq(list(payloads), lambda wr, d: wr.fixed(d.data, 32))
    inner = Writer()
    proof.encode(inner)
    w.var_bytes(inner.bytes())


def _decode_ring_entry(r: Reader) -> tuple[tuple[Digest, ...], CommitProof]:
    payloads = tuple(r.seq(lambda rd: Digest(rd.fixed(32))))
    inner = Reader(r.var_bytes())
    proof = CommitProof.decode(inner)
    inner.expect_done()
    return payloads, proof
