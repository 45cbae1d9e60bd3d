"""Point-to-point network plane: fire-and-forget sender + framed receiver.

Capability parity with the reference `network` crate (network/src/lib.rs):
  * NetMessage(bytes, [addr..]) -- one payload, a list of recipients
    (network/src/lib.rs:27)
  * NetSender -- one worker task + bounded queue per peer, lazy connect,
    drop-on-failure (reliability is the protocol's job via sync retries)
    (network/src/lib.rs:29-87)
  * NetReceiver -- TCP accept loop, one worker per inbound connection, reads
    length-delimited frames, decodes, forwards to a delivery channel
    (network/src/lib.rs:89-144)

Wire format: 4-byte big-endian length prefix (tokio LengthDelimitedCodec
default) followed by the codec payload. Properties the protocol relies on:
per-peer per-LANE FIFO (one ordered TCP stream; urgent recovery traffic
may overtake bulk gossip — see NetSender), at-most-once, NO delivery
guarantee. This is the control plane and deliberately stays on host
CPU/TCP; the card appears only inside the crypto step.

Urgent-lane users (NetMessage.urgent=True): mempool payload sync
requests/replies, and the consensus synchronizer's recovery traffic —
per-digest SyncRequests, batched catch-up SyncRangeRequest/Reply
(consensus/messages.py) and the blocks served for them. Recovery frames
un-stall consensus; queueing them behind megabytes of bulk gossip is
exactly the stall they exist to clear. The aggregation overlay's TIMEOUT
bundles (TAG_TIMEOUT_BUNDLE, consensus/messages.py + overlay.py) ride
the same hot lane — a stalled round's partial quorum IS recovery
traffic — while vote bundles stay on the cold lane with the votes they
replace.

The port's copy of `hotstuff_tpu/network/net.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import random
import struct
from dataclasses import dataclass
from typing import Callable

from ..utils import metrics, tracing
from ..utils.actors import Selector, channel, spawn

log = logging.getLogger("hotstuff.network")

Address = tuple[str, int]

_M_FRAMES_TAGGED = metrics.counter("trace.frames_tagged")

_M_BYTES_SENT = metrics.counter("net.bytes_sent")
_M_FRAMES_SENT = metrics.counter("net.frames_sent")
_M_BYTES_RECEIVED = metrics.counter("net.bytes_received")
_M_FRAMES_RECEIVED = metrics.counter("net.frames_received")
_M_SEND_FAILURES = metrics.counter("net.send_failures")
_M_RECONNECTS = metrics.counter("net.reconnects")
_M_DROPPED_FULL = metrics.counter("net.dropped_full")
_M_DECODE_ERRORS = metrics.counter("net.decode_errors")
_M_BACKOFF_SECONDS = metrics.counter("net.backoff_seconds")
_M_BACKOFF_DROPS = metrics.counter("net.backoff_drops")

# Per-peer observatory aggregates (the per-link detail lives in the
# PeerLink ledger below; these are the process-global roll-ups).
_M_PEER_LINKS = metrics.counter("net.peer.links")
_M_PEER_PROBES_SENT = metrics.counter("net.peer.probes_sent")
_M_PEER_PINGS_RECEIVED = metrics.counter("net.peer.pings_received")
_M_PEER_PONGS_RECEIVED = metrics.counter("net.peer.pongs_received")
_M_PEER_RTT_SAMPLES = metrics.counter("net.peer.rtt_samples")

MAX_FRAME = 64 * 1024 * 1024  # defensive cap against Byzantine length prefixes


def backoff_jitter_rng(node: object, sender: str, addr: Address) -> random.Random:
    """Per-(node, sender, peer) seeded jitter stream for connect backoff —
    the chaos `SeededRng.stream` idiom (hash a stable name, seed a
    Random). `node` is the tracing NODE_LABEL (the chaos runner's node
    index; the store name in a real node process — node/main.py sets
    it), NOT just the sender's role name: every node names its sender
    "consensus-sender", so a role-only seed would hand all n-1 nodes
    retrying one recovering peer the SAME jitter sequence — a lockstep
    reconnect stampede, the exact failure jitter exists to prevent.
    With node identity in the seed every draw stays a pure function of
    stable identity (bit-identical under chaos replay) while distinct
    nodes keep decorrelated retry clocks."""
    digest = hashlib.sha256(
        f"net-backoff:{node}:{sender}:{addr[0]}:{addr[1]}".encode()
    ).digest()
    return random.Random(int.from_bytes(digest[:8], "big"))


# ---------------------------------------------------------------------------
# Per-peer link observatory (`net.peer.*`).
#
# One PeerLink per DIRECTED (node, peer address) pair, attributed the
# same way frames and backoff streams are: by the tracing NODE_LABEL
# contextvar the node's construction scope set. Sender paths (both the
# TCP workers and the chaos-transport branch) account frames/bytes/
# drops/backoffs; the consensus probe handlers (consensus/core.py
# Ping/Pong) feed RTT samples. Everything here is pure bookkeeping
# driven by loop-clock durations, so under the chaos virtual clock the
# whole ledger — EWMAs included — replays bit-identically.

# EWMA weight for new RTT samples. 0.2 converges within ~10 probes while
# still smoothing per-frame chaos jitter; the raw p50 rides alongside so
# the dash can show both.
RTT_EWMA_ALPHA = 0.2
# Bounded raw-sample ring per link (p50 source). Small on purpose: the
# observatory is always-on bookkeeping, not a histogram service.
RTT_SAMPLE_CAP = 256
# Gap threshold (ms) for per-vantage RTT classing: consecutive sorted
# EWMAs further apart than this start a new class. The chaos WanMatrix's
# closest inter-region spacing is 20 ms (us-west 62 vs eu-west 82 from
# us-east), so 15 ms splits every seeded geometry while absorbing EWMA
# residue from per-frame latency jitter.
RTT_CLASS_GAP_MS = 15.0


class PeerLink:
    """Per-directed-peer accounting: link counters + RTT estimators."""

    __slots__ = (
        "frames_sent", "bytes_sent", "drops_full", "backoff_drops",
        "connects", "reconnects", "send_failures", "probes_sent",
        "pings_received", "pongs_received", "rtt_ewma_ms", "_rtt_samples",
    )

    def __init__(self) -> None:
        self.frames_sent = 0
        self.bytes_sent = 0
        self.drops_full = 0
        self.backoff_drops = 0
        self.connects = 0
        self.reconnects = 0
        self.send_failures = 0
        self.probes_sent = 0
        self.pings_received = 0
        self.pongs_received = 0
        self.rtt_ewma_ms: float | None = None
        self._rtt_samples: list[float] = []

    def note_sent(self, nbytes: int) -> None:
        self.frames_sent += 1
        self.bytes_sent += nbytes

    def note_rtt(self, rtt_ms: float) -> None:
        if self.rtt_ewma_ms is None:
            self.rtt_ewma_ms = rtt_ms
        else:
            self.rtt_ewma_ms = (
                RTT_EWMA_ALPHA * rtt_ms
                + (1.0 - RTT_EWMA_ALPHA) * self.rtt_ewma_ms
            )
        self._rtt_samples.append(rtt_ms)
        if len(self._rtt_samples) > RTT_SAMPLE_CAP:
            del self._rtt_samples[0]
        _M_PEER_RTT_SAMPLES.inc()

    def rtt_p50_ms(self) -> float | None:
        if not self._rtt_samples:
            return None
        ordered = sorted(self._rtt_samples)
        # Nearest-rank p50, mirroring utils/metrics.percentile.
        return ordered[max(0, -(-len(ordered) // 2) - 1)]

    def snapshot(self) -> dict:
        return {
            "frames_sent": self.frames_sent,
            "bytes_sent": self.bytes_sent,
            "drops_full": self.drops_full,
            "backoff_drops": self.backoff_drops,
            "connects": self.connects,
            "reconnects": self.reconnects,
            "send_failures": self.send_failures,
            "probes_sent": self.probes_sent,
            "pings_received": self.pings_received,
            "pongs_received": self.pongs_received,
            "rtt_ewma_ms": (
                round(self.rtt_ewma_ms, 6)
                if self.rtt_ewma_ms is not None
                else None
            ),
            "rtt_p50_ms": (
                round(self.rtt_p50_ms(), 6)
                if self._rtt_samples
                else None
            ),
            "rtt_samples": len(self._rtt_samples),
        }


# node label -> "host:port" -> PeerLink
_peer_links: dict[object, dict[str, PeerLink]] = {}


def _addr_key(addr: Address) -> str:
    return f"{addr[0]}:{addr[1]}"


def peer_link(addr: Address, node: object | None = None) -> PeerLink:
    """The (create-on-first-touch) ledger entry for `addr` as seen from
    `node` (default: the calling task's tracing NODE_LABEL)."""
    if node is None:
        node = tracing.NODE_LABEL.get()
    links = _peer_links.setdefault(node, {})
    key = _addr_key(addr)
    link = links.get(key)
    if link is None:
        link = links[key] = PeerLink()
        _M_PEER_LINKS.inc()
    return link


def peer_snapshot(node: object | None = None) -> dict[str, dict]:
    """JSON-ready per-peer view for one node, sorted by peer key so the
    serialized form is bit-stable across same-seed replays."""
    if node is None:
        node = tracing.NODE_LABEL.get()
    links = _peer_links.get(node) or {}
    return {key: links[key].snapshot() for key in sorted(links)}


def reset_peers() -> None:
    """Drop every ledger entry (chaos runs start from a clean slate so
    back-to-back scenarios in one process cannot bleed into each other)."""
    _peer_links.clear()


def note_probe_sent(addr: Address) -> None:
    """A Ping left for `addr` (consensus/core.py probe ticker)."""
    peer_link(addr).probes_sent += 1
    _M_PEER_PROBES_SENT.inc()


def note_ping_received(addr: Address) -> None:
    """A Ping arrived from the peer listening at `addr`."""
    peer_link(addr).pings_received += 1
    _M_PEER_PINGS_RECEIVED.inc()


def note_pong_rtt(addr: Address, rtt_s: float) -> None:
    """A Pong closed the loop for `addr`: fold the measured round trip
    (loop-clock seconds) into the link's EWMA/p50 estimators."""
    link = peer_link(addr)
    link.pongs_received += 1
    link.note_rtt(rtt_s * 1000.0)
    _M_PEER_PONGS_RECEIVED.inc()


def rtt_classes(
    rtts: dict[str, float], gap_ms: float = RTT_CLASS_GAP_MS
) -> dict[str, int]:
    """Cluster peers into RTT classes from ONE vantage: sort by
    (RTT, peer) and start a new class at every gap wider than `gap_ms`.
    Class 0 is the nearest band (same-region peers under the chaos
    WanMatrix). Pure and order-stable — same inputs, same classes."""
    classes: dict[str, int] = {}
    cls = -1
    prev: float | None = None
    for peer, rtt in sorted(rtts.items(), key=lambda kv: (kv[1], kv[0])):
        if prev is None or rtt - prev > gap_ms:
            cls += 1
        classes[peer] = cls
        prev = rtt
    return classes


# ---------------------------------------------------------------------------
# Pluggable transport (the chaos subsystem's fault-injection seam).
#
# When a transport is installed, NetSender/NetReceiver keep their public
# contract (NetMessage in, decoded messages out, identical framing and
# codec calls) but hand the socket layer to the transport: senders submit
# framed payloads per destination, receivers register (port, deliver,
# decode) bindings. hotstuff_tpu/chaos/transport.py installs a seeded
# FaultyTransport here to drop/delay/duplicate/reorder/partition traffic
# deterministically; production code never installs one and takes the TCP
# paths below.

_transport = None


def install_transport(transport) -> object | None:
    """Install (or, with None, remove) the process-wide transport override;
    returns the previous one. Affects NetSender/NetReceiver instances
    created AFTERWARDS — install before booting nodes (instances snapshot
    the transport at construction)."""
    global _transport
    prev, _transport = _transport, transport
    return prev


@dataclass(slots=True)
class NetMessage:
    """(serialized bytes, recipient addresses) -- network/src/lib.rs:27.

    `urgent` selects the hot egress lane: protocol-critical recovery
    traffic (payload sync requests/replies) that must not queue behind
    bulk gossip. See NetSender.

    `trace` is an optional causal trace context (utils/tracing.py):
    when set, the sender appends its 22-byte trailer INSIDE the frame
    (counted by the length prefix, stripped by the receiver before the
    codec) so the block's journey can be stitched across nodes.
    Trailer-less peers and trailer-less frames interoperate unchanged."""

    data: bytes
    addresses: list[Address]
    urgent: bool = False
    trace: "tracing.TraceContext | None" = None


def frame(data: bytes, trace: "tracing.TraceContext | None" = None) -> bytes:
    if trace is not None:
        trailer = trace.trailer()
        return struct.pack(">I", len(data) + len(trailer)) + data + trailer
    return struct.pack(">I", len(data)) + data


class FrameReader:
    """Bulk-buffered frame reader: one stream read yields every complete
    frame already in the TCP buffer, so the per-frame event-loop cost is
    amortized. The previous per-frame readexactly pair costs two awaits
    PER FRAME — at a 30k tx/s ingress the saturated-node profile showed
    those awaits as ~15% of node CPU (data/profiles/). Returns None on
    EOF (clean or mid-frame); raises ConnectionError on a frame whose
    declared length exceeds the Byzantine MAX_FRAME cap."""

    __slots__ = ("_reader", "_buf", "_off")

    READ_SIZE = 256 * 1024

    def __init__(self, reader: asyncio.StreamReader) -> None:
        self._reader = reader
        # bytearray: += grows in place (amortized O(chunk)); an immutable-
        # bytes rebuild per refill would be O(buffer) per read — quadratic
        # for any frame larger than READ_SIZE, and a CPU-DoS lever for a
        # peer trickling a MAX_FRAME-sized declaration in small segments.
        self._buf = bytearray()
        self._off = 0

    def _try_parse(self) -> bytes | None:
        """Pop one complete frame from the buffer, or None if incomplete."""
        have = len(self._buf) - self._off
        if have < 4:
            return None
        length = int.from_bytes(self._buf[self._off : self._off + 4], "big")
        if length > MAX_FRAME:
            raise ConnectionError(f"frame too large: {length}")
        if have < 4 + length:
            return None
        start = self._off + 4
        data = bytes(self._buf[start : start + length])
        self._off = start + length
        return data

    async def next_frame(self) -> bytes | None:
        while True:
            data = self._try_parse()
            if data is not None:
                return data
            if self._off:  # compact consumed prefix before refilling
                del self._buf[: self._off]
                self._off = 0
            try:
                chunk = await self._reader.read(self.READ_SIZE)
            except (ConnectionError, OSError):
                return None
            if not chunk:
                return None
            self._buf += chunk



class NetSender:
    """Receives NetMessage from a channel; maintains one worker per peer
    address so a slow peer never blocks broadcast
    (network/src/lib.rs:44-57,60-86).

    Each peer has TWO bounded lanes: `urgent` messages (payload sync
    requests/replies — the recovery path that un-stalls consensus) ride a
    hot lane the worker drains first; everything else (bulk payload
    gossip) rides the cold lane. A single FIFO let megabytes of gossip
    backlog starve the kilobyte-scale recovery replies that would have
    cleared it — saturation runs stalled exactly this
    way (sync retries re-broadcast for minutes while replies sat behind
    gossip and dropped). FIFO order is preserved WITHIN each lane; no
    protocol message relies on cross-lane ordering (payload delivery and
    sync replies are idempotent at the receiver)."""

    PEER_QUEUE = 1_000

    # Connect-failure backoff (per peer, jittered exponential). Without it
    # every frame queued for an unreachable peer retries open_connection
    # immediately: a partitioned peer with a full cold lane hot-loops
    # SYN attempts (one per queued frame) for the whole partition.
    BACKOFF_BASE_S = 0.05
    BACKOFF_MAX_S = 5.0

    def __init__(self, rx: asyncio.Queue, name: str = "net-sender") -> None:
        self._rx = rx
        self._name = name
        # Captured at construction: chaos installs its transport before
        # booting nodes, and a mid-flight install must not tear an active
        # sender between two planes.
        self._transport = _transport
        # addr -> (hot, cold) queues
        self._peers: dict[Address, tuple[asyncio.Queue, asyncio.Queue]] = {}
        self._task = spawn(self._run(), name=name)

    def egress_backlogged(self, frac: float = 0.5) -> bool:
        """True while MORE THAN HALF of the peers' COLD lanes sit above
        `frac` of capacity — i.e. gossip fan-out can no longer reach a
        majority without dropping. Producers (the payload maker) use this
        as a high-water backpressure signal: without it, sustained
        overload fills the per-peer queues, payload gossip drops
        silently, replicas stall on payload availability, and consensus
        crawls at timeout pace while the producer keeps flooding.
        Majority (not any) so one slow/Byzantine peer whose queue sits
        full cannot throttle our payload production. The hot lane is
        excluded: recovery traffic must never feed back into shedding."""
        if not self._peers:
            return False
        high_water = int(self.PEER_QUEUE * frac)
        over = sum(
            1 for _, cold in self._peers.values() if cold.qsize() > high_water
        )
        return over * 2 > len(self._peers)

    async def _run(self) -> None:
        while True:
            msg: NetMessage = await self._rx.get()
            payload = frame(msg.data, msg.trace)
            if msg.trace is not None:
                _M_FRAMES_TAGGED.inc()
                tracing.event(
                    "net.send", msg.trace.trace_id,
                    hop=msg.trace.hop, peers=len(msg.addresses),
                    bytes=len(msg.data), urgent=msg.urgent,
                )
            if self._transport is not None:
                # Chaos seam: the transport owns delivery (and the faults).
                for addr in msg.addresses:
                    peer_link(addr).note_sent(len(payload))
                    await self._transport.send(addr, payload, urgent=msg.urgent)
                continue
            for addr in msg.addresses:
                lanes = self._peers.get(addr)
                if lanes is None:
                    lanes = (
                        asyncio.Queue(self.PEER_QUEUE),
                        asyncio.Queue(self.PEER_QUEUE),
                    )
                    self._peers[addr] = lanes
                    spawn(
                        self._worker(addr, *lanes),
                        name=f"{self._name}-{addr}",
                    )
                q = lanes[0] if msg.urgent else lanes[1]
                try:
                    q.put_nowait(payload)
                except asyncio.QueueFull:
                    # Fire-and-forget: drop rather than block the fan-out.
                    _M_DROPPED_FULL.inc()
                    peer_link(addr).drops_full += 1
                    log.debug("dropping message to %s: peer queue full", addr)

    async def _worker(
        self, addr: Address, hot: asyncio.Queue, cold: asyncio.Queue
    ) -> None:
        """Per-peer worker: lazily connects, writes frames in per-lane FIFO
        order (hot lane first), drops messages while the peer is
        unreachable. The Selector's anti-starvation bound means a saturated
        hot lane still lets the occasional cold frame through rather than
        parking gossip forever."""
        # Selector serves LOWER priority numbers first (the pacemaker's
        # must-lose timer branch gets priority=1 in consensus/core.py):
        # hot keeps the winning default 0, cold must lose ties.
        selector = Selector()
        selector.add("hot", hot.get)
        selector.add("cold", cold.get, priority=1)
        # The worker task inherits the node's NODE_LABEL contextvar
        # (orchestrator sets an index per in-process node; node/main.py
        # sets the store name per process).
        jitter = backoff_jitter_rng(tracing.NODE_LABEL.get(), self._name, addr)
        link = peer_link(addr)
        writer: asyncio.StreamWriter | None = None
        connected_before = False  # reconnects = churn, not initial connects
        backoff = 0.0  # current backoff window (s); 0 = healthy
        next_attempt = 0.0  # loop time before which connects are suppressed
        loop = asyncio.get_running_loop()
        while True:
            _branch, payload = await selector.next()
            if writer is None:
                if loop.time() < next_attempt:
                    # Inside the backoff window: drop without a SYN. The
                    # fire-and-forget contract already allows the drop;
                    # what backoff buys is not hot-looping connect attempts
                    # (one per queued frame) against a partitioned peer.
                    _M_BACKOFF_DROPS.inc()
                    link.backoff_drops += 1
                    continue
                try:
                    _, writer = await asyncio.open_connection(addr[0], addr[1])
                    if connected_before:
                        _M_RECONNECTS.inc()
                        link.reconnects += 1
                    connected_before = True
                    link.connects += 1
                    backoff = 0.0
                except OSError as e:
                    _M_SEND_FAILURES.inc()
                    link.send_failures += 1
                    # Jittered exponential growth, capped AFTER the jitter so
                    # BACKOFF_MAX_S is a true bound: jitter decorrelates the
                    # retry clocks of many senders all aimed at one
                    # recovering peer (no reconnect stampede at heal time).
                    # Drawn from the per-(sender, peer) seeded stream, not
                    # the ambient `random` module, so a chaos replay sees
                    # the identical backoff schedule.
                    backoff = min(
                        max(2 * backoff, self.BACKOFF_BASE_S)
                        * (0.5 + jitter.random()),
                        self.BACKOFF_MAX_S,
                    )
                    next_attempt = loop.time() + backoff
                    _M_BACKOFF_SECONDS.inc(backoff)
                    log.debug(
                        "failed to connect to %s: %s (backing off %.2fs)",
                        addr,
                        e,
                        backoff,
                    )
                    continue  # drop this message
            try:
                writer.write(payload)
                await writer.drain()
                _M_FRAMES_SENT.inc()
                _M_BYTES_SENT.inc(len(payload))
                link.note_sent(len(payload))
            except (ConnectionError, OSError) as e:
                _M_SEND_FAILURES.inc()
                link.send_failures += 1
                log.debug("failed to send to %s: %s", addr, e)
                try:
                    writer.close()
                except Exception:
                    pass
                writer = None  # reconnect lazily on next message


class NetReceiver:
    """Binds a listener; every inbound connection gets a worker that decodes
    frames and forwards them into the delivery channel
    (network/src/lib.rs:89-144)."""

    def __init__(
        self,
        address: Address,
        deliver: asyncio.Queue,
        decode: Callable[[bytes], object],
        name: str = "net-receiver",
    ) -> None:
        self._address = address
        self._deliver = deliver
        self._decode = decode
        self._name = name
        self._transport = _transport  # captured like NetSender's
        self._server: asyncio.AbstractServer | None = None
        self._task = spawn(self._run(), name=name)

    async def _run(self) -> None:
        if self._transport is not None:
            # Chaos seam: register the binding instead of a TCP listener;
            # park until cancelled (a chaos crash), then unbind so the
            # restarted node can re-register the port.
            self._transport.bind(self._address, self._deliver, self._decode)
            log.debug("%s bound on chaos transport %s", self._name, self._address)
            try:
                await asyncio.Event().wait()
            finally:
                self._transport.unbind(self._address)
            return
        self._server = await asyncio.start_server(
            self._handle, host=self._address[0], port=self._address[1]
        )
        log.debug("%s listening on %s", self._name, self._address)
        async with self._server:
            await self._server.serve_forever()

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peer = writer.get_extra_info("peername")
        frames = FrameReader(reader)
        while True:
            try:
                data = await frames.next_frame()
            except ConnectionError as e:
                log.warning("%s: dropping connection from %s: %s", self._name, peer, e)
                break
            if data is None:
                break
            _M_FRAMES_RECEIVED.inc()
            _M_BYTES_RECEIVED.inc(len(data) + 4)  # + length prefix
            data, ctx = tracing.strip_trailer(data)
            if ctx is not None:
                tracing.note_received(ctx)
                tracing.event(
                    "net.recv", ctx.trace_id, hop=ctx.hop, bytes=len(data)
                )
            try:
                message = self._decode(data)
            except Exception as e:
                _M_DECODE_ERRORS.inc()
                log.warning("%s: undecodable frame from %s: %r", self._name, peer, e)
                continue
            await self._deliver.put(message)
        try:
            writer.close()
        except Exception:
            pass


class SimpleSender:
    """Convenience owner of a NetSender: exposes send/broadcast coroutines.
    Plays the role of Synchronizer::transmit's shared send path
    (consensus/src/synchronizer.rs:109-129)."""

    def __init__(self, name: str = "sender") -> None:
        self._tx = channel()
        self._sender = NetSender(self._tx, name=name)

    async def send(self, data: bytes, address: Address) -> None:
        await self._tx.put(NetMessage(data, [address]))

    async def broadcast(self, data: bytes, addresses: list[Address]) -> None:
        await self._tx.put(NetMessage(data, list(addresses)))
