"""FaultyTransport: the deterministic, fault-injecting message fabric.

Wraps the NetSender/NetReceiver seam exposed by network/net.py
(`install_transport`): senders hand over exactly the framed bytes they
would have written to TCP, receivers register the (port, deliver, decode)
triple they would have served from a listener — framing, codecs, queue
semantics and every layer above (consensus, mempool, crypto) run
unmodified. In between, this fabric interprets a FaultPlan per directed
link: drop / duplicate / reorder / delay probabilities, timed partitions,
and unrouted traffic to crashed nodes, with every probabilistic decision
drawn from a per-link seeded stream keyed by frame sequence number — so a
replay with the same master seed reproduces the identical fault trace.

Sender attribution: in-process nodes share one module, so the transport
identifies the sending node via a contextvar (`NODE_LABEL`) set by the
orchestrator while a node's subsystems are constructed — every task the
node spawns (and thus every NetSender worker) inherits it.

Byzantine hook: a per-node AdversaryPolicy sees (and may replace) each
outbound frame of its node and observes inbound frames, and can inject
fabricated frames toward any port — the seam chaos/byzantine.py builds
equivocation, signature forgery, stale replay and withholding on.
"""

from __future__ import annotations

import asyncio
import contextvars
import logging

from ..network.net import MAX_FRAME, Address
from ..utils import metrics, tracing
from ..utils.actors import spawn
from .plan import FaultPlan, SeededRng

log = logging.getLogger("hotstuff.chaos")

# Which in-process node (index) is executing — inherited by tasks spawned
# during node construction, read at frame-submit time for link attribution.
NODE_LABEL: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "chaos-node-label", default=None
)

_M_FRAMES = metrics.counter("chaos.frames")
_M_DROPS = metrics.counter("chaos.drops")
_M_DELAYS = metrics.counter("chaos.delays")
_M_DUPLICATES = metrics.counter("chaos.duplicates")
_M_REORDERS = metrics.counter("chaos.reorders")
_M_PARTITION_DROPS = metrics.counter("chaos.partition_drops")
_M_UNROUTED = metrics.counter("chaos.unrouted")
_M_TRACE_DROPPED = metrics.counter("chaos.fault_trace_dropped")
_M_WAN_FRAMES = metrics.counter("wan.frames")
_M_WAN_CROSS = metrics.counter("wan.cross_region_frames")
_M_NET_FRAMES_RECEIVED = metrics.counter("net.frames_received")
_M_NET_BYTES_RECEIVED = metrics.counter("net.bytes_received")
_M_NET_DECODE_ERRORS = metrics.counter("net.decode_errors")

TRACE_CAP = 20_000  # report-size bound; beyond it only counters advance


class _Binding:
    __slots__ = ("deliver", "decode")

    def __init__(self, deliver: asyncio.Queue, decode) -> None:
        self.deliver = deliver
        self.decode = decode


class FaultyTransport:
    """One instance per chaos run; installed via net.install_transport."""

    def __init__(
        self,
        plan: FaultPlan,
        rng: SeededRng,
        node_of_port: dict[int, int],
    ) -> None:
        self.plan = plan
        self.node_of_port = dict(node_of_port)
        self._rng = rng
        self._link_rng: dict[tuple[int, int], object] = {}
        self._link_seq: dict[tuple[int, int], int] = {}
        self._bindings: dict[int, _Binding] = {}
        self._policies: dict[int, object] = {}
        self.trace: list[dict] = []
        self.trace_overflow = 0
        # WAN topology: region per node index, a pure function of the
        # master seed (stream "wan:regions" — adding the matrix to a plan
        # cannot shift any link-fault stream's decisions).
        self.regions: list[str] = []
        if plan.wan is not None:
            n = max(self.node_of_port.values(), default=-1) + 1
            self.regions = plan.wan.assign(rng.stream("wan:regions"), n)

    # -- NetReceiver seam ----------------------------------------------------

    def bind(self, address: Address, deliver: asyncio.Queue, decode) -> None:
        self._bindings[address[1]] = _Binding(deliver, decode)

    def unbind(self, address: Address) -> None:
        self._bindings.pop(address[1], None)

    # -- adversary hook ------------------------------------------------------

    def set_policy(self, node: int, policy) -> None:
        self._policies[node] = policy
        policy.attach(self)

    # -- NetSender seam ------------------------------------------------------

    async def send(self, addr: Address, payload: bytes, urgent: bool = False) -> None:
        """Submit one framed payload toward `addr`, applying the plan."""
        src = NODE_LABEL.get()
        dst = self.node_of_port.get(addr[1])
        now = asyncio.get_running_loop().time()
        _M_FRAMES.inc()
        if src is None or dst is None:
            _M_UNROUTED.inc()
            self._record(now, src, dst, -1, "unrouted")
            return

        data = payload[4:]  # policies and injection work on unframed bytes
        policy = self._policies.get(src)
        if policy is not None:
            # Policies decode codec bytes — hand them the frame WITHOUT
            # the trace trailer, then re-append it only to the unmodified
            # passthrough (an adversary-forged frame must not inherit the
            # honest frame's causal token).
            clean, ctx = tracing.strip_trailer(data, count=False)
            replaced = policy.on_send(src, dst, clean)
            if replaced is None:
                replaced = [clean]
            for out in replaced:
                if ctx is not None and out == clean:
                    out = out + ctx.trailer()
                await self._submit_link(src, dst, addr[1], out, now)
            return
        await self._submit_link(src, dst, addr[1], data, now)

    async def _submit_link(
        self, src: int, dst: int, port: int, data: bytes, now: float
    ) -> None:
        key = (src, dst)
        seq = self._link_seq.get(key, 0)
        self._link_seq[key] = seq + 1
        rng = self._link_rng.get(key)
        if rng is None:
            rng = self._link_rng[key] = self._rng.stream(f"link:{src}->{dst}")

        # Fixed draw count per frame: the stream position is a pure function
        # of `seq`, so reconfiguring one fault class never shifts another's
        # decisions (trace stability under scenario evolution).
        r_drop, r_dup, r_reorder, r_jitter = (
            rng.random(),
            rng.random(),
            rng.random(),
            rng.random(),
        )

        if self.plan.partitioned(src, dst, now):
            _M_PARTITION_DROPS.inc()
            self._record(now, src, dst, seq, "partition")
            return
        lf = self.plan.link(src, dst)
        if r_drop < lf.drop:
            _M_DROPS.inc()
            self._record(now, src, dst, seq, "drop")
            return
        delay = lf.delay + lf.jitter * r_jitter
        if self.regions:
            # WAN class on top of the link-quality faults: the pair's
            # one-way latency, looked up by each endpoint's region.
            src_region, dst_region = self.regions[src], self.regions[dst]
            delay += self.plan.wan.one_way_s(src_region, dst_region)
            _M_WAN_FRAMES.inc()
            if src_region != dst_region:
                _M_WAN_CROSS.inc()
        if r_reorder < lf.reorder:
            delay += lf.reorder_delay
            _M_REORDERS.inc()
        copies = 2 if r_dup < lf.duplicate else 1
        if copies > 1:
            _M_DUPLICATES.inc()
        if delay > 0:
            _M_DELAYS.inc()
        self._record(
            now, src, dst, seq, "deliver", delay=delay, dup=copies > 1
        )
        for _ in range(copies):
            spawn(
                self._deliver(src, dst, port, data, delay),
                name=f"chaos-deliver-{src}->{dst}",
            )

    def inject(self, dst: int, data: bytes, delay: float = 0.0) -> None:
        """Adversary-fabricated frame toward node `dst`'s CONSENSUS plane
        (unframed bytes). Bypasses the fault plan: the adversary owns its
        own links."""
        now = asyncio.get_running_loop().time()
        self._record(now, None, dst, -1, "inject", delay=delay)
        # Injection targets a node, not an address: route to the node's
        # lowest port, which the orchestrator assigns to the consensus
        # plane (the only plane adversary policies speak).
        port = min(
            (p for p, n in self.node_of_port.items() if n == dst), default=None
        )
        spawn(
            self._deliver(None, dst, port, data, delay),
            name=f"chaos-inject-{dst}",
        )

    async def _deliver(
        self, src: int | None, dst: int, port: int | None, data: bytes, delay: float
    ) -> None:
        """Hand `data` to the binding on the ORIGINAL destination port —
        never re-derived from the node index, since one node exposes a port
        per plane (consensus/mempool/front) and a frame must not cross
        planes into the wrong decoder."""
        if delay > 0:
            await asyncio.sleep(delay)
        binding = self._bindings.get(port) if port is not None else None
        if binding is None:
            _M_UNROUTED.inc()  # crashed / never-booted destination
            return
        if len(data) > MAX_FRAME:
            _M_NET_DECODE_ERRORS.inc()
            return
        _M_NET_FRAMES_RECEIVED.inc()
        _M_NET_BYTES_RECEIVED.inc(len(data) + 4)
        # Same trailer strip as NetReceiver: the codec never sees trace
        # bytes, and the receive stamp is attributed to the DESTINATION
        # node (the deliver task runs outside any node's context).
        data, ctx = tracing.strip_trailer(data)
        if ctx is not None:
            tracing.note_received(ctx)
            tracing.RECORDER.record(
                "net.recv", ctx.trace_id, None, {"hop": ctx.hop}, label=dst
            )
        policy = self._policies.get(dst)
        if policy is not None:
            policy.on_receive(src, dst, data)
        try:
            message = binding.decode(data)
        except Exception as e:
            _M_NET_DECODE_ERRORS.inc()
            log.warning("chaos: undecodable frame to node %d: %r", dst, e)
            return
        await binding.deliver.put(message)

    # -- trace ---------------------------------------------------------------

    def _record(self, t: float, src, dst, seq: int, action: str, **extra) -> None:
        if action != "deliver":
            # Faults (drop/partition/inject/unrouted) also land in the
            # flight recorder, attributed to the victim destination, so a
            # watchdog dump shows the faults leading up to an anomaly.
            tracing.RECORDER.record(
                "chaos.fault", None, None,
                {"action": action, "src": src, "dst": dst},
                label=dst,
            )
        if len(self.trace) >= TRACE_CAP:
            # Silent truncation was the old failure mode: a 100-node run
            # blows the cap in seconds and the report's trace looked
            # complete. The counter + the report's `fault_trace_truncated`
            # flag make the cut visible.
            self.trace_overflow += 1
            _M_TRACE_DROPPED.inc()
            return
        entry = {"t": round(t, 6), "src": src, "dst": dst, "seq": seq, "action": action}
        for k, v in extra.items():
            entry[k] = round(v, 6) if isinstance(v, float) else v
        self.trace.append(entry)
