"""Open-loop client load generation: arrival curves, signed traffic, and
per-client latency accounting.

A copy of `hotstuff_tpu/ingress/loadgen.py` for the port (`ArrivalCurve`,
`OpenLoopLoadGen`, and `IngressLoad`, the chaos scenarios' spec). OPEN loop means arrivals follow the curve whatever
the node answers. Each generated transaction is ed25519-signed by one of a
pool of client identities; all randomness comes from the injected rng, in
the reference's order (the client seeds first, then each transaction's
client, fee and body draws), so a seeded run offers the reference's
transactions byte for byte.

Curves:
  * sustained  — flat `rate` tx/s for the whole run;
  * diurnal    — smooth cosine ramp between `rate` and `peak` over
                 `period` seconds;
  * flash      — flat `rate` with a rectangular spike to `peak` inside
                 [t_start, t_end).

The signer (`make_signer`): OpenSSL (`cryptography`'s Ed25519) where it
imports, else the port's exact `pysigner.sign`; while a chaos run has a
scheme installed in `pysigner` (the trusted-crypto stub), every
signature goes through `pysigner.sign`, so the run's verifier accepts it. The reference signs every
transaction with its exact pure-Python signer in the event loop, which
caps the offered rate far below the curve; RFC 8032 signatures are
deterministic, so both signers give the same bytes. `sign_s` and `signed`
count the generator's signing time and signatures.

`log_summary()` emits the `Ingress offered/accepted/shed/...` log lines
that `benchmark/logs.py` scrapes.
"""

from __future__ import annotations

import asyncio
import logging
import math
import random
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable

from ..crypto import pysigner
from ..utils import metrics
from ..utils.actors import spawn
from . import messages
from .admission import IngressConfig
from .messages import ClientTransaction, IngressResponse

log = logging.getLogger("hotstuff.loadgen")

TICK_S = 0.05  # arrival scheduling granularity (matches node/client.py)


@dataclass(frozen=True, slots=True)
class ArrivalCurve:
    kind: str = "sustained"  # sustained | diurnal | flash
    rate: float = 100.0  # base tx/s
    peak: float = 0.0  # diurnal/flash peak tx/s
    t_start: float = 0.0  # flash spike window
    t_end: float = 0.0
    period: float = 60.0  # diurnal period (s)

    def __post_init__(self) -> None:
        if self.kind not in ("sustained", "diurnal", "flash"):
            raise ValueError(f"unknown arrival curve {self.kind!r}")

    def rate_at(self, t: float) -> float:
        if self.kind == "sustained":
            return self.rate
        if self.kind == "diurnal":
            # rate at the trough, peak at period/2; one full day per period.
            phase = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / self.period))
            return self.rate + (self.peak - self.rate) * phase
        return self.peak if self.t_start <= t < self.t_end else self.rate

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "rate": self.rate,
            "peak": self.peak,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "period": self.period,
        }


def make_signer() -> tuple[str, Callable[[bytes, bytes, bytes], bytes]]:
    """(name, sign(seed, message, public_key) -> 64-byte signature):
    OpenSSL where `cryptography` imports, else the exact `pysigner.sign`."""
    try:
        from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey
    except ImportError:
        return "exact", pysigner.sign
    keys: dict[bytes, Ed25519PrivateKey] = {}

    def sign_openssl(seed: bytes, message: bytes, public_key: bytes | None = None) -> bytes:
        if pysigner.active_scheme() is not None:
            return pysigner.sign(seed, message)
        key = keys.get(seed)
        if key is None:
            key = keys[seed] = Ed25519PrivateKey.from_private_bytes(seed)
        return key.sign(message)

    return "openssl", sign_openssl


# Canonical list-percentile (utils/metrics.py): one definition across
# loadgen, scheduler LaneStats, and the trace-report tables.
percentile = metrics.percentile


# Fee mix: mostly standard traffic, a slice paying for the priority lane,
# a slice riding bulk for free (see admission.IngressConfig defaults).
_FEE_CHOICES = ((1_000, 0.15), (1, 0.75), (0, 0.10))


class OpenLoopLoadGen:
    """Drives `submit` (an async callable: ClientTransaction →
    IngressResponse) with curve-shaped traffic from `clients` signing
    identities. All randomness comes from the injected rng, so a seeded
    run is deterministic (the chaos replay contract)."""

    def __init__(
        self,
        submit: Callable[[ClientTransaction], Awaitable[IngressResponse]],
        curve: ArrivalCurve,
        duration: float,
        clients: int = 8,
        tx_bytes: int = 64,
        rng: random.Random | None = None,
        label: str = "loadgen",
    ) -> None:
        if tx_bytes < 9:
            raise ValueError("tx_bytes must be >= 9 (sample-tx header)")
        self.signer, self._sign = make_signer()
        self.sign_s = 0.0  # seconds spent signing
        self.signed = 0
        self.submit = submit
        self.curve = curve
        self.duration = duration
        self.tx_bytes = tx_bytes
        self.label = label
        self.rng = rng or random.Random(0)
        self._seeds = [self.rng.randbytes(32) for _ in range(clients)]
        # pysigner keypair derivation is ~ms each; done once per client here.
        self._keys = [pysigner.keypair_from_seed(s) for s in self._seeds]
        # Disjoint per-client nonce ranges: nonces are client-chosen and
        # only need per-client uniqueness for the replay filter, but the
        # TCP IngressClient correlates responses by nonce across the ONE
        # shared connection — overlapping ranges would cross-match them.
        self._nonces = [c << 40 for c in range(clients)]
        self.offered = 0
        self.by_status: dict[str, int] = {}
        self.latencies_s: list[float] = []
        self.retry_hints = 0  # SHED responses carrying retry_after_ms > 0
        self.unresolved = 0  # submissions still in flight at teardown
        self._inflight: set[asyncio.Task] = set()

    # -- traffic -------------------------------------------------------------

    def _make_tx(self) -> ClientTransaction:
        c = self.rng.randrange(len(self._seeds))
        self._nonces[c] += 1
        r = self.rng.random()
        acc = 0.0
        fee = _FEE_CHOICES[-1][0]
        for value, weight in _FEE_CHOICES:
            acc += weight
            if r < acc:
                fee = value
                break
        # Front-compatible body: 0x01 + u64 tag + padding (never a sample
        # tx — sample accounting belongs to the closed-loop client).
        body = (
            b"\x01"
            + self.rng.randbytes(8)
            + bytes(self.tx_bytes - 9)
        )
        t0 = time.perf_counter()
        tx = ClientTransaction.new_signed(
            self._seeds[c], self._nonces[c], fee, body,
            public_key=self._keys[c][0], sign=self._sign,
        )
        self.sign_s += time.perf_counter() - t0
        self.signed += 1
        return tx

    async def _one(self, tx: ClientTransaction, t0: float) -> None:
        loop = asyncio.get_running_loop()
        try:
            resp = await self.submit(tx)
        except (ConnectionError, OSError) as e:
            self.by_status["error"] = self.by_status.get("error", 0) + 1
            log.debug("%s: submission failed: %r", self.label, e)
            return
        self.latencies_s.append(loop.time() - t0)
        name = resp.status_name
        self.by_status[name] = self.by_status.get(name, 0) + 1
        if resp.status == messages.SHED and resp.retry_after_ms > 0:
            self.retry_hints += 1

    async def run(self) -> dict:
        loop = asyncio.get_running_loop()
        start = loop.time()
        carry = 0.0
        next_tick = start
        while True:
            now = loop.time()
            t = now - start
            if t >= self.duration:
                break
            carry += self.curve.rate_at(t) * TICK_S
            n = int(carry)
            carry -= n
            for _ in range(n):
                tx = self._make_tx()
                self.offered += 1
                # actors.spawn, not bare ensure_future: in-process chaos
                # runs the generator inside a node-side SpawnScope, and a
                # crash-cancel must take the in-flight submissions with it.
                task = spawn(
                    self._one(tx, loop.time()),
                    name=f"{self.label}-tx{self.offered}",
                )
                self._inflight.add(task)
                task.add_done_callback(self._inflight.discard)
            next_tick += TICK_S
            delay = next_tick - loop.time()
            # Open loop: never slow the schedule down; a late tick fires
            # immediately and the curve's integral is preserved via carry.
            await asyncio.sleep(max(0.0, delay))
        # Grace for stragglers (one retry-max window), then count leftovers.
        if self._inflight:
            await asyncio.wait(list(self._inflight), timeout=5.0)
        self.unresolved = len(self._inflight)
        return self.summary()

    # -- reporting -----------------------------------------------------------

    def summary(self) -> dict:
        accepted = self.by_status.get("accepted", 0)
        shed = self.by_status.get("shed", 0)
        responded = sum(self.by_status.values())
        lat_ms = [s * 1000.0 for s in self.latencies_s]
        return {
            "curve": self.curve.to_json(),
            "duration_s": self.duration,
            "clients": len(self._seeds),
            "offered": self.offered,
            "responded": responded,
            "accepted": accepted,
            "shed": shed,
            "retry_hints": self.retry_hints,
            "bad_signature": self.by_status.get("bad_signature", 0),
            "replay": self.by_status.get("replay", 0),
            "malformed": self.by_status.get("malformed", 0),
            "errors": self.by_status.get("error", 0),
            "unresolved": self.unresolved,
            "shed_rate": (shed / responded) if responded else 0.0,
            "latency_ms": {
                "p50": round(percentile(lat_ms, 0.50), 3),
                "p99": round(percentile(lat_ms, 0.99), 3),
                "max": round(max(lat_ms), 3) if lat_ms else 0.0,
            },
        }

    def log_summary(self) -> dict:
        """Emit the scrapeable result lines (benchmark/logs.py contract).
        NOTE: these log entries are used to compute performance."""
        s = self.summary()
        log.info("Ingress offered: %s transactions", s["offered"])
        log.info("Ingress accepted: %s transactions", s["accepted"])
        log.info("Ingress shed: %s transactions", s["shed"])
        log.info(
            "Ingress client latency p50: %s ms", s["latency_ms"]["p50"]
        )
        log.info(
            "Ingress client latency p99: %s ms", s["latency_ms"]["p99"]
        )
        log.info("Ingress shed rate: %.2f %%", 100.0 * s["shed_rate"])
        return s


@dataclass(slots=True)
class IngressLoad:
    """Declarative ingress-load spec for chaos scenarios: the orchestrator
    boots one IngressPipeline + OpenLoopLoadGen per target node (seeded
    from the scenario's master seed, so replay stays bit-identical) and
    embeds each generator's summary in the report under `ingress`."""

    curve: ArrivalCurve
    duration: float
    clients: int = 4
    tx_bytes: int = 32
    targets: tuple[int, ...] | None = None  # node indices; None = all honest
    config: Callable[[], IngressConfig] = field(default=IngressConfig)
