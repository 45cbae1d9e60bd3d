"""Benchmark load generator (reference node/src/client.rs:86-167).

Sends `--rate` transactions/sec of `--size` bytes to a node's front port in
bursts on a 50 ms tick. The FIRST transaction of each burst is a "sample":
a zero byte, a big-endian u64 counter, then zero padding -- the LogParser
joins sample ids to payload digests to commit timestamps for end-to-end
latency. Other transactions start with 0x01 followed by random bytes.
Before sending, waits until all `--nodes` addresses are TCP-reachable.

The port's copy of `hotstuff_tpu/node/client.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import struct
import time

from ..network.net import frame
from ..utils.logging import setup_logging

log = logging.getLogger("hotstuff.client")

BURST_INTERVAL = 0.05  # 50 ms ticks (client.rs:115)


async def wait_for_nodes(addresses: list[tuple[str, int]]) -> None:
    """Block until every node's consensus port accepts connections
    (client.rs:96-112)."""
    for host, port in addresses:
        while True:
            try:
                _, w = await asyncio.open_connection(host, port)
                w.close()
                break
            except OSError:
                await asyncio.sleep(0.1)


async def run_client(
    target: tuple[str, int],
    size: int,
    rate: int,
    nodes: list[tuple[str, int]],
    duration: float | None = None,
) -> None:
    if size < 9:
        raise ValueError("transaction size must be at least 9 bytes")
    # NOTE: these log entries are used to compute performance.
    log.info("Transactions size: %s B", size)
    log.info("Transactions rate: %s tx/s", rate)
    if nodes:
        log.info("Waiting for all nodes to be online...")
        await wait_for_nodes(nodes)

    reader, writer = await asyncio.open_connection(target[0], target[1])
    burst = max(1, int(rate * BURST_INTERVAL))
    counter = 0
    rnd = os.urandom(size - 9)
    # Monotonic per-tx tag so every client (and every burst) sends distinct
    # transactions — payload digests must not collide (client.rs:130).
    tx_tag = int.from_bytes(os.urandom(8), "big")
    log.info("Start sending transactions")
    start = time.monotonic()
    next_tick = start
    while duration is None or (time.monotonic() - start) < duration:
        t0 = time.monotonic()
        for x in range(burst):
            if x == 0:
                # Sample transaction: 0x00 + u64 counter + padding.
                tx = b"\x00" + struct.pack(">Q", counter) + bytes(size - 9)
                # NOTE: This log entry is used to compute performance.
                log.info("Sending sample transaction %s", counter)
            else:
                tx_tag = (tx_tag + 1) & 0xFFFFFFFFFFFFFFFF
                tx = b"\x01" + struct.pack(">Q", tx_tag) + rnd
            writer.write(frame(tx))
        await writer.drain()
        counter += 1
        next_tick += BURST_INTERVAL
        now = time.monotonic()
        if now > next_tick:
            log.warning("rate too high for this client")
            next_tick = now
        else:
            await asyncio.sleep(next_tick - now)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="client", description=__doc__)
    parser.add_argument("-v", "--verbose", action="count", default=2)
    parser.add_argument("target", help="front address host:port of the target node")
    parser.add_argument("--size", type=int, required=True, help="tx size in bytes")
    parser.add_argument("--rate", type=int, required=True, help="tx per second")
    parser.add_argument(
        "--nodes",
        nargs="*",
        default=[],
        help="consensus addresses to wait for before sending",
    )
    parser.add_argument("--duration", type=float, default=None, help="seconds to run")
    args = parser.parse_args(argv)
    if args.size < 9:
        parser.error("--size must be at least 9 bytes (sample tx header)")
    setup_logging(args.verbose)

    def parse(s: str) -> tuple[str, int]:
        host, port = s.rsplit(":", 1)
        return (host, int(port))

    asyncio.run(
        run_client(
            parse(args.target),
            args.size,
            args.rate,
            [parse(n) for n in args.nodes],
            args.duration,
        )
    )


if __name__ == "__main__":
    main()
