"""The port's `node` binary (reference node/src/main.rs:16-92).

Subcommands:
  * keys --filename F                       -- generate a keypair file
  * run --keys K --committee C --store S [--parameters P]
        [--crypto torch|cpu|remote] [--device cuda|cpu] [--ingress]
        [--telemetry-port PORT]
  * deploy --nodes N [--crypto torch|cpu|remote] [--device cuda|cpu]
        [--crypto-crossover N] [--no-warmup] [--metrics-out PATH]
                                            -- the in-process local testbed

The port's copy of `hotstuff_tpu/node/main.py`. `--crypto` selects the
`CryptoBackend` every batch verification of the node goes through:
  * `torch` (the default): an in-process `TorchBackend` on the card
    (`--device cuda`, the default) or on the plain PyTorch kernels
    (`--device cpu`). Asking for the card on a host without one exits with
    an error; the node never falls back to the CPU. `--crypto-crossover N`
    sets its `crossover` and `committee_crossover` (default:
    `DEFAULT_CROSSOVERS`), `--crypto-sharded` splits batches over every
    visible GPU. The backend is warmed and the committee registered before
    the node boots, so no early round waits on a first launch; the metrics
    and the kernel launch counts are then zeroed, so they count the node's
    own run.
  * `cpu`: OpenSSL on the host (`CpuBackend`).
  * `remote`: a crypto sidecar at `--crypto-addr` (`RemoteBackend`),
    batches under `--crypto-crossover` (default 64) on the host.

`--metrics-out` writes the metrics registry's dump at exit (SIGTERM
included), with the kernel launch counts of `ops/_build.launches()` under
`launches`; `--trace-out` writes the flight recorder's dump, and arms the
anomaly watchdog's dumps beside it. A `METRICS {json}` line is logged
every `HOTSTUFF_METRICS_INTERVAL` seconds (default 5; 0 disables).
`--telemetry-port PORT` serves the live telemetry plane
(`utils/telemetry.py`) on 0.0.0.0:PORT, as the reference node does: a
delta snapshot of the registry every 5 s, the SLO burn evaluation over
the node's `LaneStats`, the device timeline's summary and the per-peer
link ledger, scraped with `telemetry.scrape_sync` or the reference's
`tools/telemetry_dash.py --poll`; the plane's last snapshots ride every
watchdog dump.
`--ingress` (or `ingress_enabled` in the mempool parameters) serves the
authenticated client ingress on front_port + `ingress_port_offset`
(signed transactions, admission, verification through the node's
backend) and the commit proofs of what it admitted on front_port +
`proofs_port_offset`; `python -m hotstuff_tpu_torch.loadgen` drives both.

`deploy --nodes N` is the reference's in-process testbed
(`hotstuff_tpu/node/main.py:104-150`): N nodes in this process, keys from
`random.Random(0)`, consensus on 127.0.0.1:7000+i, mempool on 7100+i, front
on 7200+i, stores at `.db_{i}/log` under the working directory, the
default consensus and mempool parameters, one commit drain a node. The
nodes share one process-wide backend, built as `run` builds it
(`make_node_backend`: the card's `TorchBackend` by default, no CPU
fallback) and warmed before they boot; no committee is registered, as the
reference's deploy registers none, so committee-tagged batches take the
generic kernels. `--metrics-out` and `HOTSTUFF_METRICS_INTERVAL` work as
for `run`; a `--crypto remote` deploy uses the sidecar at 127.0.0.1:9700.

Refused with an error, not ported: the reference's `--crypto tpu` (use
`torch`) and `HOTSTUFF_PROFILE`.
"""

from __future__ import annotations

import argparse
import asyncio
import atexit
import json
import logging
import os
import signal
import sys

from ..utils.logging import setup_logging

log = logging.getLogger("hotstuff.node")

# The reference's sidecar crossover default (`hotstuff_tpu/node/main.py`).
REMOTE_CROSSOVER = 64


def _cmd_keys(args) -> None:
    from .config import Secret

    Secret.new().write(args.filename)
    print(f"Wrote keypair to {args.filename}")


def make_node_backend(args):
    """The backend of `--crypto`, with its flags."""
    from ..crypto.backend import make_backend

    if args.crypto == "torch":
        kwargs = {}
        if args.crypto_crossover is not None:
            kwargs.update(crossover=args.crypto_crossover, committee_crossover=args.crypto_crossover)
        if args.crypto_sharded:
            kwargs["sharded"] = True
        else:
            kwargs["device"] = args.device
        return make_backend("torch", **kwargs)
    if args.crypto == "remote":
        host, port = args.crypto_addr.rsplit(":", 1)
        crossover = REMOTE_CROSSOVER if args.crypto_crossover is None else args.crypto_crossover
        return make_backend("remote", addr=(host, int(port)), crossover=crossover)
    return make_backend("cpu")


def install_node_backend(args):
    """Make the backend of `--crypto` (`make_node_backend`), install it as
    the process's, and warm it unless `--no-warmup`: the kernels are built
    and every bucket width run BEFORE the pacemaker can arm, since a first
    launch stalls early rounds past timeout_delay."""
    from ..crypto.backend import set_backend

    backend = make_node_backend(args)
    set_backend(backend)
    if not args.no_warmup:
        from ..crypto.remote import warmup_backend

        warmup_backend(backend)
    return backend


async def _run_node(args) -> None:
    from ..ops import _build
    from ..utils import metrics

    install_node_backend(args)
    node = make_node(args)
    # Committee registration at startup: validator keys become device-
    # resident tables, with the committee kernels run before the node
    # joins consensus. boot() re-asserts it (a no-op for the same keys).
    node.register_committee(warmup=not args.no_warmup)
    # The dump's metrics and launch counts (--metrics-out) are the node's
    # own run, not the warmup's.
    metrics.reset()
    _build.reset_launches()
    node.boot()
    if args.telemetry_port is not None:
        start_telemetry(node, args.keys, args.telemetry_port)
    await node.analyze_block()


# The reference testbed's base ports: consensus, mempool and front.
DEPLOY_PORTS = (7000, 7100, 7200)


def deploy_keys(n: int) -> list:
    """The testbed's keypairs: `generate_keypair` on `random.Random(0)`, in
    the reference's order."""
    import random

    from ..crypto import generate_keypair

    rng = random.Random(0)
    return [generate_keypair(rng) for _ in range(n)]


def deploy_committees(keys, consensus_port: int = DEPLOY_PORTS[0], mempool_port: int = DEPLOY_PORTS[1],
                      front_port: int = DEPLOY_PORTS[2]):
    """The testbed's consensus and mempool committees over `keys`: stake 1
    each, node i on 127.0.0.1 at consensus_port + i, mempool_port + i and
    front_port + i."""
    from ..consensus.config import Committee as ConsensusCommittee
    from ..mempool.config import MempoolCommittee

    consensus = ConsensusCommittee.new(
        [(pk, 1, ("127.0.0.1", consensus_port + i)) for i, (pk, _) in enumerate(keys)])
    mempool = MempoolCommittee.new(
        [(pk, ("127.0.0.1", front_port + i), ("127.0.0.1", mempool_port + i)) for i, (pk, _) in enumerate(keys)])
    return consensus, mempool


async def _deploy_testbed(args, consensus_port: int = DEPLOY_PORTS[0], mempool_port: int = DEPLOY_PORTS[1],
                          front_port: int = DEPLOY_PORTS[2]) -> None:
    """The in-process local testbed (`hotstuff_tpu/node/main.py:104-150`,
    node/src/main.rs:94-153): `args.nodes` nodes on one shared backend.
    Tests pass other base ports; the command line keeps the reference's."""
    from ..consensus import Consensus
    from ..consensus.config import Parameters
    from ..crypto import SignatureService
    from ..mempool import Mempool
    from ..mempool.config import MempoolParameters
    from ..ops import _build
    from ..store import Store
    from ..utils import metrics
    from ..utils.actors import channel

    install_node_backend(args)
    # The dump's metrics and launch counts (--metrics-out) are the
    # testbed's own run, not the warmup's.
    metrics.reset()
    _build.reset_launches()
    keys = deploy_keys(args.nodes)
    consensus_committee, mempool_committee = deploy_committees(keys, consensus_port, mempool_port, front_port)
    commits = []
    for i, (pk, sk) in enumerate(keys):
        store = Store(f".db_{i}/log")
        signer = SignatureService(sk)
        cm_channel = channel()
        core_channel = channel()
        commit_channel = channel()
        Mempool.run(pk, mempool_committee, MempoolParameters(), store, signer, cm_channel, core_channel)
        Consensus.run(pk, consensus_committee, Parameters(), store, signer, cm_channel, commit_channel,
                      core_channel=core_channel)
        commits.append(commit_channel)

    async def drain(ch):
        while True:
            await ch.get()

    await asyncio.gather(*(drain(c) for c in commits))


def make_node(args):
    """The `Node` of `run`'s files, with `--ingress` turning on
    `ingress_enabled` on top of the parameters file."""
    from .node import Node

    node = Node(args.committee, args.keys, args.store, args.parameters)
    if args.ingress:
        node.parameters.mempool.ingress_enabled = True
    return node


def start_telemetry(node, keys_path: str, port: int):
    """The node's live telemetry plane and its scrape endpoint on
    0.0.0.0:`port`, wired as the reference node wires them: the keys-file
    stem as the label, the node's `LaneStats`, the device timeline's
    summary, the per-peer link ledger, the watchdog's dump context; the
    server and the snapshot loop spawned on the running loop. Returns the
    plane and its server (bound on the loop's next pass)."""
    from ..network import net
    from ..ops import timeline
    from ..utils import telemetry
    from ..utils.actors import spawn

    plane = telemetry.TelemetryPlane(
        label=os.path.splitext(os.path.basename(keys_path))[0],
        lane_stats=node.verification_service.lane_stats,
        timeline_fn=timeline.summary,
        # One node a process, so the default vantage is this node's links.
        peers_fn=net.peer_snapshot,
    )
    plane.attach_watchdog()
    server = telemetry.TelemetryServer(("0.0.0.0", port), plane)
    server.launch()
    spawn(plane.run(), name="telemetry-plane")
    return plane, server


def metrics_dump() -> dict:
    """The `--metrics-out` dump: the registry's, with the kernel launch
    counts under `launches`."""
    from ..ops import _build
    from ..utils import metrics

    return {**metrics.dump(), "launches": _build.launches()}


def write_metrics(path: str) -> None:
    with open(path, "w") as f:
        json.dump(metrics_dump(), f, indent=2, sort_keys=True)
        f.write("\n")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """The command line, with what is not ported refused (exit 2)."""
    parser = argparse.ArgumentParser(prog="node", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-v", "--verbose", action="count", default=2)
    sub = parser.add_subparsers(dest="command", required=True)

    p_keys = sub.add_parser("keys", help="generate a keypair file")
    p_keys.add_argument("--filename", required=True)

    p_run = sub.add_parser("run", help="run a node")
    p_run.add_argument("--keys", required=True)
    p_run.add_argument("--committee", required=True)
    p_run.add_argument("--parameters", default=None)
    p_run.add_argument("--store", required=True)
    p_run.add_argument("--crypto", default="torch", choices=["torch", "cpu", "remote"])
    p_run.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="with --crypto torch: the card (default) or the plain PyTorch kernels")
    p_run.add_argument("--crypto-addr", default="127.0.0.1:9700",
                       help="sidecar address for --crypto remote (host:port)")
    p_run.add_argument("--crypto-crossover", type=int, default=None,
                       help="batches below this size verify on the host CPU (torch: default "
                       "DEFAULT_CROSSOVERS, for committee batches too; remote: default 64)")
    p_run.add_argument("--crypto-sharded", action="store_true",
                       help="with --crypto torch: split verification over every visible GPU; "
                       "committee registration replicates the tables onto each")
    p_run.add_argument("--ingress", action="store_true",
                       help="serve the authenticated client ingress on front_port + ingress_port_offset and "
                       "the commit proofs on front_port + proofs_port_offset; equivalent to ingress_enabled "
                       "in the mempool parameters")
    p_run.add_argument("--no-warmup", action="store_true",
                       help="skip running the kernels before joining consensus")
    p_run.add_argument("--telemetry-port", type=int, default=None, metavar="PORT",
                       help="serve the live telemetry plane (framed JSON scrapes) on this port")
    p_run.add_argument("--metrics-out", default=None,
                       help="write the metrics dump, with the kernel launch counts, to this path on exit/SIGTERM")
    p_run.add_argument("--trace-out", default=None,
                       help="write the flight-recorder dump to this path on exit/SIGTERM; watchdog dumps "
                       "land next to it as <path>.watchdog-<reason>-<n>.json")

    p_deploy = sub.add_parser("deploy", help="in-process local testbed")
    p_deploy.add_argument("--nodes", type=int, required=True)
    p_deploy.add_argument("--crypto", default="torch", choices=["torch", "cpu", "remote"])
    p_deploy.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                          help="with --crypto torch: the card (default) or the plain PyTorch kernels")
    p_deploy.add_argument("--crypto-crossover", type=int, default=None,
                          help="batches below this size verify on the host CPU (as for run)")
    p_deploy.add_argument("--no-warmup", action="store_true",
                          help="skip running the kernels before the nodes boot")
    p_deploy.add_argument("--metrics-out", default=None,
                          help="write the metrics dump, with the kernel launch counts, to this path on exit/SIGTERM")
    # The sidecar address and sharding are run's flags; deploy keeps the
    # reference's flag set and these defaults.
    p_deploy.set_defaults(crypto_addr="127.0.0.1:9700", crypto_sharded=False, trace_out=None)

    args = parser.parse_args(argv)
    if args.command in ("run", "deploy"):
        if args.device != "cuda" and args.crypto != "torch":
            parser.error("--device applies to --crypto torch only")
    if args.command == "deploy" and args.nodes < 1:
        parser.error("--nodes must be at least 1")
    if args.command == "run":
        if args.crypto_sharded and (args.crypto != "torch" or args.device != "cuda"):
            parser.error("--crypto-sharded requires --crypto torch on --device cuda")
    if args.command in ("run", "deploy"):
        if os.environ.get("HOTSTUFF_PROFILE"):
            parser.error("HOTSTUFF_PROFILE is not ported")
    return args


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    setup_logging(args.verbose)

    # GIL switch interval: a short one cuts the handoff between the event
    # loop and the verification worker threads (the reference's default).
    try:
        sys.setswitchinterval(float(os.environ.get("HOTSTUFF_SWITCH_INTERVAL", "0.001")))
    except ValueError:
        log.warning("ignoring malformed HOTSTUFF_SWITCH_INTERVAL")

    if args.command == "keys":
        _cmd_keys(args)
        return

    from ..utils import metrics

    try:
        interval = float(os.environ.get("HOTSTUFF_METRICS_INTERVAL", "5"))
    except ValueError:
        logging.getLogger("hotstuff.metrics").warning("ignoring malformed HOTSTUFF_METRICS_INTERVAL")
        interval = 5.0
    metrics.start_periodic_emitter(interval)

    # Exit-time flushers: the benchmark harness stops nodes with SIGTERM,
    # which skips atexit by default, so the hooks ride one SIGTERM handler
    # and one atexit.
    flushers = []
    if args.metrics_out:

        def _write_metrics():
            try:
                write_metrics(args.metrics_out)
            except OSError as e:
                logging.getLogger("hotstuff.metrics").warning("failed to write metrics dump: %r", e)

        flushers.append(_write_metrics)
    if args.trace_out:
        from ..utils import tracing

        # Label this process's events with the keys-file stem, so dumps of
        # several nodes stitch with stable names, and arm the watchdog's
        # dumps next to the exit dump.
        tracing.NODE_LABEL.set(os.path.splitext(os.path.basename(args.keys))[0])
        tracing.WATCHDOG.set_auto_dump(args.trace_out)

        def _write_trace():
            try:
                tracing.write_json(args.trace_out)
            except OSError as e:
                logging.getLogger("hotstuff.tracing").warning("failed to write trace dump: %r", e)

        flushers.append(_write_trace)
    # Drain the dispatch pipelines' workers on SIGTERM too: the handler
    # exits by os._exit, which skips the pipeline's own atexit hook.
    from ..ops.pipeline import close_all

    flushers.append(close_all)

    def _flush_all():
        for flush in flushers:
            flush()

    def _on_term(*_a):
        _flush_all()
        os._exit(0)

    signal.signal(signal.SIGTERM, _on_term)
    atexit.register(_flush_all)
    asyncio.run(_deploy_testbed(args) if args.command == "deploy" else _run_node(args))


if __name__ == "__main__":
    main()
