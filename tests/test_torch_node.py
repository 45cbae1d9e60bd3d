"""The port's node (`hotstuff_tpu_torch/node/`, `consensus/`, `mempool/`,
`network/`, `store/`) against the reference's.

  * A mixed committee: two reference nodes and two port nodes over
    localhost TCP, in the manner of `tests/test_node_e2e.py`, on OpenSSL
    backends, each with a client; all four commit, and where two commit
    the same round the digests agree.
  * The seam: the port's `BatchVerificationService` over
    `TorchBackend(device="cpu", crossover=1)` with the committee
    registered takes one synthetic mempool batch on the generic plain
    kernels (K2, K3, K1, K4) and one QC on the committee plain kernels
    (K2g, K5, K4).
  * The entry point: `python -m hotstuff_tpu_torch.node.main run --crypto
    torch` asks for the card, so on a host without one it exits non-zero,
    and never falls back to the CPU; what is not ported is refused.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytest.importorskip("cryptography")

from hotstuff_tpu.consensus import Consensus as RConsensus
from hotstuff_tpu.consensus import Parameters as RParameters
from hotstuff_tpu.consensus.config import Committee as RCommittee
from hotstuff_tpu.crypto import SignatureService as RSignatureService
from hotstuff_tpu.crypto import generate_keypair as r_generate_keypair
from hotstuff_tpu.mempool import Mempool as RMempool
from hotstuff_tpu.mempool import MempoolCommittee as RMempoolCommittee
from hotstuff_tpu.mempool import MempoolParameters as RMempoolParameters
from hotstuff_tpu.node.client import run_client as r_run_client
from hotstuff_tpu.store import Store as RStore
from hotstuff_tpu.utils.actors import channel as r_channel
from hotstuff_tpu.utils.actors import spawn as r_spawn
from hotstuff_tpu_torch.consensus import Consensus, Parameters
from hotstuff_tpu_torch.consensus.config import Committee
from hotstuff_tpu_torch.consensus.messages import QC, Vote
from hotstuff_tpu_torch.crypto import Digest, PublicKey, SecretKey, SignatureService
from hotstuff_tpu_torch.crypto.backend import CpuBackend
from hotstuff_tpu_torch.crypto.batch_service import BatchVerificationService
from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
from hotstuff_tpu_torch.mempool import Mempool, MempoolCommittee, MempoolParameters
from hotstuff_tpu_torch.mempool.core import SyntheticPool
from hotstuff_tpu_torch.node.client import run_client
from hotstuff_tpu_torch.ops import _build
from hotstuff_tpu_torch.ops import committee as ops_committee
from hotstuff_tpu_torch.ops import ed25519 as ops_ed25519
from hotstuff_tpu_torch.ops import ladder as ops_ladder
from hotstuff_tpu_torch.ops import sha512 as ops_sha512
from hotstuff_tpu_torch.store import Store
from hotstuff_tpu_torch.utils import metrics
from hotstuff_tpu_torch.utils.actors import channel
from tests.common_torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
GENERIC = {"h_digits", "decompress_table", "ladder", "compress_eq"}
COMMITTEE = {"h_digits_idx", "committee_ladder", "compress_eq"}
# Each kernel's plain version, which its wrapper calls on CPU tensors, by
# the kernel's name in `ops/_build.py`.
PLAIN = {
    "h_digits": (ops_sha512, "h_digits_plain"),
    "h_digits_idx": (ops_sha512, "h_digits_gather_plain"),
    "decompress_table": (ops_ed25519, "decompress_table_plain"),
    "ladder": (ops_ladder, "ladder_plain"),
    "committee_ladder": (ops_committee, "committee_ladder_plain"),
    "compress_eq": (ops_ed25519, "compress_eq_plain"),
}


def _keys(n: int, seed: int):
    rng = random.Random(seed)
    return [r_generate_keypair(rng) for _ in range(n)]


def _mixed_committee(run_async, base_port, **consensus):
    """Nodes 0 and 1 are the reference's, nodes 2 and 3 the port's, over
    localhost TCP, each package's consensus `Parameters` given
    `consensus`; every node commits payload-carrying blocks, and the
    digests agree wherever two nodes commit one round."""
    n = 4
    keys = _keys(n, int(os.environ.get("HOTSTUFF_TEST_SEED", "20")))

    def addr(i):
        return ("127.0.0.1", base_port + i)

    ref_cc = RCommittee.new([(pk, 1, addr(2 * n + i)) for i, (pk, _) in enumerate(keys)])
    ref_mc = RMempoolCommittee.new([(pk, addr(i), addr(n + i)) for i, (pk, _) in enumerate(keys)])
    port_cc = Committee.from_json(ref_cc.to_json())
    port_mc = MempoolCommittee.from_json(ref_mc.to_json())
    assert port_cc.to_json() == ref_cc.to_json() and port_mc.to_json() == ref_mc.to_json()

    async def body():
        commit_channels = []
        for i, (pk, sk) in enumerate(keys):
            cm, core, commit = (r_channel(), r_channel(), r_channel()) if i < 2 else (channel(), channel(), channel())
            commit_channels.append(commit)
            if i < 2:
                sig = RSignatureService(sk)
                store = RStore()
                RMempool.run(pk, ref_mc, RMempoolParameters(max_payload_size=256, min_block_delay=10), store, sig,
                             cm, core)
                RConsensus.run(pk, ref_cc, RParameters(timeout_delay=1_000, min_block_delay=10, **consensus), store,
                               sig, cm, commit, core_channel=core)
            else:
                ppk, psk = PublicKey(pk.data), SecretKey(sk.data)
                sig = SignatureService(psk)
                store = Store()
                service = BatchVerificationService(CpuBackend())
                Mempool.run(ppk, port_mc, MempoolParameters(max_payload_size=256, min_block_delay=10), store, sig,
                            cm, core, verification_service=service)
                Consensus.run(ppk, port_cc, Parameters(timeout_delay=1_000, min_block_delay=10, **consensus), store,
                              sig, cm, commit, core_channel=core, verification_service=service)
        await asyncio.sleep(0.2)
        for i in range(n):
            client = r_run_client if i < 2 else run_client
            r_spawn(client(addr(i), size=64, rate=200, nodes=[], duration=30.0))

        async def commits(ch, want: int):
            """Blocks until `want` payload-carrying blocks committed."""
            got = []
            while len(got) < want:
                block = await ch.get()
                if block.payload:
                    got.append(block)
            return got

        return await asyncio.wait_for(asyncio.gather(*(commits(c, 3) for c in commit_channels)), 90)

    per_node = run_async(body(), timeout=120)
    by_round: dict[int, set] = {}
    for blocks in per_node:
        for b in blocks:
            by_round.setdefault(b.round, set()).add(b.digest().data)
    assert all(len(d) == 1 for d in by_round.values()), by_round
    # Reference and port nodes committed some round in common.
    ref_rounds = {b.round for node in per_node[:2] for b in node}
    port_rounds = {b.round for node in per_node[2:] for b in node}
    assert ref_rounds & port_rounds


def test_mixed_committee_commits_the_same_blocks(run_async, base_port):
    _mixed_committee(run_async, base_port)


def test_mixed_committee_commits_the_same_blocks_over_the_aggregation_overlay(run_async, base_port):
    """The same, with every node's votes and timeouts riding the
    aggregation tree (`aggregation_overlay`) as partial bundles."""
    before = metrics.REGISTRY.counter("agg.bundles_sent").value
    _mixed_committee(run_async, base_port, aggregation_overlay=True)
    assert metrics.REGISTRY.counter("agg.bundles_sent").value > before


@pytest.mark.parametrize("option", [{"leader_collector": True}, {"probe_interval_ms": 100},
                                    {"region_aware_election": True}], ids=lambda o: next(iter(o)))
def test_mixed_committee_commits_the_same_blocks_with_an_option_on(run_async, base_port, option):
    """The same with the rest of the consensus options that are off by
    default: votes collected at the round's own leader, which hands the QC
    to the next; round-trip probes between the nodes; region-aware
    election, whose schedule with no region map is round-robin in both
    packages."""
    _mixed_committee(run_async, base_port, **option)


@pytest.mark.parametrize("section, option", [("consensus", "aggregate_certs"), ("mempool", "ingress_enabled")])
def test_node_refuses_parameters_that_are_not_ported(tmp_path, section, option):
    """A parameters file that turns on an option the port leaves out stops
    the node before it boots; `Consensus.run` refuses the consensus ones."""
    from hotstuff_tpu_torch.node.config import ConfigError, Secret
    from hotstuff_tpu_torch.node.node import Node

    key = tmp_path / "node.json"
    Secret.new().write(str(key))
    name = json.loads(key.read_text())["name"]
    committee = tmp_path / "committee.json"
    committee.write_text(json.dumps({
        "consensus": {"epoch": 1, "authorities": {name: {"stake": 1, "address": "127.0.0.1:1"}}},
        "mempool": {"epoch": 1, "authorities": {name: {
            "front_address": "127.0.0.1:2", "mempool_address": "127.0.0.1:3"}}},
    }))
    params = tmp_path / "parameters.json"
    params.write_text(json.dumps({section: {option: True}}))
    with pytest.raises(ConfigError, match=f"{option} is not ported"):
        Node(str(committee), str(key), str(tmp_path / "db"), str(params))
    if section == "consensus":
        with pytest.raises(ValueError, match=f"{option} is not ported"):
            Consensus.run(PublicKey(bytes(32)), Committee.new([]), Parameters(**{option: True}), None,
                          None, channel(), channel())


def test_service_routes_synthetic_load_and_qcs_to_their_kernels(run_async, monkeypatch):
    """One synthetic mempool batch takes the generic plain kernels, one QC
    the committee plain kernels, through the service a node builds."""
    calls: dict[str, int] = {}
    depth = [0]

    def counted(name, fn):
        def plain(*args):
            # Only the wrapper's own call counts, not a plain version that
            # another calls (K2g's calls K2's).
            if depth[0] == 0:
                calls[name] = calls.get(name, 0) + 1
            depth[0] += 1
            try:
                return fn(*args)
            finally:
                depth[0] -= 1
        return plain

    for name, (module, attr) in PLAIN.items():
        monkeypatch.setattr(module, attr, counted(name, getattr(module, attr)))
    keys = _keys(4, 3)
    backend = TorchBackend(device="cpu", crossover=1, min_bucket=8, max_bucket=8, chunk=8)
    backend.register_committee(sorted(PublicKey(pk.data) for pk, _ in keys))
    pool = SyntheticPool(6, seed=5)
    digest = Digest.of(b"block")
    votes = [Vote.new_from_key(digest, 3, PublicKey(pk.data), SecretKey(sk.data)) for pk, sk in keys[:3]]
    qc = QC(digest, 3, tuple((v.author, v.signature) for v in votes))

    async def body():
        service = BatchVerificationService(backend)
        msgs, pairs = pool.take(6)
        mask = await service.verify_group(msgs, pairs, urgent=False, dedup=False, source="mempool")
        generic = set(calls)
        calls.clear()
        committee_sigs = backend.stats["committee_sigs"]
        await qc.verify_async(Committee.new([(PublicKey(pk.data), 1, ("127.0.0.1", 1)) for pk, _ in keys]), service)
        return mask, generic, set(calls), backend.stats["committee_sigs"] - committee_sigs

    mask, generic, committee, committee_sigs = run_async(body(), timeout=600)
    assert mask == [True] * 6
    assert generic == GENERIC
    assert committee == COMMITTEE
    assert committee_sigs == 3


def _node(*args, timeout=120):
    return subprocess.run([sys.executable, "-m", "hotstuff_tpu_torch.node.main", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a host without a card")
def test_node_asks_for_the_card_and_never_falls_back(tmp_path):
    key = tmp_path / "node.json"
    assert _node("keys", "--filename", str(key)).returncode == 0
    secret = json.loads(key.read_text())
    committee = tmp_path / "committee.json"
    committee.write_text(json.dumps({
        "consensus": {"epoch": 1, "authorities": {secret["name"]: {"stake": 1, "address": "127.0.0.1:1"}}},
        "mempool": {"epoch": 1, "authorities": {secret["name"]: {
            "front_address": "127.0.0.1:2", "mempool_address": "127.0.0.1:3"}}},
    }))
    proc = _node("run", "--keys", str(key), "--committee", str(committee), "--store", str(tmp_path / "db"),
                 "--crypto", "torch", timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "successfully booted" not in proc.stderr


def test_node_cli_commits_and_dumps_at_sigterm(tmp_path, base_port):
    """`node.main run --crypto cpu` as a process, a committee of one: it
    boots, commits, and on SIGTERM writes its metrics dump with the
    launch counts (none: OpenSSL verifies) and its trace dump."""
    import signal
    import time

    key = tmp_path / "node.json"
    assert _node("keys", "--filename", str(key)).returncode == 0
    name = json.loads(key.read_text())["name"]
    ports = [base_port, base_port + 1, base_port + 2]
    committee = tmp_path / "committee.json"
    committee.write_text(json.dumps({
        "consensus": {"epoch": 1, "authorities": {name: {"stake": 1, "address": f"127.0.0.1:{ports[0]}"}}},
        "mempool": {"epoch": 1, "authorities": {name: {
            "front_address": f"127.0.0.1:{ports[1]}", "mempool_address": f"127.0.0.1:{ports[2]}"}}},
    }))
    params = tmp_path / "parameters.json"
    params.write_text(json.dumps({"consensus": {"timeout_delay": 1_000, "min_block_delay": 10}}))
    log = tmp_path / "node.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "hotstuff_tpu_torch.node.main", "-vv", "run", "--keys", str(key),
             "--committee", str(committee), "--store", str(tmp_path / "db" / "log"), "--parameters", str(params),
             "--crypto", "cpu", "--metrics-out", str(tmp_path / "metrics.json"),
             "--trace-out", str(tmp_path / "trace.json")],
            cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while "Committed B" not in log.read_text() and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.2)
        assert "Committed B" in log.read_text(), log.read_text()[-3000:]
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(30)
    assert proc.returncode == 0
    dump = json.loads((tmp_path / "metrics.json").read_text())
    assert dump["counters"]["consensus.commits"] > 0
    assert set(dump["launches"]) == set(_build.KERNELS) and not any(dump["launches"].values())
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["node"] == "node" and trace["recorded"] > 0


@pytest.mark.parametrize("argv, said", [
    (["run", "--ingress"], "--ingress is not ported"),
    (["run", "--crypto", "cpu", "--device", "cpu"], "--device applies to --crypto torch only"),
    (["run", "--crypto", "cpu", "--crypto-sharded"], "--crypto-sharded requires --crypto torch"),
    (["run", "--crypto", "tpu"], "invalid choice: 'tpu'"),
    (["deploy", "--nodes", "4"], "deploy subcommand is not ported"),
])
def test_node_refuses_what_is_not_ported(argv, said, capsys):
    from hotstuff_tpu_torch.node import main as node_main

    if argv[0] == "run":
        argv = [*argv[:1], "--keys", "k", "--committee", "c", "--store", "s", *argv[1:]]
    with pytest.raises(SystemExit) as exit_:
        node_main.parse_args(argv)
    assert exit_.value.code == 2 and said in capsys.readouterr().err


def test_node_serves_its_telemetry_plane(run_async):
    """`run --telemetry-port` is accepted, and the plane the node starts
    (its keys-file stem as the label, its service's lanes, the device
    timeline, the peer ledger, the watchdog's dump context) answers the
    reference's scrape over localhost TCP, on the reference's wire."""
    import types

    from hotstuff_tpu.utils import telemetry as ref_telemetry
    from hotstuff_tpu_torch.node import main as node_main
    from hotstuff_tpu_torch.utils import tracing

    args = node_main.parse_args(["run", "--keys", "k", "--committee", "c", "--store", "s", "--telemetry-port", "0"])
    assert args.telemetry_port == 0

    async def body():
        service = BatchVerificationService(CpuBackend())
        service.lane_stats.note("consensus", 0.001)
        node = types.SimpleNamespace(verification_service=service)
        plane, server = node_main.start_telemetry(node, "keys/node-3.json", 0)
        try:
            for _ in range(500):  # the server binds on the loop's next pass
                if server._server is not None:
                    break
                await asyncio.sleep(0.01)
            plane.snapshot(1.0)
            assert tracing.WATCHDOG.context()["telemetry"]["node-3"] == plane.snapshots()
            return await ref_telemetry.scrape(("127.0.0.1", server.port))
        finally:
            plane.detach_watchdog()
            server._server.close()

    dump = run_async(body(), timeout=30)
    assert dump["kind"] == "telemetry" and dump["node"] == "node-3"
    assert dump["lanes"]["consensus"]["count"] == 1 and len(dump["snapshots"]) == 1
    assert isinstance(dump["device"], dict) and isinstance(dump["peers"], dict)
