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
  * The client plane: the mixed committee with `ingress_enabled` on every
    node; signed transactions submitted to a port node's ingress port and
    to a reference node's come back from each node's proof port as commit
    proofs that both packages' `CommitProof.verify` accept.
  * The entry point: `python -m hotstuff_tpu_torch.node.main run --crypto
    torch` asks for the card, so on a host without one it exits non-zero,
    and never falls back to the CPU; `--ingress` turns the client plane on;
    `aggregate_certs` and `deploy` are taken; what is not ported is
    refused; `HOTSTUFF_PROFILE` dumps cProfile stats at SIGTERM.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import os
import random
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke

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
from hotstuff_tpu_torch.utils.serde import Reader
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


# This file's committees listen on ports that no other test and no outgoing
# connection can hold: below Linux's ephemeral range (32,768 and up), where
# a connect() of any process on the host may take a node's port as its
# source port, and below the 11,000 and up of tests/conftest.py's
# `base_port`, whose blocks (keyed by pid % 500) overlap between xdist
# workers. Each worker has its own range, and a block is handed out only
# when every port of it binds (the receivers bind 0.0.0.0 with
# SO_REUSEADDR, as the probe does).
PORTS_FROM, WORKER_PORTS, BLOCK_PORTS = 4_000, 500, 20
_blocks = itertools.count()


def _binds(port: int) -> bool:
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("0.0.0.0", port))
        except OSError:
            return False
    return True


@pytest.fixture
def base_port():
    """The first of BLOCK_PORTS free ports in this worker's range (this
    file's own `base_port`, in place of tests/conftest.py's)."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    lo = PORTS_FROM + int(worker.removeprefix("gw") or 0) % 6 * WORKER_PORTS
    for _ in range(WORKER_PORTS // BLOCK_PORTS):
        base = lo + next(_blocks) % (WORKER_PORTS // BLOCK_PORTS) * BLOCK_PORTS
        if all(_binds(p) for p in range(base, base + BLOCK_PORTS)):
            return base
    raise RuntimeError(f"no block of {BLOCK_PORTS} free ports in [{lo}, {lo + WORKER_PORTS})")


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


def _node_files(tmp_path, parameters: dict) -> tuple[str, str, str]:
    """A key, a committee of that one key and a parameters file: their
    paths."""
    from hotstuff_tpu_torch.node.config import Secret

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
    params.write_text(json.dumps(parameters))
    return str(key), str(committee), str(params)


@pytest.mark.parametrize("section, option", [("consensus", "aggregate_certs")])
def test_node_refuses_parameters_that_are_not_ported(tmp_path, run_async, base_port, section, option):
    """Since the aggregate-certificate plane is ported, a parameters file
    that turns on `aggregate_certs` is taken as the reference's node takes
    it: both packages' `Node` read it, and a mixed committee with it on
    commits the same blocks. A node has no aggregate signer, so neither
    package emits an aggregate vote or timeout and no AggQC forms."""
    from hotstuff_tpu.node.node import Node as RNode
    from hotstuff_tpu_torch.node.node import Node

    key, committee, params = _node_files(tmp_path, {section: {option: True}})
    for node in (Node(committee, key, str(tmp_path / "db"), params),
                 RNode(committee, key, str(tmp_path / "rdb"), params)):
        assert getattr(node.parameters.consensus, option) is True
    before = metrics.REGISTRY.counter("agg.qcs_formed").value
    _mixed_committee(run_async, base_port, **{option: True})
    assert metrics.REGISTRY.counter("agg.qcs_formed").value == before


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


def _run_node_of_one(tmp_path, base_port, *extra: str, env: dict | None = None) -> int:
    """`node.main run --crypto cpu` as a process, a committee of one, until
    it commits, then SIGTERM; returns its pid."""
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
             "--crypto", "cpu", *extra],
            cwd=REPO, stdout=out, stderr=subprocess.STDOUT, env=None if env is None else {**os.environ, **env})
    try:
        deadline = time.monotonic() + 120
        while "Committed B" not in log.read_text() and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.2)
        assert "Committed B" in log.read_text(), log.read_text()[-3000:]
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(30)
    assert proc.returncode == 0
    return proc.pid


def test_node_cli_commits_and_dumps_at_sigterm(tmp_path, base_port):
    """`node.main run --crypto cpu` as a process, a committee of one: it
    boots, commits, and on SIGTERM writes its metrics dump with the
    launch counts (none: OpenSSL verifies) and its trace dump."""
    _run_node_of_one(tmp_path, base_port, "--metrics-out", str(tmp_path / "metrics.json"),
                     "--trace-out", str(tmp_path / "trace.json"))
    dump = json.loads((tmp_path / "metrics.json").read_text())
    assert dump["counters"]["consensus.commits"] > 0
    assert set(dump["launches"]) == set(_build.KERNELS) and not any(dump["launches"].values())
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["node"] == "node" and trace["recorded"] > 0


def test_node_profile_dumps_its_stats_at_sigterm(tmp_path, base_port):
    """`HOTSTUFF_PROFILE=<path>`: the node runs under cProfile and, on
    SIGTERM, dumps the stats to `<path>.<pid>`, which `pstats` loads with
    the node's own consensus code among the profiled functions."""
    import pstats

    prefix = tmp_path / "node.prof"
    pid = _run_node_of_one(tmp_path, base_port, env={"HOTSTUFF_PROFILE": str(prefix)})
    assert [p.name for p in tmp_path.glob("node.prof*")] == [f"node.prof.{pid}"]
    stats = pstats.Stats(str(tmp_path / f"node.prof.{pid}"))
    files = {fn for fn, _line, _name in stats.stats}
    assert any("hotstuff_tpu_torch/consensus/" in f for f in files)
    assert stats.total_calls > 0


@pytest.mark.parametrize("argv, said", [
    (["run", "--crypto", "cpu", "--device", "cpu"], "--device applies to --crypto torch only"),
    (["run", "--crypto", "cpu", "--crypto-sharded"], "--crypto-sharded requires --crypto torch"),
    (["run", "--crypto", "tpu"], "invalid choice: 'tpu'"),
    (["deploy", "--nodes", "4", "--crypto", "cpu", "--device", "cpu"], "--device applies to --crypto torch only"),
    (["deploy", "--nodes", "0"], "--nodes must be at least 1"),
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


def test_mixed_committee_serves_ingress_and_commit_proofs(run_async):
    """The mixed committee (nodes 0, 1 the reference's, 2, 3 the port's) with
    `ingress_enabled` and a proof registry on every node. Signed client
    transactions go to port node 2's ingress port (the port's client) and
    to reference node 0's (the reference's client); each node's proof port
    serves their commit proofs, and both packages' `CommitProof.verify`
    accept every proof, whichever node served it. The nodes commit equal
    digests wherever two commit a round."""
    from hotstuff_tpu import ingress as r_ingress
    from hotstuff_tpu import proofs as r_proofs
    from hotstuff_tpu.crypto import backend as r_backend
    from hotstuff_tpu.utils import serde as r_serde
    from hotstuff_tpu_torch import ingress, proofs
    from hotstuff_tpu_torch.crypto import backend as p_backend

    n = 4
    keys = _keys(n, 21)
    others = chip_smoke._free_ports(2 * n)
    fronts = chip_smoke.free_ports_with_offsets(n, avoid=others)  # ingress and proof ports free too
    addr = lambda p: ("127.0.0.1", p)  # noqa: E731
    ref_cc = RCommittee.new([(pk, 1, addr(others[n + i])) for i, (pk, _) in enumerate(keys)])
    ref_mc = RMempoolCommittee.new([(pk, addr(fronts[i]), addr(others[i])) for i, (pk, _) in enumerate(keys)])
    port_cc = Committee.from_json(ref_cc.to_json())
    port_mc = MempoolCommittee.from_json(ref_mc.to_json())
    # (package, client seed, node) of each client: the port's at port node
    # 2, the reference's at reference node 0.
    clients = (("port", b"\x0b" * 32, 2), ("ref", b"\x0c" * 32, 0))
    txs_each = 6

    async def body():
        commit_channels, registries = [], []
        for i, (pk, sk) in enumerate(keys):
            cm, core, commit = (r_channel(), r_channel(), r_channel()) if i < 2 else (channel(), channel(), channel())
            commit_channels.append(commit)
            if i < 2:
                sig, store = RSignatureService(sk), RStore()
                reg = r_proofs.ProofRegistry(store=store)
                RMempool.run(pk, ref_mc, RMempoolParameters(max_payload_size=256, min_block_delay=10,
                                                            ingress_enabled=True), store, sig, cm, core,
                             proof_registry=reg)
                RConsensus.run(pk, ref_cc, RParameters(timeout_delay=1_000, min_block_delay=10), store, sig, cm,
                               commit, core_channel=core, proof_registry=reg)
            else:
                ppk, psk = PublicKey(pk.data), SecretKey(sk.data)
                sig, store = SignatureService(psk), Store()
                reg = proofs.ProofRegistry(store=store)
                service = BatchVerificationService(CpuBackend())
                Mempool.run(ppk, port_mc, MempoolParameters(max_payload_size=256, min_block_delay=10,
                                                            ingress_enabled=True), store, sig, cm, core,
                            verification_service=service, proof_registry=reg)
                Consensus.run(ppk, port_cc, Parameters(timeout_delay=1_000, min_block_delay=10), store, sig, cm,
                              commit, core_channel=core, verification_service=service, proof_registry=reg)
            registries.append(reg)
        committed: list[list] = [[] for _ in range(n)]

        async def drain(i):
            while True:
                committed[i].append(await commit_channels[i].get())

        drains = [asyncio.ensure_future(drain(i)) for i in range(n)]
        await asyncio.sleep(0.3)
        served = []
        for pkg, seed, node in clients:
            ing, prf = (ingress, proofs) if pkg == "port" else (r_ingress, r_proofs)
            client = ing.IngressClient()
            await client.connect(("127.0.0.1", fronts[node] + 1_000))
            txs = [ing.ClientTransaction.new_signed(seed, nonce, 1, b"\x01" + bytes([nonce]) * 40)
                   for nonce in range(1, txs_each + 1)]
            statuses = await asyncio.gather(*(client.submit(tx) for tx in txs))
            assert [r.status_name for r in statuses] == ["accepted"] * txs_each, (pkg, statuses)
            client.close()
            proof_client = prf.ProofClient()
            await proof_client.connect(("127.0.0.1", fronts[node] + 2_000))
            replies = await asyncio.gather(*(proof_client.query(prf.ProofQuery(tx.client, tx.nonce,
                                                                               prf.MODE_SUBSCRIBE))
                                             for tx in txs))
            proof_client.close()
            assert [r.status_name for r in replies] == ["ok"] * txs_each, (pkg, replies)
            served += [(pkg, node, prf.encode_proof_message(r)) for r in replies]
        for d in drains:
            d.cancel()
        return served, committed, [reg.stats["mismatch"] for reg in registries]

    prev_port, prev_ref = p_backend.set_backend(CpuBackend()), r_backend.set_backend(r_backend.CpuBackend())
    try:
        served, committed, mismatches = run_async(body(), timeout=120)
        assert len(served) == 2 * txs_each and mismatches == [0] * n
        for pkg, node, wire in served:
            ours = proofs.decode_proof_message(wire).proof
            theirs = r_proofs.decode_proof_message(wire).proof
            ours.verify(port_cc)
            theirs.verify(ref_cc)
            w = r_serde.Writer()
            theirs.encode(w)
            assert proofs.CommitProof.decode(Reader(w.bytes())) == ours
    finally:
        p_backend.set_backend(prev_port)
        r_backend.set_backend(prev_ref)
    by_round: dict[int, set] = {}
    for blocks in committed:
        for b in blocks:
            by_round.setdefault(b.round, set()).add(b.digest().data)
    assert all(committed) and all(len(d) == 1 for d in by_round.values()), by_round


def test_node_run_accepts_ingress(tmp_path):
    """`run --ingress` parses and turns `ingress_enabled` on over a
    parameters file that leaves it off."""
    from hotstuff_tpu_torch.node import main as node_main

    key, committee, params = _node_files(tmp_path, {"mempool": {"ingress_enabled": False}})
    base = ["run", "--keys", key, "--committee", committee, "--store", str(tmp_path / "db"), "--parameters", params]
    assert not node_main.make_node(node_main.parse_args(base)).parameters.mempool.ingress_enabled
    args = node_main.parse_args([*base, "--ingress"])
    assert args.ingress and node_main.make_node(args).parameters.mempool.ingress_enabled
    _, _, on = _node_files(tmp_path, {"mempool": {"ingress_enabled": True}})
    assert node_main.make_node(node_main.parse_args([*base[:-1], on])).parameters.mempool.ingress_enabled


def test_node_still_refuses_aggregate_certs_and_deploy(tmp_path, capsys):
    """Since the aggregate-certificate plane and the testbed are ported,
    with the client plane on, aggregate certificates in the parameters
    and the `deploy` subcommand are taken, no longer refused: the node is
    made with both planes on, and `deploy` parses to the reference's flag
    set with `run`'s backend defaults (the card's `TorchBackend`)."""
    from hotstuff_tpu_torch.node import main as node_main

    key, committee, params = _node_files(tmp_path, {"mempool": {"ingress_enabled": True},
                                                    "consensus": {"aggregate_certs": True}})
    args = node_main.parse_args(["run", "--keys", key, "--committee", committee, "--store", str(tmp_path / "db"),
                                 "--parameters", params, "--ingress"])
    node = node_main.make_node(args)
    assert node.parameters.consensus.aggregate_certs and node.parameters.mempool.ingress_enabled
    args = node_main.parse_args(["deploy", "--nodes", "4"])
    assert (args.command, args.nodes, args.crypto, args.device, args.crypto_crossover, args.no_warmup,
            args.metrics_out) == ("deploy", 4, "torch", "cuda", None, False, None)
    assert capsys.readouterr().err == ""
