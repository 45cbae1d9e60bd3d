"""The port's in-process testbed (`python -m hotstuff_tpu_torch.node.main
deploy`) against the reference's (`hotstuff_tpu/node/main.py:104-150`).

  * The committee: the same keypairs from `random.Random(0)` and the same
    consensus, mempool and front addresses as the reference's testbed
    builds (its body is replayed here, the reference's deploy never
    booted).
  * Four deploy nodes on OpenSSL (`--crypto cpu`), on free base ports,
    commit the same blocks within a few seconds: every round one digest,
    committed by all four (`chip_smoke.deploy_commit_errors`).
  * `--crypto torch --device cpu --crypto-crossover 1` sends every lane to
    the plain kernels (`crypto.tpu_sigs`), none to the host.
  * The default, `--crypto torch` on `--device cuda`, exits non-zero on a
    host without a card before any node boots.
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import chip_smoke

pytest.importorskip("cryptography")

from hotstuff_tpu.consensus.config import Committee as RCommittee
from hotstuff_tpu.crypto import generate_keypair as r_generate_keypair
from hotstuff_tpu.mempool.config import MempoolCommittee as RMempoolCommittee
from hotstuff_tpu_torch.node import main as node_main

REPO = Path(__file__).resolve().parents[1]

# Runs `node.main` with deploy's base ports moved (the coroutine's test
# seam): argv[1:4] are the consensus, mempool and front bases.
_DRIVER = """
import functools, sys
from hotstuff_tpu_torch.node import main as m
c, mp, f = (int(x) for x in sys.argv[1:4])
m._deploy_testbed = functools.partial(m._deploy_testbed, consensus_port=c, mempool_port=mp, front_port=f)
m.main(sys.argv[4:])
"""


def _reference_testbed(n: int):
    """The reference's testbed topology, built as `_deploy_testbed` builds
    it (`hotstuff_tpu/node/main.py:118-131`)."""
    rng = random.Random(0)
    keys = [r_generate_keypair(rng) for _ in range(n)]
    consensus = RCommittee.new([(pk, 1, ("127.0.0.1", 7000 + i)) for i, (pk, _) in enumerate(keys)])
    mempool = RMempoolCommittee.new(
        [(pk, ("127.0.0.1", 7200 + i), ("127.0.0.1", 7100 + i)) for i, (pk, _) in enumerate(keys)])
    return keys, consensus, mempool


@pytest.mark.parametrize("n", [1, 4, 10])
def test_deploy_committee_is_the_references(n):
    keys = node_main.deploy_keys(n)
    consensus, mempool = node_main.deploy_committees(keys)
    r_keys, r_consensus, r_mempool = _reference_testbed(n)
    assert [(pk.data, sk.data) for pk, sk in keys] == [(pk.data, sk.data) for pk, sk in r_keys]
    assert consensus.to_json() == r_consensus.to_json()
    assert mempool.to_json() == r_mempool.to_json()
    assert node_main.DEPLOY_PORTS == (7000, 7100, 7200) == chip_smoke.DEPLOY_BASES


def _free_bases(n: int) -> tuple[int, int, int]:
    """Three bases, each with n free consecutive ports on 127.0.0.1."""
    rng = random.Random(os.getpid())
    for _ in range(200):
        bases = tuple(rng.randrange(20_000, 60_000, 50) for _ in range(3))
        if len(set(bases)) == 3 and not chip_smoke.deploy_ports_taken(n, bases):
            return bases
    raise RuntimeError("no free ports")


def _deploy(tmp_path: Path, flags: list[str], seconds: float, n: int = 4) -> tuple[str, dict]:
    """Runs `deploy --nodes n` with `flags` in tmp_path for `seconds`, then
    SIGTERM; returns its log and its metrics dump."""
    bases = _free_bases(n)
    log = tmp_path / "deploy.log"
    env = dict(os.environ, PYTHONPATH=str(REPO), HOTSTUFF_METRICS_INTERVAL="0", OMP_NUM_THREADS="1")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", _DRIVER, *map(str, bases), "-vv", "deploy", "--nodes", str(n),
             "--metrics-out", "metrics.json", *flags],
            cwd=tmp_path, env=env, stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        time.sleep(seconds)
        assert proc.poll() is None, log.read_text()[-3000:]
    finally:
        os.killpg(proc.pid, signal.SIGTERM)
        proc.wait(30)
    return log.read_text(errors="replace"), json.loads((tmp_path / "metrics.json").read_text())


def test_four_deploy_nodes_commit_the_same_blocks(tmp_path):
    text, dump = _deploy(tmp_path, ["--crypto", "cpu"], 6.0)
    counts = chip_smoke.deploy_commit_counts(text)
    assert chip_smoke.deploy_commit_errors(counts, 4) == []
    assert max(r for r, by in counts.items() if sum(by.values()) == 4) >= 5
    assert dump["counters"]["consensus.commits"] >= 4 * 5
    assert sorted(p.name for p in tmp_path.glob(".db_*")) == [f".db_{i}" for i in range(4)]


def test_deploy_on_the_plain_kernels_sends_no_lane_to_the_host(tmp_path):
    text, dump = _deploy(tmp_path, ["--crypto", "torch", "--device", "cpu", "--crypto-crossover", "1",
                                    "--no-warmup"], 12.0)
    lanes = chip_smoke.node_dump_lanes(dump)
    assert lanes["generic"] > 0 and lanes["committee"] == 0 and lanes["host"] == 0, lanes
    assert dump["counters"].get("crypto.tpu_batches", 0) > 0 and not dump["counters"].get("crypto.cpu_batches")
    # On the CPU the wrappers run the plain versions and count no launch.
    assert not any(chip_smoke.deploy_launches(dump).values())
    assert "successfully booted" in text


def test_deploy_asks_for_the_card_and_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device boots")
    out = subprocess.run(
        [sys.executable, "-m", "hotstuff_tpu_torch.node.main", "deploy", "--nodes", "4"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "successfully booted" not in out.stdout + out.stderr
    assert not list(tmp_path.glob(".db_*"))
