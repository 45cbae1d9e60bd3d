"""Region-aware leader election in the port (`consensus/leader.py`)
against the reference's (`hotstuff_tpu/consensus/leader.py`): the port's
`RegionAwareElector` gives the reference's leader for rounds 0-199 over a
region map, over measured RTTs with full coverage (measurements win) and
with partial coverage (rejected: the map stays), with neither (round-robin),
and across an epoch boundary; and a port `Node` accepts
`region_aware_election: true`.

Keys come from the port's pure-Python signer (identities only), and each
package's committee is built from the same JSON.
"""

from __future__ import annotations

import json

import pytest

from hotstuff_tpu.consensus import leader as r_leader
from hotstuff_tpu.consensus.config import Committee as RCommittee
from hotstuff_tpu.crypto import PublicKey as RPublicKey
from hotstuff_tpu_torch.consensus import leader as p_leader
from hotstuff_tpu_torch.consensus.config import Committee
from hotstuff_tpu_torch.crypto import PublicKey, pysigner

ROUNDS = 200


def _keys(n: int) -> list[bytes]:
    return [pysigner.keypair_from_seed(bytes([i + 1]) * 32)[0] for i in range(n)]


def _committees(raw: list[bytes], epoch: int = 1):
    """The same committee in each package: (port, reference)."""
    port = Committee.new([(PublicKey(k), 1, ("127.0.0.1", 9_000 + i)) for i, k in enumerate(raw)], epoch=epoch)
    ref = RCommittee.from_json(port.to_json())
    assert ref.to_json() == port.to_json()
    return port, ref


def _maps(raw: list[bytes], labels: list[str]):
    return ({PublicKey(k): lab for k, lab in zip(raw, labels)},
            {RPublicKey(k): lab for k, lab in zip(raw, labels)})


def _rtts(raw: list[bytes], rows: dict[int, dict[int, float]]):
    """{a: {b: ms}} over key indices, in each package's key type."""
    return ({PublicKey(raw[a]): {PublicKey(raw[b]): v for b, v in row.items()} for a, row in rows.items()},
            {RPublicKey(raw[a]): {RPublicKey(raw[b]): v for b, v in row.items()} for a, row in rows.items()})


def _schedule(elector, rounds: int = ROUNDS) -> list[bytes]:
    return [elector.get_leader(r).data for r in range(rounds)]


RAW8 = _keys(8)
# Full coverage: keys 0-3 close to each other, 4-7 close, 150 ms across.
FULL = {a: {b: (4.0 if (a < 4) == (b < 4) else 150.0) for b in range(8) if b != a} for a in (0, 4)}
FULL.update({a: {0 if a < 4 else 4: 4.0} for a in (1, 2, 3, 5, 6, 7)})
PARTIAL = {0: {1: 4.0, 2: 150.0}}  # keys 3-7 never measured

CASES = {
    "region map": (["west", "west", "west", "east", "east", "ap", "ap", "eu"], None),
    "measured full": (["x"] * 7 + ["y"], FULL),
    "measured partial": (["a", "a", "b", "b", "b", "c", "c", "a"], PARTIAL),
    "measured only": ([], FULL),
    "neither": ([], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_elector_gives_the_reference_schedule(case):
    labels, rtts = CASES[case]
    port_cmt, ref_cmt = _committees(RAW8)
    p_map, r_map = _maps(RAW8, labels)
    p_rtt, r_rtt = _rtts(RAW8, rtts) if rtts else (None, None)
    port = p_leader.RegionAwareElector(port_cmt, region_of=p_map, measured_rtts=p_rtt)
    ref = r_leader.RegionAwareElector(ref_cmt, region_of=r_map, measured_rtts=r_rtt)
    assert {k.data: v for k, v in port.regions.items()} == {k.data: v for k, v in ref.regions.items()}
    assert _schedule(port) == _schedule(ref)
    if case == "measured full":  # measurements win over the map: two regions of four
        assert sorted(list(port.regions.values()).count(r) for r in set(port.regions.values())) == [4, 4]
    if case == "measured partial":  # rejected wholesale: the map stays in effect
        assert port.regions == p_map
    if case == "neither":
        assert _schedule(port) == _schedule(p_leader.LeaderElector(port_cmt))


def test_pure_rule_and_plurality_agree():
    port_cmt, _ = _committees(RAW8)
    ks = port_cmt.sorted_keys()
    rks = [RPublicKey(k.data) for k in ks]
    for labels in (["b", "b", "a", "a", "c", "c", "c", "a"], ["solo"] * 8, ["p", "q"] * 4):
        p_map = dict(zip(ks, labels))
        r_map = dict(zip(rks, labels))
        assert p_leader.plurality_region(ks, p_map) == r_leader.plurality_region(rks, r_map)
        assert ([p_leader.elect_region_aware(r, ks, p_map).data for r in range(ROUNDS)]
                == [r_leader.elect_region_aware(r, rks, r_map).data for r in range(ROUNDS)])


def test_epoch_boundary_gives_the_reference_schedule():
    raw = _keys(6)
    boundary = 20
    port_g, ref_g = _committees(raw[:4])
    port_e2, ref_e2 = _committees(raw[2:], epoch=2)
    p_map, r_map = _maps(raw, ["a", "a", "b", "b", "c", "c"])
    port = p_leader.RegionAwareElector(port_g, region_of=p_map)
    ref = r_leader.RegionAwareElector(ref_g, region_of=r_map)
    assert port._epochs.schedule.apply(boundary, port_e2)
    assert ref._epochs.schedule.apply(boundary, ref_e2)
    schedule = _schedule(port)
    assert schedule == _schedule(ref)
    departed = {k.data for k in port_g.sorted_keys()} - {k.data for k in port_e2.sorted_keys()}
    assert departed and not departed & set(schedule[boundary:])


def test_node_accepts_region_aware_election(tmp_path):
    """A parameters file with `region_aware_election: true` builds a port
    `Node`, whose consensus parameters carry it (a node passes no region
    map, so its schedule is round-robin)."""
    from hotstuff_tpu_torch.node.config import Secret
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
    params.write_text(json.dumps({"consensus": {"region_aware_election": True}}))
    node = Node(str(committee), str(key), str(tmp_path / "db"), str(params))
    assert node.parameters.consensus.region_aware_election is True
    elector = p_leader.RegionAwareElector(node.epoch_manager)
    assert elector.regions == {}
    assert _schedule(elector, 8) == _schedule(p_leader.LeaderElector(node.epoch_manager), 8)
