"""The generator: a seed gives the same groups every time, and every seed
the same sizes and schedule."""

import json
from pathlib import Path

from portbench import generator

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "portbench/configs/hs2c-n50-wan.json").read_text())
FLOOD = json.loads((ROOT / "portbench/traffic/flood.json").read_text())
SMALL = dict(CONFIG, synthetic_pool_size=96, payload_triples=40)


def build(seed, config=SMALL, seconds=1.0):
    return generator.build(config, FLOOD, seed, seconds)


def shape(wl):
    return ([(l.name, l.loop, l.size, l.in_flight, l.interval_s, len(l.groups)) for l in wl.lanes],
            len(wl.pool), len(wl.corrupted), len(wl.committee_keys))


def test_a_seed_repeats_exactly():
    a, b = build(2**33 + 5), build(2**33 + 5)
    assert a.pool == b.pool and a.corrupted == b.corrupted and a.committee_keys == b.committee_keys
    assert [l.groups for l in a.lanes] == [l.groups for l in b.lanes]


def test_seeds_differ_in_bytes_not_in_shape():
    a, b = build(1), build(2)
    assert a.pool != b.pool and a.committee_keys != b.committee_keys
    assert shape(a) == shape(b)


def test_groups_follow_the_configuration():
    wl = build(7)
    mempool, consensus = wl.lanes
    assert mempool.size == 40 and mempool.in_flight == 8 and mempool.call["dedup"] is False
    assert consensus.size == CONFIG["quorum"] == 34 and consensus.interval_s == 0.1
    assert len(wl.corrupted) == round(FLOOD["corrupt_share"] * 96)
    # Each certificate: one digest, distinct registered signers.
    for msgs, keys, _ in consensus.groups:
        assert len(set(msgs)) == 1 and len(set(keys)) == 34 and set(keys) <= set(wl.committee_keys)
    # Pool groups walk the pool in turn and wrap round.
    assert wl.pool_group(mempool, 2) == [(80 + j) % 96 for j in range(40)]
    assert len({k for _, k, _ in wl.pool}) == 96


def test_the_published_sizes():
    assert CONFIG["payload_triples"] == CONFIG["mempool_max_payload_size"] // CONFIG["tx_size"] == 976
    assert CONFIG["quorum"] == 2 * CONFIG["nodes"] // 3 + 1 == 34


