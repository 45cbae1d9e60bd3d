"""The one traffic generator: a configuration's sizes and a traffic mix's
parameters, both plain data, and a seed give every signed group a run
submits.

A mix (`traffic/<name>.json`) lists lanes. Each lane is a loop, its group
size, who signs its groups, and the keyword arguments of its
`verify_group` call:

  * `loop`: "closed" (`in_flight` callers, each sending its next group
    when the last one is answered) or "open" (one group every
    `interval_ms`, due on that schedule whatever came back);
  * `size`: a number, or the name of a configuration key;
  * `signers`: "pool" (the groups walk the configuration's pool of
    `synthetic_pool_size` triples, each signed by a key of its own, in
    turn and wrapping round, as the fork's synthetic pool does) or
    "committee" (each group is one certificate: `size` distinct members
    of the configuration's `nodes` validators, drawn from the seed, sign
    one fresh 32-byte digest; open loops only);
  * `call`: `urgent`, `committee`, `dedup`, `source`, passed as given.

`corrupt_share` of the pool's triples, drawn from the seed, carry a
signature with one bit flipped. Keys, messages, digests and signers are
drawn from `--seed` alone (string-seeded `random.Random`, so any whole
number gives the same bytes in every process), and every seed gets the
same sizes and schedule. Signatures are made with OpenSSL (the
`cryptography` package), split over spawned processes when there are many.
"""

from __future__ import annotations

import math
import multiprocessing
import random
from dataclasses import dataclass, field

SIGN_CHUNK = 2048


def _sign_part(items: list[tuple[bytes, bytes]]) -> list[tuple[bytes, bytes]]:
    """(private seed, message) -> (public key, signature), by OpenSSL."""
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

    out = []
    for priv, msg in items:
        sk = Ed25519PrivateKey.from_private_bytes(priv)
        out.append((sk.public_key().public_bytes_raw(), sk.sign(msg)))
    return out


def sign_all(items: list[tuple[bytes, bytes]], workers: int) -> list[tuple[bytes, bytes]]:
    """`_sign_part` over `items`, in order, on up to `workers` spawned
    processes (here when the list is short)."""
    if workers <= 1 or len(items) <= SIGN_CHUNK:
        return _sign_part(items)
    parts = [items[i : i + SIGN_CHUNK] for i in range(0, len(items), SIGN_CHUNK)]
    with multiprocessing.get_context("spawn").Pool(min(workers, len(parts))) as pool:
        done = pool.map(_sign_part, parts)
    return [x for part in done for x in part]


@dataclass
class Lane:
    name: str
    loop: str
    size: int
    signers: str
    call: dict
    in_flight: int = 0
    interval_s: float = 0.0
    # Open committee lanes: every group of the run, in due order, as
    # (messages, keys, signatures) of bytes.
    groups: list = field(default_factory=list)


@dataclass
class Workload:
    seed: int
    lanes: list[Lane]
    # The pool: (message, key, signature) triples, and which were corrupted.
    pool: list[tuple[bytes, bytes, bytes]]
    corrupted: list[int]
    committee_keys: list[bytes]
    warmup_s: float

    def pool_group(self, lane: Lane, g: int) -> list[int]:
        """Pool indices of group `g` of a pool-signed lane."""
        n = len(self.pool)
        return [(g * lane.size + j) % n for j in range(lane.size)]


def _value(spec, config: dict, what: str):
    if isinstance(spec, str):
        if spec not in config:
            raise KeyError(f"{what} names {spec!r}, which the configuration lacks")
        return config[spec]
    return spec


def make_lanes(config: dict, traffic: dict) -> list[Lane]:
    lanes = []
    for spec in traffic["lanes"]:
        lane = Lane(
            name=spec["name"],
            loop=spec["loop"],
            size=int(_value(spec["size"], config, f"lane {spec['name']}'s size")),
            signers=spec["signers"],
            call=dict(spec["call"]),
            in_flight=int(spec.get("in_flight", 0)),
        )
        if lane.loop == "open":
            lane.interval_s = float(_value(spec["interval_ms"], config, f"lane {lane.name}'s interval")) / 1e3
        elif lane.loop != "closed" or lane.in_flight < 1:
            raise ValueError(f"lane {lane.name}: loop must be 'open', or 'closed' with in_flight >= 1")
        if lane.signers not in ("pool", "committee") or (lane.signers == "committee" and lane.loop != "open"):
            raise ValueError(f"lane {lane.name}: signers must be 'pool', or 'committee' on an open loop")
        lanes.append(lane)
    return lanes


def open_groups(lane: Lane, seconds: float, warmup_s: float) -> int:
    """Groups an open lane needs: the warm-up's and the window's, each
    schedule rounded up, and one spare for a trace phase's."""
    return math.ceil(warmup_s / lane.interval_s) + math.ceil(seconds / lane.interval_s) + 1


def build(config: dict, traffic: dict, seed: int, seconds: float, extra_s: float = 0.0,
          workers: int = 1) -> Workload:
    """Every group of a run of `seconds` (and `extra_s` after it) from
    `seed`."""
    lanes = make_lanes(config, traffic)
    warmup_s = float(traffic.get("warmup_s", 0.0))
    items: list[tuple[bytes, bytes]] = []

    pool_n = int(config["synthetic_pool_size"]) if any(l.signers == "pool" for l in lanes) else 0
    rng = random.Random(f"portbench/pool/{seed}")
    for _ in range(pool_n):
        items.append((rng.randbytes(32), rng.randbytes(32)))
    corrupted = sorted(rng.sample(range(pool_n), round(float(traffic.get("corrupt_share", 0.0)) * pool_n)))
    flips = [rng.randrange(512) for _ in corrupted]

    nodes = int(config["nodes"])
    crng = random.Random(f"portbench/committee/{seed}")
    committee_priv = [crng.randbytes(32) for _ in range(nodes)]
    items.extend((priv, b"") for priv in committee_priv)
    votes: list[tuple[Lane, bytes, list[int]]] = []
    for lane in lanes:
        if lane.signers != "committee":
            continue
        if lane.size > nodes:
            raise ValueError(f"lane {lane.name}: {lane.size} signers of {nodes} validators")
        qrng = random.Random(f"portbench/lane/{lane.name}/{seed}")
        for _ in range(open_groups(lane, seconds + extra_s, warmup_s)):
            digest = qrng.randbytes(32)
            members = qrng.sample(range(nodes), lane.size)
            votes.append((lane, digest, members))
            items.extend((committee_priv[m], digest) for m in members)

    signed = sign_all(items, workers)
    pool = []
    for (priv, msg), (pk, sig) in zip(items[:pool_n], signed[:pool_n]):
        pool.append((msg, pk, sig))
    for i, bit in zip(corrupted, flips):
        msg, pk, sig = pool[i]
        sig = bytearray(sig)
        sig[bit // 8] ^= 1 << (bit % 8)
        pool[i] = (msg, pk, bytes(sig))
    committee_keys = [pk for pk, _ in signed[pool_n : pool_n + nodes]]
    at = pool_n + nodes
    for lane, digest, members in votes:
        sigs = [sig for _, sig in signed[at : at + len(members)]]
        at += len(members)
        lane.groups.append(([digest] * len(members), [committee_keys[m] for m in members], sigs))
    return Workload(seed, lanes, pool, corrupted, committee_keys, warmup_s)
