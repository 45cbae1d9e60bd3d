"""The BLS aggregation corpus that `chip_smoke.py` phase 8 and
`ladder_ab`'s K6 leg run: validator keys from fixed seeds, a committee
table's special lanes, and certificate bitmap rows.

Keys come from `ExactBlsScheme.keypair_from_seed` (pure Python, about 0.1 s
a key): callers map `keypair` over `validator_seeds(n)` in a spawn pool.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .crypto import aggsig
from .ops import bls


def validator_seeds(n: int) -> list[bytes]:
    """The 32-byte seeds of validators 0 .. n - 1."""
    return [hashlib.sha256(b"bls validator %d" % i).digest() for i in range(n)]


def keypair(seed: bytes) -> tuple[bytes, int]:
    """(compressed public key, secret) of one seed (picklable, for a pool)."""
    return aggsig.ExactBlsScheme().keypair_from_seed(seed)


def bad_key() -> bytes:
    """A compressed 48-byte G1 encoding whose x has no point: the smallest
    x with x^3 + 4 a non-square mod p."""
    p = aggsig.P
    x = next(x for x in range(1, 64) if pow(x**3 + aggsig.B_G1, (p - 1) // 2, p) != 1)
    return bytes([0x80]) + x.to_bytes(47, "big")


def table_keys(pairs: list, n: int) -> tuple[list[bytes], list, dict[str, tuple[int, ...]]]:
    """n committee keys from `pairs` ((key, secret) pairs), each lane's
    secret beside it (None: no point), and the special lanes: a duplicate
    key, a key beside its negation and one undecodable key in the last
    three lanes; above 34 keys also a duplicate and an inverse pair in one
    partial's lanes (0 and 32, 1 and 33, which K6's threads 0 and 1 fold
    in turn; at phase 8's sizes the end lanes' pairs meet only in the
    tree)."""

    def neg(k: bytes) -> bytes:
        return aggsig.compress_g1(aggsig._g1_neg(aggsig.decompress_g1(k)))

    keys, sks = [pk for pk, _ in pairs[:n]], [sk for _, sk in pairs[:n]]
    dup, inv = min(2, n - 4), min(3, n - 4)
    keys[n - 3], sks[n - 3] = keys[dup], sks[dup]
    keys[n - 2], sks[n - 2] = neg(keys[inv]), -sks[inv] % aggsig.R_ORDER
    keys[n - 1], sks[n - 1] = bad_key(), None
    lanes = {"dup": (dup, n - 3), "inverse": (inv, n - 2), "invalid": (n - 1,)}
    t = bls.THREADS
    if n > t + 2:
        keys[t], sks[t] = keys[0], sks[0]
        keys[t + 1], sks[t + 1] = neg(keys[1]), -sks[1] % aggsig.R_ORDER
        lanes.update(dup_one_partial=(0, t), inverse_one_partial=(1, t + 1))
    return keys, sks, lanes


def bitmap_rows(seed: int, n: int, lanes: dict, rows: int) -> tuple[np.ndarray, list[str]]:
    """(rows, n) bool bitmap rows and the edge rows' labels: empty, all, a
    single member, one row per special-lane entry, then random quorums of
    floor(2n / 3) + 1 members (2f + 1 where n = 3f + 1)."""
    rng = np.random.default_rng([seed, n])
    labels = ["empty", "all", "single", *lanes]
    masks = np.zeros((rows, n), bool)
    masks[1] = True
    masks[2, int(rng.integers(n))] = True
    for r, name in enumerate(lanes, 3):
        masks[r, list(lanes[name])] = True
    for r in range(len(labels), rows):
        masks[r, rng.choice(n, 2 * n // 3 + 1, replace=False)] = True
    return masks, labels
