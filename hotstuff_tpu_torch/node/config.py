"""Node configuration files (reference node/src/config.rs:13-78).

The Export pattern: every config is a JSON file with read/write helpers.
  * Secret    -- {name, secret} keypair file (written by `node keys`)
  * Committee -- {consensus: {...}, mempool: {...}} addresses + stakes
  * NodeParameters -- {consensus: {...}, mempool: {...}} tuning knobs

The port's copy of `hotstuff_tpu/node/config.py`, in the same JSON, with
`read_consensus_keys`: the sorted consensus keys of a committee file,
which the crypto sidecar's `--committee` registers (the order of
`ConsensusCommittee.sorted_keys()`, raw key bytes ascending).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from ..consensus.config import Committee as ConsensusCommittee
from ..consensus.config import Parameters as ConsensusParameters
from ..crypto import PublicKey, SecretKey, generate_production_keypair
from ..mempool.config import MempoolCommittee, MempoolParameters


class ConfigError(Exception):
    pass


def _read_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ConfigError(f"failed to read config {path}: {e}") from e


def _write_json(path: str, obj: dict) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.write("\n")


@dataclass(slots=True)
class Secret:
    """Keypair file (node/src/config.rs:41-57)."""

    name: PublicKey
    secret: SecretKey

    @staticmethod
    def new() -> "Secret":
        pk, sk = generate_production_keypair()
        return Secret(pk, sk)

    @staticmethod
    def read(path: str) -> "Secret":
        obj = _read_json(path)
        return Secret(
            PublicKey.decode_base64(obj["name"]),
            SecretKey.decode_base64(obj["secret"]),
        )

    def write(self, path: str) -> None:
        _write_json(
            path,
            {"name": self.name.encode_base64(), "secret": self.secret.encode_base64()},
        )


@dataclass(slots=True)
class Committee:
    """Combined consensus+mempool committee (node/src/config.rs:59-68)."""

    consensus: ConsensusCommittee
    mempool: MempoolCommittee

    @staticmethod
    def read(path: str) -> "Committee":
        obj = _read_json(path)
        return Committee(
            ConsensusCommittee.from_json(obj["consensus"]),
            MempoolCommittee.from_json(obj["mempool"]),
        )

    def write(self, path: str) -> None:
        _write_json(
            path,
            {"consensus": self.consensus.to_json(), "mempool": self.mempool.to_json()},
        )


@dataclass(slots=True)
class NodeParameters:
    """Combined parameters (node/src/config.rs:70-78)."""

    consensus: ConsensusParameters
    mempool: MempoolParameters

    @staticmethod
    def default() -> "NodeParameters":
        return NodeParameters(ConsensusParameters(), MempoolParameters())

    @staticmethod
    def read(path: str) -> "NodeParameters":
        obj = _read_json(path)
        return NodeParameters(
            ConsensusParameters.from_json(obj.get("consensus", {})),
            MempoolParameters.from_json(obj.get("mempool", {})),
        )

    def write(self, path: str) -> None:
        _write_json(
            path,
            {"consensus": self.consensus.to_json(), "mempool": self.mempool.to_json()},
        )


def read_consensus_keys(path: str) -> list[bytes]:
    """The 32-byte consensus keys of the committee file at `path`, sorted
    by raw bytes. Raises ConfigError on an unreadable or malformed file."""
    try:
        committee = ConsensusCommittee.from_json(_read_json(path)["consensus"])
    except (KeyError, TypeError, ValueError) as e:  # binascii.Error is a ValueError
        raise ConfigError(f"failed to read committee {path}: {e!r}") from e
    return [k.data for k in committee.sorted_keys()]
