"""Reading a node committee file for the crypto sidecar.

The port's counterpart of `hotstuff_tpu/node/config.py:73-78` as far as the
sidecar's `--committee` needs it: the consensus authorities' public keys,
in the order the reference registers them
(`ConsensusCommittee.sorted_keys()`, `hotstuff_tpu/consensus/config.py:58`,
which sorts `PublicKey`s by their raw bytes).

The file is the node committee JSON that `benchmark/config.py` writes:

    {"consensus": {"epoch": 1, "authorities": {<base64 key>: {"stake": 1,
     "address": "host:port"}, ...}}, "mempool": {...}}
"""

from __future__ import annotations

import base64
import binascii
import json


class ConfigError(Exception):
    pass


def read_consensus_keys(path: str) -> list[bytes]:
    """The 32-byte consensus keys of the committee file at `path`, sorted
    by raw bytes. Raises ConfigError on an unreadable or malformed file."""
    try:
        with open(path) as f:
            authorities = json.load(f)["consensus"]["authorities"]
        keys = [base64.standard_b64decode(name.encode()) for name in authorities]
    except (OSError, json.JSONDecodeError, KeyError, TypeError, binascii.Error) as e:
        raise ConfigError(f"failed to read committee {path}: {e!r}") from e
    bad = [k for k in keys if len(k) != 32]
    if bad:
        raise ConfigError(f"committee {path}: {len(bad)} keys are not 32 bytes")
    return sorted(keys)
