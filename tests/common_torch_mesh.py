"""Corpora and verifiers shared by the port's mesh tests
(tests/test_torch_mesh*.py): tests/test_mesh_committee.py's validators and
digest batch, and the port's sharded verifier on a virtual CPU mesh."""

from __future__ import annotations

import hashlib

from hotstuff_tpu_torch.ops import ed25519 as ted
from hotstuff_tpu_torch.parallel import ShardedEd25519TorchVerifier, default_mesh
from tests.common import rfc8032_keypair, rfc8032_sign


def validators(n: int) -> list[tuple[bytes, bytes]]:
    """tests/test_mesh_committee.py's keypairs (public key, seed)."""
    return [rfc8032_keypair(bytes([i + 1]) * 32) for i in range(n)]


def digest_corpus(kps, n_valid: int = 8):
    """tests/test_mesh_committee.py's `digest_batch`, over `len(kps)`
    validators: `n_valid` valid votes (validator i % n) over 32-byte digests,
    then one lane of each rejection class: forged R, forged s, wrong
    message, wrong index (a valid vote by validator 3 claimed as the next
    one), s + L. Returns (msgs, validator indices, sigs, expected)."""
    n = len(kps)
    msgs, idx, sigs = [], [], []
    for i in range(n_valid):
        m = hashlib.sha512(bytes([i])).digest()[:32]
        msgs.append(m), idx.append(i % n), sigs.append(rfc8032_sign(kps[i % n], m))
    msgs.append(msgs[0]), idx.append(idx[0]), sigs.append(bytes([sigs[0][0] ^ 1]) + sigs[0][1:])
    msgs.append(msgs[1]), idx.append(idx[1]), sigs.append(sigs[1][:33] + bytes([sigs[1][33] ^ 1]) + sigs[1][34:])
    msgs.append(msgs[3]), idx.append(idx[2]), sigs.append(sigs[2])
    msgs.append(msgs[3]), idx.append((idx[3] + 1) % n), sigs.append(sigs[3])
    s_int = int.from_bytes(sigs[5][32:], "little") + ted.L_ORDER
    msgs.append(msgs[5]), idx.append(idx[5]), sigs.append(sigs[5][:32] + s_int.to_bytes(32, "little"))
    return msgs, idx, sigs, [True] * n_valid + [False] * 5


def cpu_mesh_verifier(ndev: int, **kw) -> ShardedEd25519TorchVerifier:
    """The port's sharded verifier on a virtual mesh of `ndev` CPU shards."""
    return ShardedEd25519TorchVerifier(mesh=default_mesh(ndev, device="cpu"), **kw)

