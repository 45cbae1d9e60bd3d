"""The verifier's device-hash latch (`Ed25519TorchVerifier`). On the CPU it
is the reference's (`tests/test_sha512_device.py:149-183`): a batch whose
device-hash run raises is redone with host hashing and the latch goes off;
when the host-hash retry raises too, the error propagates and the latch
stays on. On the card a device-hash failure propagates with no retry.
Generic and committee paths."""

import random

import pytest
import torch

from hotstuff_tpu_torch.crypto import pysigner
from hotstuff_tpu_torch.ops import committee, ladder
from hotstuff_tpu_torch.ops.verifier import Ed25519TorchVerifier
from tests.common_torch_threads import one_torch_thread  # noqa: F401

N = 5


def _batch(seed):
    """N signatures over 32-byte digests by N keys; lane 2 forged."""
    rng = random.Random(seed)
    seeds = [rng.randbytes(32) for _ in range(N)]
    keys = [pysigner.keypair_from_seed(s)[0] for s in seeds]
    msgs = [rng.randbytes(32) for _ in range(N)]
    sigs = [pysigner.sign(s, m, public_key=k) for s, m, k in zip(seeds, msgs, keys)]
    sigs[2] = bytes(64)
    return msgs, keys, sigs


def _verify(path, v, msgs, keys, sigs):
    if path == "generic":
        return v.verify_batch_mask(msgs, keys, sigs).tolist()
    v.set_committee(keys)
    return v.verify_batch_mask_committee(msgs, list(range(N)), sigs).tolist()


# (path, the device-hash kernel call, the host-hash one) per path
PATHS = {
    "generic": (ladder, "verify_packed128_dh", "verify_packed128"),
    "committee": (committee, "verify_committee96_dh", "verify_committee96"),
}
WANT = [True, True, False, True, True]


def _fail(*args, **kwargs):
    raise RuntimeError("injected kernel failure")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_device_hash_failure_falls_back_to_host_hashing(path, monkeypatch):
    module, dh, hh = PATHS[path]
    v = Ed25519TorchVerifier(device="cpu", min_bucket=8, max_bucket=8)
    msgs, keys, sigs = _batch(21)
    calls = []
    host_hash = getattr(module, hh)
    monkeypatch.setattr(module, dh, _fail)
    monkeypatch.setattr(module, hh, lambda *a: calls.append(1) or host_hash(*a))
    assert _verify(path, v, msgs, keys, sigs) == WANT
    assert v._device_hash_ok is False and v.device_hash_fallbacks == 1 and len(calls) == 1
    # later batches go straight to host hashing: no second fallback
    assert _verify(path, v, msgs, keys, sigs) == WANT
    assert v.device_hash_fallbacks == 1 and len(calls) == 2


@pytest.mark.parametrize("path", sorted(PATHS))
def test_failed_retry_does_not_latch(path, monkeypatch):
    module, dh, hh = PATHS[path]
    v = Ed25519TorchVerifier(device="cpu", min_bucket=8, max_bucket=8)
    msgs, keys, sigs = _batch(22)
    monkeypatch.setattr(module, dh, _fail)
    monkeypatch.setattr(module, hh, _fail)
    with pytest.raises(RuntimeError, match="injected"):
        _verify(path, v, msgs, keys, sigs)
    assert v._device_hash_ok is True and v.device_hash_fallbacks == 1
    monkeypatch.undo()
    assert _verify(path, v, msgs, keys, sigs) == WANT  # the device hash recovers
    assert v._device_hash_ok is True


@pytest.mark.parametrize("path", sorted(PATHS))
def test_card_device_hash_failure_propagates(path, monkeypatch):
    """A verifier on the card never redoes a batch with host hashing: the
    first failure raises, nothing is counted and the latch stays on."""
    v = Ed25519TorchVerifier(device="cpu", min_bucket=8, max_bucket=8)
    msgs, keys, sigs = _batch(23)
    if path == "committee":
        v.set_committee(keys)
    v.device = torch.device("cuda")  # the run itself is stubbed: no card needed
    calls = []

    def run_chunks(*args):
        calls.append(1)
        raise RuntimeError("injected kernel failure")

    monkeypatch.setattr(v, "_run_chunks", run_chunks)
    with pytest.raises(RuntimeError, match="injected"):
        _verify(path, v, msgs, keys, sigs)
    assert len(calls) == 1 and v.device_hash_fallbacks == 0 and v._device_hash_ok is True
