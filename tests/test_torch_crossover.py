"""`TorchBackend`'s host route and crossovers against the reference's
`TpuBackend` (`hotstuff_tpu/crypto/tpu_backend.py:55-124`, `:276-353`), on
the CPU with no JAX trace: batches under a crossover go to OpenSSL where
`cryptography` imports (else to the exact verifier), committee batches obey
`committee_crossover` and its mesh floor, the routing counters move as the
reference's do, and no route changes a verdict."""

from __future__ import annotations

import logging
import random

import pytest

from hotstuff_tpu.crypto import primitives as jprim
from hotstuff_tpu.crypto.backend import CpuBackend as RefCpuBackend
from hotstuff_tpu.crypto.tpu_backend import TpuBackend
from hotstuff_tpu.parallel import mesh as jmesh
from hotstuff_tpu.utils import metrics as jmetrics
from hotstuff_tpu_torch.crypto import pysigner
from hotstuff_tpu_torch.crypto import torch_backend as tbm
from hotstuff_tpu_torch.crypto.backend import CpuBackend, HostBackend
from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
from hotstuff_tpu_torch.parallel import default_mesh
from hotstuff_tpu_torch.utils import metrics
from tests.common_torch_threads import one_torch_thread  # noqa: F401

pytest.importorskip("cryptography")

P, L = pysigner.P, pysigner.L
ROUTING = ("crypto.tpu_batches", "crypto.tpu_sigs", "crypto.cpu_batches", "crypto.cpu_sigs",
           "verifier.crossover_fallbacks", "verifier.committee_misses", "verifier.rejected_sigs",
           "verifier.committee_rejected_sigs")


def _signed(n: int, seed: int, lengths=(32,)):
    rng = random.Random(seed)
    msgs, keys, sigs, seeds = [], [], [], []
    for i in range(n):
        sk = rng.randbytes(32)
        pk, _ = pysigner.keypair_from_seed(sk)
        m = rng.randbytes(lengths[i % len(lengths)])
        msgs.append(m), keys.append(pk), sigs.append(pysigner.sign(sk, m, public_key=pk)), seeds.append(sk)
    return msgs, keys, sigs, seeds


def _forged_identity(s: int) -> bytes:
    """R = enc([s]B), S = s: valid for any message under a key that decodes
    to the identity."""
    return pysigner._pt_compress(pysigner._pt_mul(s, pysigner._B_POINT)) + s.to_bytes(32, "little")


def edge_batch():
    """ROADMAP C's 65-lane edge batch: messages of 0, 32 and 77 bytes; s = L,
    L + 1 and 2^256 - 1; keys with y = 0, 1, p - 1, p, p + 1 and 2^255 - 1
    (and y = 1 and p + 1 with the sign bit), each with an identity-key
    forgery R = enc([s]B) and a real signature of another key; random keys,
    and bit flips of R, S and the message."""
    lengths = (0, 32, 77)
    msgs, keys, sigs, _ = _signed(15, seed=65, lengths=lengths)
    rng = random.Random(66)
    for i, s in enumerate((L, L + 1, 2**256 - 1)):  # 3 x 3 lanes of s >= L on valid R
        for j in range(3):
            k = 3 * i + j
            msgs.append(msgs[k]), keys.append(keys[k]), sigs.append(sigs[k][:32] + s.to_bytes(32, "little"))
    special = [0, 1, P - 1, P, P + 1, 2**255 - 1, 1 | 1 << 255, P + 1 | 1 << 255]
    for y in special:  # 8 x 4 lanes
        key = y.to_bytes(32, "little")
        for m in (b"", bytes(32), rng.randbytes(77)):
            msgs.append(m), keys.append(key), sigs.append(_forged_identity(rng.randrange(1, L)))
        other = len(keys) % 15
        msgs.append(msgs[other]), keys.append(key), sigs.append(sigs[other])
    for k in range(9):  # 9 bit flips: R, S, then the message, on each length
        m, key, sig = msgs[k], keys[k], sigs[k]
        if k < 3:
            sig = sig[:5] + bytes([sig[5] ^ 0x10]) + sig[6:]
        elif k < 6:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        else:
            m = bytes([m[0] ^ 1]) + m[1:] if m else b"\x00"
        msgs.append(m), keys.append(key), sigs.append(sig)
    assert len(msgs) == 65
    return msgs, keys, sigs


def _args(msgs, keys, sigs):
    return msgs, [PublicKey(k) for k in keys], [Signature(s) for s in sigs]


# -- the host route ----------------------------------------------------------------


def test_sub_crossover_batches_go_to_openssl_and_exact_on_request():
    msgs, keys, sigs, _ = _signed(6, seed=1)
    sigs[2] = bytes(64)
    tb = TorchBackend(device="cpu")
    assert tb.host_route == "openssl" and isinstance(tb._host, CpuBackend)
    assert (tb.crossover, tb.committee_crossover) == tbm.DEFAULT_CROSSOVERS["openssl"]
    calls = []
    verify = tb._host.verify_batch_mask
    tb._host.verify_batch_mask = lambda *a: calls.append(len(a[0])) or verify(*a)
    n = min(6, tb.crossover - 1)
    assert tb.verify_batch_mask(*_args(msgs[:n], keys[:n], sigs[:n])) == [i != 2 for i in range(n)]
    assert calls == [n] and tb.stats["host_sigs"] == n and tb.stats["device_sigs"] == 0
    exact = TorchBackend(device="cpu", host="exact", crossover=8)
    assert exact.host_route == "exact" and isinstance(exact._host, HostBackend)
    assert exact.verify_batch_mask(*_args(msgs, keys, sigs)) == [i != 2 for i in range(6)]
    assert exact.stats["host_sigs"] == 6
    assert (TorchBackend(device="cpu", host="exact").crossover, TorchBackend(device="cpu", host="exact")
            .committee_crossover) == (1, 1) == tbm.DEFAULT_CROSSOVERS["exact"]
    with pytest.raises(ValueError, match="host must be one of"):
        TorchBackend(device="cpu", host="dalek")


def test_without_cryptography_the_default_route_is_exact(monkeypatch):
    import sys

    for mod in ("cryptography", "cryptography.exceptions", "cryptography.hazmat.primitives.asymmetric.ed25519"):
        monkeypatch.setitem(sys.modules, mod, None)
    tb = TorchBackend(device="cpu")
    assert tb.host_route == "exact" and (tb.crossover, tb.committee_crossover) == (1, 1)
    with pytest.raises(ImportError):
        TorchBackend(device="cpu", host="openssl")


# -- committee_crossover and the mesh floor (tests/test_mesh_committee.py:270-283) ----


def test_mesh_aware_committee_crossover_as_the_reference():
    """Case for case the reference's test: a sharded backend floors the
    committee crossover at mesh_alignment // 8, an explicit value wins, a
    single-device backend keeps crossover // 4. Each beside the reference's
    `TpuBackend` on a 4-device mesh."""
    ours = TorchBackend(mesh=default_mesh(4, device="cpu"), crossover=64)
    ref = TpuBackend(mesh=jmesh.default_mesh(4), crossover=64)
    align = ours._verifier.mesh_alignment
    assert align == ref._verifier.mesh_alignment == 512
    assert ours.committee_crossover == ref.committee_crossover == max(64 // 4, align // 8) == 64
    forced = TorchBackend(mesh=default_mesh(4, device="cpu"), crossover=64, committee_crossover=7)
    assert forced.committee_crossover == TpuBackend(mesh=jmesh.default_mesh(4), crossover=64,
                                                    committee_crossover=7).committee_crossover == 7
    single = TorchBackend(device="cpu", crossover=64)
    assert single.committee_crossover == TpuBackend(crossover=64).committee_crossover == 16
    for b in (ours, ref, forced, single):
        b.close()


def test_measured_defaults_and_their_mesh_floor():
    generic, committee = tbm.DEFAULT_CROSSOVERS["openssl"]
    assert (tbm.CROSSOVER_OPENSSL, tbm.COMMITTEE_CROSSOVER_OPENSSL) == (generic, committee)
    for ndev in (1, 2, 4):
        tb = TorchBackend(mesh=default_mesh(ndev, device="cpu"))
        assert tb.crossover == generic and tb.committee_crossover == max(committee, 128 * ndev // 8)
        exact = TorchBackend(mesh=default_mesh(ndev, device="cpu"), host="exact")
        assert exact.crossover == 1 and exact.committee_crossover == 16 * ndev
    assert TorchBackend(device="cpu", crossover=1).committee_crossover == 1


# -- routing never changes a verdict -------------------------------------------------


def test_edge_batch_gives_one_mask_on_every_route():
    msgs, keys, sigs = edge_batch()
    want = RefCpuBackend().verify_batch_mask(msgs, [jprim.PublicKey(k) for k in keys],
                                             [jprim.Signature(s) for s in sigs])
    assert want == [pysigner.verify_device_semantics(k, m, s) for m, k, s in zip(msgs, keys, sigs)]
    assert 0 < sum(want) < 65
    masks = {}
    for route, kw in (("openssl", {}), ("exact", {"host": "exact"}), ("card", {"crossover": 1})):
        tb = TorchBackend(device="cpu", **({"crossover": 66} | kw))
        masks[route] = tb.verify_batch_mask(*_args(msgs, keys, sigs))
        assert tb.stats["host_sigs" if route != "card" else "device_sigs"] == 65
        assert tb.host_route == ("exact" if route == "exact" else "openssl")
    assert masks["openssl"] == masks["exact"] == masks["card"] == want


# -- the routing counters against the reference's ------------------------------------


def _counters(registry) -> dict:
    d = registry.dump()
    out = {name: d["counters"].get(name, 0) for name in ROUTING}
    size = d["histograms"]["crypto.batch_size"]
    out["batch_size"] = (size["count"], size["sum"], size["buckets"]["counts"])
    return out


def test_routing_counters_move_as_the_reference_tpu_backends(caplog):
    """The same sub-crossover batches through both backends at crossover 64
    (committee 16): untagged with rejected lanes, tagged before a
    registration, tagged and resolved, tagged with an unregistered key. All
    reach OpenSSL on both sides; every counter and the batch-size histogram
    end equal, and each side logs its first fallback and miss."""
    committee = _signed(4, seed=2)
    members = committee[1]
    msgs, keys, sigs, _ = _signed(12, seed=3)
    sigs[0], sigs[5] = bytes(64), sigs[4]
    cmsgs = [b"q" * 32] * 10
    ckeys = [members[i % 4] for i in range(10)]
    csigs = [pysigner.sign(committee[3][i % 4], cmsgs[i], public_key=members[i % 4]) for i in range(10)]
    csigs[3] = csigs[2]
    outsider = keys[:5]
    ours, ref = TorchBackend(device="cpu", crossover=64), TpuBackend(crossover=64, min_bucket=128, max_bucket=128)
    metrics.reset()
    jmetrics.reset()
    wrap = {"ours": lambda ks: [PublicKey(k) for k in ks], "ref": lambda ks: [jprim.PublicKey(k) for k in ks]}
    sig = {"ours": lambda ss: [Signature(s) for s in ss], "ref": lambda ss: [jprim.Signature(s) for s in ss]}
    masks = {}
    with caplog.at_level(logging.INFO, logger="hotstuff.crypto"):
        for side, b in (("ours", ours), ("ref", ref)):
            w, g = wrap[side], sig[side]
            out = [b.verify_batch_mask(msgs, w(keys), g(sigs)),
                   b.verify_batch_mask(cmsgs, w(ckeys), g(csigs), committee=True)]
            b.register_committee(w(members))
            out.append(b.verify_batch_mask(cmsgs, w(ckeys), g(csigs), committee=True))
            out.append(b.verify_batch_mask(msgs[:5], w(outsider), g(sigs[:5]), committee=True))
            masks[side] = out
    assert masks["ours"] == masks["ref"]
    assert masks["ours"][2] == [i != 3 for i in range(10)]
    assert _counters(metrics) == _counters(jmetrics)
    got = _counters(metrics)
    assert got["crypto.cpu_batches"] == 4 and got["crypto.cpu_sigs"] == 37 and got["crypto.tpu_batches"] == 0
    assert got["verifier.committee_misses"] == 1 and got["verifier.crossover_fallbacks"] == 4
    assert got["verifier.committee_rejected_sigs"] == 1 and got["verifier.rejected_sigs"] == 2 + 1 + 1 + 1
    assert ours.stats["host_batches"] == 4 and ours.stats["committee_misses"] == 1
    assert caplog.text.count("sub-crossover fallback #1:") == 2 and caplog.text.count("committee miss #1:") == 2
    ours.close()
    ref.close()


@pytest.mark.parametrize("count,logged", [(1, True), (2, False), (9, False), (10, True), (11, False),
                                          (100, True), (1000, True), (1001, False), (0, False)])
def test_decade_throttle_matches_the_reference(count, logged):
    from hotstuff_tpu.crypto.tpu_backend import _is_decade

    assert tbm._is_decade(count) == _is_decade(count) == logged
