"""The port's ingress package (`hotstuff_tpu_torch/ingress/`) against the
reference's (`hotstuff_tpu/ingress/`), on the same seeded inputs: the wire
codec byte for byte both ways, the load generator's transactions byte for
byte (and its OpenSSL signer against the exact one), admission's lane or
rejection for each submission, and the pipeline's statuses and
`ingress.*` counters over a CPU `TorchBackend` against the reference's
over OpenSSL or its pure-Python verifier."""

from __future__ import annotations

import asyncio
import random
import sys

import pytest

from hotstuff_tpu import ingress as ref
from hotstuff_tpu.crypto.batch_service import BatchVerificationService as RefService
from hotstuff_tpu.crypto.primitives import PublicKey as RefPublicKey
from hotstuff_tpu.crypto.primitives import Signature as RefSignature
from hotstuff_tpu.utils import metrics as ref_metrics
from hotstuff_tpu.utils.serde import Reader as RefReader
from hotstuff_tpu_torch import ingress as port
from hotstuff_tpu_torch.crypto import pysigner
from hotstuff_tpu_torch.crypto.batch_service import BatchVerificationService
from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
from hotstuff_tpu_torch.ingress import loadgen
from hotstuff_tpu_torch.utils import metrics
from hotstuff_tpu_torch.utils.serde import Reader, SerdeError
from tests.common_torch_threads import one_torch_thread  # noqa: F401


def _txs(pkg, n: int, seed: int = 7):
    """The first n transactions of a seeded load generator of `pkg`."""
    gen = pkg.OpenLoopLoadGen(None, pkg.ArrivalCurve(), 1.0, rng=random.Random(seed))
    return [gen._make_tx() for _ in range(n)], gen


def _to_ref(tx):
    """The reference's object for a port transaction (decoded from its bytes)."""
    return ref.decode_ingress_message(port.encode_ingress_message(tx))


def test_first_transactions_of_the_load_generator_are_the_references():
    ours, gen = _txs(port, 32)
    theirs, _ = _txs(ref, 32)
    assert [port.encode_ingress_message(t) for t in ours] == [ref.encode_ingress_message(t) for t in theirs]
    assert gen.signed == 32 and gen.sign_s > 0
    assert len({t.client for t in ours}) > 1 and len({t.fee for t in ours}) > 1


def test_openssl_signer_equals_the_exact_signer():
    """Where `cryptography` imports the generator signs through OpenSSL;
    its signatures are the port's exact signer's, byte for byte (and so
    the reference's: the test above)."""
    pytest.importorskip("cryptography")
    fast, gen = _txs(port, 32)
    assert gen.signer == "openssl"
    for tx in fast:
        seed = gen._seeds[[k[0] for k in gen._keys].index(tx.client.data)]
        assert tx.signature.data == pysigner.sign(seed, tx.digest().data)


def test_without_openssl_the_generator_signs_exactly(monkeypatch):
    monkeypatch.setitem(sys.modules, "cryptography.hazmat.primitives.asymmetric.ed25519", None)
    name, sign = port.make_signer()
    assert name == "exact" and sign is pysigner.sign
    exact, gen = _txs(port, 4)
    theirs, _ = _txs(ref, 4)
    assert gen.signer == "exact"
    assert [port.encode_ingress_message(t) for t in exact] == [ref.encode_ingress_message(t) for t in theirs]


def test_codec_is_the_references_both_ways():
    txs, _ = _txs(port, 4)
    for tx in txs:
        wire = port.encode_ingress_message(tx)
        back = _to_ref(tx)
        assert ref.encode_ingress_message(back) == wire
        assert port.decode_ingress_message(ref.encode_ingress_message(back)) == tx
        assert tx.digest().data == back.digest().data
        assert port.ClientTransaction.decode(Reader(wire[1:])) == tx
    for status in (port.ACCEPTED, port.SHED, port.BAD_SIGNATURE, port.REPLAY, port.MALFORMED):
        resp = port.IngressResponse(1 << 41, status, 1234 * status)
        wire = port.encode_ingress_message(resp)
        assert wire == ref.encode_ingress_message(ref.IngressResponse(1 << 41, status, 1234 * status))
        assert port.decode_ingress_message(wire) == resp
        assert resp.status_name == ref.IngressResponse(0, status).status_name
        assert ref.IngressResponse.decode(RefReader(wire[1:])).retry_after_ms == 1234 * status
    with pytest.raises(SerdeError):
        port.decode_ingress_message(b"\x07")
    with pytest.raises(SerdeError):
        port.decode_ingress_message(port.encode_ingress_message(txs[0]) + b"\x00")
    with pytest.raises(TypeError):
        port.encode_ingress_message(object())


def _config(pkg):
    return pkg.IngressConfig(
        lanes=(pkg.LaneSpec("priority", min_fee=1_000, capacity=3), pkg.LaneSpec("standard", min_fee=1, capacity=3),
               pkg.LaneSpec("bulk", min_fee=0, capacity=3)),
        replay_window=12, max_tx_bytes=64)


def _admission_script(pkg, txs):
    """Admit a sequence with replays, a malformed body, full lanes, drains
    and forgets; returns every decision and every take."""
    ctl = pkg.AdmissionController(_config(pkg))
    out = []
    t = 100.0
    for i, tx in enumerate(txs):
        out.append(("admit", i, ctl.admit(tx, i)))
        if i % 5 == 4:
            out.append(("replay", i, ctl.admit(txs[i - 2], -1)))
        if i % 7 == 6:
            taken = ctl.take(4)
            t += 0.01 * (i + 1)
            ctl.note_drained(len(taken), t)
            out.append(("take", i, taken))
        if i == 9:
            ctl.forget(txs[3])
            out.append(("forgotten", i, ctl.admit(txs[3], 3)))
    big = type(txs[0])(txs[0].client, 99, 1, b"\x01" * 65, txs[0].signature)
    empty = type(txs[0])(txs[0].client, 98, 1, b"", txs[0].signature)
    out.append(("oversized", 0, ctl.admit(big, -2)))
    out.append(("empty", 0, ctl.admit(empty, -3)))
    out.append(("depth", 0, ctl.depth()))
    out.append(("drain all", 0, ctl.take(100)))
    return out, ctl.shed


def test_admission_decides_as_the_reference():
    ours, _ = _txs(port, 40, seed=3)
    theirs = [_to_ref(tx) for tx in ours]
    metrics.reset()
    ref_metrics.reset()
    got, shed = _admission_script(port, ours)
    want, ref_shed = _admission_script(ref, theirs)
    assert got == want and shed == ref_shed > 0
    assert any(d[2][1] == port.REPLAY for d in got if d[0] == "replay")
    retries = [d[2][2] for d in got if d[0] == "admit" and d[2][1] == port.SHED]
    assert retries and len(set(retries)) > 1  # the drain-rate estimate moved the hint
    names = ("ingress.shed", "ingress.replays", "ingress.malformed", "ingress.admitted")
    assert {n: metrics.counter(n).value for n in names} == {n: ref_metrics.counter(n).value for n in names}
    assert metrics.gauge("ingress.lane_depth").value == ref_metrics.gauge("ingress.lane_depth").value
    with pytest.raises(ValueError):
        port.AdmissionController(port.IngressConfig(lanes=(port.LaneSpec("x", 1, 1),)))


PIPE_TXS = 64
BAD_EVERY = 16


def _corrupted(pkg, n: int):
    """n seeded transactions, every BAD_EVERY-th with a bit of R flipped."""
    txs, _ = _txs(pkg, n, seed=11)
    out = []
    for i, tx in enumerate(txs):
        if i % BAD_EVERY == 3:
            sig = bytearray(tx.signature.data)
            sig[5] ^= 0x10
            tx = type(tx)(tx.client, tx.nonce, tx.fee, tx.body, type(tx.signature)(bytes(sig)))
        out.append(tx)
    return out


def _ref_backend():
    try:
        from hotstuff_tpu.crypto.backend import CpuBackend

        backend = CpuBackend()
        backend.verify_batch_mask([b"x"], [RefPublicKey(bytes(32))], [RefSignature(bytes(64))])
        return backend
    except ImportError:
        from hotstuff_tpu.crypto.pysigner import PurePythonBackend

        return PurePythonBackend()


def _drive(pkg, service, txs, batch: int):
    async def body():
        sink: asyncio.Queue = asyncio.Queue()
        pipeline = pkg.IngressPipeline(service, sink, pkg.IngressConfig(verify_batch=batch))
        responses = await asyncio.gather(*[pipeline.submit(tx) for tx in txs])
        bodies = [sink.get_nowait() for _ in range(sink.qsize())]
        return [(r.nonce, r.status) for r in responses], bodies, dict(pipeline.stats), len(service.dedup)

    return asyncio.run(asyncio.wait_for(body(), 120))


def test_pipeline_statuses_and_counters_are_the_references():
    """64 transactions, 1/16 corrupted, through the port's pipeline over a
    CPU `TorchBackend` (one 64-lane batch on the kernels' plain versions)
    and through the reference's over its host verifier: the same statuses,
    forwarded bodies and `ingress.*` counters; the verified-signature
    cache stays empty."""
    ours = _corrupted(port, PIPE_TXS)
    theirs = [_to_ref(tx) for tx in ours]
    metrics.reset()
    ref_metrics.reset()
    backend = TorchBackend(device="cpu")
    try:
        got = _drive(port, BatchVerificationService(backend), ours, PIPE_TXS)
    finally:
        backend.close()
    want = _drive(ref, RefService(_ref_backend()), theirs, PIPE_TXS)
    assert got == want
    statuses = [s for _, s in got[0]]
    assert statuses.count(port.BAD_SIGNATURE) == PIPE_TXS // BAD_EVERY
    assert statuses.count(port.ACCEPTED) == PIPE_TXS - PIPE_TXS // BAD_EVERY
    assert got[3] == 0  # client traffic never enters the cache
    assert backend.stats["device_sigs"] == PIPE_TXS  # one batch on the plain kernels
    names = ("ingress.received", "ingress.verified_sigs", "ingress.rejected_sigs", "ingress.forwarded")
    assert {n: metrics.counter(n).value for n in names} == {n: ref_metrics.counter(n).value for n in names}
    assert metrics.counter("verifier.dedup_hits").value == metrics.counter("verifier.dedup_misses").value == 0


class _FailingBackend:
    name = "failing"

    def verify_batch_mask(self, messages, keys, signatures):
        raise RuntimeError("the card is gone")


def test_a_failed_dispatch_rejects_the_whole_batch():
    """The reference's conservative catch: a dispatch that raises marks its
    batch BAD_SIGNATURE (never forwarded) and counts every lane in
    `ingress.rejected_sigs`, where the bench and the smoke run see it."""
    txs, _ = _txs(port, 6)
    metrics.reset()
    statuses, bodies, stats, _ = _drive(port, BatchVerificationService(_FailingBackend()), txs, 4)
    assert [s for _, s in statuses] == [port.BAD_SIGNATURE] * 6 and bodies == []
    assert stats == {"received": 6, "accepted": 0, "responded": 6}
    assert metrics.counter("ingress.rejected_sigs").value == 6


def test_arrival_curves_are_the_references():
    for kw in (dict(kind="sustained", rate=40.0), dict(kind="diurnal", rate=10.0, peak=90.0, period=8.0),
               dict(kind="flash", rate=20.0, peak=100.0, t_start=1.0, t_end=2.0)):
        ours, theirs = port.ArrivalCurve(**kw), ref.ArrivalCurve(**kw)
        assert ours.to_json() == theirs.to_json()
        assert [ours.rate_at(t / 4) for t in range(40)] == [theirs.rate_at(t / 4) for t in range(40)]
    with pytest.raises(ValueError):
        port.ArrivalCurve(kind="bursty")
    assert loadgen.TICK_S == 0.05 and loadgen._FEE_CHOICES == ref.loadgen._FEE_CHOICES


def test_load_generator_summary_has_the_references_keys():
    async def run(pkg):
        async def submit(tx):
            return pkg.IngressResponse(tx.nonce, pkg.SHED if tx.fee == 0 else pkg.ACCEPTED, 50)

        gen = pkg.OpenLoopLoadGen(submit, pkg.ArrivalCurve(rate=200.0), 0.2, rng=random.Random(5))
        return await gen.run()

    ours, theirs = asyncio.run(run(port)), asyncio.run(run(ref))
    assert set(ours) == set(theirs)
    assert ours["offered"] > 0 and ours["offered"] == ours["responded"]
    assert ours["retry_hints"] == ours["shed"]


def test_new_signed_derives_its_key_when_not_given():
    seed = bytes(range(32))
    tx = port.ClientTransaction.new_signed(seed, 1, 1, b"\x01" + bytes(31))
    theirs = ref.ClientTransaction.new_signed(seed, 1, 1, b"\x01" + bytes(31))
    assert port.encode_ingress_message(tx) == ref.encode_ingress_message(theirs)
    assert isinstance(tx.client, PublicKey) and isinstance(tx.signature, Signature)
