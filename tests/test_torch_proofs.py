"""The port's commit-proof plane (`hotstuff_tpu_torch/proofs/`) against the
reference's (`hotstuff_tpu/proofs/`): the reference's non-chaos cases of
tests/test_proofs.py over both packages, on the same seeded keys and
inputs, with an exact tolerance (byte and verdict identity).

  * codec: each package decodes the other's bytes and re-encodes them byte
    for byte, the tagged envelope, version-0 interop and version bounds;
  * stateless verification of an entry-list QC proof (pysigner keys) and
    of an AggQC proof at 4 keys (exact BLS, the port's aggregate-key
    registry), tampered proofs: the same verdict from both packages;
  * the registry's ring eviction, persistence written through each
    package's `Store` and reloaded by the other's registry, bounded waiters;
  * `ProofService`: the same reply states and retry hints for the same
    sequence of queries, commits and `now`;
  * the reference's two chaos cases (`ingress_proofs`, `proof_squatter` at
    seed 11) through both packages' chaos planes: the reference's checks
    hold on the port's report, and its `proofs` and `proof_squat`
    sections and `proofs.*` deltas equal the reference's.
"""

from __future__ import annotations

import asyncio
import dataclasses

import pytest

from hotstuff_tpu import proofs as ref
from hotstuff_tpu.consensus import messages as ref_msgs
from hotstuff_tpu.consensus.config import Committee as RefCommittee
from hotstuff_tpu.crypto import aggsig as ref_aggsig
from hotstuff_tpu.crypto import backend as ref_backend
from hotstuff_tpu.crypto import primitives as ref_prim
from hotstuff_tpu.crypto.pysigner import PurePythonBackend
from hotstuff_tpu.store import Store as RefStore
from hotstuff_tpu.utils import metrics as ref_metrics
from hotstuff_tpu.utils import serde as ref_serde
from hotstuff_tpu_torch import proofs as port
from hotstuff_tpu_torch.consensus.config import Committee
from hotstuff_tpu_torch.consensus.messages import QC, AggQC, Block, _vote_digest
from hotstuff_tpu_torch.crypto import Digest, PublicKey, Signature, aggsig, pysigner
from hotstuff_tpu_torch.crypto import backend as port_backend
from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
from hotstuff_tpu_torch.proofs.messages import PROOF_VERSION
from hotstuff_tpu_torch.store import Store
from hotstuff_tpu_torch.utils import metrics
from hotstuff_tpu_torch.utils.serde import Reader, SerdeError, Writer
from tests.common_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tests.common_torch_chaos import chaos_process_state  # noqa: F401  (autouse)


def _fleet(n: int = 4, tag: bytes = b"proof", epoch: int = 1):
    """n (PublicKey, seed) pairs in sorted-key order and both packages'
    committees over them: tests/test_proofs.py's key ceremony."""
    pairs = sorted(pysigner.keypair_from_seed(tag + bytes(31 - len(tag)) + bytes([i])) for i in range(n))
    keys = [(PublicKey(pk), seed) for pk, seed in pairs]
    members = [(pk, 1, ("127.0.0.1", 7100 + i)) for i, (pk, _) in enumerate(keys)]
    cmt = Committee.new(members, epoch=epoch)
    ref_cmt = RefCommittee.new([(ref_prim.PublicKey(pk.data), s, a) for pk, s, a in members], epoch=epoch)
    return keys, cmt, ref_cmt


def _proof_with_qc(keys, round_=3, payload_n=1, reconfig_digest=None):
    """A port CommitProof whose cert is a 3-of-4 pysigner QC over the
    proof's own recomputed block digest."""
    author = keys[round_ % len(keys)][0]
    payload = tuple(Digest.of(f"tx-{i}".encode()) for i in range(payload_n))
    skeleton = port.CommitProof(author, round_, payload, Digest.of(b"parent"), round_ - 1, QC.genesis(),
                                reconfig_digest)
    digest = skeleton.block_digest()
    msg = _vote_digest(digest, round_).data
    votes = tuple((pk, Signature(pysigner.sign(seed, msg))) for pk, seed in keys[:3])
    return dataclasses.replace(skeleton, cert=QC(digest, round_, votes))


def _bytes(obj, version: int | None = None) -> bytes:
    w = Writer()
    obj.encode(w) if version is None else obj.encode(w, version=version)
    return w.bytes()


def _ref_bytes(obj, version: int | None = None) -> bytes:
    w = ref_serde.Writer()
    obj.encode(w) if version is None else obj.encode(w, version=version)
    return w.bytes()


def _to_ref(proof) -> "ref.CommitProof":
    return ref.CommitProof.decode(ref_serde.Reader(_bytes(proof)))


def _verdict(fn) -> str:
    """'ok', or the class name of what `fn` raised."""
    try:
        fn()
    except Exception as e:  # the verdict is the exception's kind
        return type(e).__name__
    return "ok"


@pytest.fixture
def backends():
    """OpenSSL on both sides, restored afterwards."""
    prev_port = port_backend.set_backend(port_backend.CpuBackend())
    prev_ref = ref_backend.set_backend(ref_backend.CpuBackend())
    yield
    port_backend.set_backend(prev_port)
    ref_backend.set_backend(prev_ref)


# --- codec ---------------------------------------------------------------------


def test_proof_wire_roundtrip_equals_the_reference_both_ways():
    keys, _, _ = _fleet()
    for proof in (_proof_with_qc(keys), _proof_with_qc(keys, payload_n=3),
                  _proof_with_qc(keys, reconfig_digest=Digest.of(b"epoch-change"))):
        wire = _bytes(proof)
        theirs = ref.CommitProof.decode(ref_serde.Reader(wire))
        assert _ref_bytes(theirs) == wire
        assert port.CommitProof.decode(Reader(_ref_bytes(theirs))) == proof
        assert proof.encoded_size() == theirs.encoded_size() == len(wire)
        assert proof.block_digest().data == theirs.block_digest().data
    query = port.ProofQuery(keys[0][0], 42, port.MODE_SUBSCRIBE)
    ref_query = ref.ProofQuery(ref_prim.PublicKey(keys[0][0].data), 42, ref.MODE_SUBSCRIBE)
    assert port.encode_proof_message(query) == ref.encode_proof_message(ref_query)
    assert port.decode_proof_message(ref.encode_proof_message(ref_query)) == query
    proof = _proof_with_qc(keys)
    for reply, ref_reply in ((port.ProofReply(42, port.PROOF_OK, 0, proof), ref.ProofReply(42, ref.PROOF_OK, 0,
                                                                                          _to_ref(proof))),
                             (port.ProofReply(7, port.PROOF_SHED, 250), ref.ProofReply(7, ref.PROOF_SHED, 250))):
        wire = port.encode_proof_message(reply)
        assert wire == ref.encode_proof_message(ref_reply)
        assert port.decode_proof_message(wire) == reply
        assert ref.decode_proof_message(wire) == ref_reply
    # trailing garbage is a malformed frame in both
    with pytest.raises(SerdeError):
        port.decode_proof_message(port.encode_proof_message(query) + b"\x00")
    with pytest.raises(ref_serde.SerdeError):
        ref.decode_proof_message(ref.encode_proof_message(ref_query) + b"\x00")


def test_legacy_v0_interop_and_version_bounds():
    keys, _, _ = _fleet()
    proof = _proof_with_qc(keys)
    v0 = _bytes(proof, version=0)
    assert v0 == _ref_bytes(_to_ref(proof), version=0)
    assert port.CommitProof.decode(Reader(v0)) == proof
    assert ref.CommitProof.decode(ref_serde.Reader(v0)) == _to_ref(proof)
    assert port.CommitProof.decode(Reader(v0)).reconfig_digest is None
    with pytest.raises(ValueError):
        _proof_with_qc(keys, reconfig_digest=Digest.of(b"e")).encode(Writer(), version=0)
    agg = dataclasses.replace(proof, cert=AggQC(proof.cert.hash, proof.round, 0b0111, b"\x00" * 48))
    with pytest.raises(ValueError):
        agg.encode(Writer(), version=0)
    with pytest.raises(ValueError):
        proof.encode(Writer(), version=PROOF_VERSION + 8)
    blob = bytearray(port.encode_proof_message(port.ProofReply(1, port.PROOF_OK, 0, proof)))
    blob[15] = 9  # the proof's leading version byte
    with pytest.raises(SerdeError):
        port.decode_proof_message(bytes(blob))
    with pytest.raises(ref_serde.SerdeError):
        ref.decode_proof_message(bytes(blob))


# --- stateless verification ----------------------------------------------------


def test_stateless_verification_equal_verdicts(backends):
    keys, cmt, ref_cmt = _fleet()
    proof = _proof_with_qc(keys, payload_n=2)
    theirs = _to_ref(proof)
    cases = [
        (lambda: proof.verify(cmt), lambda: theirs.verify(ref_cmt)),
        (lambda: proof.verify(cmt, payload_digest=proof.payload[1]),
         lambda: theirs.verify(ref_cmt, payload_digest=theirs.payload[1])),
        (lambda: proof.verify(cmt, payload_digest=Digest.of(b"not-in-the-block")),
         lambda: theirs.verify(ref_cmt, payload_digest=ref_prim.Digest.of(b"not-in-the-block"))),
    ]
    assert [(_verdict(a), _verdict(b)) for a, b in cases] == [
        ("ok", "ok"), ("ok", "ok"), ("ProofVerificationError", "ProofVerificationError")]
    # The port's card route on its plain kernels agrees.
    prev = port_backend.set_backend(TorchBackend(device="cpu", crossover=1, min_bucket=8, max_bucket=8, chunk=8))
    try:
        assert _verdict(lambda: proof.verify(cmt)) == "ok"
    finally:
        port_backend.set_backend(prev)
    # ... and the reference's exact signer-side verifier too.
    prev = ref_backend.set_backend(PurePythonBackend())
    try:
        assert _verdict(lambda: theirs.verify(ref_cmt)) == "ok"
    finally:
        ref_backend.set_backend(prev)


def test_aggqc_proof_at_four_keys_through_the_aggregate_key_registry():
    """An AggQC certificate signed by 3 of 4 exact BLS keys, the port's keys
    in its aggregate-key registry: both packages accept it, both reject it
    with one signer dropped from the bitmap, and the proof's bytes are the
    same."""
    keys, cmt, ref_cmt = _fleet()
    scheme = aggsig.exact_scheme()
    bls = {pk.data: scheme.keypair_from_seed(seed) for pk, seed in keys}
    base = _proof_with_qc(keys)
    digest = base.block_digest()
    msg = _vote_digest(digest, base.round).data
    signers = [pk for pk, _ in keys[:3]]
    bitmap = aggsig.bitmap_from_bytes(aggsig.bitmap_to_bytes(sum(1 << i for i in range(3))))
    sig = scheme.sign(sum(bls[pk.data][1] for pk in signers) % aggsig.R_ORDER, msg)
    proof = dataclasses.replace(base, cert=AggQC(digest, base.round, bitmap, sig))
    theirs = _to_ref(proof)
    assert _ref_bytes(theirs) == _bytes(proof)
    short = dataclasses.replace(proof, cert=AggQC(digest, base.round, 0b0011, sig))
    saved = dict(aggsig._REGISTRY)
    prev_scheme = ref_aggsig.install_agg_scheme(ref_aggsig.exact_scheme())
    prev_reg = ref_aggsig.install_agg_registry({pk: bpk for pk, (bpk, _) in bls.items()})
    try:
        for pk, (bpk, _) in bls.items():
            aggsig.register_agg_key(pk, bpk)
        assert _verdict(lambda: proof.verify(cmt, payload_digest=proof.payload[0])) == "ok"
        assert _verdict(lambda: theirs.verify(ref_cmt, payload_digest=theirs.payload[0])) == "ok"
        assert _verdict(lambda: short.verify(cmt)) == _verdict(lambda: _to_ref(short).verify(ref_cmt)) \
            == "QCRequiresQuorumError"
    finally:
        aggsig._REGISTRY.clear()
        aggsig._REGISTRY.update(saved)
        ref_aggsig.install_agg_scheme(prev_scheme)
        ref_aggsig.install_agg_registry(prev_reg)


def _tampered(proof, keys):
    cert = proof.cert
    (pk0, sig0), *rest = cert.votes
    bad = Signature(sig0.data[:-1] + bytes([sig0.data[-1] ^ 1]))
    return [
        dataclasses.replace(proof, round=proof.round + 1),
        dataclasses.replace(proof, author=keys[0][0] if proof.author != keys[0][0] else keys[1][0]),
        dataclasses.replace(proof, payload=(Digest.of(b"swapped"),)),
        dataclasses.replace(proof, parent_round=proof.parent_round + 1),
        dataclasses.replace(proof, reconfig_digest=Digest.of(b"grafted-epoch")),
        dataclasses.replace(proof, cert=QC(cert.hash, cert.round + 1, cert.votes)),
        dataclasses.replace(proof, cert=QC(cert.hash, cert.round, ((pk0, bad), *rest))),
    ]


def test_tampered_proofs_rejected_by_both(backends):
    keys, cmt, ref_cmt = _fleet()
    proof = _proof_with_qc(keys)
    verdicts = [(_verdict(lambda: t.verify(cmt)), _verdict(lambda: _to_ref(t).verify(ref_cmt)))
                for t in _tampered(proof, keys)]
    assert verdicts == [("ProofVerificationError",) * 2] * 6 + [("InvalidSignatureError",) * 2]


# --- registry -------------------------------------------------------------------


def _committed_chain(keys, rounds, pkg="port"):
    """(block, certifying QC) pairs for rounds 1..rounds, chained as
    Core._commit hands them over, in the port's or the reference's types."""
    m = ref_msgs if pkg == "ref" else None
    author = keys[0][0] if m is None else ref_prim.PublicKey(keys[0][0].data)
    D = Digest if m is None else ref_prim.Digest
    Q, B, S = (QC, Block, Signature) if m is None else (m.QC, m.Block, ref_prim.Signature)
    out, qc = [], Q.genesis()
    for r in range(1, rounds + 1):
        payload = (D.of(f"blk-{r}".encode()),)
        digest = B.make_digest(author, r, list(payload), qc)
        block = B(qc, None, author, r, payload, S(bytes(64)))
        assert block.digest() == digest
        cert = Q(digest, r, ())
        out.append((block, cert))
        qc = cert
    return out


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_registry_ring_eviction_and_persistence_reload_across_packages(run_async, tmp_path, writer):
    """A registry of `writer`'s package persists its ring through its own
    `Store`; the other package's registry and store reload it, and both
    stores hold the same `proof-ring` bytes."""
    keys, _, _ = _fleet()
    path = str(tmp_path / "proof-store")
    reader = "ref" if writer == "port" else "port"
    pkgs = {"port": (port.ProofRegistry, Store), "ref": (ref.ProofRegistry, RefStore)}

    async def write_phase():
        Reg, St = pkgs[writer]
        store = St(path)
        reg = Reg(store=store, capacity=2, persist_window=2)
        chain = _committed_chain(keys, 3, writer)
        for block, cert in chain:
            await reg.note_commit(block, cert)
        assert reg.proof_for_payload(chain[0][0].payload[0]) is None
        assert reg.stats["evicted"] == 1
        rogue, _ = _committed_chain(keys, 1, writer)[0]
        await reg.note_commit(rogue, type(chain[0][1])(type(rogue.payload[0]).of(b"wrong"), rogue.round, ()))
        assert reg.stats["mismatch"] == 1 and reg.proof_for_payload(rogue.payload[0]) is None
        blob = await store.read(b"proof-ring")
        store.close()
        return blob

    blob = run_async(write_phase())
    # The same ring written by the other package: the same bytes.
    other_reg = pkgs[reader][0](capacity=2, persist_window=2)

    async def other_blob():
        store = pkgs[reader][1]()
        other_reg.store = store
        for block, cert in _committed_chain(keys, 3, reader):
            await other_reg.note_commit(block, cert)
        return await store.read(b"proof-ring")

    assert run_async(other_blob()) == blob

    async def reload_phase():
        Reg, St = pkgs[reader]
        store = St(path)
        reg = Reg(store=store)
        assert await reg.load() == 2
        chain = _committed_chain(keys, 3, reader)
        for block, cert in chain[1:]:
            got = reg.proof_for_payload(block.payload[0])
            assert got is not None and got.cert == cert
        assert reg.proof_for_payload(chain[0][0].payload[0]) is None
        store.close()

    run_async(reload_phase())


def test_registry_waiters_bounded_and_commit_wakes_them(run_async):
    keys, _, _ = _fleet()
    client = keys[0][0]

    async def body():
        reg = port.ProofRegistry(max_waiters=2)
        payload = tuple(Digest.of(f"tx-{n}".encode()) for n in range(3))
        digest = Block.make_digest(client, 1, list(payload), QC.genesis())
        block = Block(QC.genesis(), None, client, 1, payload, Signature(bytes(64)))
        cert = QC(digest, 1, ())
        for nonce in (0, 1, 2):
            reg.note_tx(client, nonce, payload[nonce])
        futs = [reg.add_waiter(client, n) for n in (0, 1)]
        assert all(f is not None for f in futs)
        shed = metrics.REGISTRY.counter("proofs.subs_shed").value
        assert reg.add_waiter(client, 2) is None  # table full: shed
        assert metrics.REGISTRY.counter("proofs.subs_shed").value == shed + 1
        assert reg.waiters() == 2
        await reg.note_commit(block, cert)
        for fut in futs:
            assert fut.done() and fut.result().cert == cert
        assert reg.waiters() == 0
        proof, known = reg.proof_for_client(client, 1)
        assert known and proof is not None and proof.cert == cert

    run_async(body())


def test_registry_pairs_flushed_bodies_as_the_reference(run_async):
    """The node path: transactions admitted with their bodies, flushed into
    a payload by body, resolved at the payload's commit; the same counters
    move in both packages' registries (each package's own)."""
    keys, _, _ = _fleet()

    def drive(pkg):
        m = ref_msgs if pkg == "ref" else None
        Reg = ref.ProofRegistry if m else port.ProofRegistry
        P = ref_prim.PublicKey if m else PublicKey
        D = ref_prim.Digest if m else Digest
        chain = _committed_chain(keys, 1, pkg)
        block, cert = chain[0]
        reg = Reg()
        client = P(keys[1][0].data)
        bodies = [b"\x01" + bytes([i]) * 8 for i in range(3)]
        for i, body in enumerate(bodies):
            reg.note_tx(client, i, D.of(body), body=body)
        reg.note_payload(bodies[:2] + [b"front-body"], block.payload[0])

        async def commit():
            await reg.note_commit(block, cert)

        run_async(commit())
        return [reg.proof_for_client(client, i)[1] for i in range(4)], \
            [reg.proof_for_client(client, i)[0] is not None for i in range(3)], reg.size(), dict(reg.stats)

    assert drive("port") == drive("ref") == ([True, True, True, False], [True, True, False], 5,
                                             {"indexed": 1, "resolved": 2, "evicted": 0, "mismatch": 0})


# --- the service ----------------------------------------------------------------


def test_service_reply_states_and_retry_hints_equal_the_reference(run_async):
    """One sequence of queries, commits and `now` through both packages'
    services: equal statuses, retry hints, proofs and stats."""
    keys, _, _ = _fleet()

    def drive(pkg):
        is_ref = pkg == "ref"
        mod = ref if is_ref else port
        P = ref_prim.PublicKey if is_ref else PublicKey
        client = P(keys[0][0].data)
        chain = _committed_chain(keys, 3, pkg)

        async def body():
            reg = mod.ProofRegistry(max_waiters=1)
            svc = mod.ProofService(reg)
            out = []

            async def ask(nonce, mode, now):
                reply = await svc.handle(mod.ProofQuery(client, nonce, mode), now)
                out.append((reply.nonce, reply.status_name, reply.retry_after_ms,
                            None if reply.proof is None else mod.encode_proof_message(reply)))

            await ask(0, mod.MODE_QUERY, 0.0)  # unknown
            await ask(0, mod.MODE_SUBSCRIBE, 0.0)  # unknown subscribe: shed, max hint
            for n, (block, _) in enumerate(chain):
                reg.note_tx(client, n, block.payload[0])
            await ask(0, mod.MODE_QUERY, 0.1)  # pending, max hint
            waiter = asyncio.ensure_future(svc.handle(mod.ProofQuery(client, 1, mod.MODE_SUBSCRIBE), 0.2))
            await asyncio.sleep(0)
            await ask(2, mod.MODE_SUBSCRIBE, 0.2)  # waiter table full: shed
            for t, (block, cert) in zip((0.5, 0.75, 1.5), chain):
                await reg.note_commit(block, cert)
                await ask(chain.index((block, cert)), mod.MODE_QUERY, t)  # ok, feeds the rate EWMA
            reg.note_tx(client, 9, (ref_prim.Digest if is_ref else Digest).of(b"late"))
            await ask(9, mod.MODE_QUERY, 2.0)  # pending, hint from the observed rate
            # The parked subscription, woken by chain[1]'s commit, is read
            # last: its reply is served at the loop's own clock.
            reply = await waiter
            out.append((reply.nonce, reply.status_name, reply.proof is not None))
            return out, dict(svc.stats), reg.size()

        return run_async(body())

    ours, theirs = drive("port"), drive("ref")
    assert ours == theirs
    statuses = [row[1] for row in ours[0]]
    assert statuses == ["unknown", "shed", "pending", "shed", "ok", "ok", "ok", "pending", "ok"]
    hints = [row[2] for row in ours[0] if row[1] in ("shed", "pending")]
    assert hints[:3] == [5_000] * 3 and 50 <= hints[3] < 5_000
    assert ours[1]["served"] == 4 and ours[1]["subs_shed"] == 2


def test_service_counts_under_the_reference_names(run_async):
    """The `proofs.*` counters and histograms keep the reference's names;
    each package counts into its own registry."""
    keys, _, _ = _fleet()
    names = ("proofs.queries", "proofs.served", "proofs.unknown", "proofs.subs_shed")
    before = {n: metrics.REGISTRY.counter(n).value for n in names}
    ref_before = {n: ref_metrics.REGISTRY.counter(n).value for n in names}
    (block, cert), = _committed_chain(keys, 1)

    async def body():
        reg = port.ProofRegistry()
        svc = port.ProofService(reg)
        await svc.handle(port.ProofQuery(keys[0][0], 0), 0.0)
        await svc.handle(port.ProofQuery(keys[0][0], 0, port.MODE_SUBSCRIBE), 0.0)
        reg.note_tx(keys[0][0], 0, block.payload[0])
        await reg.note_commit(block, cert)
        await svc.handle(port.ProofQuery(keys[0][0], 0), 1.0)

    run_async(body())
    assert {n: metrics.REGISTRY.counter(n).value - before[n] for n in names} == {
        "proofs.queries": 3, "proofs.served": 1, "proofs.unknown": 1, "proofs.subs_shed": 1}
    assert {n: ref_metrics.REGISTRY.counter(n).value for n in names} == ref_before
    dump = metrics.dump()
    assert {"proofs.serve_s", "proofs.proof_bytes"} <= set(dump["histograms"])
    assert {"proofs.indexed", "proofs.resolved", "proofs.evicted", "proofs.cert_mismatch"} <= set(dump["counters"])
    assert "proofs.registry_size" in dump["gauges"]


# --- the end-to-end chaos cases (tests/test_proofs.py) -------------------------


def _chaos_reports(name: str) -> tuple[dict, dict]:
    from hotstuff_tpu.chaos import run_scenario as ref_run_scenario
    from hotstuff_tpu_torch.chaos import run_scenario

    return ref_run_scenario(name, seed=11), run_scenario(name, seed=11)


def _proofs_deltas(report: dict) -> dict:
    return {k: v for k, v in report["metrics"].items() if k.startswith("proofs.")}


def test_ingress_proofs_scenario_closes_the_loop():
    """Under link faults every transaction the ingress plane admits and
    consensus commits is provable: each tracked client holds a verified
    proof, none is left unproved, and the worst proof stays inside the
    O(1) byte envelope; the port's sections equal the reference's."""
    from hotstuff_tpu_torch.chaos.scenarios import _proof_bytes_bound

    ref, report = _chaos_reports("ingress_proofs")
    assert report["ok"], report.get("expectation_failures")
    assert report.get("expectation_failures", []) == [] and report["safety_violations"] == []
    summaries = report["proofs"].values()
    assert summaries
    for s in summaries:
        assert s["tracked"] > 0
        assert s["served"] == s["verified_ok"] > 0
        assert s["verify_failed"] == 0 and s["unproved_committed"] == 0
        assert 0 < s["proof_bytes_max"] <= _proof_bytes_bound(4)
        assert s["latency_ms"]["p99"] >= s["latency_ms"]["p50"] > 0
    assert report["metrics"]["proofs.served"] >= 4
    assert report["metrics"].get("proofs.cert_mismatch", 0) == 0
    assert report["proofs"] == ref["proofs"] and _proofs_deltas(report) == _proofs_deltas(ref)


def test_proof_squatter_sheds_without_allocating():
    """A nonce-squatting flood of never-admitted subscriptions is shed to
    the last query while honest clients still get their proofs and every
    registry stays bounded; the port's sections equal the reference's."""
    ref, report = _chaos_reports("proof_squatter")
    assert report["ok"], report.get("expectation_failures")
    assert report.get("expectation_failures", []) == []
    squat = report["proof_squat"].values()
    assert squat
    for s in squat:
        assert s["sent"] > 0 and s["shed"] == s["sent"]
    assert report["metrics"]["proofs.subs_shed"] >= 200
    for s in report["proofs"].values():
        assert s["served"] == s["verified_ok"] > 0
        assert s["registry_size"] <= 3_000
    assert report["proof_squat"] == ref["proof_squat"] and report["proofs"] == ref["proofs"]
    assert _proofs_deltas(report) == _proofs_deltas(ref)
