"""The certificate codec of the port (`consensus/messages.py`, `utils/serde.py`)
against the reference's, and the bench's `--aggregate-ab` leg on the CPU.

`QC` and `AggQC` must encode byte for byte as the reference's and decode
each other's bytes; `Writer` / `Reader` must round-trip the reference's
bytes. The leg's byte columns are held without the pairing, at the
reference's sizes, and the leg itself runs once at 4 validators (K6's
plain version and one pure-Python pairing)."""

from __future__ import annotations

import hashlib
import json
import random
from pathlib import Path

import pytest

from hotstuff_tpu.consensus import messages as ref_msgs
from hotstuff_tpu.crypto import aggsig as ref_aggsig
from hotstuff_tpu.crypto.primitives import Digest as RefDigest
from hotstuff_tpu.crypto.primitives import PublicKey as RefPublicKey
from hotstuff_tpu.crypto.primitives import Signature as RefSignature
from hotstuff_tpu.utils import serde as ref_serde
from hotstuff_tpu_torch import bench
from hotstuff_tpu_torch.consensus.messages import QC, AggQC, _vote_digest
from hotstuff_tpu_torch.crypto.primitives import Digest, PublicKey, Signature
from hotstuff_tpu_torch.utils import serde
from tests.common_torch_threads import one_torch_thread  # noqa: F401

# The reference's keys of the --aggregate-ab payload (`bench.py:759-790`).
AGG_KEYS = {"metric", "value", "unit", "sizes", "agg_bytes_spread", "all_verified", "backend"}
ROW_KEYS = {"n", "entry_list", "aggregate", "bytes_ratio"}
# AGG_AB_r01.json's entry-list bytes; an AggQC is 204 bytes at every size.
ENTRY_BYTES = {4: 428, 16: 1580, 64: 6188}
ARTIFACT = Path(__file__).resolve().parents[1] / "AGG_AB_r01.json"


def _encode(cert, pkg) -> bytes:
    w = pkg.Writer()
    cert.encode(w)
    return w.bytes()


def _qc_pair(n: int, seed: int):
    """The same n-vote QC in both packages (random bytes as votes)."""
    rng = random.Random(seed)
    h, rnd = rng.randbytes(32), rng.randrange(2**64)
    votes = [(rng.randbytes(32), rng.randbytes(64)) for _ in range(n)]
    ours = QC(Digest(h), rnd, tuple((PublicKey(k), Signature(s)) for k, s in votes))
    theirs = ref_msgs.QC(RefDigest(h), rnd, tuple((RefPublicKey(k), RefSignature(s)) for k, s in votes))
    return ours, theirs


@pytest.mark.parametrize("n", [0, 1, 4, 43, 256])
def test_qc_encodes_as_the_reference_and_decodes_its_bytes(n):
    ours, theirs = _qc_pair(n, n)
    wire = _encode(ours, serde)
    assert wire == _encode(theirs, ref_serde)
    assert len(wire) == 44 + 96 * n
    assert QC.decode(serde.Reader(_encode(theirs, ref_serde))) == ours
    assert _encode(ref_msgs.QC.decode(ref_serde.Reader(wire)), ref_serde) == wire
    assert ours.signed_digest().data == theirs.signed_digest().data


@pytest.mark.parametrize("members", [1, 4, 64, 256, 512])
def test_aggqc_encodes_as_the_reference_and_decodes_its_bytes(members):
    rng = random.Random(members)
    h, rnd = rng.randbytes(32), rng.randrange(2**64)
    bitmap = rng.getrandbits(members) | 1 << (members - 1)
    sig = rng.randbytes(96)
    ours, theirs = AggQC(Digest(h), rnd, bitmap, sig), ref_msgs.AggQC(RefDigest(h), rnd, bitmap, sig)
    wire = _encode(ours, serde)
    assert wire == _encode(theirs, ref_serde) and len(wire) == 204
    assert AggQC.decode(serde.Reader(wire)) == ours
    assert ref_msgs.AggQC.decode(ref_serde.Reader(wire)) == theirs
    assert ours.signed_digest() == Digest(theirs.signed_digest().data)


def test_vote_digest_is_the_references():
    for rnd in (0, 1, 2**64 - 1):
        h = hashlib.sha512(b"%d" % rnd).digest()[:32]
        assert _vote_digest(Digest(h), rnd).data == ref_msgs._vote_digest(RefDigest(h), rnd).data
    assert _encode(QC(Digest(bytes(32)), 0, ()), serde) == _encode(ref_msgs.QC.genesis(), ref_serde)
    with pytest.raises(ValueError):
        Digest(bytes(31))


def test_writer_and_reader_round_trip_the_references_bytes():
    rng = random.Random(3)
    w, rw = serde.Writer(), ref_serde.Writer()
    ops = [("u8", rng.randrange(256)), ("u32", rng.randrange(2**32)), ("u64", rng.randrange(2**64)),
           ("var_bytes", rng.randbytes(37)), ("raw", rng.randbytes(5))]
    for name, v in ops:
        getattr(w, name)(v)
        getattr(rw, name)(v)
    w.fixed(b"\x01" * 8, 8)
    rw.fixed(b"\x01" * 8, 8)
    w.seq([1, 2, 3], lambda wr, x: wr.u32(x))
    rw.seq([1, 2, 3], lambda wr, x: wr.u32(x))
    data = w.bytes()
    assert data == rw.bytes()
    r = serde.Reader(data)
    assert [r.u8(), r.u32(), r.u64(), r.var_bytes(), r.fixed(5), r.fixed(8)] == [v for _, v in ops] + [b"\x01" * 8]
    assert r.seq(lambda rd: rd.u32()) == [1, 2, 3] and r.done()
    r.expect_done()
    with pytest.raises(serde.SerdeError):
        serde.Reader(data[:3]).u32()
    with pytest.raises(serde.SerdeError):
        serde.Reader(data).expect_done()
    with pytest.raises(ValueError):
        serde.Writer().fixed(b"\x00", 2)


@pytest.mark.parametrize("n", sorted(ENTRY_BYTES))
def test_the_legs_certificates_have_the_reference_artifacts_bytes(n):
    """The leg's two certificates at the reference's sizes, without the
    signing and the pairing: an n-vote QC over the leg's digest and an
    n-member AggQC, against the reference's artifact."""
    digest = Digest(hashlib.sha512(b"agg-ab:%d" % n).digest()[:32])
    votes = tuple((PublicKey(bytes([i % 256]) * 32), Signature(bytes(64))) for i in range(n))
    assert len(_encode(QC(digest, 7, votes), serde)) == ENTRY_BYTES[n]
    assert len(_encode(AggQC(digest, 7, (1 << n) - 1, bytes(96)), serde)) == 204
    row = next(r for r in json.loads(ARTIFACT.read_text())["parsed"]["sizes"] if r["n"] == n)
    assert row["entry_list"]["cert_bytes"] == ENTRY_BYTES[n] and row["aggregate"]["cert_bytes"] == 204
    assert ref_aggsig.AGG_BITMAP_BYTES == 64


def test_aggregate_ab_leg_on_the_cpu(tmp_path):
    """`--aggregate-ab --agg-sizes 4` on the CPU: the reference's keys, the
    reference's bytes, every certificate verified, and a trace dump that
    loads."""
    trace = tmp_path / "trace.json"
    line = bench.main(["--device", "cpu", "--aggregate-ab", "--agg-sizes", "4", "--trace-out", str(trace)])
    assert set(line) == AGG_KEYS | {"device", "power_limit_w"}
    (row,) = line["sizes"]
    assert set(row) == ROW_KEYS and row["n"] == 4
    assert row["entry_list"]["cert_bytes"] == 428 and row["aggregate"]["cert_bytes"] == 204
    assert row["entry_list"]["verify_ok"] and row["aggregate"]["verify_ok"] and line["all_verified"]
    assert set(row["aggregate"]) == {"cert_bytes", "verify_ok", "verify_wall_s", "certs_per_s", "table_build_s"}
    assert line["agg_bytes_spread"] == 1.0 and line["value"] == 204.0 and line["backend"] == "cpu"
    assert json.loads(trace.read_text())["v"] == 1
