"""The port's wire codecs (`hotstuff_tpu_torch/consensus/messages.py`,
`consensus/reconfig.py`, `mempool/messages.py`, the trace trailer of
`utils/tracing.py` and `network/net.py`'s framing) and its configuration
files (`node/config.py`, `consensus/leader.py`) against the reference's.

Every consensus and mempool message is built twice from the same seeded
inputs, once with each package: the two encodings must be equal byte for
byte, the digests equal, and each package must decode the other's frames
back to the same bytes. Trace trailers, a block carrying an `EpochChange`
and the aggregate-certificate forms (`TAG_PROPOSE_V2`, ...) included.
"""

from __future__ import annotations

import json
import random

import numpy as np
import pytest

pytest.importorskip("cryptography")

import hotstuff_tpu.consensus.leader as r_leader
import hotstuff_tpu.consensus.messages as r_msgs
import hotstuff_tpu.consensus.reconfig as r_reconfig
import hotstuff_tpu.crypto as r_crypto
import hotstuff_tpu.crypto.aggsig as r_aggsig
import hotstuff_tpu.mempool.messages as r_mmsgs
import hotstuff_tpu.network.net as r_net
import hotstuff_tpu.node.config as r_config
import hotstuff_tpu.utils.tracing as r_tracing
import hotstuff_tpu_torch.consensus.leader as p_leader
import hotstuff_tpu_torch.consensus.messages as p_msgs
import hotstuff_tpu_torch.consensus.reconfig as p_reconfig
import hotstuff_tpu_torch.crypto as p_crypto
import hotstuff_tpu_torch.crypto.aggsig as p_aggsig
import hotstuff_tpu_torch.mempool.messages as p_mmsgs
import hotstuff_tpu_torch.network.net as p_net
import hotstuff_tpu_torch.node.config as p_config
import hotstuff_tpu_torch.utils.tracing as p_tracing
from tests.common_torch_threads import one_torch_thread  # noqa: F401  (autouse)

SEED = 2020
PACKAGES = {
    "ref": (r_crypto, r_msgs, r_reconfig, r_mmsgs),
    "port": (p_crypto, p_msgs, p_reconfig, p_mmsgs),
}


def _seeds(n: int) -> list[bytes]:
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, 256, 32, np.uint8).tobytes() for _ in range(n)]


def build(pkg: str) -> dict[str, object]:
    """Every consensus and mempool message of `pkg`, from the same seeded
    inputs whichever the package."""
    crypto, M, R, MP = PACKAGES[pkg]
    rng = np.random.default_rng(SEED + 1)
    raw = lambda n: rng.integers(0, 256, n, np.uint8).tobytes()  # noqa: E731
    keys = []
    for seed in _seeds(4):
        sk = crypto.SecretKey(seed)
        pk = sk.public_key() if pkg == "port" else crypto.PublicKey(sk.to_crypto().public_key().public_bytes_raw())
        keys.append((pk, sk))
    (a, sa), (b, sb), (c, sc), (d, _) = keys
    digests = [crypto.Digest(raw(32)) for _ in range(3)]
    parent = M.Block.new_from_key(M.QC.genesis(), None, a, 1, digests, sa)
    votes = [M.Vote.new_from_key(parent.digest(), 1, pk, sk) for pk, sk in keys[:3]]
    qc = M.QC(parent.digest(), 1, tuple((v.author, v.signature) for v in votes))
    timeouts = [M.Timeout.new_from_key(qc, 2, pk, sk) for pk, sk in keys[:3]]
    tc = M.TC(2, tuple((t.author, t.signature, t.high_qc.round) for t in timeouts))
    members = [(pk, 1, ("127.0.0.1", 7000 + i), ("127.0.0.1", 7100 + i)) for i, (pk, _) in enumerate(keys)]
    change = R.EpochChange.new_from_seed(2, 40, members[:3], b, _seeds(4)[1])
    with_tc = M.Block.new_from_key(qc, tc, b, 3, digests[:1], sb)
    with_change = M.Block.new_from_key(qc, None, c, 4, [], sc, reconfig=change)
    agg_qc = M.AggQC(parent.digest(), 1, 0b0111, raw(96))
    agg_tc = M.AggTC(2, ((1, 0b0011), (0, 0b0100)), raw(96))
    with_agg = M.Block.new_from_key(agg_qc, agg_tc, d, 5, digests[1:], keys[3][1])
    payload = MP.Payload.new_from_key([raw(9), raw(64), b""], a, sa)
    return {
        "block": parent,
        "block_tc": with_tc,
        "block_epoch_change": with_change,
        "block_agg": with_agg,
        "vote": votes[0],
        "timeout": timeouts[1],
        "tc": tc,
        "agg_tc": agg_tc,
        "sync_request": M.SyncRequest(parent.digest(), c),
        "sync_range_request": M.SyncRangeRequest(parent.digest(), 1, d),
        "sync_range_reply": M.SyncRangeReply(with_tc.digest(), (parent, with_tc, with_change)),
        "sync_range_reply_v2": M.SyncRangeReply(with_agg.digest(), (parent, with_agg)),
        "vote_bundle": M.VoteBundle(1, parent.digest(), qc.votes),
        "timeout_bundle": M.TimeoutBundle(2, qc, tc.votes),
        "agg_vote_bundle": M.AggVoteBundle(1, parent.digest(), 0b1011, raw(96), 2),
        "agg_timeout_bundle": M.AggTimeoutBundle(2, agg_qc, ((1, 0b0011),), raw(96), 1),
        "ping": M.Ping(a, 7, 1_700_000_000_000_000),
        "pong": M.Pong(a, b, 7, 1_700_000_000_000_000),
        "payload": payload,
        "payload_request": MP.PayloadRequest((payload.digest(), digests[0]), b),
    }


MEMPOOL = {"payload", "payload_request"}
NAMES = sorted(build("ref"))


def _codec(pkg: str, name: str):
    _, M, _, MP = PACKAGES[pkg]
    if name in MEMPOOL:
        return MP.encode_mempool_message, MP.decode_mempool_message
    return M.encode_consensus_message, M.decode_consensus_message


@pytest.fixture(scope="module")
def messages():
    return {pkg: build(pkg) for pkg in PACKAGES}


@pytest.mark.parametrize("name", NAMES)
def test_message_bytes_equal_and_decode_both_ways(messages, name):
    ref, port = messages["ref"][name], messages["port"][name]
    (r_enc, r_dec), (p_enc, p_dec) = _codec("ref", name), _codec("port", name)
    frame = r_enc(ref)
    assert p_enc(port) == frame
    assert p_enc(p_dec(frame)) == frame
    assert r_enc(r_dec(p_enc(port))) == frame
    if callable(getattr(ref, "digest", None)):
        assert port.digest().data == ref.digest().data
        assert p_dec(frame).digest().data == ref.digest().data


@pytest.mark.parametrize("name", ["block", "block_tc", "block_epoch_change", "block_agg"])
def test_stored_blocks_and_epoch_changes_equal(messages, name):
    ref, port = messages["ref"][name], messages["port"][name]
    stored = r_msgs.encode_stored_block(ref)
    assert p_msgs.encode_stored_block(port) == stored
    assert p_msgs.encode_stored_block(p_msgs.decode_stored_block(stored)) == stored
    assert r_msgs.encode_stored_block(r_msgs.decode_stored_block(p_msgs.encode_stored_block(port))) == stored
    if ref.reconfig is not None:
        assert port.reconfig.digest().data == ref.reconfig.digest().data
        assert str(port.reconfig) == str(ref.reconfig)


@pytest.fixture(scope="module")
def agg_qc_case(messages):
    """A 3-of-4 AggQC signed with seeded BLS keys, in both packages' types."""
    scheme = r_aggsig.ExactBlsScheme()
    bls = [scheme.keypair_from_seed(seed) for seed in _seeds(4)]
    msg = r_msgs._vote_digest(messages["ref"]["block"].digest(), 1).data
    sigs = [scheme.sign(sk, msg) for _, sk in bls[:3]]
    sig, short = scheme.aggregate(sigs), scheme.aggregate(sigs[:2])
    cases = {}
    for pkg in PACKAGES:
        M = PACKAGES[pkg][1]
        keys = [entry[0] for entry in messages[pkg]["tc"].votes] + [messages[pkg]["block_agg"].author]
        committee = M.Committee.new([(pk, 1, ("127.0.0.1", 9000 + i)) for i, pk in enumerate(keys)])
        registry = {pk.data: agg_pk for pk, (agg_pk, _) in zip(committee.sorted_keys(), bls)}
        cases[pkg] = (M.AggQC(messages[pkg]["block"].digest(), 1, 0b0111, sig), committee, registry, short)
    return cases


@pytest.mark.parametrize("case", ["valid", "forged", "unregistered"])
def test_aggregate_qc_verifies_as_the_references(agg_qc_case, monkeypatch, case):
    """An inbound AggQC: the port accepts and rejects what the reference
    does, with each package's aggregate-key registry holding the same keys."""
    verdicts = {}
    for pkg, aggsig in (("ref", r_aggsig), ("port", p_aggsig)):
        qc, committee, registry, short = agg_qc_case[pkg]
        if case == "forged":  # two members' aggregate claiming three
            qc = type(qc)(qc.hash, qc.round, qc.bitmap, short)
        if case == "unregistered":
            registry = dict(list(registry.items())[1:])
        monkeypatch.setattr(aggsig, "_REGISTRY", dict(registry))
        try:
            qc.verify(committee)
            verdicts[pkg] = "ok"
        except Exception as exc:  # noqa: BLE001 — the two packages' error types differ
            verdicts[pkg] = type(exc).__name__
    assert verdicts["port"] == verdicts["ref"] == ("ok" if case == "valid" else "InvalidSignatureError")


@pytest.mark.parametrize("round_, hop", [(0, 0), (7, 3), (2**64 - 1, 255)])
def test_trace_trailer_frames_both_ways(messages, round_, hop):
    """A consensus frame with the 22-byte trace trailer: the same bytes from
    either package's `frame`, each package strips the other's trailer."""
    digest = messages["ref"]["block"].digest().data
    data = r_msgs.encode_consensus_message(messages["ref"]["vote"])
    ours = p_net.frame(data, p_tracing.TraceContext(round_, digest, hop))
    theirs = r_net.frame(data, r_tracing.TraceContext(round_, digest, hop))
    assert ours == theirs and len(ours) == 4 + len(data) + p_tracing.TRAILER_SIZE
    body, ctx = p_tracing.strip_trailer(theirs[4:], count=False)
    assert body == data and (ctx.round, ctx.digest8, ctx.hop) == (round_, digest[:8], hop)
    body, ctx = r_tracing.strip_trailer(ours[4:], count=False)
    assert body == data and ctx.trace_id == p_tracing.trace_id(round_, digest)
    assert p_tracing.strip_trailer(data, count=False) == (data, None)
    assert p_net.frame(data) == r_net.frame(data)


def _committee_file(tmp_path, n: int):
    rng = random.Random(n)
    keys = [r_crypto.generate_keypair(rng) for _ in range(n)]
    cc = r_msgs.Committee.new([(pk, 1, ("127.0.0.1", 9000 + i)) for i, (pk, _) in enumerate(keys)])
    mc = r_config.MempoolCommittee.new([(pk, ("127.0.0.1", 9100 + i), ("127.0.0.1", 9200 + i)) for i, (pk, _) in enumerate(keys)])
    path = tmp_path / f"committee-{n}.json"
    r_config.Committee(cc, mc).write(str(path))
    return path


@pytest.mark.parametrize("n", [4, 7])
def test_configuration_files_and_leaders_agree(tmp_path, n):
    path = _committee_file(tmp_path, n)
    ref, port = r_config.Committee.read(str(path)), p_config.Committee.read(str(path))
    assert port.consensus.to_json() == ref.consensus.to_json()
    assert port.mempool.to_json() == ref.mempool.to_json()
    assert [k.data for k in port.consensus.sorted_keys()] == [k.data for k in ref.consensus.sorted_keys()]
    assert p_config.read_consensus_keys(str(path)) == [k.data for k in ref.consensus.sorted_keys()]
    assert port.consensus.quorum_threshold() == ref.consensus.quorum_threshold()
    ours, theirs = p_leader.LeaderElector(port.consensus), r_leader.LeaderElector(ref.consensus)
    assert [ours.get_leader(r).data for r in range(1, 65)] == [theirs.get_leader(r).data for r in range(1, 65)]
    # Written back by the port, the file reads the same in the reference.
    out = tmp_path / f"port-{n}.json"
    port.write(str(out))
    assert json.loads(out.read_text()) == json.loads(path.read_text())


def test_parameter_and_key_files_agree(tmp_path):
    params = tmp_path / "parameters.json"
    params.write_text(json.dumps({
        "consensus": {"timeout_delay": 1_000, "sync_retry_delay": 10_000, "max_payload_size": 1_000,
                      "min_block_delay": 0},
        "mempool": {"queue_capacity": 10_000, "sync_retry_delay": 10_000, "max_payload_size": 15_000,
                    "min_block_delay": 0, "benchmark_mode": True},
    }))
    ref, port = r_config.NodeParameters.read(str(params)), p_config.NodeParameters.read(str(params))
    assert port.consensus.to_json() == ref.consensus.to_json()
    assert port.mempool.to_json() == ref.mempool.to_json()
    assert p_config.NodeParameters.default().consensus.to_json() == r_config.NodeParameters.default().consensus.to_json()
    assert p_config.NodeParameters.default().mempool.to_json() == r_config.NodeParameters.default().mempool.to_json()
    key = tmp_path / "key.json"
    r_config.Secret.new().write(str(key))
    ref_secret, port_secret = r_config.Secret.read(str(key)), p_config.Secret.read(str(key))
    assert port_secret.name.data == ref_secret.name.data and port_secret.secret.data == ref_secret.secret.data
    # A key file the port writes signs as the reference's does.
    p_config.Secret.new().write(str(key))
    ref_secret, port_secret = r_config.Secret.read(str(key)), p_config.Secret.read(str(key))
    assert port_secret.secret.public_key().data == ref_secret.name.data
    digest = r_crypto.Digest.of(b"vote")
    assert (p_crypto.Signature.new(p_crypto.Digest(digest.data), port_secret.secret).data
            == r_crypto.Signature.new(digest, ref_secret.secret).data)
