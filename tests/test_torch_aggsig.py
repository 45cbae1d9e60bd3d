"""The port's copy of the exact BLS12-381 code (hotstuff_tpu_torch/crypto/aggsig.py)
against the JAX package's `hotstuff_tpu/crypto/aggsig.py`: the same
constants, keys, point encodings (and the same refusals of malformed ones),
hash to G2, signatures and pairing verdicts. Inputs come from seeds; every
comparison is exact."""

import hashlib

import pytest

from hotstuff_tpu.crypto import aggsig as ref
from hotstuff_tpu_torch.crypto import aggsig
from tests.common_torch_threads import one_torch_thread  # noqa: F401

PORT, REF = aggsig.ExactBlsScheme(), ref.exact_scheme()


def test_constants_match():
    for name in ("P", "R_ORDER", "X_PARAM", "B_G1", "G1_GEN", "G2_GEN", "KEY_DOMAIN", "DST_DOMAIN",
                 "PK_BYTES", "SIG_BYTES", "XI", "_FP2_NONRESIDUE", "_HARD_EXP"):
        assert getattr(aggsig, name) == getattr(ref, name), name
    assert aggsig._FP_OPS.on_curve(aggsig.G1_GEN) and aggsig._FP2_OPS.on_curve(aggsig.G2_GEN)
    assert aggsig._FP2_OPS.b == ref._FP2_OPS.b == ref._fp2_scalar(ref.B_G2, 1)  # the twist's 4(1 + i)


def test_keypairs_and_g1_encodings_match():
    seeds = [hashlib.sha256(b"aggsig %d" % i).digest() for i in range(4)] + [b"\x00" * 32]
    for seed in seeds:
        pk, sk = PORT.keypair_from_seed(seed)
        assert (pk, sk) == REF.keypair_from_seed(seed)
        pt = aggsig.decompress_g1(pk)
        assert pt == ref.decompress_g1(pk) and aggsig.compress_g1(pt) == pk
        neg = aggsig._g1_neg(pt)
        assert neg == ref._g1_neg(pt) and aggsig.compress_g1(neg) == ref.compress_g1(neg)
    inf = aggsig.compress_g1(None)
    assert inf == ref.compress_g1(None) and aggsig.decompress_g1(inf) is None


def test_g2_encodings_hash_to_g2_and_signatures_match():
    pk, sk = PORT.keypair_from_seed(b"\x05" * 32)
    for msg in (b"", b"qc digest 7"):
        h = aggsig.hash_to_g2(msg)
        assert h == ref.hash_to_g2(msg)
        enc = aggsig.compress_g2(h)
        assert enc == ref.compress_g2(h) and aggsig.decompress_g2(enc) == ref.decompress_g2(enc) == h
        assert aggsig._g2_in_subgroup(h)
        assert PORT.sign(sk, msg) == REF.sign(sk, msg)
    assert aggsig.decompress_g2(aggsig.compress_g2(None)) is None


def _bad_g1() -> list[bytes]:
    x_big = bytearray(aggsig.P.to_bytes(48, "big"))
    x_big[0] |= 0x80
    x = next(x for x in range(1, 64) if pow(x**3 + aggsig.B_G1, (aggsig.P - 1) // 2, aggsig.P) != 1)
    x_off = bytearray(x.to_bytes(48, "big"))  # x^3 + 4 has no square root
    x_off[0] |= 0x80
    return [b"\x00" * 48, b"\x01" * 47, bytes([0xC0]) + b"\x01" + bytes(46), bytes([0xE0]) + bytes(47),
            bytes(x_big), bytes(x_off)]


@pytest.mark.parametrize("i", range(6))
def test_malformed_g1_keys_are_refused_alike(i):
    data = _bad_g1()[i]
    with pytest.raises(ValueError) as port_err:
        aggsig.decompress_g1(data)
    with pytest.raises(ValueError) as ref_err:
        ref.decompress_g1(data)
    assert str(port_err.value) == str(ref_err.value)


def test_malformed_signatures_are_refused_alike():
    for data in (b"\x00" * 96, b"\x80" * 95, bytes([0xC0]) + b"\x01" + bytes(94)):
        with pytest.raises(ValueError) as port_err:
            aggsig.decompress_g2(data)
        with pytest.raises(ValueError) as ref_err:
            ref.decompress_g2(data)
        assert str(port_err.value) == str(ref_err.value)


def test_pairing_verdicts_match():
    """One aggregate: three keys, a signature under their summed secret.
    The right message verifies in both, a wrong message, a missing member
    and a malformed signature fail in both."""
    pairs = [PORT.keypair_from_seed(bytes([i]) * 32) for i in (3, 4, 5)]
    pks = [pk for pk, _ in pairs]
    msg = b"aggregate certificate"
    sig = PORT.sign(sum(sk for _, sk in pairs) % aggsig.R_ORDER, msg)
    cases = [(pks, msg, sig), (pks, b"other", sig), (pks[:2], msg, sig), (pks, msg, b"\x00" * 96)]
    got = [PORT.verify(*c) for c in cases]
    assert got == [REF.verify(*c) for c in cases] == [True, False, False, False]
