"""The plain reference against RFC 8032's first test vector and OpenSSL,
on valid signatures and signatures with one bit flipped."""

import random

import pytest

from portbench import reference

# RFC 8032, section 7.1, TEST 1 (empty message).
PK = bytes.fromhex("d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a")
SIG = bytes.fromhex("e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b")


def test_rfc8032_vector():
    assert reference.verify(b"", PK, SIG)
    assert not reference.verify(b"\x00", PK, SIG)


def test_agrees_with_openssl_on_valid_and_flipped():
    ed = pytest.importorskip("cryptography.hazmat.primitives.asymmetric.ed25519")
    from cryptography.exceptions import InvalidSignature

    rng = random.Random(11)
    triples, want = [], []
    for i in range(48):
        sk = ed.Ed25519PrivateKey.from_private_bytes(rng.randbytes(32))
        m = rng.randbytes(32)
        s = bytearray(sk.sign(m))
        if i % 2:
            bit = rng.randrange(512)
            s[bit // 8] ^= 1 << (bit % 8)
        pk = sk.public_key().public_bytes_raw()
        try:
            ed.Ed25519PublicKey.from_public_bytes(pk).verify(bytes(s), m)
            want.append(True)
        except InvalidSignature:
            want.append(False)
        triples.append((m, pk, bytes(s)))
    assert reference.verdicts(triples) == want
    assert sum(want) == 24


def test_rejects_what_does_not_decode_or_is_not_reduced():
    s_big = SIG[:32] + (int.from_bytes(SIG[32:], "little") + reference.L).to_bytes(32, "little")
    assert not reference.verify(b"", PK, s_big)
    assert not reference.verify(b"", (2**255 - 1).to_bytes(32, "little"), SIG)
    assert not reference.verify(b"", PK, SIG[:63])
