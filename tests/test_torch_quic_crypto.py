"""The port's QUIC crypto (``firedancer_tpu_torch.ballet``: ``aes``,
``hmac``, ``hkdf``, ``ed25519.x25519``, ``x509`` and the native signer
of ``ed25519.native``) against the standards' vectors and the JAX
package's, on the CPU.

* AES-128/256 FIPS-197, AES-GCM NIST test cases 3 and 4 and the empty
  plaintext, each on the AES-NI path and the bytecode path; random keys,
  nonces, plaintexts and AAD sealed and opened equal to the JAX
  ``AesGcm`` on both paths; the path is chosen once, at construction.
* HMAC against ``hmac``; HKDF RFC 5869 case 1 and the QUIC Initial
  labels of RFC 9001 A.1, equal to the JAX ``hkdf``.
* X25519 RFC 7748 and equality with the JAX ``x25519``.
* The certificate of an identity seed byte-equal to the JAX ``x509``'s.
* Native ``sign`` and ``public_key`` equal to the oracle's; a library
  without the signer raises, naming its path.
"""

import hashlib
import hmac as std_hmac
import os

import numpy as np
import pytest

from firedancer_tpu.ballet import aes as jaes
from firedancer_tpu.ballet import hkdf as jhkdf
from firedancer_tpu.ballet import x509 as jx509
from firedancer_tpu.ballet.ed25519 import oracle as joracle
from firedancer_tpu.ballet.ed25519 import x25519 as jx25519
from firedancer_tpu_torch.ballet import aes as paes
from firedancer_tpu_torch.ballet import hkdf as phkdf
from firedancer_tpu_torch.ballet import hmac as phmac
from firedancer_tpu_torch.ballet import x509 as px509
from firedancer_tpu_torch.ballet.ed25519 import native as pnative
from firedancer_tpu_torch.ballet.ed25519 import oracle as poracle
from firedancer_tpu_torch.ballet.ed25519 import x25519 as px25519
from firedancer_tpu_torch.tango import rings as prings

PATHS = [pytest.param(None, id="ni"), pytest.param(False, id="bytecode")]


def h(s: str) -> bytes:
    return bytes.fromhex(s)


def test_the_path_follows_fd_aes128_has_ni():
    """An AES-128 cipher built by default takes AES-NI exactly where
    fd_aes128_has_ni() says the host has it; native=False and AES-256
    take the bytecode path."""
    ni = paes.aes_path() == "aes-ni"
    assert (paes.Aes(bytes(16))._nat is not None) == ni
    assert paes.Aes(bytes(16), native=False)._nat is None
    assert paes.Aes(bytes(32))._nat is None


@pytest.mark.parametrize("native", PATHS)
@pytest.mark.parametrize("key,expect", [
    ("000102030405060708090a0b0c0d0e0f", "69c4e0d86a7b0430d8cdb78070b4c55a"),
    ("000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f",
     "8ea2b7ca516745bfeafc49904b496089"),
], ids=["aes128", "aes256"])
def test_aes_fips197(native, key, expect):
    a = paes.Aes(h(key), native=native)
    assert a.encrypt_block(h("00112233445566778899aabbccddeeff")) == h(expect)


_GCM_KEY = "feffe9928665731c6d6a8f9467308308"
_GCM_IV = "cafebabefacedbaddecaf888"
_GCM_PT = ("d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
           "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b391aafd255")


@pytest.mark.parametrize("native", PATHS)
def test_gcm_nist_case3(native):
    sealed = paes.AesGcm(h(_GCM_KEY), native=native).seal(
        h(_GCM_IV), h(_GCM_PT), b"")
    assert sealed[:-16] == h(
        "42831ec2217774244b7221b784d0d49ce3aa212f2c02a4e035c17e2329aca12e"
        "21d514b25466931c7d8f6a5aac84aa051ba30b396a0aac973d58e091473f5985")
    assert sealed[-16:] == h("4d5c2af327cd64a62cf35abd2ba6fab4")


@pytest.mark.parametrize("native", PATHS)
def test_gcm_nist_case4_aad(native):
    pt = h(_GCM_PT)[:60]
    aad = h("feedfacedeadbeeffeedfacedeadbeefabaddad2")
    g = paes.AesGcm(h(_GCM_KEY), native=native)
    sealed = g.seal(h(_GCM_IV), pt, aad)
    assert sealed[-16:] == h("5bc94fbc3221a5db94fae95ae7121a47")
    assert g.open(h(_GCM_IV), sealed, aad) == pt
    bad = bytearray(sealed)
    bad[3] ^= 1
    with pytest.raises(ValueError, match="tag mismatch"):
        g.open(h(_GCM_IV), bytes(bad), aad)


@pytest.mark.parametrize("native", PATHS)
def test_gcm_empty_plaintext(native):
    sealed = paes.AesGcm(bytes(16), native=native).seal(bytes(12), b"", b"")
    assert sealed == h("58e2fccefa7e3061367f1d57a4e7455a")


@pytest.mark.parametrize("native", PATHS)
def test_gcm_random_equals_jax(native):
    """Seeded keys, nonces, plaintexts (0 to 1,300 bytes: a datagram)
    and AAD: the port's seal equals the JAX cipher's, and opens back."""
    rng = np.random.default_rng(27)
    for i in range(24):
        ksz = 16 if i % 3 else 32
        key, iv = rng.bytes(ksz), rng.bytes(12)
        pt = rng.bytes(int(rng.integers(0, 1300)))
        aad = rng.bytes(int(rng.integers(0, 40)))
        ours = paes.AesGcm(key, native=native)
        sealed = ours.seal(iv, pt, aad)
        assert sealed == jaes.AesGcm(key).seal(iv, pt, aad), i
        assert ours.open(iv, sealed, aad) == pt
        blk = rng.bytes(16)
        assert (paes.Aes(key, native=native).encrypt_block(blk)
                == jaes.Aes(key).encrypt_block(blk))


def test_aes_path_is_fixed_at_construction(monkeypatch):
    """A cipher keeps the path it was built on; a library that does not
    build raises instead of choosing the bytecode path."""
    g = paes.AesGcm(bytes(16))
    monkeypatch.setattr(paes, "_NATIVE", None)

    def broken(path=None):
        raise OSError("make failed")

    monkeypatch.setattr(prings, "ensure_native_built", broken)
    with pytest.raises(RuntimeError, match="does not build or load"):
        paes.AesGcm(bytes(16))
    with pytest.raises(RuntimeError, match="does not build or load"):
        paes.aes_path()
    # The built cipher still seals on its own path, and the bytecode
    # path needs no library.
    assert g.seal(bytes(12), b"", b"") == h("58e2fccefa7e3061367f1d57a4e7455a")
    assert paes.AesGcm(bytes(16), native=False).seal(
        bytes(12), b"", b"") == h("58e2fccefa7e3061367f1d57a4e7455a")


@pytest.mark.parametrize("fn,algo", [(phmac.hmac_sha256, "sha256"),
                                     (phmac.hmac_sha384, "sha384")])
def test_hmac_equals_stdlib(fn, algo):
    rng = np.random.default_rng(3)
    for ksz in (0, 16, 64, 200):
        key, msg = rng.bytes(ksz), rng.bytes(int(rng.integers(0, 300)))
        assert fn(key, msg) == std_hmac.new(key, msg, algo).digest()


def test_hkdf_rfc5869_case1():
    ikm = bytes([0x0B] * 22)
    salt = h("000102030405060708090a0b0c")
    info = h("f0f1f2f3f4f5f6f7f8f9")
    prk = phkdf.hkdf_extract(salt, ikm)
    assert prk == h(
        "077709362c2e32df0ddc3f0dc47bba6390b6c73bb50f9c3122ec844ad7c2b3e5")
    okm = phkdf.hkdf_expand(prk, info, 42)
    assert okm == h("3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db02d56"
                    "ecc4c5bf34007208d5b887185865")
    assert okm == jhkdf.hkdf_expand(jhkdf.hkdf_extract(salt, ikm), info, 42)


def test_hkdf_quic_initial_labels():
    """RFC 9001 A.1: the Initial secrets and the client's key, iv, hp."""
    initial = phkdf.hkdf_extract(h("38762cf7f55934b34d179ae6a4c80cadccbb7f0a"),
                                 h("8394c8f03e515708"))
    assert initial == h(
        "7db5df06e7a69e432496adedb00851923595221596ae2ae9fb8115c1e9ed0a44")
    client = phkdf.hkdf_expand_label(initial, b"client in", b"", 32)
    assert client == h(
        "c00cf151ca5be075ed0ebfb5c80323c42d6b7db67881289af4008f1f6c357aea")
    assert phkdf.hkdf_expand_label(initial, b"server in", b"", 32) == h(
        "3c199828fd139efd216c155ad844cc81fb82fa8d7446fa7d78be803acdda951b")
    for label, n, want in ((b"quic key", 16, "1f369613dd76d5467730efcbe3b1a22d"),
                           (b"quic iv", 12, "fa044b2f42a3fd3b46fb255c"),
                           (b"quic hp", 16, "9f50449e04a0e810283a1e9933adedd2")):
        got = phkdf.hkdf_expand_label(client, label, b"", n)
        assert got == h(want)
        assert got == jhkdf.hkdf_expand_label(client, label, b"", n)


def test_x25519_rfc7748():
    k = h("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4")
    u = h("e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c")
    assert px25519.x25519(k, u) == h(
        "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552")
    a = h("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
    b = h("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
    a_pub, b_pub = px25519.x25519_public(a), px25519.x25519_public(b)
    assert a_pub == h(
        "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
    shared = h(
        "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742")
    assert px25519.x25519(a, b_pub) == shared == px25519.x25519(b, a_pub)


def test_x25519_equals_jax():
    rng = np.random.default_rng(9)
    for _ in range(6):
        sk, u = rng.bytes(32), rng.bytes(32)
        assert px25519.x25519(sk, u) == jx25519.x25519(sk, u)
        assert px25519.x25519_public(sk) == jx25519.x25519_public(sk)


@pytest.mark.parametrize("seed", [bytes(range(32)), b"\x11" * 32,
                                  hashlib.sha256(b"identity").digest()])
def test_x509_byte_equal_to_jax(seed):
    cert = px509.generate_self_signed(seed, cn="test-node")
    assert cert == jx509.generate_self_signed(seed, cn="test-node")
    assert px509.generate_self_signed(seed) == jx509.generate_self_signed(seed)
    assert px509.extract_ed25519_pubkey(cert) == \
        joracle.keypair_from_seed(seed)[2]
    assert px509.verify_self_signed(cert)
    bad = bytearray(cert)
    bad[len(bad) // 2] ^= 1
    assert not px509.verify_self_signed(bytes(bad))


def test_native_sign_and_public_key_equal_the_oracle():
    rng = np.random.default_rng(11)
    for i in range(8):
        seed = rng.bytes(32)
        msg = rng.bytes(i * 37)
        assert pnative.public_key(seed) == poracle.keypair_from_seed(seed)[2]
        sig = pnative.sign(msg, seed)
        assert sig == poracle.sign(msg, seed)
        assert poracle.verify(msg, sig, pnative.public_key(seed)) == 0
    with pytest.raises(ValueError, match="32 bytes"):
        pnative.sign(b"m", bytes(31))
    with pytest.raises(ValueError, match="32 bytes"):
        pnative.public_key(bytes(33))


def test_native_without_the_signer_raises(monkeypatch):
    """A library that predates the signer raises, naming its path: the
    handshake never signs through the oracle."""

    class VerifyOnly:
        fd_ed25519_cpu_verify1 = fd_ed25519_cpu_verify_batch = object()

    monkeypatch.setattr(pnative, "_SIGN_LIB", None)
    monkeypatch.setattr(pnative, "lib", lambda: VerifyOnly())
    with pytest.raises(RuntimeError, match="libfdtango.so lacks "
                       "fd_ed25519_cpu_sign"):
        pnative.sign(b"m", os.urandom(32))
    with pytest.raises(RuntimeError, match="lacks"):
        px509._ed_sign(b"m", os.urandom(32))
