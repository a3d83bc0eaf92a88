"""Minimal X.509: self-signed Ed25519 certificate generation + pubkey extract.

The port's copy of ``firedancer_tpu/ballet/x509.py``, signing with the
native signer only (``ballet.ed25519.native.sign``).

Role parity with the reference's src/ballet/x509/fd_x509.{h,c}, which
generates the self-signed certs Solana p2p QUIC requires (there via OpenSSL;
here with a standalone DER encoder over the ballet Ed25519 signer). The
certificate is the TLS-level identity document; Solana peers extract the
Ed25519 public key from it and ignore the rest of the PKI machinery.
"""

from __future__ import annotations

_OID_ED25519 = bytes([0x06, 0x03, 0x2B, 0x65, 0x70])  # 1.3.101.112
_OID_CN = bytes([0x06, 0x03, 0x55, 0x04, 0x03])  # 2.5.4.3


# ------------------------------------------------------------ DER encode ---

def _der_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def _tlv(tag: int, body: bytes) -> bytes:
    return bytes([tag]) + _der_len(len(body)) + body


def _seq(*parts: bytes) -> bytes:
    return _tlv(0x30, b"".join(parts))


def _int(v: int) -> bytes:
    body = v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big")
    if body[0] & 0x80:
        body = b"\x00" + body
    return _tlv(0x02, body)


def _bitstring(b: bytes) -> bytes:
    return _tlv(0x03, b"\x00" + b)


def _utf8(s: str) -> bytes:
    return _tlv(0x0C, s.encode())


def _utctime(s: str) -> bytes:
    return _tlv(0x17, s.encode())


def _name(cn: str) -> bytes:
    rdn = _tlv(0x31, _seq(_OID_CN, _utf8(cn)))  # SET { SEQ { oid, value } }
    return _seq(rdn)


_ALG_ED25519 = _seq(_OID_ED25519)  # AlgorithmIdentifier, no params


def generate_self_signed(
    seed: bytes,
    cn: str = "firedancer-tpu",
    serial: int = 1,
    not_before: str = "250101000000Z",
    not_after: str = "450101000000Z",
) -> bytes:
    """DER self-signed Ed25519 certificate for the keypair from `seed`.

    Memoized: the cert is a pure function of its arguments and every
    QUIC connection constructs a TlsEndpoint — before the cache, cert
    generation alone (keypair + sign through the Python oracle) cost
    ~0.5 s PER CONNECTION, the dominant term of the fd_siege
    connection-churn handshake rate."""
    return _generate_self_signed_cached(
        bytes(seed), cn, serial, not_before, not_after)


def _ed_sign(msg: bytes, seed: bytes) -> bytes:
    """Ed25519 sign through the native signer (bit-exact against the
    oracle, tests/test_torch_quic_crypto.py); it raises when its library
    does not build, where the JAX signer falls back to the oracle
    (~0.13 ms against ~180 ms a signature: the handshake rate under
    connection churn is set by exactly this)."""
    from .ed25519 import native

    return native.sign(msg, seed)


def _ed_public_key(seed: bytes) -> bytes:
    from .ed25519 import native

    return native.public_key(seed)


from functools import lru_cache as _lru_cache  # noqa: E402


@_lru_cache(maxsize=64)
def _generate_self_signed_cached(
    seed: bytes, cn: str, serial: int, not_before: str, not_after: str,
) -> bytes:
    pub = _ed_public_key(seed)
    spki = _seq(_ALG_ED25519, _bitstring(pub))
    name = _name(cn)
    tbs = _seq(
        _tlv(0xA0, _int(2)),  # [0] EXPLICIT version v3
        _int(serial),
        _ALG_ED25519,
        name,  # issuer == subject (self-signed)
        _seq(_utctime(not_before), _utctime(not_after)),
        name,
        spki,
    )
    sig = _ed_sign(tbs, seed)
    return _seq(tbs, _ALG_ED25519, _bitstring(sig))


# ------------------------------------------------------------- DER parse ---

def _read_tlv(buf: bytes, off: int):
    """-> (tag, body_start, body_end). Raises ValueError on malformed DER."""
    if off + 2 > len(buf):
        raise ValueError("x509: truncated TLV")
    tag = buf[off]
    l0 = buf[off + 1]
    off += 2
    if l0 < 0x80:
        length = l0
    else:
        n = l0 & 0x7F
        if n == 0 or off + n > len(buf):
            raise ValueError("x509: bad length")
        length = int.from_bytes(buf[off : off + n], "big")
        off += n
    if off + length > len(buf):
        raise ValueError("x509: length past end")
    return tag, off, off + length


def extract_ed25519_pubkey(cert_der: bytes) -> bytes:
    """Walk the DER to subjectPublicKeyInfo; return the 32-byte key.

    Raises ValueError if the certificate is malformed or not Ed25519.
    """
    tag, s, e = _read_tlv(cert_der, 0)  # Certificate
    if tag != 0x30:
        raise ValueError("x509: not a SEQUENCE")
    tag, s, e = _read_tlv(cert_der, s)  # TBSCertificate
    if tag != 0x30:
        raise ValueError("x509: bad tbs")
    off = s
    end = e
    # version [0] optional, serial, sigalg, issuer, validity, subject, spki
    tag, bs, be = _read_tlv(cert_der, off)
    if tag == 0xA0:
        off = be
    for _ in range(5):  # serial .. subject
        _, _, off = _read_tlv(cert_der, off)
        if off > end:
            raise ValueError("x509: truncated tbs")
    tag, s, e = _read_tlv(cert_der, off)  # SubjectPublicKeyInfo
    if tag != 0x30:
        raise ValueError("x509: bad spki")
    tag, as_, ae = _read_tlv(cert_der, s)  # AlgorithmIdentifier
    if tag != 0x30 or cert_der[as_:ae][: len(_OID_ED25519)] != _OID_ED25519:
        raise ValueError("x509: not an Ed25519 key")
    tag, ks, ke = _read_tlv(cert_der, ae)  # BIT STRING
    if tag != 0x03 or ke - ks != 33 or cert_der[ks] != 0:
        raise ValueError("x509: bad key bitstring")
    return cert_der[ks + 1 : ke]


def verify_self_signed(cert_der: bytes) -> bool:
    """Check the certificate's Ed25519 signature against its own SPKI key
    (the native verifier)."""
    from .ed25519 import native

    try:
        pub = extract_ed25519_pubkey(cert_der)
        _, s, e = _read_tlv(cert_der, 0)
        tag, ts, te = _read_tlv(cert_der, s)  # TBS
        tbs = cert_der[s:te]  # TBS including its own tag+length header
        off = te
        _, _, off = _read_tlv(cert_der, off)  # sig AlgorithmIdentifier
        tag, ss, se = _read_tlv(cert_der, off)  # signature BIT STRING
        if tag != 0x03 or cert_der[ss] != 0:
            return False
        sig = cert_der[ss + 1 : se]
        return native.verify(tbs, sig, pub) == 0
    except (ValueError, IndexError):
        return False
