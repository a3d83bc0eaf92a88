"""HKDF (RFC 5869) + TLS 1.3 HKDF-Expand-Label (RFC 8446 §7.1).

Role parity with the key-derivation helpers inside the reference's QUIC
crypto suite (the reference's src/tango/quic/crypto/fd_quic_crypto_suites.c,
fd_quic_hkdf_* functions), built on the ballet HMAC primitives.

The port's copy of ``firedancer_tpu/ballet/hkdf.py``.
"""

from __future__ import annotations

from .hmac import hmac_sha256, hmac_sha384

_HMACS = {"sha256": (hmac_sha256, 32), "sha384": (hmac_sha384, 48)}


def hkdf_extract(salt: bytes, ikm: bytes, hash_name: str = "sha256") -> bytes:
    hmac_fn, hash_sz = _HMACS[hash_name]
    if not salt:
        salt = bytes(hash_sz)
    return hmac_fn(salt, ikm)


def hkdf_expand(
    prk: bytes, info: bytes, length: int, hash_name: str = "sha256"
) -> bytes:
    hmac_fn, hash_sz = _HMACS[hash_name]
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = hmac_fn(prk, t + info + bytes([i]))
        out += t
        i += 1
    return out[:length]


def hkdf_expand_label(
    secret: bytes,
    label: bytes,
    context: bytes,
    length: int,
    hash_name: str = "sha256",
) -> bytes:
    """TLS 1.3 HkdfLabel expansion ("tls13 " prefix, RFC 8446 §7.1)."""
    full = b"tls13 " + label
    info = (
        length.to_bytes(2, "big")
        + bytes([len(full)])
        + full
        + bytes([len(context)])
        + context
    )
    return hkdf_expand(secret, info, length, hash_name)
