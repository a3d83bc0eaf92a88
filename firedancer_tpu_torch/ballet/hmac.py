"""HMAC-SHA256 / HMAC-SHA512 (RFC 2104).

Role parity with the reference's fd_hmac
(the reference's src/ballet/hmac/): explicit ipad/opad construction over
the ballet hash primitives rather than delegating to a library HMAC, so
the key-block handling is visible and testable.

The port's copy of ``firedancer_tpu/ballet/hmac.py``.
"""

from __future__ import annotations

import hashlib


def _hmac(hash_name: str, block_sz: int, key: bytes, msg: bytes) -> bytes:
    if len(key) > block_sz:
        key = hashlib.new(hash_name, key).digest()
    key = key + b"\x00" * (block_sz - len(key))
    ipad = bytes(b ^ 0x36 for b in key)
    opad = bytes(b ^ 0x5C for b in key)
    inner = hashlib.new(hash_name, ipad + msg).digest()
    return hashlib.new(hash_name, opad + inner).digest()


def hmac_sha256(key: bytes, msg: bytes) -> bytes:
    return _hmac("sha256", 64, key, msg)


def hmac_sha512(key: bytes, msg: bytes) -> bytes:
    return _hmac("sha512", 128, key, msg)


def hmac_sha384(key: bytes, msg: bytes) -> bytes:
    return _hmac("sha384", 128, key, msg)
