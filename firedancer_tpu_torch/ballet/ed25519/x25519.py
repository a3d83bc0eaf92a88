"""X25519 Diffie-Hellman (RFC 7748) — the TLS 1.3 key-exchange group.

Role parity with the reference's src/ballet/ed25519/fd_x25519.{h,c}
(fd_x25519_exchange / fd_x25519_public): Montgomery-ladder scalar
multiplication on Curve25519's u-coordinate. The reference shares field
arithmetic with its Ed25519 backends; here the ladder runs on Python
bignums (this is the handshake path — a few exchanges per connection —
not the batched hot path, which lives in the ops package).

The port's copy of ``firedancer_tpu/ballet/ed25519/x25519.py``.
"""

from __future__ import annotations

P = 2**255 - 19
_A24 = 121665

BASE_POINT = (9).to_bytes(32, "little")


def _clamp(k: bytes) -> int:
    e = bytearray(k)
    e[0] &= 248
    e[31] &= 127
    e[31] |= 64
    return int.from_bytes(e, "little")


def x25519(scalar: bytes, u_point: bytes) -> bytes:
    """scalar * u_point on the Montgomery curve; both 32-byte strings."""
    if len(scalar) != 32 or len(u_point) != 32:
        raise ValueError("x25519 operands must be 32 bytes")
    k = _clamp(scalar)
    # mask the non-canonical high bit per RFC 7748 §5
    u = int.from_bytes(u_point, "little") & ((1 << 255) - 1)

    x1 = u
    x2, z2 = 1, 0
    x3, z3 = u, 1
    swap = 0
    for t in range(254, -1, -1):
        kt = (k >> t) & 1
        if swap ^ kt:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % P
        aa = (a * a) % P
        b = (x2 - z2) % P
        bb = (b * b) % P
        e = (aa - bb) % P
        c = (x3 + z3) % P
        d = (x3 - z3) % P
        da = (d * a) % P
        cb = (c * b) % P
        x3 = (da + cb) % P
        x3 = (x3 * x3) % P
        z3 = (da - cb) % P
        z3 = (x1 * z3 * z3) % P
        x2 = (aa * bb) % P
        z2 = (e * ((aa + _A24 * e) % P)) % P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = (x2 * pow(z2, P - 2, P)) % P
    return out.to_bytes(32, "little")


def x25519_public(scalar: bytes) -> bytes:
    """Public key for a 32-byte secret (scalar * base point)."""
    return x25519(scalar, BASE_POINT)
