"""Bit-exact pure-Python Ed25519 oracle (the port's own copy).

The port's own version of ``firedancer_tpu/ballet/ed25519/oracle.py``:
the port never imports the JAX package, so it keeps this module beside
its kernels. It supplies the curve constants and ``point_add`` for the
constant tables of the CUDA kernels, and ``sign``/``keypair_from_seed``
for test and smoke traffic. It differs from the JAX package's in one
place: ``scalarmult`` runs its ladder in extended coordinates with one
inversion at the end (the same affine result, made faster for signing
the smoke traffic); ``tests/test_torch_verify.py`` holds it against
RFC 8032 and against the JAX package's ladder.

Semantics follow RFC 8032 with the reference verifier's choices:

1. **s-range check**: reject s >= L with ERR_SIG (upstream semantics).
2. **Point decompression** is donna-style: the top bit of the y-encoding
   is masked off, y is *not* required to be canonical (y >= p is accepted
   and reduced), x == 0 with sign bit 1 is accepted. A failed square root
   yields ERR_PUBKEY.
3. **Acceptance test** is the 2-point path: decompress A and R, reject
   small-order A (ERR_PUBKEY) and small-order R (ERR_SIG), and compare
   h*(-A) + s*B with the decoded R as group elements.

All arithmetic uses Python big ints — slow, but unambiguous.
"""

from __future__ import annotations

import hashlib

__all__ = [
    "FD_ED25519_SUCCESS",
    "FD_ED25519_ERR_SIG",
    "FD_ED25519_ERR_PUBKEY",
    "FD_ED25519_ERR_MSG",
    "verify",
    "sign",
    "keypair_from_seed",
    "point_decompress",
    "point_compress",
    "scalarmult",
    "point_add",
]

# Return codes, same meaning as the reference's fd_ed25519.h error space.
FD_ED25519_SUCCESS = 0
FD_ED25519_ERR_SIG = -1
FD_ED25519_ERR_PUBKEY = -2
FD_ED25519_ERR_MSG = -3

# Curve constants (RFC 8032 section 5.1).
P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p

# Base point B (RFC 8032): y = 4/5, x recovered with even sign.
_By = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int, sign: int):
    """Donna-style x recovery. Returns x or None on sqrt failure.

    Mirrors the behavior of ref/fd_ed25519_ge.c:242-289: accepts x == 0
    regardless of requested sign (no canonicality rejection).
    """
    y %= P
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    # x = u * v^3 * (u * v^7)^((p-5)/8)
    x = (u * pow(v, 3, P) * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P)) % P
    vxx = v * x * x % P
    if vxx != u:
        if vxx == (P - u) % P:
            x = x * SQRT_M1 % P
        else:
            return None
    if (x & 1) != sign:
        x = (P - x) % P
    return x


B = (_recover_x(_By, 0), _By)


def point_decompress(s: bytes):
    """Decompress a 32-byte point encoding. Returns (x, y) or None.

    Donna semantics: bit 255 is the x sign, y is the low 255 bits reduced
    mod p (non-canonical y accepted).
    """
    if len(s) != 32:
        raise ValueError("expected 32 bytes")
    n = int.from_bytes(s, "little")
    sign = n >> 255
    y = (n & ((1 << 255) - 1)) % P
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y)


def point_compress(pt) -> bytes:
    """Canonical 32-byte encoding: y little-endian, bit 255 = x & 1."""
    x, y = pt
    n = (y % P) | ((x & 1) << 255)
    return n.to_bytes(32, "little")


def point_add(p1, p2):
    """Affine twisted-Edwards addition (complete formula)."""
    x1, y1 = p1
    x2, y2 = p2
    k = D * x1 * x2 % P * y1 % P * y2 % P
    x3 = (x1 * y2 + x2 * y1) * pow(1 + k, P - 2, P) % P
    y3 = (y1 * y2 + x1 * x2) * pow(1 - k, P - 2, P) % P
    return (x3, y3)


def _ext_add(p, q):
    """Unified extended-coordinates addition (a = -1, complete)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * D * t1 * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def scalarmult(k: int, pt):
    """Double-and-add scalar multiplication (vartime, oracle only), in
    extended coordinates with one inversion at the end; the same affine
    result as repeated point_add."""
    x, y = pt
    p = (x, y, 1, x * y % P)
    q = (0, 1, 1, 0)  # identity
    while k > 0:
        if k & 1:
            q = _ext_add(q, p)
        p = _ext_add(p, p)
        k >>= 1
    zi = pow(q[2], P - 2, P)
    return (q[0] * zi % P, q[1] * zi % P)


def _sha512_mod_l(*chunks: bytes) -> int:
    h = hashlib.sha512()
    for c in chunks:
        h.update(c)
    return int.from_bytes(h.digest(), "little") % L


def is_small_order(pt) -> bool:
    """8*P == identity (order divides the cofactor), the reference's
    fd_ed25519_ge_p3_is_small_order: 3 doublings + identity check."""
    t = pt
    for _ in range(3):
        t = point_add(t, t)
    return t == (0, 1)


def verify(msg: bytes, sig: bytes, public_key: bytes) -> int:
    """Verify an Ed25519 signature. Returns an FD_ED25519_* status code.

    Matches the reference's fd_ed25519_verify DEFAULT (2-point) path
    (fd_ed25519_user.c:346-433, FD_ED25519_VERIFY_USE_2POINT=1): s-range
    check, decompress BOTH A and R, reject small-order A (ERR_PUBKEY)
    and small-order R (ERR_SIG), then compare h*(-A)+s*B against the
    DECODED R as group elements. Pinned by the 396 Zcash malleability
    vectors (tests/test_ed25519_malleability.py) — the round-4 1-point
    form (compress + byte-compare, no small-order checks) accepted 12
    of the reference's should-fail vectors.
    """
    if len(sig) != 64:
        return FD_ED25519_ERR_SIG
    if len(public_key) != 32:
        return FD_ED25519_ERR_PUBKEY
    r_bytes = sig[:32]
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return FD_ED25519_ERR_SIG
    A = point_decompress(public_key)
    if A is None:
        return FD_ED25519_ERR_PUBKEY
    R = point_decompress(r_bytes)
    if R is None:
        # frombytes_vartime_2 surfaces a bad R as ERR_PUBKEY (the
        # shared decompress error code), and so do we.
        return FD_ED25519_ERR_PUBKEY
    if is_small_order(A):
        return FD_ED25519_ERR_PUBKEY
    if is_small_order(R):
        return FD_ED25519_ERR_SIG
    h = _sha512_mod_l(r_bytes, public_key, msg)
    neg_A = ((P - A[0]) % P, A[1])
    Rp = point_add(scalarmult(h, neg_A), scalarmult(s, B))
    if Rp != R:
        return FD_ED25519_ERR_MSG
    return FD_ED25519_SUCCESS


def keypair_from_seed(seed: bytes):
    """RFC 8032 key generation: returns (secret_scalar a, prefix, pub_bytes)."""
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    prefix = h[32:]
    A = scalarmult(a, B)
    return a, prefix, point_compress(A)


def sign(msg: bytes, seed: bytes) -> bytes:
    """RFC 8032 signing (oracle/test-fixture generation only)."""
    a, prefix, pub = keypair_from_seed(seed)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    R = scalarmult(r, B)
    r_bytes = point_compress(R)
    h = _sha512_mod_l(r_bytes, pub, msg)
    s = (r + h * a) % L
    return r_bytes + s.to_bytes(32, "little")
