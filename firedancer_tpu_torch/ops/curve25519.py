"""Plain PyTorch edwards25519 group layer.

Mirrors ``firedancer_tpu/ops/curve25519.py``: extended coordinates
(X:Y:Z:T), T = XY/Z, on -x^2 + y^2 = 1 + d x^2 y^2, with the unified
a = -1 formulas, which are complete, so the torsion points that donna
decompression can produce need no special cases. A point is a tuple of
fe tensors ``(B, 10)`` (``fe25519``); T may be None where nothing reads
it. Batch-uniform control flow: failures become masks.
"""

from __future__ import annotations

import torch

from ..ballet.ed25519 import oracle as _oracle
from . import fe25519 as fe


def identity(batch_shape, device="cpu"):
    return (fe.fe_zero(batch_shape, device), fe.fe_one(batch_shape, device),
            fe.fe_one(batch_shape, device), fe.fe_zero(batch_shape, device))


def point_add(p, q, need_t: bool = True):
    """add-2008-hwcd-3, a = -1 (complete)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    d2 = fe.fe_const(fe.D2_INT, device=x1.device)
    a = fe.fe_mul(fe.fe_sub(y1, x1), fe.fe_sub(y2, x2))
    b = fe.fe_mul(fe.fe_add(y1, x1), fe.fe_add(y2, x2))
    c = fe.fe_mul(fe.fe_mul(t1, t2), d2)
    zz = fe.fe_mul(z1, z2)
    d_ = fe.fe_add(zz, zz)
    e = fe.fe_sub(b, a)
    f = fe.fe_sub(d_, c)
    g = fe.fe_add(d_, c)
    h = fe.fe_add(b, a)
    t = fe.fe_mul(e, h) if need_t else None
    return fe.fe_mul(e, f), fe.fe_mul(g, h), fe.fe_mul(f, g), t


def point_double(p, need_t: bool = True):
    """dbl-2008-hwcd, a = -1. The input T is never read."""
    x1, y1, z1, _ = p
    a = fe.fe_sq(x1)
    b = fe.fe_sq(y1)
    zz = fe.fe_sq(z1)
    c = fe.fe_add(zz, zz)
    d_ = fe.fe_neg(a)
    e = fe.fe_sub(fe.fe_sub(fe.fe_sq(fe.fe_add(x1, y1)), a), b)
    g = fe.fe_add(d_, b)
    f = fe.fe_sub(g, c)
    h = fe.fe_sub(d_, b)
    t = fe.fe_mul(e, h) if need_t else None
    return fe.fe_mul(e, f), fe.fe_mul(g, h), fe.fe_mul(f, g), t


def point_neg(p):
    x, y, z, t = p
    return fe.fe_neg(x), y, z, None if t is None else fe.fe_neg(t)


def point_select(mask, p, q):
    return tuple(fe.fe_select(mask, a, b) for a, b in zip(p, q))


def decompress(y_bytes: torch.Tensor):
    """(B, 32) uint8 encodings -> ((X, Y, Z, T), ok), donna semantics.

    Accepts non-canonical y (y >= p is reduced) and x == 0 with either
    sign bit. Failed lanes carry the identity with ok False."""
    dev = y_bytes.device
    batch = y_bytes.shape[:-1]
    sign = (y_bytes[..., 31] >> 7) == 1
    y = fe.fe_from_bytes(y_bytes, mask_high_bit=True)
    one = fe.fe_one(batch, dev)
    yy = fe.fe_sq(y)
    u = fe.fe_sub(yy, one)                                  # y^2 - 1
    v = fe.fe_add(fe.fe_mul(yy, fe.fe_const(fe.D_INT, device=dev)), one)
    v3 = fe.fe_mul(fe.fe_sq(v), v)
    uv7 = fe.fe_mul(fe.fe_mul(fe.fe_sq(v3), v), u)          # u v^7
    x = fe.fe_mul(fe.fe_mul(fe.fe_pow22523(uv7), v3), u)    # u v^3 (u v^7)^((p-5)/8)
    vxx = fe.fe_mul(fe.fe_sq(x), v)
    root_ok = fe.fe_eq(vxx, u)
    neg_ok = fe.fe_eq(vxx, fe.fe_neg(u))
    x = fe.fe_select(root_ok, x,
                     fe.fe_mul(x, fe.fe_const(fe.SQRT_M1_INT, device=dev)))
    ok = root_ok | neg_ok
    flip = fe.fe_is_negative(x) != sign
    x = fe.fe_select(flip, fe.fe_neg(x), x)
    pt = (x, y, one, fe.fe_mul(x, y))
    return point_select(ok, pt, identity(batch, dev)), ok


def small_order_mask(p) -> torch.Tensor:
    """8*P == identity: three doublings and a projective identity test."""
    t = p
    for _ in range(3):
        t = point_double(t, need_t=False)
    x8, y8, z8, _ = t
    return fe.fe_is_zero(x8) & fe.fe_eq(y8, z8)


def point_eq_affine(aff, proj) -> torch.Tensor:
    """Affine (ax, ay) equals projective (X:Y:Z): ax*Z == X, ay*Z == Y."""
    ax, ay = aff[:2]
    x, y, z = proj[:3]
    return fe.fe_eq(fe.fe_mul(ax, z), x) & fe.fe_eq(fe.fe_mul(ay, z), y)


def from_limbs51(t: torch.Tensor, coords: int = 4):
    """(B, k, 5) int64 radix-2^51 limbs -> tuple of `coords` fe."""
    return tuple(fe.fe_from_limbs51(t[:, c]) for c in range(coords))


def to_limbs51(pt) -> torch.Tensor:
    """Tuple of fe -> canonical (B, len(pt), 5) int64 limbs."""
    return torch.stack([fe.fe_to_limbs51(c) for c in pt], dim=1)


def windows_from_bytes(scalar_bytes: torch.Tensor) -> torch.Tensor:
    """(B, 32) uint8 -> (B, 64) int64 4-bit windows, least significant
    first (window 2i is the low nibble of byte i)."""
    b = scalar_bytes.to(torch.int64)
    return torch.stack([b & 0xF, b >> 4], dim=-1).flatten(-2)


def base_multiples() -> list[tuple[int, int]]:
    """[0..15]*B as affine Python-int pairs (from the oracle)."""
    pts = [(0, 1), _oracle.B]
    for _ in range(14):
        pts.append(_oracle.point_add(pts[-1], _oracle.B))
    return pts


def _stack_table(pts):
    return tuple(torch.stack([pt[c] for pt in pts], dim=0) for c in range(4))


def _lookup(table, w: torch.Tensor):
    lanes = torch.arange(w.shape[0], device=w.device)
    return tuple(c[w, lanes] for c in table)


def double_scalarmult(h_bytes: torch.Tensor, a_point, s_bytes: torch.Tensor,
                      n_windows: int = 64):
    """R = h*A + s*B over fixed 4-bit windows, most significant first:
    each window is 4 doublings, one add from the per-lane [0..15]*A
    table and one from the shared [0..15]*B table. The A table is built
    by 14 successive adds, as the CUDA kernel builds it, so the two give
    the same projective coordinates. n_windows < 64 runs only the most
    significant windows. Returns (X, Y, Z, None)."""
    dev = h_bytes.device
    bsz = h_bytes.shape[0]
    hw = windows_from_bytes(h_bytes)
    sw = windows_from_bytes(s_bytes)
    a_pts = [identity((bsz,), dev), a_point]
    for _ in range(2, 16):
        a_pts.append(point_add(a_pts[-1], a_point))
    a_tab = _stack_table(a_pts)
    b_pts = []
    for x, y in base_multiples():
        b_pts.append(tuple(fe.fe_const(v, (bsz,), dev)
                           for v in (x, y, 1, x * y % fe.P)))
    b_tab = _stack_table(b_pts)
    r = identity((bsz,), dev)
    for w in range(63, 63 - n_windows, -1):
        for _ in range(3):
            r = point_double(r, need_t=False)
        r = point_double(r, need_t=True)
        r = point_add(r, _lookup(a_tab, hw[:, w]), need_t=True)
        r = point_add(r, _lookup(b_tab, sw[:, w]), need_t=False)
    return r
