"""Plain PyTorch edwards25519 group layer.

Mirrors ``firedancer_tpu/ops/curve25519.py``: extended coordinates
(X:Y:Z:T), T = XY/Z, on -x^2 + y^2 = 1 + d x^2 y^2, with the unified
a = -1 formulas, which are complete, so the torsion points that donna
decompression can produce need no special cases. A point is a tuple of
fe tensors ``(B, 10)`` (``fe25519``); T may be None where nothing reads
it. Batch-uniform control flow: failures become masks.
"""

from __future__ import annotations

import functools

import torch

from ..ballet.ed25519 import oracle as _oracle
from . import fe25519 as fe


def identity(batch_shape, device="cpu"):
    return (fe.fe_zero(batch_shape, device), fe.fe_one(batch_shape, device),
            fe.fe_one(batch_shape, device), fe.fe_zero(batch_shape, device))


def _muls(xs, ys):
    """The elementwise products xs[i] * ys[i] as one fe_mul over the
    stacked operands: the same values, a fraction of the PyTorch ops
    (what bounds the plain version on small batches)."""
    ts = list(xs) + list(ys)
    if any(t.shape != ts[0].shape for t in ts):
        ts = torch.broadcast_tensors(*ts)
    n = len(xs)
    return fe.fe_mul(torch.stack(ts[:n]), torch.stack(ts[n:])).unbind(0)


@functools.lru_cache(maxsize=None)
def _coeffs(rows: tuple, ndim: int, device: torch.device) -> torch.Tensor:
    c = torch.tensor(rows, dtype=torch.int64, device=device)
    return c.reshape(c.shape + (1,) * ndim)


def _lin(rows: tuple, xs):
    """Small integer combinations sum_j rows[i][j] * xs[j] of field
    elements, one carry for all of them (the formulas' adds and subs:
    the same values as chaining fe_add and fe_sub)."""
    ts = torch.broadcast_tensors(*xs)
    c = _coeffs(rows, ts[0].dim(), ts[0].device)
    return fe.fe_carry((c * torch.stack(ts)).sum(dim=1)).unbind(0)


# [a, b, c, d] -> [b - a, 2d - c, 2d + c, b + a]: e, f, g, h of the adds.
_EFGH = ((-1, 1, 0, 0), (0, 0, -1, 2), (0, 0, 1, 2), (1, 1, 0, 0))
# [x1, y1, x2, y2] -> [y1 - x1, y1 + x1, y2 - x2, y2 + x2].
_SUMS = ((-1, 1, 0, 0), (1, 1, 0, 0), (0, 0, -1, 1), (0, 0, 1, 1))
# [x^2, y^2, z^2, (x + y)^2] -> e, f, g, h of the doubling (a = -1):
# e = (x + y)^2 - x^2 - y^2, g = y^2 - x^2, f = g - 2 z^2, h = -x^2 - y^2.
_DBL = ((-1, -1, 0, 1), (-1, 1, -2, 0), (-1, 1, 0, 0), (-1, -1, 0, 0))


def _outputs(e, f, g, h, need_t: bool):
    """(e f, g h, f g[, e h]): the shared last step of the formulas."""
    if need_t:
        return _muls([e, g, f, e], [f, h, g, h])
    return _muls([e, g, f], [f, h, g]) + (None,)


def point_add(p, q, need_t: bool = True):
    """add-2008-hwcd-3, a = -1 (complete)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    d2 = fe.fe_const(fe.D2_INT, device=x1.device)
    ym1, yp1, ym2, yp2 = _lin(_SUMS, (x1, y1, x2, y2))
    a, b, tt, zz = _muls([ym1, yp1, t1, z1], [ym2, yp2, t2, z2])
    c = fe.fe_mul(tt, d2)
    return _outputs(*_lin(_EFGH, (a, b, c, zz)), need_t)


def point_double(p, need_t: bool = True):
    """dbl-2008-hwcd, a = -1. The input T is never read."""
    x1, y1, z1, _ = p
    xy = fe.fe_add(x1, y1)
    sq = _muls([x1, y1, z1, xy], [x1, y1, z1, xy])
    return _outputs(*_lin(_DBL, sq), need_t)


def point_neg(p):
    x, y, z, t = p
    return fe.fe_neg(x), y, z, None if t is None else fe.fe_neg(t)


def point_select(mask, p, q):
    return tuple(fe.fe_select(mask, a, b) for a, b in zip(p, q))


def madd_niels(p, q):
    """Unified mixed add, p extended + q = (yp, ym, t2d) in niels form of
    a Z = 1 point: msm_pallas.py:52 _madd_niels, 7 multiplies, in its
    order. The identity niels (1, 1, 0) scales p projectively."""
    x1, y1, z1, t1 = p
    yp2, ym2, t2d2 = q
    ym1, yp1, _, _ = _lin(_SUMS, (x1, y1, x1, y1))
    a, b, c = _muls([ym1, yp1, t1], [ym2, yp2, t2d2])
    return _outputs(*_lin(_EFGH, (a, b, c, z1)), True)


def niels(p):
    """Niels form (y + x, y - x, 2d t) of Z = 1 points."""
    x, y, _, t = p
    return (fe.fe_add(y, x), fe.fe_sub(y, x),
            fe.fe_mul(t, fe.fe_const(fe.D2_INT, device=x.device)))


# 2p in radix-2^51 limbs: 2p - x is -x with every limb in (0, 2^52) for a
# canonical x, which is what the kernels take.
_TWO_P51 = [(1 << 52) - 38] + [(1 << 52) - 2] * 4


def point_neg_limbs(pt: torch.Tensor) -> torch.Tensor:
    """-P for (B, 4, 5) canonical limbs: X and T become 2p - X, 2p - T
    (limbs in (0, 2^52), the same field elements as fe_neg gives)."""
    two_p = _two_p51(pt.device)
    return torch.stack([two_p - pt[:, 0], pt[:, 1], pt[:, 2],
                        two_p - pt[:, 3]], dim=1)


def is_identity_limbs(pt: torch.Tensor) -> torch.Tensor:
    """(n, >= 3, 5) canonical limbs -> (n,) bool X == 0 and Y == Z, the
    projective identity test (verify_rlc.py:468-471)."""
    return ((pt[:, 0] == 0).all(dim=-1)
            & (pt[:, 1] == pt[:, 2]).all(dim=-1))


def sum_is_identity(p, q) -> torch.Tensor:
    """P + Q is the identity, i.e. P == -Q: X1 Z2 + X2 Z1 == 0 and
    Y1 Z2 - Y2 Z1 == 0 (the same verdict as adding and testing X == 0,
    Y == Z, in four multiplies instead of nine)."""
    x1z2, x2z1, y1z2, y2z1 = _muls([p[0], q[0], p[1], q[1]],
                                   [q[2], p[2], q[2], p[2]])
    zero = fe.fe_is_zero(torch.stack([fe.fe_add(x1z2, x2z1),
                                      fe.fe_sub(y1z2, y2z1)]))
    return zero[0] & zero[1]


@functools.lru_cache(maxsize=None)
def _two_p51(device: torch.device) -> torch.Tensor:
    return torch.tensor(_TWO_P51, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def base_point_limbs(device: torch.device) -> torch.Tensor:
    """The base point B as a (1, 4, 5) Z = 1 extended point (sign.py:29
    _b_point), made once per device; callers must not write to it."""
    x, y = _oracle.B
    return to_limbs51(tuple(fe.fe_const(v, (1,), device)
                            for v in (x, y, 1, x * y % fe.P)))


def niels_limbs(pt: torch.Tensor) -> torch.Tensor:
    """(n, 4, 5) limbs of Z = 1 points -> canonical (n, 3, 5) limbs of
    their niels forms (y + x, y - x, 2d t), what the bucket fill reads."""
    x, y, _, t = from_limbs51(pt)
    return to_limbs51(niels((x, y, None, t)))


@functools.lru_cache(maxsize=None)
def base_niels_limbs(device: torch.device) -> torch.Tensor:
    """B's niels form as (1, 3, 5) limbs, made once per device; callers
    must not write to it."""
    return niels_limbs(base_point_limbs(device))


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


def compress(pt: torch.Tensor) -> torch.Tensor:
    """(B, >= 3, 5) limbs of projective X, Y, Z (limbs in [0, 2^52)) ->
    (B, 32) uint8 canonical encodings: y = Y/Z little-endian, the parity
    of x = X/Z in bit 255 (curve25519.py:229 compress, one inversion per
    lane; Z = 0 encodes as zero bytes)."""
    x, y, z = from_limbs51(pt, 3)
    zinv = fe.fe_invert(z)
    ax, ay = _muls([x, y], [zinv, zinv])
    out = fe.fe_to_bytes(ay)
    sign = fe.fe_is_negative(ax).to(torch.uint8) << 7
    return torch.cat([out[:, :31], (out[:, 31] | sign)[:, None]], dim=1)


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
