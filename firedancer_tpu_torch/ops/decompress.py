"""Montgomery-batched point decompression, the plain version of the
kernel behind ``curve_cuda.decompress_niels``: the counterpart of
``firedancer_tpu/ops/decompress_pallas.py`` (``_y_pm1_mask``:212,
``_mont_inv_tree``:233, ``_decompress_block``:242,
``decompress_batched_xla``:316, ``inversion_count``:170).

The donna square root x = u v^3 (u v^7)^((p-5)/8) is restructured so
that one inversion serves a whole group of lanes:

    u = y^2 - 1,  v = d y^2 + 1,  w = u v,  m = u^2 v^3 = w^2 v
    x = w^(2^252) * inv(m)          (= (u v)^((p+3)/8) / v)

``w^(2^252)`` is 252 squarings per lane; ``inv(m)`` comes from a grouped
prefix-product tree, one field inversion per GROUP lanes. The candidate
differs from donna's by a fourth root of unity, and the same root checks
(v x^2 == +-u) and sign fix-up turn either into the unique x, so the
outputs are bit-exact. Lanes with y = +-1 (u = 0, so m = 0 would poison
their group) enter the tree as 1; their x is 0 from the ladder.

The group is the kernel's: one warp of GROUP = 32 lanes, a batch padded
with 1 to a multiple of it. Field elements are ``fe25519`` (B, 10)
tensors; points cross as canonical (B, 4, 5) radix-2^51 limbs.
"""

from __future__ import annotations

import functools

import torch

from . import curve25519 as ge
from . import fe25519 as fe

GROUP_LOG2 = 5                 # one inversion per warp of 32 lanes
GROUP = 1 << GROUP_LOG2
LADDER_SQUARINGS = 252

# The byte strings of y = 1, p - 1 and p + 1: with bit 255 masked these
# are the only encodings of y = +-1 mod p below 2^255.
_PM1 = (1, fe.P - 1, fe.P + 1)


@functools.lru_cache(maxsize=None)
def _pm1_bytes(device: torch.device) -> torch.Tensor:
    return torch.tensor([list(v.to_bytes(32, "little")) for v in _PM1],
                        dtype=torch.uint8, device=device)


def _y_pm1_mask(y_bytes: torch.Tensor) -> torch.Tensor:
    """(B, 32) uint8 encodings -> (B,) bool y == +-1 mod p, from three
    byte compares of y with bit 255 masked: the lanes whose u = y^2 - 1
    is 0, and exactly the lanes whose x is 0."""
    y = torch.cat([y_bytes[:, :31], y_bytes[:, 31:] & 0x7F], dim=1)
    return (y[:, None, :] == _pm1_bytes(y.device)).all(dim=-1).any(dim=-1)


def _mont_inv_tree(m: torch.Tensor, g: int = GROUP_LOG2) -> torch.Tensor:
    """Inverses of (B, 10) field elements, every lane nonzero mod p: the
    batch padded with 1 to a multiple of 2^g, then fe_invert_batch with
    groups of exactly 2^g lanes (one inversion per group)."""
    bsz = m.shape[0]
    pad = -bsz % (1 << g)
    if pad:
        m = torch.cat([m, fe.fe_one((pad,), m.device)])
    return fe.fe_invert_batch(m, group_log2=g)[:bsz]


def _decompress_block(y_bytes: torch.Tensor):
    """The batched decompress of (B, 32) uint8 encodings ->
    ((x, y, z, t) fe, ok): failed lanes carry the identity (0, 1, 1, 0)
    with ok False."""
    dev = y_bytes.device
    bsz = y_bytes.shape[0]
    sign = (y_bytes[:, 31] >> 7) == 1
    y = fe.fe_from_bytes(y_bytes, mask_high_bit=True)
    one = fe.fe_one((bsz,), dev)
    yy = fe.fe_sq(y)
    u = fe.fe_sub(yy, one)
    v = fe.fe_add(fe.fe_mul(yy, fe.fe_const(fe.D_INT, device=dev)), one)
    w = fe.fe_mul(u, v)
    uz = _y_pm1_mask(y_bytes)
    m = fe.fe_select(uz, one, fe.fe_mul(fe.fe_sq(w), v))
    x = fe.fe_mul(fe.fe_sqn(w, LADDER_SQUARINGS), _mont_inv_tree(m))
    vxx = fe.fe_mul(fe.fe_sq(x), v)
    root_ok = fe.fe_eq(vxx, u)
    ok = root_ok | fe.fe_eq(vxx, fe.fe_neg(u))
    x = fe.fe_select(root_ok, x,
                     fe.fe_mul(x, fe.fe_const(fe.SQRT_M1_INT, device=dev)))
    x = fe.fe_select(fe.fe_is_negative(x) != sign, fe.fe_neg(x), x)
    pt = (x, y, one, fe.fe_mul(x, y))
    return ge.point_select(ok, pt, ge.identity((bsz,), dev)), ok


def decompress_batched(y_bytes: torch.Tensor):
    """(B, 32) uint8 -> (point (B, 4, 5) limbs, ok (B,) bool, small_order
    (B,) bool): decompress_batched_xla with want_small_order. The
    small-order mask reads True on failed lanes (the identity)."""
    pt, ok = _decompress_block(y_bytes)
    return ge.to_limbs51(pt), ok, ge.small_order_mask(pt)


def inversion_count(bsz: int) -> int:
    """Field inversions one bsz-lane decompress runs: one per group of
    GROUP lanes, over the batch padded to a multiple of GROUP."""
    return -(-max(0, bsz) // GROUP)
