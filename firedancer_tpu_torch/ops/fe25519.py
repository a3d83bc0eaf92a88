"""Plain PyTorch arithmetic over GF(2^255 - 19).

The plain version beside the CUDA kernels: the CPU tests run it, and
``chip_smoke.py`` holds each kernel against it on the card. It mirrors
``firedancer_tpu/ops/fe25519.py`` in function, not in layout.

Two layouts meet here:

* **fe** — this module's working form: an int64 tensor ``(..., 10)`` of
  signed limbs in radix 2^25.5 (limb i weighs 2^ceil(25.5 i): 26, 25, 26,
  ... bits). Products of two limbs stay under 2^53, so a whole 10x10
  schoolbook row sum fits int64 without a 128-bit type, which torch does
  not have. torch on the CPU has no add or shift for uint32/uint64, so
  every limb is a signed int64.
* **limbs51** — the kernels' layout: an int64 tensor ``(..., 5)`` of
  radix-2^51 limbs (each 51-bit limb is exactly one 26-bit and one
  25-bit fe limb). Every op of the port hands field elements across in
  this layout, canonical (value < p, limbs < 2^51).

Limb bounds: after any public op every limb has magnitude < 2^26 + 2^20,
so a product term a_i * b_j * 38 stays < 2^58.4 and a 10-term row sum
< 2^61.8. Two carry passes bring such a sum back under 2^26 + 2^15.
"""

from __future__ import annotations

import functools

import torch

P = 2**255 - 19
D_INT = (-121665 * pow(121666, P - 2, P)) % P
D2_INT = 2 * D_INT % P
SQRT_M1_INT = pow(2, (P - 1) // 4, P)

NLIMBS = 10
# Bit offset of each limb: ceil(25.5 * i).
_OFFSETS = [(51 * i + 1) // 2 for i in range(NLIMBS + 1)]
_WIDTHS = [_OFFSETS[i + 1] - _OFFSETS[i] for i in range(NLIMBS)]
M26 = (1 << 26) - 1
M51 = (1 << 51) - 1

# Product schedule: c_k = sum_i a_i * W[i, k] * b[IDX[i, k]], where
# j = (k - i) mod 10; W carries the factor 2 when i and j are both odd
# (their offsets sum one bit past limb k's) and 19 for the wrap past
# 2^255.
_IDX = [[(k - i) % NLIMBS for k in range(NLIMBS)] for i in range(NLIMBS)]
_W = [[(19 if i > k else 1) * (2 if (i & 1 and (k - i) % NLIMBS & 1) else 1)
       for k in range(NLIMBS)] for i in range(NLIMBS)]


def _const(values, device):
    return torch.tensor(values, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """Per-device constants, made once (a tensor made per op would cost
    more than the op on small batches, and a copy to the card per op
    would stall the host): limb widths, their masks, the carry-in
    weights (19 for the wrap into limb 0), the product schedule."""
    return (_const(_WIDTHS, device),
            _const([(1 << w) - 1 for w in _WIDTHS], device),
            _const([19] + [1] * (NLIMBS - 1), device),
            _const(_IDX, device).flatten(), _const(_W, device))


def fe_carry(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry pass over uncarried limbs (each < 2^62 in
    magnitude, e.g. a small integer combination of field elements): each
    limb keeps its low bits and hands the rest (arithmetic shift: exact
    for signed limbs) to the next, the top limb's carry wrapping into
    limb 0 times 19."""
    sh, mask, wrap, _, _ = _tables(x.device)
    return (x & mask) + (x >> sh).roll(1, -1) * wrap


def fe_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fe_carry(a + b)


def fe_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fe_carry(a - b)


def fe_neg(a: torch.Tensor) -> torch.Tensor:
    return fe_carry(-a)


def fe_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _, _, _, idx, w = _tables(a.device)
    g = b.index_select(-1, idx).unflatten(-1, (NLIMBS, NLIMBS))  # (.., i, k)
    c = (a.unsqueeze(-1) * w * g).sum(dim=-2)
    return fe_carry(fe_carry(c))


def fe_sq(a: torch.Tensor) -> torch.Tensor:
    return fe_mul(a, a)


def fe_sqn(a: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        a = fe_sq(a)
    return a


def _seq_carry(x: torch.Tensor, wrap: bool = True) -> torch.Tensor:
    """Exact sequential carry over the limbs (limbs 1..9 end in range;
    the top carry wraps into limb 0 times 19, or is dropped)."""
    limbs = list(x.unbind(-1))
    for i in range(NLIMBS):
        c = limbs[i] >> _WIDTHS[i]
        limbs[i] = limbs[i] & ((1 << _WIDTHS[i]) - 1)
        if i + 1 < NLIMBS:
            limbs[i + 1] = limbs[i + 1] + c
        elif wrap:
            limbs[0] = limbs[0] + 19 * c
    return torch.stack(limbs, dim=-1)


def fe_canonical(x: torch.Tensor) -> torch.Tensor:
    """The unique representative in [0, p), limbs in [0, 2^26/2^25)."""
    x = _seq_carry(_seq_carry(_seq_carry(x)))       # value in [0, 2^255)
    limbs = x.unbind(-1)
    q = (limbs[0] + 19) >> _WIDTHS[0]
    for i in range(1, NLIMBS):
        q = (limbs[i] + q) >> _WIDTHS[i]                # q = (x >= p)
    x = x.clone()
    x[..., 0] += 19 * q
    return _seq_carry(x, wrap=False)


def fe_is_zero(x: torch.Tensor) -> torch.Tensor:
    return (fe_canonical(x) == 0).all(dim=-1)


def fe_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fe_is_zero(fe_sub(a, b))


def fe_is_negative(x: torch.Tensor) -> torch.Tensor:
    """Parity of the canonical representative (bool)."""
    return (fe_canonical(x)[..., 0] & 1) == 1


def fe_select(mask: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.unsqueeze(-1), a, b)


def _bits(b: torch.Tensor, start: int, width: int) -> torch.Tensor:
    """Bits [start, start+width) of little-endian bytes (..., n) int64."""
    out = None
    for j in range(start // 8, (start + width - 1) // 8 + 1):
        sh = 8 * j - start
        term = b[..., j] << sh if sh >= 0 else b[..., j] >> -sh
        out = term if out is None else out | term
    return out & ((1 << width) - 1)


def fe_from_bytes(b: torch.Tensor, mask_high_bit: bool = True) -> torch.Tensor:
    """(..., 32) uint8 little-endian -> fe. Bit 255 (a point encoding's
    x sign) is dropped when mask_high_bit; values >= p are accepted."""
    x = b.to(torch.int64)
    if mask_high_bit:
        x = torch.cat([x[..., :31], x[..., 31:] & 0x7F], dim=-1)
    limbs = [_bits(x, _OFFSETS[i], _WIDTHS[i]) for i in range(NLIMBS - 1)]
    top = _bits(x, _OFFSETS[9], 256 - _OFFSETS[9])    # bit 255 folds in
    limbs.append(top)
    return fe_carry(torch.stack(limbs, dim=-1))


def fe_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """fe -> (..., 32) uint8, canonical little-endian."""
    c = fe_canonical(x)
    out = []
    for j in range(32):
        byte = None
        for i in range(NLIMBS):
            lo, hi = _OFFSETS[i], _OFFSETS[i + 1]
            if hi <= 8 * j or lo >= 8 * j + 8:
                continue
            sh = lo - 8 * j
            term = c[..., i] << sh if sh >= 0 else c[..., i] >> -sh
            byte = term if byte is None else byte | term
        out.append(byte & 0xFF)
    return torch.stack(out, dim=-1).to(torch.uint8)


def fe_from_limbs51(x: torch.Tensor) -> torch.Tensor:
    """(..., 5) int64 radix-2^51 limbs (each in [0, 2^52)) -> fe."""
    lo = x & M26
    hi = x >> 26
    return fe_carry(torch.stack([lo, hi], dim=-1).flatten(-2))


def fe_to_limbs51(x: torch.Tensor) -> torch.Tensor:
    """fe -> canonical (..., 5) int64 radix-2^51 limbs."""
    c = fe_canonical(x)
    return c[..., 0::2] | (c[..., 1::2] << 26)


def fe_from_int(values, device="cpu") -> torch.Tensor:
    """Python ints (any sign) -> (len, 10) fe."""
    rows = []
    for v in values:
        v %= P
        rows.append([(v >> _OFFSETS[i]) & ((1 << _WIDTHS[i]) - 1)
                     for i in range(NLIMBS)])
    return _const(rows, device).reshape(len(rows), NLIMBS)


def fe_to_int(x: torch.Tensor) -> list[int]:
    """fe (B, 10) -> canonical Python ints."""
    rows = x.detach().cpu().tolist()
    return [sum(int(v) << _OFFSETS[i] for i, v in enumerate(r)) % P
            for r in rows]


@functools.lru_cache(maxsize=None)
def _const_row(value: int, device: torch.device) -> torch.Tensor:
    return fe_from_int([value], device)[0]


def fe_const(value: int, batch_shape=(), device="cpu") -> torch.Tensor:
    c = _const_row(value, torch.device(device))
    return c.expand(*batch_shape, NLIMBS).contiguous()


def fe_one(batch_shape=(), device="cpu") -> torch.Tensor:
    return fe_const(1, batch_shape, device)


def fe_zero(batch_shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros(*batch_shape, NLIMBS, dtype=torch.int64, device=device)


def _pow_ladder(z: torch.Tensor):
    """The curve25519 addition chain prefix: (z^(2^250 - 1), z^11)."""
    z2 = fe_sq(z)
    z9 = fe_mul(fe_sqn(z2, 2), z)
    z11 = fe_mul(z9, z2)
    z_5_0 = fe_mul(fe_sq(z11), z9)
    z_10_0 = fe_mul(fe_sqn(z_5_0, 5), z_5_0)
    z_20_0 = fe_mul(fe_sqn(z_10_0, 10), z_10_0)
    z_40_0 = fe_mul(fe_sqn(z_20_0, 20), z_20_0)
    z_50_0 = fe_mul(fe_sqn(z_40_0, 10), z_10_0)
    z_100_0 = fe_mul(fe_sqn(z_50_0, 50), z_50_0)
    z_200_0 = fe_mul(fe_sqn(z_100_0, 100), z_100_0)
    z_250_0 = fe_mul(fe_sqn(z_200_0, 50), z_50_0)
    return z_250_0, z11


def fe_invert(z: torch.Tensor) -> torch.Tensor:
    """z^(p-2) = z^(2^255 - 21)."""
    z_250_0, z11 = _pow_ladder(z)
    return fe_mul(fe_sqn(z_250_0, 5), z11)


def fe_pow22523(z: torch.Tensor) -> torch.Tensor:
    """z^((p-5)/8) = z^(2^252 - 3)."""
    z_250_0, _ = _pow_ladder(z)
    return fe_mul(fe_sqn(z_250_0, 2), z)


def fe_invert_batch(z: torch.Tensor, group_log2: int = 6) -> torch.Tensor:
    """Per-lane inverses of (B, 10) field elements by a grouped Montgomery
    product tree (firedancer_tpu/ops/fe25519.py:924): adjacent lanes are
    multiplied pairwise group_log2 times, one fe_invert runs on the
    B / 2^g group roots, and the inverses come back down (inv_a = inv_ab
    * b). The group shrinks until it divides B. A lane that is 0 mod p
    poisons its whole group (callers mask such lanes to 1)."""
    bsz = z.shape[0]
    if bsz == 0:
        return z
    g = group_log2
    while g > 0 and bsz % (1 << g):
        g -= 1
    pairs = []
    cur = z
    for _ in range(g):
        a, b = cur[0::2], cur[1::2]
        pairs.append((a, b))
        cur = fe_mul(a, b)
    inv = fe_invert(cur)
    for a, b in reversed(pairs):
        both = fe_mul(torch.stack([inv, inv]), torch.stack([b, a]))
        inv = both.transpose(0, 1).reshape(-1, NLIMBS)   # inv_a, inv_b
    return inv
