"""Plain PyTorch scalar arithmetic mod L, the group order.

Mirrors ``firedancer_tpu/ops/sc25519.py``: ``sc_check_range`` (upstream
s < L semantics: s >= L is rejected) and ``sc_reduce64`` (Barrett mod L
of a 64-byte little-endian integer). Limbs are int64 tensors; torch on
the CPU has no unsigned 64-bit add or shift.
"""

from __future__ import annotations

import functools

import torch

L = 2**252 + 27742317777372353535851937790883648493
_L_BYTES = [(L >> (8 * i)) & 0xFF for i in range(32)]

# Barrett over radix b = 2^16 with k = 16 (b^(k-1) <= L < b^k):
# mu = floor(b^(2k) / L) has 17 limbs.
_B_BITS = 16
_K = 16
_MU = (1 << 512) // L
_MU_LIMBS = [(_MU >> (_B_BITS * i)) & 0xFFFF for i in range(_K + 1)]
_L_LIMBS = [(L >> (_B_BITS * i)) & 0xFFFF for i in range(_K + 1)]


@functools.lru_cache(maxsize=None)
def _range_consts(device: torch.device):
    """L's bytes and the weights 2^i, made once per device (a copy to
    the card per call would stall the host on the hot path)."""
    return (torch.tensor(_L_BYTES, dtype=torch.int64, device=device),
            torch.tensor([1 << i for i in range(32)], dtype=torch.int64,
                         device=device))


def sc_check_range(s_bytes: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 little-endian -> bool mask s < L.

    The sign of sum_i sign(s_i - L_i) * 2^i is the sign of the most
    significant differing byte, so one weighted sum is the whole
    lexicographic compare."""
    lb, w = _range_consts(s_bytes.device)
    d = torch.sign(s_bytes.to(torch.int64) - lb)
    return (d * w).sum(dim=-1) < 0


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """Barrett constants on the device: mu's and L's limbs, the limbs of
    b^(k+1) - L, and the output column i + j of each limb product of a
    17 x 17 and of a 16 x 16 convolution."""
    i = torch.arange(_K + 1, device=device)
    neg_l = (1 << (_B_BITS * (_K + 1))) - L
    return (torch.tensor(_MU_LIMBS, dtype=torch.int64, device=device),
            torch.tensor(_L_LIMBS, dtype=torch.int64, device=device),
            torch.tensor([(neg_l >> (_B_BITS * j)) & 0xFFFF
                          for j in range(_K + 1)], dtype=torch.int64,
                         device=device),
            (i[:, None] + i[None, :]).flatten(),
            (i[:_K, None] + i[None, :_K]).flatten())


def _normalize(x: torch.Tensor):
    """Exact base-2^16 carry of nonnegative limbs (..., n), each < 2^62:
    (canonical limbs, the carry out of the top limb). Three parallel carry
    passes leave every limb below 2^16 + 2^14 + 1, so a carry-in of at
    most 1 makes a carry-out of at most 1; the last carry chain is then
    resolved at once: the carry out of limb i is that of the nearest limb
    j <= i that is not 0xFFFF (which passes a carry through), generated
    iff limb j >= 2^16. A handful of tensor ops in place of a sequential
    walk over the limbs (the glue runs on the card, where each op is a
    launch)."""
    top = torch.zeros_like(x[..., 0])
    for _ in range(3):
        c = x >> _B_BITS
        top = top + c[..., -1]
        x = (x & 0xFFFF) + torch.nn.functional.pad(c[..., :-1], (1, 0))
    pos = torch.arange(x.shape[-1], device=x.device)
    last, _ = torch.cummax(torch.where(x == 0xFFFF, -1, pos), dim=-1)
    cout = torch.where(last >= 0, torch.gather(x >> _B_BITS, -1,
                                               last.clamp(min=0)), 0)
    x = (x + torch.nn.functional.pad(cout[..., :-1], (1, 0))) & 0xFFFF
    return x, top + cout[..., -1]


def _conv(a: torch.Tensor, b: torch.Tensor, n_out: int) -> torch.Tensor:
    """Limb convolution of a (..., 17) with b (17,), truncated to n_out
    output limbs (uncarried; each column < 17 * 2^32)."""
    idx = _consts(a.device)[3]
    out = torch.zeros(*a.shape[:-1], 2 * _K + 2, dtype=torch.int64,
                      device=a.device)
    out.index_add_(-1, idx, (a.unsqueeze(-1) * b).flatten(-2))
    return out[..., :n_out]


def _reduce_limbs(x: torch.Tensor) -> torch.Tensor:
    """Canonical base-2^16 limbs (..., 32) of x < b^(2k) -> (..., 16)
    limbs of x mod L: Barrett, r = x - q3 L mod b^(k+1) in [0, 3L), then
    at most two subtractions of L. Every step adds nonnegative limbs:
    -y mod b^(k+1) is the limb-wise complement of y plus one, and r - L
    is r + (b^(k+1) - L), whose carry out says r >= L."""
    mu, l_limbs, neg_l, _, _ = _consts(x.device)
    q2, _ = _normalize(_conv(x[..., _K - 1:], mu, 2 * _K + 2))
    q3 = q2[..., _K + 1:]                                # floor(q2 / b^(k+1))
    r2, _ = _normalize(_conv(q3, l_limbs, _K + 1))       # q3 * L mod b^(k+1)
    r, _ = _normalize(x[..., :_K + 1] + (0xFFFF - r2)
                      + torch.nn.functional.pad(
                          torch.ones_like(r2[..., :1]), (0, _K)))
    for _ in range(2):                                   # r < 3L
        d, ge_l = _normalize(r + neg_l)
        r = torch.where((ge_l > 0).unsqueeze(-1), d, r)
    return r[..., :_K]


def sc_reduce64(hash_bytes: torch.Tensor) -> torch.Tensor:
    """(..., 64) uint8 little-endian -> canonical (..., 32) uint8 mod L."""
    return _limbs_to_bytes(_reduce_limbs(_bytes_to_limbs(hash_bytes)))


def _limbs_to_bytes(r: torch.Tensor) -> torch.Tensor:
    """Canonical base-2^16 limbs (..., n) -> (..., 2n) uint8."""
    return torch.stack([r & 0xFF, r >> 8], dim=-1).flatten(-2).to(torch.uint8)


def _bytes_to_limbs(b: torch.Tensor) -> torch.Tensor:
    """(..., 2n) uint8 little-endian -> (..., n) int64 base-2^16 limbs."""
    x8 = b.to(torch.int64)
    return x8[..., 0::2] | (x8[..., 1::2] << 8)


def _mul_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 scalars a, b -> (..., 32) uncarried base-2^16
    columns of a*b (the 16 x 16 limb products, each column < 2^37)."""
    idx = _consts(a.device)[4]
    a16, b16 = _bytes_to_limbs(a), _bytes_to_limbs(b)
    acc = torch.zeros(*a16.shape[:-1], 2 * _K, dtype=torch.int64,
                      device=a.device)
    acc.index_add_(-1, idx, (a16.unsqueeze(-1) * b16.unsqueeze(-2)).flatten(-2))
    return acc


def _reduce_columns(cols: torch.Tensor) -> torch.Tensor:
    """(..., 32) uncarried columns (each < 2^62) of a value < 2^512 ->
    (..., 32) uint8 canonical value mod L."""
    limbs, _ = _normalize(cols)
    return _limbs_to_bytes(_reduce_limbs(limbs))


def sc_muladd(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(a*b + c) mod L on (B, 32) uint8 scalars (sign.py:63 _sc_muladd):
    the limb products summed into 32 columns, the exact carry (a*b + c <
    2^512, so none leaves the top), then the Barrett reduction."""
    return _reduce_columns(_mul_columns(a, b) + torch.nn.functional.pad(
        _bytes_to_limbs(c), (0, _K)))


def sc_sum(s_bytes: torch.Tensor) -> torch.Tensor:
    """Sum of a batch of scalars mod L: (B, 32) uint8 -> (1, 32) uint8
    (sc25519.py:100). Limb sums stay < B * 2^16, exact in int64; their
    carry is a 64-byte integer < B * L, reduced by Barrett."""
    x = _bytes_to_limbs(s_bytes).sum(dim=0, keepdim=True)   # (1, 16)
    return _reduce_columns(torch.nn.functional.pad(x, (0, _K)))
