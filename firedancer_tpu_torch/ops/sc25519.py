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


def _seq_carry(x: torch.Tensor):
    """Exact base-2^16 carry along the last axis: (canonical limbs, the
    carry out of the top limb, negative for a borrow)."""
    limbs = list(x.unbind(-1))
    c = torch.zeros_like(limbs[0])
    for i in range(len(limbs)):
        v = limbs[i] + c
        c = v >> _B_BITS
        limbs[i] = v & 0xFFFF
    return torch.stack(limbs, dim=-1), c


def _conv(a: torch.Tensor, b: list[int], n_out: int) -> torch.Tensor:
    """Limb convolution of a (..., n) with constant limbs b, truncated
    to n_out output limbs (uncarried; each term < 17 * 2^32)."""
    out = torch.zeros(*a.shape[:-1], n_out, dtype=torch.int64,
                      device=a.device)
    for j, bj in enumerate(b):
        if bj == 0 or j >= n_out:
            continue
        n = min(a.shape[-1], n_out - j)
        out[..., j:j + n] += a[..., :n] * bj
    return out


def sc_reduce64(hash_bytes: torch.Tensor) -> torch.Tensor:
    """(..., 64) uint8 little-endian -> canonical (..., 32) uint8 mod L."""
    x8 = hash_bytes.to(torch.int64)
    x = x8[..., 0::2] | (x8[..., 1::2] << 8)             # (..., 32) b=2^16
    q1 = x[..., _K - 1:]                                 # floor(x / b^(k-1))
    q2, _ = _seq_carry(_conv(q1, _MU_LIMBS, 2 * _K + 2))
    q3 = q2[..., _K + 1:]                                # floor(q2 / b^(k+1))
    r2, _ = _seq_carry(_conv(q3, _L_LIMBS, _K + 1))      # q3 * L mod b^(k+1)
    r, _ = _seq_carry(x[..., :_K + 1] - r2)              # mod b^(k+1)
    lt = torch.tensor(_L_LIMBS, dtype=torch.int64, device=x.device)
    for _ in range(2):                                   # r < 3L
        d, borrow = _seq_carry(r - lt)
        r = torch.where((borrow < 0).unsqueeze(-1), r, d)
    r = r[..., :_K]
    return torch.stack([r & 0xFF, r >> 8], dim=-1).flatten(-2).to(torch.uint8)
