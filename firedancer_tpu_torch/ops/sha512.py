"""Plain PyTorch batched SHA-512 (FIPS 180-4) over variable-length rows.

Mirrors ``firedancer_tpu/ops/sha512.py:190`` ``sha512_batch``. Each
64-bit word is a pair of 32-bit halves held in int64 tensors (torch on
the CPU has no unsigned 64-bit add or shift): sums of a few halves stay
far below 2^63 and are masked once.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF


def _icbrt(n: int) -> int:
    x = 1 << ((n.bit_length() + 2) // 3)
    while True:
        y = (2 * x + n // (x * x)) // 3
        if y >= x:
            return x
        x = y


def _primes(n: int) -> list[int]:
    out, k = [], 2
    while len(out) < n:
        if all(k % p for p in out if p * p <= k):
            out.append(k)
        k += 1
    return out


def _frac_bits(root, p: int, shift: int) -> int:
    return root(p << shift) & ((1 << 64) - 1)


# Round constants and IV from their definition: the first 64 bits of the
# fractional parts of the cube roots of the first 80 primes, and of the
# square roots of the first 8 primes.
K = [_frac_bits(_icbrt, p, 192) for p in _primes(80)]
IV = [_frac_bits(math.isqrt, p, 128) for p in _primes(8)]


def _rotr(w, n: int):
    h, l = w
    if n >= 32:
        h, l, n = l, h, n - 32
    if n == 0:
        return h, l
    return (((h >> n) | (l << (32 - n))) & M32,
            ((l >> n) | (h << (32 - n))) & M32)


def _shr(w, n: int):
    h, l = w
    return h >> n, ((l >> n) | (h << (32 - n))) & M32


def _xor(*ws):
    h, l = ws[0]
    for wh, wl in ws[1:]:
        h, l = h ^ wh, l ^ wl
    return h, l


def _add(*ws):
    lo = sum(w[1] for w in ws)
    hi = sum(w[0] for w in ws) + (lo >> 32)
    return hi & M32, lo & M32


def _const(v: int, like: torch.Tensor):
    return (torch.full_like(like, v >> 32), torch.full_like(like, v & M32))


def _compress(state, words):
    """One compression: state and words are lists of (hi, lo) pairs."""
    w = list(words)
    for t in range(16, 80):
        s0 = _xor(_rotr(w[t - 15], 1), _rotr(w[t - 15], 8), _shr(w[t - 15], 7))
        s1 = _xor(_rotr(w[t - 2], 19), _rotr(w[t - 2], 61), _shr(w[t - 2], 6))
        w.append(_add(w[t - 16], s0, w[t - 7], s1))
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        s1 = _xor(_rotr(e, 14), _rotr(e, 18), _rotr(e, 41))
        ch = ((e[0] & f[0]) ^ (~e[0] & M32 & g[0]),
              (e[1] & f[1]) ^ (~e[1] & M32 & g[1]))
        kt = (K[t] >> 32, K[t] & M32)
        t1 = _add(h, s1, ch, kt, w[t])
        s0 = _xor(_rotr(a, 28), _rotr(a, 34), _rotr(a, 39))
        maj = ((a[0] & b[0]) ^ (a[0] & c[0]) ^ (b[0] & c[0]),
               (a[1] & b[1]) ^ (a[1] & c[1]) ^ (b[1] & c[1]))
        t2 = _add(s0, maj)
        h, g, f = g, f, e
        e = _add(d, t1)
        d, c, b = c, b, a
        a = _add(t1, t2)
    return [_add(x, y) for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def sha512_batch(msgs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, max_len) uint8 rows, (B,) lengths -> (B, 64) uint8 digests.

    Lengths are clamped to [0, max_len]. Every lane runs
    ceil((max_len + 17) / 128) compressions; a lane's state stops
    changing after its own last block."""
    bsz, max_len = msgs.shape
    dev = msgs.device
    lens = lengths.to(device=dev, dtype=torch.int64).clamp(0, max_len)
    max_blocks = (max_len + 17 + 127) // 128
    total = max_blocks * 128
    data = torch.zeros(bsz, total, dtype=torch.int64, device=dev)
    data[:, :max_len] = msgs.to(torch.int64)
    pos = torch.arange(total, device=dev).unsqueeze(0)
    ln = lens.unsqueeze(1)
    data = torch.where(pos < ln, data, 0)
    data = torch.where(pos == ln, 0x80, data)
    nblocks = (lens + 17 + 127) // 128
    k = pos - (nblocks * 128 - 8).unsqueeze(1)           # byte of the length
    bitlen = (ln * 8) >> ((7 - k).clamp(0, 7) * 8)
    data = torch.where((k >= 0) & (k < 8), bitlen & 0xFF, data)

    b = data.view(bsz, max_blocks, 16, 8)
    hi = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    lo = (b[..., 4] << 24) | (b[..., 5] << 16) | (b[..., 6] << 8) | b[..., 7]
    zero = torch.zeros(bsz, dtype=torch.int64, device=dev)
    state = [_const(v, zero) for v in IV]
    for blk in range(max_blocks):
        words = [(hi[:, blk, j], lo[:, blk, j]) for j in range(16)]
        new = _compress(state, words)
        active = blk < nblocks
        state = [(torch.where(active, nh, sh), torch.where(active, nl, sl))
                 for (nh, nl), (sh, sl) in zip(new, state)]
    out = []
    for sh, sl in state:
        for half in (sh, sl):
            out.extend((half >> s) & 0xFF for s in (24, 16, 8, 0))
    return torch.stack(out, dim=-1).to(torch.uint8)
