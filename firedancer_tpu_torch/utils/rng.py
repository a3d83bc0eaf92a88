"""Counter-based splittable PRNG, a copy of ``firedancer_tpu/utils/rng.py``
(``Rng``; the links' and the sink's reservoir sampling, the tiles'
housekeeping jitter).

A splitmix64-style mix of the counter (seq, idx): streams are
reproducible across processes, and equal to the JAX package's draw for
draw.
"""

from __future__ import annotations

import math

_M64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64 finalizer: bijective 64-bit hash."""
    x &= _M64
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _M64
    return x ^ (x >> 31)


class Rng:
    """Counter-based PRNG: position is (seq, idx); draws never collide
    across distinct seqs (the seq is folded in via a second mix round)."""

    __slots__ = ("seq", "idx", "_seq_mix")

    def __init__(self, seq: int = 0, idx: int = 0) -> None:
        self.seq = seq & _M64
        self.idx = idx & _M64
        self._seq_mix = _mix(self.seq ^ 0x9E3779B97F4A7C15)

    def ulong(self) -> int:
        v = _mix(_mix(self.idx) ^ self._seq_mix)
        self.idx = (self.idx + 1) & _M64
        return v

    def uint(self) -> int:
        return self.ulong() >> 32

    def roll(self, n: int) -> int:
        """Unbiased uniform in [0, n) via widening-multiply rejection."""
        assert n > 0
        zone = _M64 - ((_M64 - n + 1) % n)
        while True:
            v = self.ulong()
            res = v * n
            if (res & _M64) <= zone:
                return res >> 64

    def float01(self) -> float:
        """Uniform in [0, 1) with 53 bits."""
        return (self.ulong() >> 11) * (1.0 / (1 << 53))

    def float_exp(self) -> float:
        """Exponential with unit rate (inter-arrival modeling)."""
        u = self.float01()
        # avoid log(0)
        return -math.log(1.0 - u) if u < 1.0 else 745.0

    def float_norm(self) -> float:
        """Standard normal via Box-Muller (one draw per call, cached none)."""
        u1 = max(self.float01(), 1e-300)
        u2 = self.float01()
        return math.sqrt(-2.0 * math.log(u1)) * math.cos(2.0 * math.pi * u2)

    def shuffle(self, items: list) -> list:
        items = list(items)
        for i in range(len(items) - 1, 0, -1):
            j = self.roll(i + 1)
            items[i], items[j] = items[j], items[i]
        return items
