"""Clocks and housekeeping pacing, a copy of ``firedancer_tpu/tango/tempo.py``
(``tickcount``:20, ``lazy_default``:28, ``async_min``:37,
``async_reload``).

``time.perf_counter_ns`` is the tick count; ``lazy_default`` is the
housekeeping interval for a ring of ``depth`` frags, and the jittered
reload keeps tiles from heartbeating in lockstep.
"""

from __future__ import annotations

import time

from ..utils.rng import Rng


def tickcount() -> int:
    return time.perf_counter_ns()


def lazy_default(depth: int) -> int:
    """Default housekeeping interval in ns for a ring of `depth` frags
    (fd_tempo_lazy_default shape: ~depth microseconds / 9, clamped) —
    frequent enough that a consumer lapping the ring is detected, rare
    enough to stay off the hot path."""
    lazy = (int(depth) * 1000) // 9
    return max(1_000, min(lazy, 1_000_000_000))


def async_min(lazy: int) -> int:
    """Largest power of 2 <= max(1, lazy/2): the minimum async interval
    such that jittered reloads average near `lazy`."""
    m = max(1, lazy // 2)
    return 1 << (m.bit_length() - 1)


def async_reload(rng: Rng, amin: int) -> int:
    """Uniform in [amin, 2*amin): the jittered next-housekeeping delta."""
    return amin + rng.roll(amin)
