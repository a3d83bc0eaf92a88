"""fctl — credit-based flow control for reliable consumers, a copy of
``firedancer_tpu/tango/fctl.py`` (``make_fctl_for_fseqs``).

The fd_fctl model (fd_fctl.h:4-60): a producer serving a mix
of reliable and unreliable consumers keeps `cr_avail` credits; each
publish spends one. Credits are lazily refreshed from every reliable
consumer's fseq: the slowest reliable consumer bounds how far the
producer may run ahead (cr_max at most the ring depth), and slow
consumers are attributed via their fseq's SLOW_CNT diag.

Parameters (fd_fctl semantics):
  cr_burst  max credits a single publish burst needs (>=1)
  cr_max    max credits the producer can bank (<= min rx depth)
  cr_resume if cr_avail falls below cr_burst, wait until refresh yields
            at least cr_resume before resuming (hysteresis)
  cr_refill only refresh from fseqs when cr_avail < cr_refill (limits
            cache-line bouncing on the fseqs)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

from .rings import DIAG_SLOW_CNT


@dataclass
class _Rx:
    seq_query: Callable[[], int]         # consumer progress (fseq read)
    slow_attr: Optional[Callable[[int], None]] = None  # add to SLOW_CNT


def _seq_diff(a: int, b: int) -> int:
    """Signed distance a-b in 64-bit sequence space."""
    d = (a - b) & ((1 << 64) - 1)
    return d - (1 << 64) if d >= (1 << 63) else d


@dataclass
class Fctl:
    depth: int
    cr_burst: int = 1
    cr_max: int = 0
    cr_resume: int = 0
    cr_refill: int = 0
    _rx: List[_Rx] = field(default_factory=list)
    cr_avail: int = 0
    in_backpressure: bool = False
    backp_cnt: int = 0

    def __post_init__(self) -> None:
        if self.cr_max <= 0:
            self.cr_max = self.depth
        self.cr_max = min(self.cr_max, self.depth)
        if self.cr_resume <= 0:
            # Default hysteresis: resume at ~2/3 of cr_max (fd_fctl default
            # shape: resume >= burst, well below max to amortize refresh).
            self.cr_resume = max(self.cr_burst, (2 * self.cr_max) // 3)
        if self.cr_refill <= 0:
            self.cr_refill = max(self.cr_burst, self.cr_resume // 2)

    def rx_add(
        self,
        seq_query: Callable[[], int],
        slow_attr: Optional[Callable[[int], None]] = None,
    ) -> "Fctl":
        """Register a reliable consumer (its fseq query fn)."""
        self._rx.append(_Rx(seq_query, slow_attr))
        return self

    def tx_cr_update(self, cr_avail: int, tx_seq: int) -> int:
        """Housekeeping refresh (fd_fctl_tx_cr_update): recompute credits
        from the slowest reliable consumer. Returns new cr_avail."""
        if cr_avail >= self.cr_refill and not self.in_backpressure:
            self.cr_avail = cr_avail
            return cr_avail
        cr_query = self.cr_max
        slowest = None
        for rx in self._rx:
            rx_seq = rx.seq_query()
            # Consumer has processed up to rx_seq; producer at tx_seq may
            # run ahead at most cr_max.
            cr = self.cr_max - _seq_diff(tx_seq, rx_seq)
            cr = max(0, min(self.cr_max, cr))
            if cr < cr_query:
                cr_query = cr
                slowest = rx
        if self.in_backpressure:
            if cr_query >= self.cr_resume:
                self.in_backpressure = False
                cr_avail = cr_query
            # else stay backpressured with old (insufficient) credits
            elif slowest is not None and slowest.slow_attr:
                slowest.slow_attr(1)
        else:
            cr_avail = cr_query
            if cr_avail < self.cr_burst:
                self.in_backpressure = True
                self.backp_cnt += 1
                if slowest is not None and slowest.slow_attr:
                    slowest.slow_attr(1)
        self.cr_avail = cr_avail
        return cr_avail


def make_fctl_for_fseqs(depth: int, fseqs, cr_burst: int = 1) -> Fctl:
    """Convenience: flow control over tango FSeq objects, attributing
    slow consumers to their DIAG_SLOW_CNT slot."""
    f = Fctl(depth=depth, cr_burst=cr_burst)
    for fs in fseqs:
        f.rx_add(fs.query, lambda d, fs=fs: fs.diag_add(DIAG_SLOW_CNT, d))
    return f
