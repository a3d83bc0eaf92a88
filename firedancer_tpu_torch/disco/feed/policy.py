"""Adaptive partial-batch flush policy of the verify tile, a copy of
``firedancer_tpu/disco/feed/policy.py`` (``AdaptiveFlush``:48 and the
``FLUSH_*`` verdicts).

The policy is deadline-based with one adaptive early-out:

  full      lanes filled the batch: dispatch, always.
  deadline  the oldest staged txn is older than the latency deadline,
            anchored at staging time: dispatch now. A partial batch is
            never starved past the deadline.
  starved   the input ran dry, the device is idle and downstream has
            credits: waiting longer cannot improve fill and only adds
            latency, so dispatch after a short debounce (deadline/16,
            clamped) that absorbs momentary producer stalls.

At steady state arrivals fill batches before the deadline and the
device is never idle, so deadline and starved flushes both go to ~0.
"""

from __future__ import annotations

from typing import Optional

# due() verdicts (also the stat-bucket names in verify_stats)
FLUSH_FULL = "full"
FLUSH_DEADLINE = "deadline"
FLUSH_STARVED = "starved"

_STARVE_MIN_NS = 100_000       # debounce floor: 100 us
_STARVE_MAX_NS = 5_000_000     # debounce ceiling: 5 ms


class AdaptiveFlush:
    """Clock-free decision logic (no clock READS — the caller passes
    now_ns) so the property test can drive it through arbitrary arrival
    schedules, including pathological ones: the policy keeps a
    high-water mark of the now_ns it has been shown FOR THE CURRENT
    BATCH (keyed by the first_ns anchor), so a clock that stutters or
    jumps BACKWARD can never un-expire a deadline — once a partial
    batch has been observed past its deadline, every later poll
    flushes it regardless of what the clock claims. The hwm resets
    with each new anchor: batches are independent latency contracts,
    and a prior batch's late clock must not pre-expire the next."""

    def __init__(self, deadline_ns: int):
        if deadline_ns <= 0:
            raise ValueError(f"deadline_ns must be positive, got {deadline_ns}")
        self.deadline_ns = deadline_ns
        self.starve_ns = min(
            max(deadline_ns // 16, _STARVE_MIN_NS), _STARVE_MAX_NS
        )
        # A debounce longer than the deadline could never fire first;
        # keep the invariant starve <= deadline explicit.
        self.starve_ns = min(self.starve_ns, deadline_ns)
        self._now_hwm = 0      # monotonic view of the caller's clock...
        self._hwm_anchor = None  # ...scoped to this batch anchor

    def due(
        self,
        now_ns: int,
        lanes: int,
        batch: int,
        first_ns: int,
        starved: bool = False,
        device_idle: bool = False,
        backpressured: bool = False,
    ) -> Optional[str]:
        """Flush verdict for the currently staged partial batch.

        now_ns/first_ns are the caller's tickcount and the batch's
        oldest-txn anchor; `starved` means the last drain round returned
        nothing; `device_idle` means no batch is in flight and no READY
        slot is queued; `backpressured` means the out link has no
        credits (flushing could not publish anyway, so the starved
        early-out defers — the DEADLINE still fires, because the staged
        txns' latency budget keeps burning while downstream recovers).
        Returns None (keep filling) or one of FLUSH_*.
        """
        if lanes <= 0:
            return None
        if lanes >= batch:
            return FLUSH_FULL
        # Clock-jitter hardening: within one batch (anchor), a backward
        # jump must not rewind the deadline (the staged txns' budget
        # keeps burning in real time), and an anchor stamped "in the
        # future" by a glitch must not produce a negative age that
        # defers the starved early-out.
        if first_ns != self._hwm_anchor:
            self._hwm_anchor = first_ns
            self._now_hwm = now_ns
        elif now_ns < self._now_hwm:
            now_ns = self._now_hwm
        else:
            self._now_hwm = now_ns
        age = max(0, now_ns - first_ns)
        if age >= self.deadline_ns:
            return FLUSH_DEADLINE
        if (
            starved
            and device_idle
            and not backpressured
            and age >= self.starve_ns
        ):
            return FLUSH_STARVED
        return None
