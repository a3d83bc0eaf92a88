"""Decision logic of the verify tile's feeder, a copy of
``firedancer_tpu/disco/feed/policy.py``: the adaptive partial-batch
flush (``AdaptiveFlush``:48 and the ``FLUSH_*`` verdicts), the
device -> CPU failover breaker (``CircuitBreaker``:129 and the
``BREAKER_*`` states) and the restart delay of a crashed stager
(``respawn_backoff_s``:252), and the QUIC tile's per-connection
admission bucket (``TokenBucket``:212; the JAX fabric's tenant bucket
waits for the fabric).

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


# States of the device -> CPU verify failover breaker (verify_stats'
# breaker_state; "disabled" when the tile runs without one).
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


class CircuitBreaker:
    """The device -> CPU verify failover circuit of the feeder. The card
    is a component that can fail, and its loss must cost throughput, not
    liveness:

      closed     dispatches go to the device; `threshold` consecutive
                 device errors trip the breaker (an error followed by a
                 success resets the count: one poisoned batch is the
                 quarantine's job, not an outage).
      open       the CPU lane serves every dispatch for the cooldown;
                 then one half-open probe is allowed.
      half_open  one dispatch probes the device. Success closes the
                 breaker and resets the cooldown; failure opens it again
                 with the cooldown doubled, up to 8x, so a dead device is
                 probed at a decaying rate.

    Pure decision logic: the caller passes now_ns, and only the
    dispatcher thread drives it."""

    def __init__(self, threshold: int, cooldown_ns: int):
        if threshold < 1:
            raise ValueError(
                f"breaker threshold must be >= 1, got {threshold}")
        if cooldown_ns <= 0:
            raise ValueError(
                f"breaker cooldown_ns must be positive, got {cooldown_ns}")
        self.threshold = threshold
        self.cooldown_ns = cooldown_ns
        self.state = BREAKER_CLOSED
        self.errors = 0          # consecutive device errors while closed
        self.trips = 0           # times the circuit opened from closed
        self.reprobes = 0        # half-open probes granted
        self._open_until = 0
        self._mult = 1

    def allow_device(self, now_ns: int) -> bool:
        """May this dispatch go to the device? Open turns half-open once
        the cooldown has passed, granting one probe; everything else
        stays on the CPU lane until the probe's completion decides."""
        if self.state == BREAKER_CLOSED:
            return True
        if self.state == BREAKER_OPEN and now_ns >= self._open_until:
            self.state = BREAKER_HALF_OPEN
            self.reprobes += 1
            return True
        return False

    def record_error(self, now_ns: int) -> bool:
        """A device dispatch or completion failed. True when this error
        tripped the circuit or opened it again."""
        if self.state == BREAKER_HALF_OPEN:
            self._mult = min(self._mult * 2, 8)
            self.state = BREAKER_OPEN
            self._open_until = now_ns + self.cooldown_ns * self._mult
            return True
        if self.state == BREAKER_OPEN:
            return False  # a straggler of the outage extends nothing
        self.errors += 1
        if self.errors >= self.threshold:
            self.state = BREAKER_OPEN
            self.trips += 1
            self.errors = 0
            self._mult = 1
            self._open_until = now_ns + self.cooldown_ns
            return True
        return False

    def record_success(self) -> None:
        """A device batch completed cleanly: a half-open circuit closes
        (the probe passed); a straggler's success while open changes
        nothing."""
        if self.state == BREAKER_HALF_OPEN:
            self.state = BREAKER_CLOSED
            self._mult = 1
        if self.state == BREAKER_CLOSED:
            self.errors = 0


class TokenBucket:
    """One admission token bucket: `rate` tokens per unit of the
    CALLER'S clock, capacity `burst`, one token per admit.

    Pure decision logic like AdaptiveFlush/CircuitBreaker: no clock
    reads — the caller passes `now` in whatever unit its clock ticks
    (fd_quic passes seconds, fd_fabric passes a virtual-nanosecond
    arrival clock with rate pre-scaled to per-ns), so the property
    tests can drive arbitrary arrival schedules and the fabric's
    deterministic replay admission is a pure function of the stream.
    A backward clock jump refills nothing (tokens never mint from
    jitter) but still charges the admit — the bucket is monotone in
    the work it lets through, not in the clock it is shown.
    """

    def __init__(self, rate: float, burst: float):
        if rate <= 0.0:
            raise ValueError(f"bucket rate must be positive, got {rate}")
        if burst < 1.0:
            raise ValueError(f"bucket burst must be >= 1, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = self.burst
        self._at: Optional[float] = None

    def admit(self, now) -> bool:
        """Spend one token at clock-time `now`; False means shed."""
        if self._at is None or now < self._at:
            self._at = now
        else:
            self.tokens = min(
                self.burst, self.tokens + (now - self._at) * self.rate
            )
            self._at = now
        if self.tokens < 1.0:
            return False
        self.tokens -= 1.0
        return True


def respawn_backoff_s(restarts: int, base_s: float, max_s: float,
                      rng) -> float:
    """The delay before restart number `restarts` (>= 1) of a crashed
    component: base_s * 2^(restarts - 1) plus 0-25 % jitter drawn from
    rng (a utils.rng.Rng), capped at max_s; 0 when base_s is 0. The
    jitter keeps components that died of one cause from restarting in
    lockstep."""
    if base_s <= 0.0:
        return 0.0
    d = min(base_s * (1 << min(restarts - 1, 30)), max_s)
    return min(d * (1.0 + 0.25 * rng.float01()), max_s)
