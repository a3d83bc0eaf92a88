"""fd_chaos: deterministic, schedule-driven fault injection into the
verify tile's feed path, the counterpart of ``firedancer_tpu/disco/chaos.py``
(``FAULT_CLASSES``:95, ``ChaosFault``:134-149, ``parse_schedule``:153,
``ChaosInjector``:197, the ``quic_*`` hooks :459-538 and :572,
``hb_stalled``:542, ``active``/``install``/``uninstall``).

A tile that misbehaves is restarted and the rings heal around it; this
module makes that testable. Faults fire at fixed points: each hook site
counts its own 1-based ordinals (publish attempts, drain rounds, staged
txns, dispatches, completions), and byte and position choices come from
a seeded counter-based ``Rng``, so a run replays bit for bit from
(seed, schedule, corpus), and picks the same txn to corrupt as the JAX
package does. The classes the port has sites for:

  ring_ctl_err   the source publishes a CTL_ERR frag of seeded junk
                 ahead of payload N; the verify drain drops it at the
                 ctl word (detection and heal, once a frag).
  ring_overrun   at stager drain round N (deferred until enough frags
                 flowed) the in-ring cursor is rewound past the ring's
                 depth: the next poll reports an overrun, the drain
                 repositions and the HA tcache drops what is read again.
  credit_starve  the source sees no credits for publish attempts N..M
                 (healed when the window closes).
  stager_kill    the stager thread raises at drain round N, before the
                 round's C call; the dispatcher restarts it after a
                 jittered backoff, the staged slots kept.
  slot_corrupt   one byte of the Nth non-duplicate staged txn's message
                 row is flipped (its payload stays intact): its lane
                 fails sigverify and the txn is dropped, the slot pool
                 carrying on.
  backend_raise  batch completion N raises: the batch is quarantined and
                 re-verified on the CPU lane, its offenders published
                 as CTL_ERR frags.
  device_lost    device dispatches N..M raise: the circuit breaker trips,
                 the CPU lane serves, and a half-open probe restores
                 the card.

  hb_stall       a tile skips its cnc heartbeat on its own housekeeping
                 passes N..M (ordinals kept per tile, so which tile
                 stalls does not depend on how the threads interleave);
                 the frozen heartbeat is what the sentinel's
                 tile_heartbeat row watches. Injected and detected when
                 a tile's window opens, healed when it closes or the
                 tile halts inside it.

  quic_malformed   at the QUIC tile's Nth rx round one seeded junk
                   datagram goes straight into the endpoint, which
                   must drop it unprocessed (detection and heal).
  quic_conn_churn  at the tile's Nth churn round a well-formed Initial
                   of seeded garbage from a synthetic peer: the server
                   allocates a half-open connection (detected), which
                   the handshake-deadline reaper retires (healed), or
                   refuses it at the connection cap (both at once).
  quic_slowloris   a window over the tile's service rounds in which
                   completed streams are held, never lost: injected
                   and detected at the window's start, healed at its
                   end, when the held txns requeue.

The ``quic_*`` sites are in ``disco.quic_tile.QuicTile.step``, which
takes the run's injector from ``run_quic_pipeline``; a run with no QUIC
tile ticks none of them and books 0 on their counters, as the JAX
package's ``run_pipeline`` does. ``worker_kill`` parses as in the JAX
package, but its site is the process supervisor, which the port does not
have: an injector for a schedule naming it raises ValueError, since such
a fault could be injected and never detected.

Schedule grammar: ``entry[,entry...]`` with ``entry := class@N |
class@N:M`` (1-based ordinals, windows inclusive, only for the window
classes). Each scheduled class keeps injected/detected/healed counters;
for the drop classes (ring_ctl_err, ring_overrun, slot_corrupt) the
detection is the heal. The injector is process-global while a run holds
it (``armed``; the runners take ``chaos=``, the JAX package's FD_CHAOS
environment has no counterpart), and an armed run keeps every tile in
one process, so that one injector books every site.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Dict, List, Optional, Tuple

from ..tango.rings import CTL_ERR
from ..utils.rng import Rng
from . import flight

FAULT_CLASSES = (
    "ring_ctl_err",
    "ring_overrun",
    "credit_starve",
    "stager_kill",
    "slot_corrupt",
    "backend_raise",
    "device_lost",
    "hb_stall",
    "worker_kill",
    "quic_malformed",
    "quic_conn_churn",
    "quic_slowloris",
)
# The classes whose hook sites the port has.
PORTED_CLASSES = FAULT_CLASSES[:8] + FAULT_CLASSES[9:]

_WINDOW_CLASSES = ("credit_starve", "device_lost", "hb_stall",
                   "quic_slowloris")


class ChaosFault(RuntimeError):
    """Base of every injected exception; cls names the fault class, so a
    healing path books detected and healed on the right counters."""

    cls = "chaos"


class ChaosStagerKill(ChaosFault):
    cls = "stager_kill"


class ChaosBackendError(ChaosFault):
    cls = "backend_raise"


class ChaosDeviceLost(ChaosFault):
    cls = "device_lost"


def parse_schedule(spec: str) -> Dict[str, List[Tuple[int, int]]]:
    """``class@N[:M],...`` -> {class: [(lo, hi), ...]} (1-based,
    inclusive; a point is (N, N)). An unknown class, a malformed ordinal
    or a window on a point class raises ValueError: a mistyped schedule
    must not inject nothing."""
    out: Dict[str, List[Tuple[int, int]]] = {}
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        if "@" not in entry:
            raise ValueError(f"chaos schedule entry {entry!r}: missing '@N'")
        cls, _, ord_s = entry.partition("@")
        cls = cls.strip()
        if cls not in FAULT_CLASSES:
            raise ValueError(
                f"unknown chaos fault class {cls!r} "
                f"(want one of {', '.join(FAULT_CLASSES)})")
        if ":" in ord_s:
            if cls not in _WINDOW_CLASSES:
                raise ValueError(
                    f"chaos class {cls!r} takes a point ordinal, "
                    f"not a window ({entry!r})")
            lo_s, _, hi_s = ord_s.partition(":")
        else:
            lo_s = hi_s = ord_s
        try:
            lo, hi = int(lo_s), int(hi_s)
        except ValueError:
            raise ValueError(f"chaos schedule entry {entry!r}: ordinals "
                             "must be ints") from None
        if lo < 1 or hi < lo:
            raise ValueError(
                f"chaos schedule entry {entry!r}: want 1 <= N <= M")
        out.setdefault(cls, []).append((lo, hi))
    return out


class ChaosInjector:
    """One run's injection plan and fault accounting. Each hook site is
    driven by one thread (the source's, the stager's or the
    dispatcher's), so its ordinals follow from the run's configuration;
    the counters are updated under a lock."""

    def __init__(self, seed: int = 0, schedule: str = ""):
        self.seed = seed
        self.schedule_text = schedule or ""   # as given (the autopsies')
        self.schedule = parse_schedule(schedule or "")
        unported = sorted(set(self.schedule) - set(PORTED_CLASSES))
        if unported:
            raise ValueError(
                f"chaos classes {', '.join(unported)} have no hook site in "
                "the port: worker_kill fires in the process supervisor, "
                "which is not ported (ROADMAP queue 1 item 9)")
        # Per-site Rng streams: a choice must not depend on how draws of
        # different threads interleave.
        self._junk_rng = Rng(seq=seed ^ 0xC4A05)      # ring_ctl_err junk
        self._corrupt_rng = Rng(seq=seed ^ 0x51077)   # slot_corrupt flips
        self._lock = threading.Lock()
        self.counters: Dict[str, Dict[str, int]] = {
            cls: {"injected": 0, "detected": 0, "healed": 0}
            for cls in self.schedule}
        self._ord: Dict[str, int] = {}
        # One pending detection for each injection, consumed by the
        # matching event, so an organic lookalike books nothing.
        self._ctl_err_pending = 0
        self._overrun_due = 0
        self._overrun_pending = 0
        self._corrupt_psigs: List[int] = []
        self._starve_active = False
        self._hb_stall_active: set = set()   # tiles inside a window
        self._slowloris_active = False       # quic_slowloris window open
        self.corrupted_sha256: List[str] = []
        # Every booked event also goes to the "chaos" flight recorder, so
        # a dump carries the fault timeline (the JAX :238-244).
        self._flightrec = flight.recorder("chaos")

    # -- plumbing --------------------------------------------------------

    def note(self, cls: str, kind: str, n: int = 1) -> None:
        """Book n events of kind (injected, detected, healed) for a
        scheduled class; an unscheduled class books nothing, so organic
        faults do not skew the audit."""
        with self._lock:
            c = self.counters.get(cls)
            if c is None:
                return
            c[kind] += n
        self._flightrec.record("chaos", cls=cls, event=kind, n=n)

    def _tick(self, site: str) -> int:
        """The next 1-based ordinal of a hook site."""
        with self._lock:
            n = self._ord.get(site, 0) + 1
            self._ord[site] = n
            return n

    def _hit(self, cls: str, ordinal: int, consume: bool = False) -> bool:
        """True when ordinal falls in one of cls's windows; consume drops
        a matched point entry (a site that retries an ordinal fires
        once)."""
        wins = self.schedule.get(cls, [])
        for i, (lo, hi) in enumerate(wins):
            if lo <= ordinal <= hi:
                if consume and lo == hi:
                    wins.pop(i)
                return True
        return False

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"seed": self.seed,
                    "counters": {cls: dict(v)
                                 for cls, v in self.counters.items()},
                    "corrupted_sha256": list(self.corrupted_sha256)}

    # -- the source's publish path ---------------------------------------

    def source_starved(self) -> bool:
        """True while the credit_starve window covers this publish
        attempt: the source backs off as if it had no credits. The
        forced backpressure is seen as the source takes its backoff, so
        injected and detected are booked at the window's start, healed
        at its end."""
        n = self._tick("source_attempt")
        if self._hit("credit_starve", n):
            if not self._starve_active:
                self._starve_active = True
                self.note("credit_starve", "injected")
                self.note("credit_starve", "detected")
            return True
        if self._starve_active:
            self._starve_active = False
            self.note("credit_starve", "healed")
        return False

    def source_inject(self, out_link, publish_ord: int) -> None:
        """Before the source publishes payload publish_ord (1-based):
        maybe a CTL_ERR frag of seeded junk ahead of it. The frag spends
        a credit; without one the injection waits for the next attempt
        at the same ordinal."""
        if not self._hit("ring_ctl_err", publish_ord):
            return
        if not out_link.can_publish():
            return
        self._hit("ring_ctl_err", publish_ord, consume=True)
        junk = bytes(self._junk_rng.roll(256) for _ in range(24))
        out_link.publish(junk, sig=0, ctl=CTL_ERR)
        with self._lock:
            self._ctl_err_pending += 1
        self.note("ring_ctl_err", "injected")

    def on_ctl_err_drop(self, n: int = 1) -> None:
        """A consumer dropped n CTL_ERR frags at the ctl word: each
        consumes one pending injection. A frag the drain reads again
        after ring_overrun's rewind is dropped again and books nothing;
        the JAX injector books every drop (:343), so its audit can read
        detected > injected (ROADMAP queue 3)."""
        with self._lock:
            hits = min(n, self._ctl_err_pending)
            self._ctl_err_pending -= hits
        if hits:
            self.note("ring_ctl_err", "detected", hits)
            self.note("ring_ctl_err", "healed", hits)

    # -- the stager's drain ----------------------------------------------

    def overrun_rewind(self, in_link) -> None:
        """Maybe rewind the consumer cursor past the ring's depth, so the
        next poll reports an overrun (DIAG_OVRNR_CNT). Deferred until
        enough frags have flowed that the rewound lines are stale."""
        n = self._tick("drain_round")
        depth = in_link.mcache.depth
        if self._hit("ring_overrun", n):
            self._overrun_due += 1
        if self._overrun_due and in_link.seq > depth + 1:
            self._overrun_due -= 1
            in_link.seq -= depth + 1
            with self._lock:
                self._overrun_pending += 1
            self.note("ring_overrun", "injected")

    def on_overrun_observed(self) -> None:
        """The drain repositioned past an overrun: consume one pending
        injection."""
        with self._lock:
            if self._overrun_pending <= 0:
                return
            self._overrun_pending -= 1
        self.note("ring_overrun", "detected")
        self.note("ring_overrun", "healed")

    def stager_round_hook(self) -> None:
        """Top of every stager drain round, before its C call (nothing
        is half-booked in the slot): raises ChaosStagerKill at the
        scheduled rounds."""
        n = self._tick("stager_round")
        if self._hit("stager_kill", n):
            self.note("stager_kill", "injected")
            raise ChaosStagerKill(f"injected stager kill at round {n}")

    def post_stage_hook(self, slot, k0: int, n: int, lane0: int) -> None:
        """After a round staged txns [k0, k0 + n) of slot from lane lane0
        on: maybe flip one byte of a scheduled txn's staged message row
        (the payload sidecar stays intact, so exactly that txn must fail
        sigverify). The ordinal counts staged txns that are not HA
        duplicates, in ring order: the same schedule hits the same txn
        however the stream split into rounds."""
        lane = lane0
        for t in range(k0, k0 + n):
            if not bool(slot.ha_mask[t]):
                ordn = self._tick("staged_txn")
                msg_len = int(slot.lens[lane])
                if msg_len > 0 and self._hit("slot_corrupt", ordn,
                                             consume=True):
                    slot.msgs[lane, self._corrupt_rng.roll(msg_len)] ^= (
                        1 + self._corrupt_rng.roll(255))
                    off, ln = int(slot.offs[t]), int(slot.plens[t])
                    pay = slot.pay[off:off + ln].tobytes()
                    with self._lock:
                        self._corrupt_psigs.append(int(slot.psigs[t]))
                        self.corrupted_sha256.append(
                            hashlib.sha256(pay).hexdigest())
                    self.note("slot_corrupt", "injected")
            lane += int(slot.tlanes[t])

    def on_sv_drop(self, psigs) -> None:
        """Sigverify dropped txns of these meta sigs: consume the
        matching corruption records."""
        hits = 0
        with self._lock:
            for p in psigs:
                try:
                    self._corrupt_psigs.remove(int(p))
                    hits += 1
                except ValueError:
                    continue
        if hits:
            self.note("slot_corrupt", "detected", hits)
            self.note("slot_corrupt", "healed", hits)

    # -- every tile's housekeeping ---------------------------------------

    def hb_stalled(self, tile_id: str) -> bool:
        """True while the hb_stall window covers this housekeeping pass of
        tile tile_id: the tile skips its heartbeat. The ordinals are the
        tile's own (a counter shared by the tiles' threads would make
        which tile stalls depend on their interleaving). One injected
        and one detected when a tile's window opens (the frozen beat is
        visible at once, in monitor.snapshot and to the tile_heartbeat
        SLO), one healed when it closes: a booking a suppressed pass
        would flood the chaos flight recorder."""
        n = self._tick(f"housekeep:{tile_id}")
        if self._hit("hb_stall", n):
            if tile_id not in self._hb_stall_active:
                self._hb_stall_active.add(tile_id)
                self.note("hb_stall", "injected")
                self.note("hb_stall", "detected")
            return True
        if tile_id in self._hb_stall_active:
            self._hb_stall_active.discard(tile_id)
            self.note("hb_stall", "healed")
        return False

    def hb_stall_halt(self, tile_id: str) -> None:
        """Tile tile_id halted inside its hb_stall window: the window
        closes with the tile's run (healed), so a run that ends
        mid-window still balances its counters (as the JAX
        ``quic_slowloris_halt``:532 closes its window)."""
        if tile_id in self._hb_stall_active:
            self._hb_stall_active.discard(tile_id)
            self.note("hb_stall", "healed")

    # -- the dispatcher --------------------------------------------------

    def verify_dispatch_hook(self) -> None:
        """Before each device dispatch: raises ChaosDeviceLost in the
        scheduled dispatch windows. Only device dispatches tick the
        ordinal: a batch the CPU lane serves while the breaker is open
        draws none."""
        n = self._tick("dispatch")
        if self._hit("device_lost", n):
            self.note("device_lost", "injected")
            raise ChaosDeviceLost(f"injected device loss at dispatch {n}")

    def verify_complete_hook(self) -> None:
        """Before each batch completion is read: raises ChaosBackendError
        at the scheduled completion ordinals."""
        n = self._tick("complete")
        if self._hit("backend_raise", n):
            self.note("backend_raise", "injected")
            raise ChaosBackendError(f"injected backend error at batch {n}")


    # -- the QUIC tile (disco.quic_tile) ---------------------------------

    def quic_malformed_junk(self) -> Optional[bytes]:
        """Ticked once a QUIC tile rx round: at a scheduled ordinal, 40
        seeded junk bytes to feed straight into the endpoint (past the
        tile's quarantine gate), else None. The first byte is a short
        header's, so the junk takes the unknown-cid path and the
        endpoint must count it rx_dropped (on_quic_malformed_dropped)."""
        n = self._tick("quic_rx_round")
        if not self._hit("quic_malformed", n, consume=True):
            return None
        junk = bytes([0x40 | self._junk_rng.roll(0x40)]) + bytes(
            self._junk_rng.roll(256) for _ in range(39))
        self.note("quic_malformed", "injected")
        return junk

    def on_quic_malformed_dropped(self) -> None:
        """The endpoint dropped the injected junk: detection and heal."""
        self.note("quic_malformed", "detected")
        self.note("quic_malformed", "healed")

    def quic_churn_initial(self) -> Optional[bytes]:
        """Ticked once a QUIC tile churn round: at a scheduled ordinal a
        well-formed Initial datagram of seeded garbage (a half-open
        connection's first packet), else None. The tile books detected
        when the connection appears or the cap refuses it, healed when
        the handshake-deadline reaper retires it."""
        n = self._tick("quic_churn_round")
        if not self._hit("quic_conn_churn", n, consume=True):
            return None
        from ..tango.quic import wire

        rng = self._junk_rng
        dcid = bytes(rng.roll(256) for _ in range(8))
        scid = bytes(rng.roll(256) for _ in range(8))
        payload = bytes(rng.roll(256) for _ in range(64))
        hdr = wire.encode_long_header(
            wire.PKT_INITIAL, dcid, scid, pn=0, pn_len=2,
            payload_len=len(payload))
        self.note("quic_conn_churn", "injected")
        return hdr + payload

    def quic_slowloris_held(self) -> bool:
        """Ticked once a QUIC tile service round: True while the
        quic_slowloris window covers it (the tile holds completed
        streams). One injected and detected when the window opens,
        healed when it closes, as hb_stall."""
        n = self._tick("quic_service_round")
        if self._hit("quic_slowloris", n):
            if not self._slowloris_active:
                self._slowloris_active = True
                self.note("quic_slowloris", "injected")
                self.note("quic_slowloris", "detected")
            return True
        if self._slowloris_active:
            self._slowloris_active = False
            self.note("quic_slowloris", "healed")
        return False

    def quic_slowloris_active(self) -> bool:
        """A quic_slowloris window is open (no tick): the stream
        completion path holds the stream."""
        return self._slowloris_active

    def quic_slowloris_halt(self) -> None:
        """The tile halted inside the window: it closes here (healed),
        the tile booking its held txns as shed."""
        if self._slowloris_active:
            self._slowloris_active = False
            self.note("quic_slowloris", "healed")

    def quic_faults_pending(self) -> bool:
        """A scheduled quic_* fault has not fired yet, or a slowloris
        window is open: the QUIC tile folds this into done(), so it
        keeps stepping (each step ticks the ordinals) until every
        injection landed, whatever the pace of its clients."""
        with self._lock:
            if self._slowloris_active:
                return True
            for cls in ("quic_malformed", "quic_conn_churn"):
                if self.schedule.get(cls):
                    return True  # unconsumed point entries remain
            n = self._ord.get("quic_service_round", 0)
            return any(hi > n
                       for lo, hi in self.schedule.get("quic_slowloris", []))


# -- the process-global injector of the running pipeline ---------------------

_active: Optional[ChaosInjector] = None


def active() -> Optional[ChaosInjector]:
    return _active


def install(injector: Optional[ChaosInjector]) -> None:
    global _active
    _active = injector


def uninstall() -> None:
    install(None)


def injector(spec) -> Optional[ChaosInjector]:
    """A run's injector from its chaos= argument: None, a fresh injector
    for a (seed, schedule) pair, or the injector itself."""
    if spec is None or isinstance(spec, ChaosInjector):
        return spec
    seed, schedule = spec
    return ChaosInjector(seed=int(seed), schedule=schedule)


@contextlib.contextmanager
def armed(spec):
    """Install the run's injector (injector(spec); None clears one left
    installed) for the with block, and uninstall it afterwards, also
    when the run raises."""
    inj = injector(spec)
    install(inj)
    try:
        yield inj
    finally:
        uninstall()
