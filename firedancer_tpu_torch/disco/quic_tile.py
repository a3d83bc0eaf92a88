"""QUIC ingest tile: UDP/QUIC server -> txn frag stream, defended. The
counterpart of ``firedancer_tpu/disco/quic_tile.py`` (``_txn_priority``:90,
``quic_tile_stats``:113, ``QuicTile``:137, the ``quic_*`` chaos sites in
``step``:400-505).

Role parity with the reference's src/disco/quic/fd_quic_tile.c: the tile's
run loop services the packet transport and the QUIC endpoint back to back
(fd_quic_tile.c:449-452 drives fd_xsk_aio_service + fd_quic_service), and
every completed unidirectional stream (one Solana transaction per stream,
the TPU convention) is published into the outgoing mcache/dcache for the
verify tile, which parses it. An empty stream or one past the link's MTU
is dropped at ingest (the SV_FILT diag), as the JAX tile drops it. The
transport is ``tango.udpsock``'s batched socket (recvmmsg/sendmmsg,
``build/libfdudp.so``); where its library does not build the tile
raises, where the JAX tile falls back to the plain socket.

The overload defenses (``QuicOptions``, on by default; the JAX
FD_QUIC_* flags with their defaults):

  admission   a token bucket a connection (``admit_rate``/``admit_burst``,
              ``feed.policy.TokenBucket``): a stream completing past its
              connection's budget is SHED, counted in the tile's
              ``admit_shed`` flight metric, its sha256 appended to the
              shed ledger (so the expected sink is the corpus oracle
              less exactly the ledger) and recorded as an fd_xray "shed"
              event.
  shedding    credit-aware lowest-priority shedding: past ``shed_depth``
              queued txns the LOWEST-priority one (compute-budget
              rewards, the order fd_pack maximizes) is dropped
              (``queue_shed``) before the feed backpressures.
  quarantine  a connection-level circuit breaker: a peer with
              ``abuse_threshold`` abuse events within 1 s (malformed
              datagrams, oversized streams, slowloris reassembly
              pressure; never admission sheds) has its connections
              closed and its datagrams dropped at the socket
              (``quarantine_drop``) for a cooldown that doubles a trip
              (``conn_quarantine``). Handshake-deadline reaping
              (``hs_timeout_s``, in ``Quic.service``) bounds half-open
              connection floods.

Every admitted stream's (completion -> publish) latency lands in the
``quic_ingest`` span histogram, the fd_sentinel ``quic_ingest_p99`` row.

The port's differences: the options are a dataclass, not environment
flags; the chaos injector is the run's (``chaos=``), not a process-wide
one; and the tile keeps the log of what it published, ``payloads`` and
``pub_ticks`` (the full tick of each publish), the replay's fields, so
the runners match the sink's receipts to the publishes
(``tiles.latencies_ns``) as they do a replay's. A shed payload goes to
the ledger and never to the log.

The chaos sites (``quic_malformed``, ``quic_conn_churn``,
``quic_slowloris``; ``disco.chaos``) are in ``step``: injections go
straight into the endpoint, past the quarantine gate, so the audited
behavior is the endpoint's own defense.
"""

from __future__ import annotations

import hashlib
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

from ..tango import tempo
from ..tango.quic.quic import Quic, QuicConfig
from ..tango.udpsock import UdpBatchSock
from . import flight, xray
from .feed import policy
from .tiles import (
    CNC_DIAG_BACKP_CNT,
    CNC_DIAG_SV_FILT_CNT,
    CNC_DIAG_SV_FILT_SZ,
    FD_TPU_MTU,
    Tile,
    idle_pause,
    meta_sig,
)

# Abuse/quarantine tables are bounded: a spoofed-source flood must not
# grow tile memory without limit. Oldest entries evict first (dict
# insertion order); an evicted abuser simply starts a fresh window.
_ABUSE_TABLE_CAP = 8192
# Rolling abuse-score window (seconds).
_ABUSE_WINDOW_S = 1.0
# Quarantine cooldown doubling cap: a persistent abuser is re-probed at
# 8x base at most.
_QUARANTINE_BACKOFF_CAP = 8


@dataclass(frozen=True)
class QuicOptions:
    """The QUIC tile's options, the JAX flags FD_QUIC_DEFENSES,
    FD_QUIC_ADMIT_RATE, FD_QUIC_ADMIT_BURST, FD_QUIC_SHED_DEPTH,
    FD_QUIC_ABUSE_THRESHOLD, FD_QUIC_QUARANTINE_COOLDOWN_MS,
    FD_QUIC_SLOW_MAX_BUF and FD_QUIC_HS_TIMEOUT_S with their defaults
    (``firedancer_tpu/flags.py:513-568``)."""

    defenses: bool = True
    admit_rate: int = 5000               # tokens a second, a connection
    admit_burst: int = 256
    shed_depth: int = 4096               # ready-queue depth before shedding
    abuse_threshold: int = 32            # abuse events in 1 s to trip
    quarantine_cooldown_ms: int = 250
    slow_max_buf: int = 262144           # reassembly bytes a connection
    hs_timeout_s: float = 3.0            # handshake deadline


def as_options(spec) -> QuicOptions:
    """QuicOptions from None (the defaults), a bool (defenses on or off),
    a dict of fields or QuicOptions."""
    if spec is None:
        return QuicOptions()
    if isinstance(spec, QuicOptions):
        return spec
    if isinstance(spec, bool):
        return QuicOptions(defenses=spec)
    if isinstance(spec, dict):
        return QuicOptions(**spec)
    raise TypeError(f"quic options: want None, bool, dict or QuicOptions, "
                    f"got {type(spec).__name__}")


def _txn_priority(payload: bytes, estimator) -> int:
    """Shed priority of a queued txn: the pack tile's own rewards
    estimate (priority fee + base fee), so the front door sheds exactly
    the work fd_pack would have scheduled last. Unparseable payloads are
    priority 0: junk is always the first thing shed."""
    from ..ballet.compute_budget import estimate_rewards_and_compute
    from ..ballet.txn import TxnParseError, parse_txn

    try:
        txn = parse_txn(payload)
        rce = estimate_rewards_and_compute(
            txn, payload, lamports_per_signature=5000, estimator=estimator)
    except TxnParseError:
        return 0
    if rce is None:
        return 0
    return int(rce[0])


def quic_tile_stats(q: "QuicTile") -> Dict[str, object]:
    """The front door's record (PipelineResult.quic): offered, admitted
    and shed (admitted + shed_total == offered at quiescence), the shed
    ledger, the quarantine counters and the peers in quarantine, the
    endpoint's metrics, the AES path the packet protection took and the
    clock of the first stream and publish (the port's keys after
    "defenses")."""
    from ..ballet import aes

    m = q.fl.as_dict()
    return {
        "streams_seen": q.streams_seen,
        "offered": q.offered,
        "admitted": q.pub_cnt,
        "admit_shed": m["admit_shed"],
        "queue_shed": m["queue_shed"],
        "shed_total": m["admit_shed"] + m["queue_shed"],
        "shed_sha256": list(q.shed_sha256),
        "admitted_sha256": (list(q.admitted_sha256)
                            if q.record_digests else None),
        "conn_quarantine": m["conn_quarantine"],
        "quarantine_drop": m["quarantine_drop"],
        "defenses": q.defenses,
        "quic_metrics": dict(q.quic.metrics),
        "aes_path": aes.aes_path(),
        "quarantined_peers": sorted(repr(a) for a in q._quarantine),
        # perf_counter seconds of the first completed stream and of the
        # first publish (None before one).
        "t_first_stream": q.t_first_stream,
        "t_first_pub": q.pub_ticks[0] / 1e9 if q.pub_ticks else None,
    }


class QuicTile(Tile):
    """Source tile: accepts QUIC connections, emits one frag per txn."""

    name = "quic"

    def __init__(
        self,
        wksp,
        cnc_name,
        out_link,
        identity_seed: bytes,
        bind_addr: Tuple[str, int] = ("127.0.0.1", 0),
        idle_timeout: float = 10.0,
        stop_after: Optional[int] = None,
        retry: bool = False,
        record_digests: bool = False,
        stop_when=None,
        options=None,
        chaos=None,
        **kw,
    ):
        super().__init__(wksp, cnc_name, out_link=out_link, **kw)
        opts = as_options(options)
        self.options = opts
        self.out_links = [out_link]
        # Batched ingest: recvmmsg amortizes the syscall over a
        # 256-datagram burst, the stand-in for fd_xsk's UMEM rings.
        self.sock = UdpBatchSock(bind_addr)
        self.listen_addr = self.sock.local_addr
        self._tx_aio = self.sock.aio_tx()
        self.quic = Quic(
            QuicConfig(
                is_server=True,
                identity_seed=identity_seed,
                idle_timeout=idle_timeout,
                # Stateless Retry (zero state for spoofed Initials), off
                # by default so clients stay one round trip.
                retry=retry,
                # Half-open connections are retired on this deadline,
                # not the idle timeout.
                hs_timeout=opts.hs_timeout_s,
            ),
            tx=lambda addr, dg: self._tx_aio.send_one(addr, dg),
            on_stream=self._on_stream,
            on_rx_drop=self._on_rx_drop,
        )
        # Ready queue entries: [arrival_tick, priority, payload]. FIFO
        # publish order; the shed scan removes the minimum priority.
        self._ready: Deque[list] = deque()
        self._t0 = time.monotonic()
        self.pub_cnt = 0
        self.pub_sz = 0
        self.stop_after = stop_after
        # A custom exhaustion predicate (a client that knows how many
        # streams it delivered).
        self.stop_when = stop_when
        # The publish log, the replay's fields: each admitted payload and
        # the full tick of its publish.
        self.payloads: List[bytes] = []
        self.pub_ticks: List[int] = []
        self.t_first_stream: Optional[float] = None
        self.record_digests = record_digests
        self.admitted_sha256: list = []
        self.defenses = opts.defenses
        # addr -> [events_in_window, window_start, trips]
        self._abuse: Dict[object, list] = {}
        # addr -> quarantine-until (tile clock); absent = admitted.
        self._quarantine: Dict[object, float] = {}
        # offered = streams past the size filter; admitted + shed ==
        # offered at quiescence. The shed ledger keeps a sha256 a shed.
        self.streams_seen = 0
        self.offered = 0
        self.shed_sha256: list = []
        from ..ballet.pack import CuEstimator

        self._est = CuEstimator()
        # The tile's flight lane (admit_shed, queue_shed,
        # conn_quarantine, quarantine_drop) and the admission span.
        self.fl = flight.tile_lane(wksp, self.flight_label)
        self._ingest_span = flight.span(wksp, "quic_ingest")
        # fd_xray: shed and quarantine events in the tile's ring.
        self.xr = xray.ring(f"tile:{self.flight_label}")
        # The run's chaos injector; the slowloris hold buffer and the
        # churn connections awaiting their reap.
        self.chaos = chaos
        self._deferred: list = []
        self._churn_watch: list = []
        self._idle_spins = 0

    # -------------------------------------------------------------- quic ---

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _abuse_event(self, addr, reason: str, n: int = 1) -> None:
        """Score one abuse event against a peer; trip the quarantine
        breaker past the threshold (open for a cooldown that doubles a
        consecutive trip, half-open re-admit when it lapses, _rx)."""
        if not self.defenses or addr is None:
            return
        now = self._now()
        st = self._abuse.get(addr)
        if st is None:
            if len(self._abuse) >= _ABUSE_TABLE_CAP:
                self._abuse.pop(next(iter(self._abuse)))
            st = self._abuse[addr] = [0, now, 0]
        if now - st[1] > _ABUSE_WINDOW_S:
            st[0], st[1] = 0, now
        st[0] += n
        if st[0] < self.options.abuse_threshold or addr in self._quarantine:
            return
        st[0] = 0
        st[2] += 1
        cooldown = self.options.quarantine_cooldown_ms / 1e3 * min(
            1 << (st[2] - 1), _QUARANTINE_BACKOFF_CAP)
        if len(self._quarantine) >= _ABUSE_TABLE_CAP:
            self._quarantine.pop(next(iter(self._quarantine)))
        self._quarantine[addr] = now + cooldown
        self.fl.inc("conn_quarantine")
        self.flightrec.record("quic_quarantine", addr=repr(addr)[:64],
                              reason=reason, trips=st[2],
                              cooldown_ms=int(cooldown * 1e3))
        self.xr.record(0, 0, tempo.tickcount() & 0xFFFFFFFF,
                       "quic_quarantine",
                       {"addr": repr(addr)[:64], "reason": reason,
                        "trips": st[2]})
        # Close the abuser's live connections; Quic.service reaps them.
        for conn in list(self.quic.conns):
            if conn.peer_addr == addr and not conn.closed:
                conn.abort(0x02, "quarantined: abusive peer")

    def _on_rx_drop(self, addr) -> None:
        """Endpoint-attributed junk (malformed datagram, unknown cid, bad
        token, connection-cap overflow): an abuse event."""
        self._abuse_event(addr, "rx_drop")

    def quarantined(self, addr) -> bool:
        """addr is inside a quarantine cooldown now."""
        until = self._quarantine.get(addr)
        return until is not None and self._now() < until

    def rx(self, addr, datagram: bytes, now: float) -> None:
        """The socket's rx gate: a quarantined peer is dropped here,
        before QUIC processing buys it CPU or state; a lapsed cooldown
        re-admits (half-open: re-abuse re-trips with the doubled
        cooldown)."""
        until = self._quarantine.get(addr)
        if until is not None:
            if now < until:
                self.fl.inc("quarantine_drop")
                return
            del self._quarantine[addr]  # half-open re-admit
        self.quic.rx(addr, datagram, now)

    def _shed(self, payload: bytes, reason: str) -> None:
        """Book one shed txn: admit_shed for admission, queue_shed for
        overflow and halt drains; its sha256 in the ledger; a flight and
        an xray event. The one bookkeeping path of every shed."""
        self.fl.inc("admit_shed" if reason == "admit" else "queue_shed")
        self.shed_sha256.append(hashlib.sha256(payload).hexdigest())
        self.flightrec.record("shed", reason=reason, sz=len(payload))
        self.xr.record(0, 0, tempo.tickcount() & 0xFFFFFFFF, "shed",
                       {"reason": reason, "sz": len(payload)})

    def _admit(self, conn) -> bool:
        """The connection's token bucket (state dies with the
        connection); the clock is the tile's seconds."""
        bucket = getattr(conn, "_admit_bucket", None)
        if bucket is None:
            bucket = conn._admit_bucket = policy.TokenBucket(
                self.options.admit_rate, self.options.admit_burst)
        return bucket.admit(self._now())

    def _on_stream(self, conn, stream_id: int, data: bytes) -> None:
        self.streams_seen += 1
        if self.t_first_stream is None:
            self.t_first_stream = time.perf_counter()
        if not data or len(data) > min(FD_TPU_MTU, self.out_link.mtu):
            # The reference's in-tile parse-failure drop.
            self.cnc.diag_add(CNC_DIAG_SV_FILT_CNT, 1)
            self.cnc.diag_add(CNC_DIAG_SV_FILT_SZ, len(data))
            if data:
                # An oversized stream scores against the peer (an empty
                # one is a client bug, not an attack surface).
                self._abuse_event(conn.peer_addr, "oversize")
            return
        self.offered += 1
        if self.defenses and not self._admit(conn):
            # Admission excess is degradation, not abuse: ledgered shed,
            # never breaker fuel (honest clients behind one NAT share
            # an address).
            self._shed(data, "admit")
            return
        entry = [tempo.tickcount(), None, data]
        if self.defenses and len(self._ready) > self.options.shed_depth // 2:
            # Half-deep: pay the priority parse at enqueue, so a shed
            # scan never fills thousands of entries in one pass.
            entry[1] = _txn_priority(data, self._est)
        c = self.chaos
        if c is not None and c.quic_slowloris_active():
            # Inside a quic_slowloris window: hold, never lose; the
            # release restamps the arrival (the bytes "had not arrived").
            self._deferred.append(entry)
            return
        self._ready.append(entry)
        self._shed_overflow()

    def _shed_overflow(self) -> None:
        """While the ready queue is past shed_depth, drop the
        lowest-priority entry. Priorities are cached on the entry (filled
        at enqueue once half-deep, lazily here for the prefix enqueued
        shallow)."""
        if not self.defenses:
            return
        while len(self._ready) > self.options.shed_depth:
            low_i, low_p = 0, None
            for i, e in enumerate(self._ready):
                if e[1] is None:
                    e[1] = _txn_priority(e[2], self._est)
                if low_p is None or e[1] < low_p:
                    low_i, low_p = i, e[1]
            victim = self._ready[low_i]
            del self._ready[low_i]
            self._shed(victim[2], "queue")

    def chaos_quiet(self) -> bool:
        """No scheduled quic_* fault is pending and every injected churn
        connection was reaped: the tile keeps stepping (each step ticks
        the ordinals and drives the reaper) until the audit can
        balance."""
        c = self.chaos
        if c is None:
            return True
        return not c.quic_faults_pending() and not self._churn_watch

    def done(self) -> bool:
        if not self.chaos_quiet():
            return False
        if self.stop_when is not None:
            return bool(self.stop_when(self))
        if self.stop_after is None:
            return False
        # Every expected stream seen and each admitted or shed: the
        # ready and hold queues are empty.
        return (self.streams_seen >= self.stop_after
                and not self._ready and not self._deferred)

    # -------------------------------------------------------------- loop ---

    def _chaos_hooks(self, c, now: float) -> None:
        """The quic_* injections, fed straight into the endpoint (past
        the quarantine gate: the audited defense is the endpoint's).
        Synthetic peers are routable but inert (127.0.0.2, ports no
        client binds), so the endpoint's replies are harmless sends."""
        junk = c.quic_malformed_junk()
        if junk is not None:
            drops0 = self.quic.metrics["rx_dropped"]
            self.quic.rx(("127.0.0.2", 9), junk, now)
            if self.quic.metrics["rx_dropped"] > drops0:
                c.on_quic_malformed_dropped()
        fake = c.quic_churn_initial()
        if fake is not None:
            conns0 = self.quic.metrics["conns_created"]
            drops0 = self.quic.metrics["rx_dropped"]
            addr = ("127.0.0.2", 10000 + len(self._churn_watch) + 1)
            self.quic.rx(addr, fake, now)
            if self.quic.metrics["conns_created"] > conns0:
                # A half-open connection: detected now, healed when the
                # handshake-deadline reaper retires its cid.
                c.note("quic_conn_churn", "detected")
                self._churn_watch.append(self.quic.conns[-1].scid)
            elif self.quic.metrics["rx_dropped"] > drops0:
                # The connection cap refused it: detection and heal.
                c.note("quic_conn_churn", "detected")
                c.note("quic_conn_churn", "healed")
        if not c.quic_slowloris_held() and self._deferred:
            # The window closed: release the held txns, restamped.
            now_tick = tempo.tickcount()
            for e in self._deferred:
                e[0] = now_tick
                self._ready.append(e)
            self._deferred.clear()
            self._shed_overflow()
        if self._churn_watch:
            alive = self.quic._conns_by_cid
            still = []
            for scid in self._churn_watch:
                if scid in alive:
                    still.append(scid)
                else:
                    c.note("quic_conn_churn", "healed")
            self._churn_watch = still

    def step(self) -> None:
        now = self._now()
        if self.chaos is not None:
            self._chaos_hooks(self.chaos, now)
        got = self.sock.service_rx(lambda addr, d: self.rx(addr, d, now))
        self.quic.service(now)
        if got or self._ready:
            self._idle_spins = 0
        else:
            # Nothing arrived: back off as the port's other tiles do
            # (tiles.idle_pause), since a spinning tile takes the GIL
            # from the verify dispatcher between its torch ops; with no
            # connection at all, at least the JAX tile's 0.5 ms.
            self._idle_spins += 1
            pause = idle_pause(self._idle_spins)
            if not self.quic.conns:
                pause = max(pause, 0.0005)
            if pause:
                time.sleep(pause)
            return
        while self._ready:
            if not self.out_link.can_publish():
                self.cnc.diag_add(CNC_DIAG_BACKP_CNT, 1)
                # Backpressured: shed past the depth rather than stall.
                self._shed_overflow()
                return  # keep servicing the socket; retry next step
            t_arr, _prio, payload = self._ready.popleft()
            now_tick = tempo.tickcount()
            if self._ingest_span is not None:
                self._ingest_span.observe((now_tick - t_arr) & 0xFFFFFFFF)
            self.payloads.append(payload)
            self.pub_ticks.append(now_tick)
            self.out_link.publish(payload, meta_sig(payload),
                                  tsorig=now_tick & 0xFFFFFFFF)
            if self.record_digests:
                self.admitted_sha256.append(
                    hashlib.sha256(payload).hexdigest())
            self.pub_cnt += 1
            self.pub_sz += len(payload)

    def on_housekeep(self) -> None:
        # Publish the flight lane, then the slowloris scan: a connection
        # holding more than slow_max_buf bytes of incomplete streams is
        # an abuse event (at housekeeping rate, off the datagram path).
        self.fl.publish()
        if not self.defenses:
            return
        for conn in list(self.quic.conns):
            if conn.closed:
                continue
            _n, buffered = conn.reassembly_pressure()
            if buffered > self.options.slow_max_buf:
                self._abuse_event(conn.peer_addr, "slowloris",
                                  n=self.options.abuse_threshold)

    def on_halt(self) -> None:
        if self.chaos is not None:
            self.chaos.quic_slowloris_halt()
        # What is still queued at HALT is booked shed (reason "halt",
        # queue_shed), so admitted + shed == offered on a cut run too.
        for e in list(self._deferred) + list(self._ready):
            self._shed(e[2], "halt")
        self._deferred.clear()
        self._ready.clear()
        self.fl.publish()
        self.sock.close()
