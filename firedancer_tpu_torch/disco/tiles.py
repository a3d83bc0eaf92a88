"""disco tiles over the tango rings, the counterpart of
``firedancer_tpu/disco/tiles.py`` (``meta_sig``:118, ``LinkNames``:126,
``InLink``:134, ``OutLink``:195, ``Tile``:324, ``MuxTile``:693,
``ReplayTile``:709, ``_txn_batch_arrays``:773, ``_InflightBatch``:790,
``VerifyTile``:858, ``DedupTile``:3075, ``PackTile``:3323,
``SinkTile``:3571).
``_DeviceBatch`` gives a direct engine's statuses, and the CPU lane's,
the async surface of ``_ReadyBatch``:817, and ``latencies_ns`` reads
the chain's end-to-end latencies from the replay's and the sink's
records. ``LatReservoir`` keeps an out-link's latency samples when the
fd_feed runtime asks for them (``OutLink.lat_ns``:235 there).

Tiles are threads joined to the native shared-memory rings
(``tango.rings``); the payloads are whole Solana transactions. The
verify tile parses, filters and verifies them on an engine of
``disco.engine.registry()``; the dedup tile drops repeated signatures;
the pack tile schedules them onto banks under their account locks, on
the host (``"greedy"``) or by the graph-coloring kernel (``"gc"``); the
sink stands in for the banks.

Under the fd_feed runtime each out-link and the stager keep a uniform
sample of (tsorig, tick) pairs (``LatReservoir``): a frag's source stamp
and the full tick count at which the stage handled it; the runtime
matches each stamp to the source's full publish tick
(``feed.runtime.stage_latencies``), so a stage's latency does not wrap
with the 32-bit stamp. An out-link keeps none unless its ``lat`` is set.

``VerifyTile`` has two backends: ``"gpu"`` (the JAX package's
``"tpu"``), which stages batches of signature lanes and dispatches them
asynchronously to the engine on ``device`` (the card unless the caller
passes ``device="cpu"``), and ``"oracle"``, which verifies each
transaction on the host with the port's copy of the oracle. The gpu
backend takes batches of at least ``MAX_SIG_CNT`` lanes and MTU-wide
rows, so every transaction that parses fits a batch. It ingests through
the native drain (``fd_verify_drain``: one C call polls, parses and
stages a round of frags) or, with ``native_drain=False``, frag by frag
in Python (``on_frag``). Both share the flush policy, the in-order
completion and the held-back ack cursor, and write the same cnc diag
slots. A batch whose result raises at completion is quarantined, as in
the JAX ``_complete``:2967-3040: counted, re-verified on the CPU lane
(``_quarantine_statuses``), its clean txns published and its offenders
sent downstream as CTL_ERR frags (``_publish_err``). An error at a
dispatch of the step loop, building the engine or warming it
propagates out of the tile's thread.

With ``feed=True`` the gpu backend runs as the JAX package's fd_feed
feeder (``_feed_setup``:1354 to ``_publish_feed_batch``:2193 there): a
stager thread drains the in-ring into the staging slots of
``feed.slots.SlotPool`` (one GIL-releasing ``fd_verify_drain`` call a
round) and commits a slot when it is full or the flush policy says so;
the tile's own thread is the dispatcher, which ships READY slots to the
engine, retires batches in order and publishes each one's passing txns
with ``fd_frag_publish_bulk_ctl``. The dispatcher makes every torch call;
the stager makes none. A slot returns to the pool only when its batch
has retired, since the engine's copy from the slot's pinned arena runs
after the dispatch returns. The feeder heals as the JAX one does
(``_feed_dispatch``:1983-2066, ``_stager_supervise``:1688): a dispatch
that raises feeds the circuit breaker (``feed.policy.CircuitBreaker``,
``breaker``, ``breaker_threshold``, ``breaker_cooldown_ms``) and its slot
is verified on the CPU lane (``_verify_slot_cpu``: the native C++
verifier, then the oracle lane by lane if that raises; never the plain
PyTorch versions), as is every slot while the breaker is open; a stager
that dies is restarted after ``respawn_backoff_s``'s jittered delay from
``stager_backoff_ms``, past ``stager_restart_max`` restarts the error is
raised. Each failover, quarantine, trip and restart is counted
(``feed.runtime.verify_tile_stats``) and logged as a warning. The hooks
of ``disco.chaos`` sit at the JAX sites: the replay's publish, the
drain's counters, the stager's round, the dispatch and the completion.

fd_flight (``disco.flight``; the JAX :237-351, :600-622, :969-1006): the
verify, dedup and pack tiles count into their flight lane (``fl``; the
``stat_*`` names of its metrics are read-only views of it), published
to the workspace's row at housekeeping; every tile records its events
(``flightrec``: dispatches, flush verdicts, breaker transitions,
quarantines, failovers, restarts, reconfigs, the halt) and dumps the
flight record before a raise leaves its thread. Each out-link given an
edge observes its span on every stamped publish, the bulk publishes a
batch at once (``OutLink.lat_sample_many``), the stager the ring dwell
of each round on ``verify_drain`` and the sink the end-to-end span on
``sink``; with flight off (``flight.FlightOptions.enabled``) recorders
and spans are off and the lanes stay.

The feeder's rung ladder (the JAX :1097-1155, :1947-2014): with
``sched`` on and a staging batch that tops two or more rungs of
``ladder`` (``engine.rung_ladder``, capped at the batch, floored at
``MAX_SIG_CNT``, the batch appended), a ``RungScheduler`` picks the rung
each slot fills toward from the ring's sequence numbers and the staged
batch's deadline slack (the stager makes no torch call for it), and the
dispatcher ships the slot on the smallest WARM rung engine covering its
lanes, copying only that many rows of the arena to the card; a rung not
yet WARM dispatches on the tile's primary engine. ``prewarm`` warms the
other rungs (``EngineRegistry.prewarm_ladder``). ``request_reconfig``
(the JAX :2347-2536) parks one live reconfig, which the dispatcher
applies when no batch is in flight while the stager keeps staging.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
import time
from dataclasses import dataclass
from hashlib import sha256 as _sha256
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ballet.compute_budget import estimate_rewards_and_compute
from ..ballet.ed25519 import native as ed_native
from ..ballet.ed25519 import oracle
from ..ballet.pack import CuEstimator, Pack, PackTxn, validate_schedule
from ..ballet.txn import MAX_ACCT_CNT, MAX_SIG_CNT, TxnParseError, parse_txn
from ..ops import backend
from ..ops.dedup_filter import DEFAULT_FILTER_BITS, dedup_filter, split_tags
from ..ops.pack_gc import (
    CU_CAP_DEFAULT,
    H_BITS_DEFAULT,
    MAX_COLORS_DEFAULT,
    PackTxnPad,
    build_arrays,
    schedule_block,
)
from ..tango import rings, tempo
from ..tango.fctl import make_fctl_for_fseqs
from ..tango.rings import (
    CNC_BOOT,
    CNC_HALT,
    CNC_RUN,
    CTL_ERR,
    DIAG_FILT_CNT,
    DIAG_FILT_SZ,
    DIAG_OVRNR_CNT,
    DIAG_PUB_CNT,
    DIAG_PUB_SZ,
    Cnc,
    DCache,
    FSeq,
    Frag,
    MCache,
    Workspace,
)
from ..ops.frontend_cuda import DEFAULT_FRONTEND, FRONTENDS
from ..tango.tcache import TCache
from ..utils.rng import Rng
from . import chaos
from . import engine as fd_engine
from . import flight, xray
from .drain import (
    CTL_BLOCK_MASK,
    CTL_NOVEL,
    MAX_CTL_COLORS,
    DrainWindow,
    ctl_block,
    ctl_color,
    device_beats_greedy,
    drain_pack_step,
    encode_ctl,
    greedy_waves,
    rot_quota,
)
from .feed.policy import (
    FLUSH_DEADLINE,
    FLUSH_FULL,
    FLUSH_STARVED,
    AdaptiveFlush,
    CircuitBreaker,
    respawn_backoff_s,
)
from .feed.runtime import LOGGER
from .feed.slots import SlotPool

# cnc diag slots (frank/fd_frank.h:20-36 ABI analog), the JAX package's.
CNC_DIAG_IN_BACKP = 0
CNC_DIAG_BACKP_CNT = 1
CNC_DIAG_HA_FILT_CNT = 2
CNC_DIAG_HA_FILT_SZ = 3
CNC_DIAG_SV_FILT_CNT = 4
CNC_DIAG_SV_FILT_SZ = 5
# Gauge: consumed-but-unverified frags the verify tile holds its ack for.
CNC_DIAG_UNACKED = 6

CTL_SOM_EOM = 3
FD_TPU_MTU = 1232  # disco/quic/fd_quic.h:46-47
# The adaptive flush's deadline when the caller passes no max_wait_us
# (the JAX package's FD_FEED_DEADLINE_US default).
DEFAULT_DEADLINE_US = 25_000
# Flushes that are not a verdict of the adaptive policy: the held-back
# ack about to exhaust the producer's credits, and the halt.
FLUSH_RING = "ring"
FLUSH_HALT = "halt"
# The fd_feed stager's: the ring's next txn does not fit the lanes left.
FLUSH_CAPACITY = "capacity"
# The feeder's healing defaults (verify_opts stager_restart_max,
# stager_backoff_ms, breaker_threshold, breaker_cooldown_ms; the JAX
# package's FD_FEED_STAGER_RESTART_MAX, FD_FEED_STAGER_BACKOFF_MS,
# FD_VERIFY_BREAKER_THRESHOLD and FD_VERIFY_BREAKER_COOLDOWN_MS): restarts
# of the stager before the feeder gives up, the first restart's delay
# (doubling a restart, +0-25 % jitter, up to the cap), and the breaker's
# consecutive device errors and cooldown.
STAGER_RESTART_MAX = 5
STAGER_BACKOFF_MS = 10
STAGER_BACKOFF_CAP_S = 2.0
BREAKER_THRESHOLD = 3
BREAKER_COOLDOWN_MS = 100

_U64 = (1 << 64) - 1
# The keys of a live reconfig request (VerifyTile.request_reconfig): the
# JAX request's FD_FRONTEND_IMPL and FD_DRAIN flips are the port's
# frontend and drain; its decompress flip has no counterpart.
RECONFIG_KEYS = ("verify_mode", "ladder", "frontend", "drain")


def tile_rungs(ladder, batch: int) -> List[int]:
    """The rungs a feed tile of staging batch `batch` schedules over:
    the ladder's rungs from MAX_SIG_CNT up to the batch, and the batch
    (its arenas' size) on top; [] when that leaves fewer than two, which
    keeps the fixed batch. A malformed ladder raises ValueError."""
    rungs = fd_engine.rung_ladder(ladder, cap=batch, floor=MAX_SIG_CNT)
    if batch not in rungs:
        rungs.append(batch)
    return rungs if len(rungs) >= 2 else []


def idle_pause(idle_spins: int) -> float:
    """Seconds an idle tile sleeps after idle_spins empty polls: the
    JAX package's 20 us (FD_SPIN_PAUSE analog) after 64 spins, doubling
    every 8 sleeps up to 1 ms. Each wake takes the GIL, and the verify
    thread must take it back after every PyTorch op of a batch (about 50
    a direct batch, 700 an RLC pass, where a JAX batch is one call), so
    a tile that stays idle wakes less often."""
    if idle_spins <= 64:
        return 0.0
    return min(20e-6 * (1 << min((idle_spins - 65) // 8, 6)), 1e-3)


def _lane_stat(name: str) -> property:
    """A tile's read-only stat_* view of its flight lane's metric."""
    return property(lambda self: self.fl.get(name),
                    doc=f"The flight lane's {name}.")


def meta_sig(payload: bytes) -> int:
    """Frag meta sig: the first 8 bytes of the txn's first signature
    (byte 0 is the compact signature count)."""
    return int.from_bytes(payload[1:9], "little") if len(payload) > 8 else 0


class LatReservoir:
    """A uniform sample (algorithm R) of at most CAP (tsorig, tick)
    pairs: a frag's source stamp (the low 32 bits of its publish tick)
    and the full tick count at which a stage handled it. Samples with
    tsorig 0 carry no stamp and are skipped. add() buffers and
    add_many() takes a round at once."""

    CAP = 16384
    _FLUSH = 256

    def __init__(self, seed: int = 0x1A7):
        self.ts = np.zeros(self.CAP, np.uint32)
        self.now = np.zeros(self.CAP, np.int64)
        self.n = 0
        self.seen = 0
        self._rng = np.random.default_rng(seed)
        self._buf_ts: list = []
        self._buf_now: list = []

    def add(self, tsorig: int, now: int) -> None:
        if tsorig:
            self._buf_ts.append(tsorig)
            self._buf_now.append(now)
            if len(self._buf_ts) >= self._FLUSH:
                self._flush()

    def _flush(self) -> None:
        ts, now = self._buf_ts, self._buf_now
        self._buf_ts, self._buf_now = [], []
        self.add_many(np.asarray(ts, np.uint32), np.asarray(now, np.int64))

    def add_many(self, ts: np.ndarray, now) -> None:
        """Samples ts (uint32 stamps) handled at now (a tick, or one a
        stamp)."""
        keep = ts != 0
        ts = ts[keep]
        now = (np.asarray(now, np.int64)[keep] if np.ndim(now)
               else np.full(len(ts), now, np.int64))
        k = min(len(ts), self.CAP - self.n)
        self.ts[self.n:self.n + k] = ts[:k]
        self.now[self.n:self.n + k] = now[:k]
        self.n += k
        rest = len(ts) - k
        if rest:
            # Sample i of the stream replaces a random slot with
            # probability CAP / (i + 1).
            j = self._rng.integers(self.seen + k + 1 + np.arange(rest))
            hit = j < self.CAP
            self.ts[j[hit]] = ts[k:][hit]
            self.now[j[hit]] = now[k:][hit]
        self.seen += len(ts)

    def samples(self):
        """(stamps, ticks) of the sample, the buffered ones included."""
        if self._buf_ts:
            self._flush()
        return self.ts[:self.n].copy(), self.now[:self.n].copy()


@dataclass
class LinkNames:
    """Workspace object names of one mcache/dcache/fseq link."""

    mcache: str
    dcache: str
    fseq: str


class InLink:
    """Consumer side of a link; resumes from the published fseq. Given an
    edge name, with xray on, its consumer's queue row (``xq``): a dwell
    (the producer's tspub to the drain) every ``queue_sample``th drained
    frag, the ring's depth and the consumer's idle ns."""

    def __init__(self, wksp: Workspace, names: LinkNames,
                 edge: Optional[str] = None):
        self.mcache = MCache(wksp, names.mcache)
        self.dcache = DCache(wksp, names.dcache)
        self.fseq = FSeq(wksp, names.fseq)
        self.seq = self.fseq.query()
        self.xq: Optional[xray.EdgeRx] = (
            xray.edge_rx(wksp, edge) if edge else None)
        self.xq_cnt = 0
        # At least 1: the stride is a modulus on the drain path.
        self.xq_every = (max(1, xray.options().queue_sample)
                         if self.xq is not None else 0)

    def housekeep(self) -> None:
        self.fseq.update(self.seq)

    def dwell_round(self, tspubs: np.ndarray, n: int) -> None:
        """The sampled dwells of a drained round of n frags (their tspub
        stamps): every xq_every-th frag of the link's stream (a round of
        at most Tile.BULK_FRAGS holds a few); a frag without a stamp is
        skipped. A round with none due costs a modulus."""
        first = (-self.xq_cnt - 1) % self.xq_every
        self.xq_cnt += n
        if first >= n:
            return
        now32 = tempo.tickcount() & 0xFFFFFFFF
        for ts in tspubs[first:n:self.xq_every].tolist():
            if ts:
                self.xq.observe_dwell((now32 - ts) & 0xFFFFFFFF)


class OutLink:
    """Producer side: dcache chunk walk, mcache publish, credit control.
    Given an edge name, with flight on, every publish of a stamped frag
    observes (tspub - tsorig) & 0xFFFFFFFF into the edge's span
    histogram (``span``) and, with xray on, its exemplar sampler
    (``xspan``); the producer's queue row (``xq_tx``) books its credit
    stalls and credits."""

    def __init__(self, wksp: Workspace, names: LinkNames,
                 mtu: int = FD_TPU_MTU,
                 reliable_fseqs: Optional[Sequence[FSeq]] = None,
                 edge: Optional[str] = None):
        self.mcache = MCache(wksp, names.mcache)
        self.dcache = DCache(wksp, names.dcache)
        self.mtu = mtu
        self.seq = self.mcache.seq_next()
        # Resume the chunk walk after the last published frag, so a
        # restarted producer never overwrites unconsumed payloads.
        self.chunk = 0
        if self.seq > 0:
            r, last = self.mcache.poll(self.seq - 1)
            if r == rings.POLL_FRAG and last is not None:
                self.chunk = self.dcache.next_chunk(last.chunk, last.sz, mtu)
        self.fctl = make_fctl_for_fseqs(self.mcache.depth,
                                        reliable_fseqs or [], cr_burst=1)
        self.cr_avail = 0
        # Latency samples of what this link publishes; None keeps none.
        self.lat: Optional[LatReservoir] = None
        # The edge's always-on span histogram; None keeps none.
        self.span: Optional[flight.EdgeHist] = flight.span(wksp, edge)
        # fd_xray's exemplar sampler and queue row; None with xray off.
        self.xspan: Optional[xray.SpanCtx] = (
            xray.span_ctx(edge) if edge else None)
        self.xq_tx: Optional[xray.EdgeTx] = (
            xray.edge_tx(wksp, edge) if edge else None)

    def lat_sample(self, tsorig: int, now: int) -> None:
        """One stamped frag published at tick now: its span, its exemplar
        capture and its reservoir sample."""
        lat = (now - tsorig) & 0xFFFFFFFF
        if self.span is not None:
            self.span.observe(lat)
        if self.xspan is not None:
            self.xspan.observe(tsorig, now & 0xFFFFFFFF, lat)
        if self.lat is not None:
            self.lat.add(tsorig, now)

    def lat_sample_many(self, ts: np.ndarray, now: int) -> None:
        """The frags of a bulk publish at tick now (uint32 stamps; 0,
        unstamped, skipped): one vectorised span update and one exemplar
        mask."""
        ts = ts[ts != 0]
        if not len(ts):
            return
        if self.span is not None or self.xspan is not None:
            lats = ((now & 0xFFFFFFFF) - ts.astype(np.int64)) & 0xFFFFFFFF
            if self.span is not None:
                self.span.observe_many(lats)
            if self.xspan is not None:
                self.xspan.observe_many(ts, lats)
        if self.lat is not None:
            self.lat.add_many(ts, now)

    def stall_since(self, t_stall: int) -> None:
        """Book a credit stall that began at tick t_stall (0: none)."""
        if t_stall and self.xq_tx is not None:
            self.xq_tx.add_stall(tempo.tickcount() - t_stall)

    def housekeep(self) -> None:
        self.cr_avail = self.fctl.tx_cr_update(self.cr_avail, self.seq)

    def can_publish(self) -> bool:
        if self.cr_avail > 0:
            return True
        self.housekeep()
        return self.cr_avail > 0

    def publish(self, payload: bytes, sig: int, tsorig: int = 0,
                ctl: int = CTL_SOM_EOM) -> None:
        """Copy payload into the dcache and publish its frag meta."""
        if len(payload) > self.mtu:
            # A payload past the MTU would trample the next frag's chunk.
            raise ValueError(f"payload of {len(payload)} bytes exceeds the "
                             f"link MTU ({self.mtu})")
        self.dcache.write(self.chunk, payload)
        now = tempo.tickcount()
        if tsorig:
            self.lat_sample(tsorig, now)
        self.mcache.publish(self.seq, sig, self.chunk, len(payload), ctl,
                            tsorig, now & 0xFFFFFFFF)
        self.chunk = self.dcache.next_chunk(self.chunk, len(payload), self.mtu)
        self.seq += 1
        self.cr_avail = max(0, self.cr_avail - 1)


class Tile:
    """Generic run loop: housekeeping on jittered intervals and the bulk
    frag drain. Subclasses implement on_frag(frag, payload) and
    optionally on_idle(), on_housekeep(), on_halt(), done() and step()."""

    name = "tile"
    # Frags a bulk drain (fd_frag_drain) takes per in-link per round.
    BULK_FRAGS = 64
    # The CUDA device a tile launches on, if any.
    device: Optional[torch.device] = None

    def __init__(self, wksp: Workspace, cnc_name: str,
                 in_link: Optional[InLink] = None,
                 out_link: Optional[OutLink] = None,
                 lazy_ns: Optional[int] = None, seed: int = 0,
                 in_links: Optional[Sequence[InLink]] = None):
        if in_link is not None and in_links is not None:
            raise ValueError("pass in_link or in_links, not both")
        self.wksp = wksp
        self.cnc_name = cnc_name
        # The cnc name less ".cnc": the tile's flight row label and
        # recorder name.
        self.flight_label = (cnc_name[:-4] if cnc_name.endswith(".cnc")
                             else cnc_name)
        self.flightrec = flight.recorder(self.flight_label)
        self.cnc = Cnc(wksp, cnc_name)
        # Several in-links are polled in turn (the dedup tile's mux);
        # in_link is the first.
        self.in_links: List[InLink] = (
            list(in_links) if in_links is not None
            else [in_link] if in_link is not None else [])
        self.in_link = self.in_links[0] if self.in_links else None
        self.in_cur = self.in_link  # link of the frag being processed
        self.out_link = out_link
        self.rng = Rng(seq=seed)
        depth = (self.in_link.mcache.depth if self.in_link is not None else
                 out_link.mcache.depth if out_link is not None else 128)
        lazy = lazy_ns if lazy_ns is not None else tempo.lazy_default(depth)
        self._async_min = tempo.async_min(lazy)
        self._last_in_backp = 0
        self.halted = False
        self.error: Optional[BaseException] = None
        self.cpu_ns = 0  # CPU time of the tile's thread in run()
        # The core run() pins the tile's thread to (layout.tile_cpus),
        # None for no pinning.
        self.cpu_idx: Optional[int] = None
        self._bulk: dict = {}
        if self.in_links:
            rings.require_drain()
        # fd_xray: ns of idle naps, flushed to the first in-edge's queue
        # row at housekeeping (this thread writes the row).
        self._xq_idle_ns = 0
        self._xq_on = any(il.xq is not None for il in self.in_links)

    # -- overridables ----------------------------------------------------

    def on_frag(self, frag: Frag, payload: bytes) -> None:
        raise NotImplementedError

    def on_idle(self) -> None:
        """Called when the inputs are empty (flush partial batches)."""

    def on_housekeep(self) -> None:
        """Extra per-tile housekeeping."""

    def on_halt(self) -> None:
        """Tile-specific teardown."""

    def done(self) -> bool:
        """Source tiles return True when exhausted."""
        return False

    def step(self) -> None:
        """Source tiles (no in-link) override."""
        time.sleep(50e-6)

    def idle_sleep(self, idle_spins: int) -> float:
        """Seconds to sleep after idle_spins empty polls."""
        return idle_pause(idle_spins)

    # -- input -----------------------------------------------------------

    def _bulk_state(self, il: InLink) -> dict:
        st = self._bulk.get(id(il))
        if st is None:
            n = self.BULK_FRAGS
            # Any frag fits the buffer alone (sz is u16, below
            # n * FD_TPU_MTU) and the per-frag cap is the u16 ceiling:
            # the drain defers a frag that does not fit the room left,
            # and never truncates one.
            st = {"pay": np.zeros(n * FD_TPU_MTU, np.uint8),
                  "offs": np.zeros(n, np.uint32),
                  "lens": np.zeros(n, np.uint32),
                  "sigs": np.zeros(n, np.uint64),
                  "ts": np.zeros(n, np.uint32),
                  "seqs": np.zeros(n, np.uint64),
                  "ctls": np.zeros(n, np.uint16),
                  "tspubs": np.zeros(n, np.uint32),
                  "ctr": np.zeros(2, np.uint64)}
            # fd_frag_drain's arguments after the cursor, the pointers
            # read once: an idle tile polls every millisecond, and each
            # ndarray.ctypes lookup costs microseconds under the GIL.
            st["args"] = (
                self.BULK_FRAGS, 0xFFFF, st["pay"].ctypes.data,
                st["pay"].nbytes, *(st[k].ctypes.data for k in (
                    "offs", "lens", "sigs", "ts", "seqs", "ctls", "tspubs",
                    "ctr")))
            self._bulk[id(il)] = st
        return st

    def poll_inputs(self):
        """One bulk drain round over the in-links: (progressed, overrun).
        The consumed cursor advances only after the round's frags were
        handled, so housekeeping never acks an unhandled frag."""
        lib = rings.lib()
        progressed = overrun = False
        for il in self.in_links:
            st = self._bulk_state(il)
            seq = ctypes.c_uint64(il.seq)
            ovr0 = int(st["ctr"][1])
            n = lib.fd_frag_drain(
                il.mcache._mem, ctypes.addressof(il.dcache._buf),
                ctypes.byref(seq), *st["args"])
            d_ovr = int(st["ctr"][1]) - ovr0
            if d_ovr:
                il.fseq.diag_add(DIAG_OVRNR_CNT, d_ovr)
                overrun = True
            if n > 0:
                self.in_cur = il
                if il.xq is not None:
                    il.dwell_round(st["tspubs"], n)
                self.on_round(il, st, n)
                progressed = True
            il.seq = seq.value
        return progressed, overrun

    def on_round(self, il: InLink, st: dict, n: int) -> None:
        """Handle a drained round of n frags (the arrays of st), frag by
        frag through on_frag; a tile may take the round at once."""
        pay, offs, lens = st["pay"], st["offs"], st["lens"]
        for i in range(n):
            off, ln = int(offs[i]), int(lens[i])
            frag = Frag(seq=int(st["seqs"][i]), sig=int(st["sigs"][i]),
                        chunk=0, sz=ln, ctl=int(st["ctls"][i]),
                        tsorig=int(st["ts"][i]), tspub=int(st["tspubs"][i]))
            self.on_frag(frag, pay[off:off + ln].tobytes())

    # -- run loop --------------------------------------------------------

    def _housekeep_out(self) -> None:
        """Out-link credit refresh and the backpressure gauge."""
        if self.out_link:
            self.out_link.housekeep()
            if self.out_link.xq_tx is not None:
                self.out_link.xq_tx.sample_credits(self.out_link.cr_avail)
            backp = 1 if self.out_link.fctl.in_backpressure else 0
            if backp != self._last_in_backp:
                self.cnc.diag_add(CNC_DIAG_IN_BACKP,
                                  (backp - self._last_in_backp) & _U64)
                self._last_in_backp = backp

    def _xq_housekeep(self) -> None:
        """fd_xray's queue rows at housekeeping: each in-edge's ring depth
        and the idle ns into the first. The tile's own thread drains its
        in-links, so it is the rows' one writer (the verify tile's
        housekeep skips this: its drain books them)."""
        if not self._xq_on:
            return
        first = True
        for il in self.in_links:
            if il.xq is None:
                continue
            il.xq.sample_depth(il.mcache.seq_next() - il.seq)
            if first and self._xq_idle_ns:
                il.xq.add_idle(self._xq_idle_ns)
                self._xq_idle_ns = 0
                first = False

    def housekeep(self, now: int) -> None:
        self.cnc.heartbeat(now)
        for il in self.in_links:
            il.housekeep()
        self._xq_housekeep()
        self._housekeep_out()
        self.on_housekeep()

    def run(self, max_ns: int = 30_000_000_000) -> None:
        """Run until HALT, done() with HALT, or max_ns of wall time. An
        exception is kept in self.error and raised again; on_halt and
        the last housekeeping run either way. A tile with a CUDA device
        runs with it current in its thread: its CUDA work is launched
        from its own thread only. With cpu_idx set the thread is pinned
        to that core first, where the host allows it (best effort, as
        in the JAX Tile.run)."""
        if self.cpu_idx is not None and hasattr(os, "sched_setaffinity"):
            try:
                os.sched_setaffinity(0, {self.cpu_idx})  # this thread
            except OSError:
                pass  # a cpuset may forbid the core
        if self.device is not None and self.device.type == "cuda":
            with torch.cuda.device(self.device):
                return self._run(max_ns)
        return self._run(max_ns)

    def _run(self, max_ns: int) -> None:
        t0 = time.thread_time_ns()
        try:
            self._run_loop(max_ns)
        except BaseException as e:
            self.error = e
            # The postmortem before the raise: what the tile was doing
            # (written when the run's flight options name a directory).
            self.flightrec.record("crash", err=repr(e)[:200])
            flight.maybe_dump(f"crash:{self.flight_label}", wksp=self.wksp)
            xray.maybe_autopsy(f"crash:{self.flight_label}", wksp=self.wksp)
            raise
        finally:
            try:
                self.on_halt()
            finally:
                self.halted = True
                self.flightrec.record("halt")
                try:
                    self.housekeep(tempo.tickcount())
                finally:
                    self.cnc.signal(CNC_BOOT)
                    self.cpu_ns = time.thread_time_ns() - t0

    def _run_loop(self, max_ns: int) -> None:
        self.cnc.signal(CNC_RUN)
        start = tempo.tickcount()
        then = start
        idle_spins = 0
        while True:
            now = tempo.tickcount()
            if now >= then:
                self.housekeep(now)
                if self.cnc.signal_query() == CNC_HALT:
                    break
                if now - start > max_ns:
                    break
                then = now + tempo.async_reload(self.rng, self._async_min)
            if self.done():
                if self.cnc.signal_query() == CNC_HALT:
                    break
                idle_spins += 1
                time.sleep(idle_pause(idle_spins + 64))
                continue
            if not self.in_links:
                self.step()
                continue
            progressed, overrun = self.poll_inputs()
            if progressed or overrun:
                idle_spins = 0
            else:
                self.on_idle()
                idle_spins += 1
                pause = self.idle_sleep(idle_spins)
                if pause:
                    time.sleep(pause)
                    if self._xq_on:
                        self._xq_idle_ns += int(pause * 1e9)

    def publish_backp(self, payload: bytes, sig: int, tsorig: int = 0,
                      count_diag: bool = True) -> bool:
        """Publish downstream, spinning through backpressure (counted in
        the BACKP diag, its wall time in the out-edge's xray stall) until
        credits arrive or HALT. False when HALT came first and the frag
        was dropped."""
        t_stall = 0
        while not self.out_link.can_publish():
            if self.cnc.signal_query() == CNC_HALT:
                return False
            if not t_stall:
                t_stall = tempo.tickcount()
            self.cnc.diag_add(CNC_DIAG_BACKP_CNT, 1)
            time.sleep(20e-6)
        self.out_link.stall_since(t_stall)
        self.out_link.publish(payload, sig, tsorig=tsorig)
        if count_diag and self.in_cur is not None:
            self.in_cur.fseq.diag_add(DIAG_PUB_CNT, 1)
            self.in_cur.fseq.diag_add(DIAG_PUB_SZ, len(payload))
        return True


class MuxTile(Tile):
    """N in-links -> 1 out-link (disco/mux/fd_mux.c analog), the JAX
    ``MuxTile``:693: forwards every frag downstream in the order the
    in-links are drained, keeping its sig and tsorig. The generic
    multi-input run loop of Tile is the mux; this is its identity
    instance."""

    name = "mux"

    def __init__(self, wksp, cnc_name, in_links: Sequence[InLink],
                 out_link: OutLink, **kw):
        super().__init__(wksp, cnc_name, in_links=in_links,
                         out_link=out_link, **kw)

    def on_frag(self, frag: Frag, payload: bytes) -> None:
        self.publish_backp(payload, frag.sig, tsorig=frag.tsorig)


class ReplayTile(Tile):
    """Source: publishes a list of payloads with flow control
    (disco/replay/fd_replay.c analog). pub_ticks holds the full tick
    count of each publish, by payload index; a frag's tsorig carries its
    low 32 bits. Given out_links (one a verify lane) instead of
    out_link, it publishes payload i on lane i mod len(out_links), the
    round-robin fan-out of the JAX ``ReplayTile``:709-724 (the
    reference's verify_tile_count data parallelism)."""

    name = "replay"

    def __init__(self, wksp, cnc_name, out_link: Optional[OutLink] = None,
                 payloads: Sequence[bytes] = (),
                 out_links: Optional[Sequence[OutLink]] = None, **kw):
        if (out_link is None) == (out_links is None):
            raise ValueError("pass exactly one of out_link and out_links")
        self.out_links = list(out_links) if out_links else [out_link]
        super().__init__(wksp, cnc_name, out_link=self.out_links[0], **kw)
        self.payloads = payloads
        self.pos = 0
        self.pub_cnt = 0
        self.pub_ticks: list = []

    def done(self) -> bool:
        return self.pos >= len(self.payloads)

    def housekeep(self, now: int) -> None:
        super().housekeep(now)
        for ol in self.out_links[1:]:
            ol.housekeep()

    def step(self) -> None:
        lane = self.out_links[self.pos % len(self.out_links)]
        c = chaos.active()
        # An injected credit starvation backs off as a refused publish; the
        # backoff is a 20 us credit stall on the lane's xray row.
        if (c is not None and c.source_starved()) or not lane.can_publish():
            self.cnc.diag_add(CNC_DIAG_BACKP_CNT, 1)
            if lane.xq_tx is not None:
                lane.xq_tx.add_stall(20_000)
            time.sleep(20e-6)
            return
        if c is not None:
            # Maybe a CTL_ERR frag ahead of the next payload (1-based);
            # it spent a credit, so check again.
            c.source_inject(lane, self.pos + 1)
            if not lane.can_publish():
                return
        payload = self.payloads[self.pos]
        now = tempo.tickcount()
        self.pub_ticks.append(now)
        lane.publish(payload, meta_sig(payload), tsorig=now & 0xFFFFFFFF)
        self.pos += 1
        self.pub_cnt += 1


def _txn_batch_arrays(items, max_len: int):
    """Pack (sig, pub, msg) tuples into the engine's padded arrays."""
    n = len(items)
    msgs = np.zeros((n, max_len), np.uint8)
    lens = np.zeros(n, np.int32)
    sigs = np.zeros((n, 64), np.uint8)
    pubs = np.zeros((n, 32), np.uint8)
    for i, (sig, pub, msg) in enumerate(items):
        m = np.frombuffer(msg, np.uint8)[:max_len]
        msgs[i, :len(m)] = m
        lens[i] = len(m)
        sigs[i] = np.frombuffer(sig, np.uint8)
        pubs[i] = np.frombuffer(pub, np.uint8)
    return msgs, lens, sigs, pubs


@dataclass
class _InflightBatch:
    """One dispatched batch awaiting completion (the software analog of
    a wiredancer DMA slot, wd_f1.c:327-408)."""

    out: object          # is_ready() / np.asarray() / used_fallback
    todo: list           # [(payload or None, n_lanes, tsorig, seq_end)]
    t_dispatch: int      # tick count at dispatch
    slot: object = None  # the fd_feed slot the batch was staged in
    drain: object = None  # the batch's _DrainBatch (fd_drain armed)
    # The EngineEntry it runs on (its service EMA); None when the CPU
    # lane served it, whose completion feeds neither the breaker nor an
    # EMA.
    entry: object = None

    def is_ready(self) -> bool:
        """The statuses and, with the drain, its verdicts are done."""
        return self.out.is_ready() and (self.drain is None
                                        or self.drain.is_ready())


class _DeviceBatch:
    """A direct engine's statuses tensor with the async-batch surface: a
    CUDA event recorded after the launches answers is_ready() without
    blocking, and np.asarray reads the statuses back (a CPU tensor is
    ready when returned)."""

    def __init__(self, statuses: torch.Tensor):
        self._t = statuses
        self._ev = None
        if statuses.device.type == "cuda":
            self._ev = torch.cuda.Event()
            self._ev.record(torch.cuda.current_stream(statuses.device))

    def is_ready(self) -> bool:
        return self._ev is None or self._ev.query()

    def __array__(self, dtype=None, copy=None):
        out = self._t.cpu().numpy()
        return out.astype(dtype) if dtype is not None else out


class _DrainBatch:
    """The fd_drain's outputs for one batch: the novel mask, the pack
    colors (drain_pack) or None, the device block id, and a CUDA event
    recorded after the drain's launches, which follow the batch's verify
    launches on the stream (a CPU batch is ready when returned)."""

    def __init__(self, novel: torch.Tensor, colors, block: int):
        self.novel = novel
        self.colors = colors
        self.block = block
        self._ev = None
        if novel.device.type == "cuda":
            self._ev = torch.cuda.Event()
            self._ev.record(torch.cuda.current_stream(novel.device))

    def is_ready(self) -> bool:
        return self._ev is None or self._ev.query()


class VerifyTile(Tile):
    """Sigverify: parse each txn in the tile, drop HA duplicates, verify
    its signatures, publish the verified txns (the verify tile of
    app/frank/fd_frank_verify.c). See the module docstring for the
    backends and ingest paths.

    Up to ``inflight`` batches are on the device while the tile keeps
    draining; completions retire in dispatch order. A partial batch is
    flushed by the adaptive policy (deadline ``max_wait_us``, or starved
    input with an idle device), or when the held-back ack cursor is
    about to exhaust the producer's credits. Parse errors, bad
    signatures and CTL_ERR frags count in the SV filter slots, HA
    duplicates in the HA slots. ``feed=True`` stages through
    ``feed_slots`` staging slots on a stager thread (the module
    docstring); it needs the gpu backend and the native drain. In feed
    mode ``drain`` ("auto" or "off", ``engine.resolve_drain_mode``) arms
    the fd_drain with a window of ``drain_filter_bits`` bits, rotated
    every ``drain.rot_quota`` confirmed-novel publishes for a dedup
    TCache of ``tcache_depth`` (the runners give both tiles one depth),
    and ``drain_pack`` colors each batch for the gc pack (the JAX flags
    FD_DRAIN, FD_DRAIN_FILTER_BITS, FD_DRAIN_PACK and their defaults;
    the JAX FD_DRAIN_ROT_QUOTA has no counterpart, since the quota
    follows from the depths the tile is given). The feed's rung ladder
    takes ``sched`` (on by default), ``ladder`` (``engine.rung_ladder``'s
    "8192,16384,32768" by default) and ``prewarm`` ("background",
    "sync" or "off"), the JAX flags FD_ENGINE_SCHED, FD_ENGINE_LADDER
    and FD_ENGINE_PREWARM and their defaults; ``frontend`` is the rlc
    engine's front half (``frontend_cuda.FRONTENDS``, the JAX
    FD_FRONTEND_IMPL). With the default ladder and a batch of 8,192 or
    less the scheduler stays off. The feeder's healing takes ``breaker``
    (on), ``breaker_threshold``, ``breaker_cooldown_ms``,
    ``stager_restart_max`` and ``stager_backoff_ms`` (the JAX flags
    FD_VERIFY_BREAKER, FD_VERIFY_BREAKER_THRESHOLD,
    FD_VERIFY_BREAKER_COOLDOWN_MS, FD_FEED_STAGER_RESTART_MAX and
    FD_FEED_STAGER_BACKOFF_MS and their defaults); the step loop has no
    breaker, as in the JAX package.
    """

    name = "verify"

    def __init__(
        self,
        wksp,
        cnc_name,
        in_link,
        out_link,
        backend: str = "gpu",
        batch: int = 128,
        max_msg_len: int = FD_TPU_MTU,
        tcache_depth: int = 4096,
        inflight: int = 2,
        max_wait_us: Optional[int] = None,
        native_drain: bool = True,
        verify_mode: str = "auto",
        device="cuda",
        feed: bool = False,
        feed_slots: int = 4,
        drain: str = "auto",
        drain_filter_bits: int = DEFAULT_FILTER_BITS,
        drain_pack: bool = False,
        sched: bool = True,
        ladder=fd_engine.DEFAULT_LADDER,
        prewarm: str = fd_engine.DEFAULT_PREWARM,
        frontend: str = DEFAULT_FRONTEND,
        breaker: bool = True,
        breaker_threshold: int = BREAKER_THRESHOLD,
        breaker_cooldown_ms: int = BREAKER_COOLDOWN_MS,
        stager_restart_max: int = STAGER_RESTART_MAX,
        stager_backoff_ms: int = STAGER_BACKOFF_MS,
        **kw,
    ):
        self.verify_mode = fd_engine.resolve_verify_mode(backend, verify_mode)
        self.drain_mode = fd_engine.resolve_drain_mode(drain)
        if prewarm not in fd_engine.PREWARM_POLICIES:
            raise ValueError(f"unknown prewarm policy {prewarm!r} "
                             "(want background|sync|off)")
        rungs = tile_rungs(ladder, batch)
        if feed and (backend != "gpu" or not native_drain
                     or in_link is None):
            raise ValueError("feed=True needs backend='gpu', the native "
                             "drain and an in-link")
        if backend == "gpu" and (batch < MAX_SIG_CNT
                                 or max_msg_len < FD_TPU_MTU):
            # A txn that parses has at most MAX_SIG_CNT signatures and a
            # message of at most FD_TPU_MTU bytes: anything narrower
            # could not verify every txn on the device.
            raise ValueError(
                f"backend='gpu' needs batch >= {MAX_SIG_CNT} and "
                f"max_msg_len >= {FD_TPU_MTU}, got batch={batch}, "
                f"max_msg_len={max_msg_len}")
        super().__init__(wksp, cnc_name, in_link=in_link, out_link=out_link,
                         **kw)
        # The tile's flight lane: every dispatch and healing counter of
        # TILE_METRICS (the stat_* properties read it).
        self.fl = flight.tile_lane(wksp, self.flight_label)
        # fd_xray (the JAX :976-983): the tile's ring of batch-context
        # exemplars (each head-sampled txn of a dispatched batch) and
        # trigger events (quarantine, breaker, CTL_ERR), and the sampling
        # threshold. The in-edge's queue row is booked where the ring is
        # drained (the stager in feed mode), not at housekeeping.
        self._xr_on = xray.enabled()
        self.xr = xray.ring(f"tile:{self.flight_label}")
        self._xr_thr = xray.sample_threshold() if self._xr_on else 0
        self._xq_on = False
        self.backend = backend
        self.batch = batch
        self.max_msg_len = max_msg_len
        self.ha_tcache = TCache(tcache_depth)
        self.inflight_max = max(1, inflight)
        deadline_us = (max_wait_us if max_wait_us is not None
                       else DEFAULT_DEADLINE_US)
        self.max_wait_ns = deadline_us * 1_000
        self.flush_policy = AdaptiveFlush(self.max_wait_ns)
        self._pending: list = []       # [(payload, items|n, tsorig, seq_end)]
        self._pending_lanes = 0
        self._pending_since = 0        # tick count of the oldest pending txn
        self._inflight: list = []      # FIFO of _InflightBatch
        # The fseq published to the producer is held back to the last
        # seq whose txn is fully verified, so a crash between consume and
        # verify leaves the frags re-readable.
        self._acked_seq = self.in_link.seq if self.in_link else 0
        self._last_unacked = int(self.cnc.diag(CNC_DIAG_UNACKED))
        # (lanes, verdict) of every batch dispatched, in order.
        self.batch_log: list = []
        # The CPU lane's signature lanes and wall ns (failover and
        # re-verify).
        self.stat_cpu_lanes = 0
        self.stat_cpu_ns = 0
        self._breaker: Optional[CircuitBreaker] = None
        if feed and breaker:
            self._breaker = CircuitBreaker(breaker_threshold,
                                           breaker_cooldown_ms * 1_000_000)
        self._breaker_pub = (None, 0, 0)   # the breaker last published
        self._stager_restart_max = stager_restart_max
        self._stager_backoff_s = stager_backoff_ms / 1e3
        # Wall ns of the engine calls (copies in, launches) and of the
        # completions (read-back wait, publishes).
        self.stat_dispatch_ns = 0
        self.stat_complete_ns = 0
        self._drain: Optional[DrainWindow] = None
        self._drain_pack = False
        self._drain_block = 0
        self._drain_h_bits = drain_filter_bits
        self._drain_pack_req = bool(drain_pack)
        # The rung ladder: the scheduler (None: the fixed batch), the
        # rung engines, batches by rung (rung switches and the current
        # target rung, 0 with the scheduler off, are in the lane).
        self.sched = bool(sched)
        self.prewarm = prewarm
        self.frontend = frontend
        self.rung_sched: Optional[fd_engine.RungScheduler] = None
        self._rung_entries: dict = {}
        self._rung_last = 0
        self.stat_rung_hist: dict = {}
        # Live reconfig: one pending request at a time (any thread parks
        # it; the dispatcher applies it at the inflight barrier).
        self._reconfig_lock = threading.Lock()
        self._reconfig_pending: Optional[dict] = None
        self._reconfig_seq = 0
        self._engine_entry = None
        self._engine_spec = None
        self._verify_batch_fn = None
        self.device = None
        if backend == "gpu":
            self._engine_spec = fd_engine.EngineSpec.for_tile(
                backend, self.verify_mode, batch, frontend)
            entry, warmed_now = fd_engine.registry().acquire(
                self._engine_spec, warm=True, device=device,
                max_msg_len=max_msg_len)
            if warmed_now:
                self._account_compile(entry)
            self._engine_entry = entry
            self._verify_batch_fn = entry.fn
            self.device = entry.device
        self._nd = backend == "gpu" and native_drain and in_link is not None
        self._feed = feed
        if self._nd:
            self._nd_setup(staging=not feed)
        if feed:
            self._feed_setup(feed_slots)
            self._drain_setup()
            if self.sched and rungs:
                self._rung_setup(rungs)

    stat_batches = _lane_stat("batches")
    stat_lanes = _lane_stat("lanes")
    stat_flush_timeout = _lane_stat("flush_timeout")
    stat_flush_starved = _lane_stat("flush_starved")
    stat_inflight_stall = _lane_stat("inflight_stall")
    stat_rlc_fallback = _lane_stat("rlc_fallback")
    stat_ctl_err = _lane_stat("ctl_err_drop")
    stat_cpu_failover = _lane_stat("cpu_failover")
    stat_quarantined = _lane_stat("quarantined")
    stat_quarantine_err_txn = _lane_stat("quarantine_err_txn")
    stat_stager_restarts = _lane_stat("stager_restarts")
    stat_feed_idle_ns = _lane_stat("feed_idle_ns")
    stat_drain_batches = _lane_stat("drain_batches")
    stat_drain_novel = _lane_stat("drain_novel")
    stat_drain_maybe = _lane_stat("drain_maybe")
    stat_drain_rot = _lane_stat("drain_rot")
    stat_rung_switches = _lane_stat("rung_switches")
    stat_rung_cur = _lane_stat("rung_cur")
    stat_reconfigs = _lane_stat("reconfigs")
    stat_reconfig_refused = _lane_stat("reconfig_refused")

    @property
    def stat_flush(self) -> dict:
        """Batches by flush verdict."""
        out = dict.fromkeys((FLUSH_FULL, FLUSH_DEADLINE, FLUSH_STARVED,
                             FLUSH_RING, FLUSH_HALT, FLUSH_CAPACITY), 0)
        for _, verdict in self.batch_log:
            out[verdict] += 1
        return out

    def _book_batch(self, lanes: int, verdict: str, **ev) -> None:
        """Count a dispatched batch in the log and the lane, its flush
        verdict (deadline, starved) and a dispatch event."""
        self.batch_log.append((lanes, verdict))
        fl = self.fl
        fl.inc("batches")
        fl.inc("lanes", lanes)
        if verdict == FLUSH_DEADLINE or verdict == FLUSH_STARVED:
            fl.inc("flush_timeout" if verdict == FLUSH_DEADLINE
                   else "flush_starved")
            self.flightrec.record("flush", verdict=verdict, lanes=lanes)
        self.flightrec.record("dispatch", lanes=lanes, **ev)

    def _xr_engine(self) -> str:
        spec = self._engine_spec
        return spec.key if spec is not None else self.backend

    def _xr_batch(self, tsorigs, n: int, verdict: str, device: bool,
                  slot_idx=None, rung=None) -> None:
        """fd_xray's batch context (the JAX _xr_batch:1220): a span for
        each head-sampled txn of a dispatched batch (at most 16), with the
        batch's ordinal, the engine's key, the flush verdict, whether the
        card ran it, and the slot and rung of a feed batch. One
        vectorised hash a batch."""
        if not self._xr_on or n <= 0:
            return
        ids = np.asarray(tsorigs[:n], np.uint64)
        idxs = np.nonzero(xray.sampled_mask(ids, self._xr_thr))[0]
        if idxs.size == 0:
            return
        now = tempo.tickcount() & 0xFFFFFFFF
        extra = {"batch": self.stat_batches, "engine": self._xr_engine(),
                 "verdict": verdict, "device": device}
        if slot_idx is not None:
            extra["slot"] = slot_idx
        if rung is not None:
            extra["rung"] = rung
            extra["rung_target"] = self._rung_last
        for i in idxs[:16]:
            t = int(ids[i])
            self.xr.record(t, t, now, "head", dict(extra))

    def _xr_trigger(self, trigger: str, tsorigs=None, **extra) -> None:
        """fd_xray's trigger event (quarantine, breaker, ctl_err; the JAX
        _xr_trigger:1270), with up to 8 of the trace ids it touched."""
        if not self._xr_on:
            return
        ids = []
        if tsorigs is not None:
            ids = [int(t) for t in np.asarray(tsorigs).ravel()[:8]]
        now = tempo.tickcount() & 0xFFFFFFFF
        first = ids[0] if ids else 0
        self.xr.record(first, first, now, trigger,
                       dict(extra, traces=ids, engine=self._xr_engine()))

    def _account_compile(self, entry) -> None:
        """Book an engine warm this tile paid into its lane (the JAX
        _account_compile:1285): count, wall ns and build cache hits."""
        self.fl.inc("compile_cnt")
        self.fl.inc("compile_ns", int(entry.warm_s * 1e9))
        if entry.warm_hit:
            self.fl.inc("compile_cache_hit")
        self.flightrec.record("compile", engine=entry.key,
                              s=round(entry.warm_s, 3), hit=entry.warm_hit)

    def _publish_flight(self) -> None:
        """Fold the pool's slot stalls and the breaker's gauges into the
        lane (a breaker transition recorded) and publish it."""
        fl = self.fl
        if self._feed:
            stall = self.feed_pool.slot_stall
            have = fl.get("slot_stall")
            if stall > have:
                fl.inc("slot_stall", stall - have)
        b = self._breaker
        fl.set_gauge("breaker_state", flight.BREAKER_STATE_CODE.get(
            b.state if b is not None else "disabled", 3))
        if b is not None:
            fl.set_gauge("breaker_trips", b.trips)
            fl.set_gauge("breaker_reprobes", b.reprobes)
            cur = (b.state, b.trips, b.reprobes)
            if cur != self._breaker_pub and self._breaker_pub[0] is not None:
                self.flightrec.record("breaker", state=b.state,
                                      trips=b.trips, reprobes=b.reprobes)
                self._xr_trigger("breaker", state=b.state, trips=b.trips,
                                 reprobes=b.reprobes)
            self._breaker_pub = cur
        fl.publish()

    # -- native drain ----------------------------------------------------

    def _nd_setup(self, staging: bool = True) -> None:
        """The drain's counters and, unless the feed's slots stage, the
        one staging buffer."""
        self._nd_lib = rings.lib()
        # {drained_ok, parse_err, overrun, oversize, parse_err_bytes,
        #  oversize_bytes, ctl_err, ctl_err_bytes}
        self._nd_counters = np.zeros(8, np.uint64)
        self._nd_prev = np.zeros(8, np.uint64)
        if not staging:
            return
        b, mtu = self.batch, self.max_msg_len
        self._nd_msgs = np.zeros((b, mtu), np.uint8)
        self._nd_lens = np.zeros(b, np.uint32)
        self._nd_sigs = np.zeros((b, 64), np.uint8)
        self._nd_pubs = np.zeros((b, 32), np.uint8)
        self._nd_pay = np.zeros(b * FD_TPU_MTU, np.uint8)
        self._nd_offs = np.zeros(b, np.uint32)
        self._nd_plens = np.zeros(b, np.uint32)
        self._nd_psigs = np.zeros(b, np.uint64)
        self._nd_tlanes = np.zeros(b, np.uint32)
        self._nd_tsorig = np.zeros(b, np.uint32)
        self._nd_tspub = np.zeros(b, np.uint32)
        self._nd_hash = np.zeros(b, np.uint64)
        self._nd_pay_fill = 0
        # The buffers' addresses, read once: an idle tile polls every
        # millisecond, and each ndarray.ctypes lookup costs microseconds
        # under the GIL.
        self._nd_ptr = {k: getattr(self, f"_nd_{k}").ctypes.data for k in (
            "msgs", "lens", "sigs", "pubs", "pay", "offs", "plens", "psigs",
            "tlanes", "tsorig", "tspub", "hash", "counters")}

    def _nd_account(self, il: InLink) -> bool:
        """Fold a drain round's counter deltas into the diag slots
        (parse errors, oversize and CTL_ERR drops to the SV filter) and
        the chaos audit (the CTL_ERR drops and the overruns are the
        detection of ring_ctl_err and ring_overrun); True when the round
        crossed an overrun."""
        d = self._nd_counters - self._nd_prev
        self._nd_prev = self._nd_counters.copy()
        if d[1] or d[3]:
            self.cnc.diag_add(CNC_DIAG_SV_FILT_CNT, int(d[1] + d[3]))
            self.cnc.diag_add(CNC_DIAG_SV_FILT_SZ, int(d[4] + d[5]))
        c = chaos.active()
        if d[6]:
            self.fl.inc("ctl_err_drop", int(d[6]))
            self.flightrec.record("ctl_err_drop", n=int(d[6]))
            self._xr_trigger("ctl_err", n=int(d[6]))
            self.cnc.diag_add(CNC_DIAG_SV_FILT_CNT, int(d[6]))
            self.cnc.diag_add(CNC_DIAG_SV_FILT_SZ, int(d[7]))
            if c is not None:
                c.on_ctl_err_drop(int(d[6]))
        if d[2]:
            il.fseq.diag_add(DIAG_OVRNR_CNT, int(d[2]))
            if c is not None:
                c.on_overrun_observed()
            return True
        return False

    def poll_inputs(self):
        if self._feed:
            return self._feed_poll()
        if not self._nd:
            return super().poll_inputs()
        il = self.in_link
        room_lanes = self.batch - self._pending_lanes
        if room_lanes <= 0:
            self._dispatch(FLUSH_FULL)
            self._complete(block=False)
            return False, False
        lane0 = self._pending_lanes
        mtu = self.max_msg_len
        if il.xq is not None:
            il.xq.sample_depth(il.mcache.seq_next() - il.seq)
        seq = ctypes.c_uint64(il.seq)
        ptr = self._nd_ptr
        n = self._nd_lib.fd_verify_drain(
            il.mcache._mem, ctypes.addressof(il.dcache._buf),
            ctypes.byref(seq),
            self.batch - len(self._pending), room_lanes, self.batch, mtu,
            ptr["msgs"] + lane0 * mtu, ptr["lens"] + lane0 * 4,
            ptr["sigs"] + lane0 * 64, ptr["pubs"] + lane0 * 32,
            ptr["pay"] + self._nd_pay_fill,
            self._nd_pay.nbytes - self._nd_pay_fill,
            ptr["offs"], ptr["plens"], ptr["psigs"], ptr["tlanes"],
            ptr["tsorig"], ptr["tspub"], ptr["hash"], ptr["counters"])
        overrun = self._nd_account(il)
        if n <= 0:
            il.seq = seq.value
            if not self._pending and not self._inflight:
                self._acked_seq = il.seq  # everything consumed is done
            return False, overrun
        if not self._pending:
            self._pending_since = tempo.tickcount()
        if il.xq is not None:
            # The round's oldest frag's ring dwell (as the stager books).
            il.xq.observe_dwell(xray.dwell32(tempo.tickcount(),
                                             int(self._nd_tspub[0])))
        drain_end = seq.value
        base = self._nd_pay_fill
        for i in range(n):
            off = base + int(self._nd_offs[i])
            ln = int(self._nd_plens[i])
            payload = self._nd_pay[off:off + ln].tobytes()
            cnt = int(self._nd_tlanes[i])
            # Only the round's last txn carries the post-round seq: the
            # ack must not pass a batch boundary inside the round.
            seq_end = drain_end if i == n - 1 else 0
            if self.ha_tcache.insert(hash(payload)):
                self.cnc.diag_add(CNC_DIAG_HA_FILT_CNT, 1)
                self.cnc.diag_add(CNC_DIAG_HA_FILT_SZ, ln)
                # Its lanes stay staged; completion skips it (None).
                self._pending.append((None, cnt, 0, seq_end))
            else:
                self._pending.append(
                    (payload, cnt, int(self._nd_tsorig[i]), seq_end))
            self._nd_pay_fill = off + ln
            self._pending_lanes += cnt
        # The consumed cursor moves after the txns are in _pending.
        il.seq = seq.value
        if self._pending_lanes >= self.batch:
            self._dispatch(FLUSH_FULL)
        elif self._ring_starved():
            self._dispatch(FLUSH_RING)
        self._complete(block=False)
        return True, overrun

    def _engine_args(self, msgs, lens, sigs, pubs):
        """The engine's inputs: lens as int32. EngineEntry.fn copies
        numpy arrays from pageable memory to the card before it returns,
        so the staging buffers are free to refill; on the CPU the
        tensors would share the buffers (and a lazy RLC fallback reads
        them later), so they are copied."""
        arrs = (msgs, lens.astype(np.int32), sigs, pubs)
        if self.device.type == "cpu":
            arrs = tuple(a.copy() for a in arrs)
        return arrs

    def _launch(self, args, fn=None):
        t0 = time.perf_counter_ns()
        out = (fn or self._verify_batch_fn)(*args)
        if isinstance(out, torch.Tensor):
            out = _DeviceBatch(out)
        self.stat_dispatch_ns += time.perf_counter_ns() - t0
        return out

    def _dispatch_native(self, verdict: str) -> None:
        if not self._pending:
            return
        while len(self._inflight) >= self.inflight_max:
            self.fl.inc("inflight_stall")
            self._complete(block=True)
        lanes = self._pending_lanes
        if lanes < self.batch:
            # Rows past the staged lanes verify as pad lanes (zero sig,
            # pub and len), not as the previous batch's signatures:
            # under rlc a stale lane would fail the batch equation.
            self._nd_lens[lanes:] = 0
            self._nd_sigs[lanes:] = 0
            self._nd_pubs[lanes:] = 0
        out = self._launch(self._engine_args(
            self._nd_msgs, self._nd_lens, self._nd_sigs, self._nd_pubs))
        self._inflight.append(_InflightBatch(
            out=out, todo=self._pending, t_dispatch=tempo.tickcount(),
            entry=self._engine_entry))
        self._book_batch(lanes, verdict, device=True)
        if self._xr_on:
            self._xr_batch([t[2] for t in self._pending], len(self._pending),
                           verdict, True)
        self._pending = []
        self._pending_lanes = 0
        self._nd_pay_fill = 0

    # -- fd_feed: stager thread and slot dispatcher ------------------------

    def _feed_setup(self, feed_slots: int) -> None:
        """The staging slots (pinned when the engine is on the card) and
        the stager's state. The stager starts on the dispatcher's first
        poll, so a tile built and never run starts no thread."""
        self.feed_pool = SlotPool(feed_slots, self.batch, self.max_msg_len,
                                  pin=self.device.type == "cuda")
        self._feed_started = False
        self._feed_stop = threading.Event()
        self._feed_thread: Optional[threading.Thread] = None
        self._feed_slot = None          # the FILLING slot (the stager's)
        self._feed_idle_mark = 0
        self._stager_err: Optional[BaseException] = None
        self._stager_restart_at = 0     # 0: no restart pending
        self._stager_err_cls: Optional[str] = None  # an injected kill's
        self.stager_cpu_ns = 0
        # Source publish -> stager drain of every staged txn.
        self.drain_lat = LatReservoir()
        # The ring dwell (the producer's publish -> the stager's drain)
        # of each round's oldest frag, the verify_drain edge.
        self._dwell_span = flight.span(self.wksp, "verify_drain")

    def _drain_setup(self) -> None:
        """Arm the fd_drain (feed mode, an out-link, drain "auto"), or
        disarm it: a fresh window on the engine's device and the
        pre-filter warmed there at the batch's shape. The ring library's
        ctl publisher is required (Tile.__init__ ran rings.require_drain).
        A live reconfig's drain flip runs this again; a window armed
        mid-run knows nothing published before, and the dedup tile's
        tripwire (false novel) keeps its verdicts exact."""
        self._drain = None
        self._drain_pack = False
        if self.drain_mode == "off" or self.out_link is None:
            return
        # The proof's quota for a dedup TCache as deep as this tile's
        # (the runners give both tiles one tcache_depth). The JAX tile
        # assumes 4096 whatever the depth (tiles.py:1453-1459).
        quota = rot_quota(self.ha_tcache.depth, self.out_link.mcache.depth,
                          self.batch)
        self._drain = DrainWindow(self._drain_h_bits, quota, self.device)
        self._engine_entry.warm_drain(self._drain_h_bits)
        self._drain_pack = self._drain_pack_req
        if self._drain_pack:
            self._drain_est = CuEstimator()

    def _rung_setup(self, rungs: List[int]) -> set:
        """Install the rung ladder on the primary engine's spec: an entry
        for each rung (each one's service EMA is the scheduler's cost
        model), the other rungs warmed by the prewarm policy, and a
        RungScheduler whose AdaptiveFlush becomes the stager's flush
        policy (one policy object). Returns the rung specs."""
        reg = fd_engine.registry()
        spec = self._engine_spec
        ents = {r: reg.entry(spec.with_batch(r), self.device) for r in rungs}
        self._rung_entries = ents
        reg.prewarm_ladder([spec.with_batch(r) for r in rungs
                            if r != self.batch], device=self.device,
                           max_msg_len=self.max_msg_len, policy=self.prewarm)
        self.rung_sched = fd_engine.RungScheduler(
            rungs, self.max_wait_ns,
            cost_ns=lambda r: ents[r].service_est_ns())
        self.flush_policy = self.rung_sched.flush
        self._rung_last = rungs[0]
        self.fl.set_gauge("rung_cur", rungs[0])
        self.flightrec.record("rung_ladder", rungs=list(rungs),
                              prewarm=self.prewarm)
        return {spec.with_batch(r) for r in rungs}

    def _drain_pack_arrays(self, slot):
        """The coloring's arrays for a slot's txns, a pad row for each
        lane past them and for a txn that does not parse or has a
        malformed compute-budget instruction (lock-free, zero score: it
        colors freely and the pack ignores its color)."""
        txns: list = [PackTxnPad] * self.batch
        for t in range(slot.n_txn):
            off, ln = int(slot.offs[t]), int(slot.plens[t])
            pt = pack_txn(slot.pay[off:off + ln].tobytes(), t,
                          self._drain_est)
            if pt is not None:
                txns[t] = pt
        return build_arrays(txns, max_w=MAX_ACCT_CNT, max_r=MAX_ACCT_CNT)

    def _drain_dispatch(self, slot) -> _DrainBatch:
        """Launch the drain for a slot right behind its verify launches,
        on the same stream: the staged txns' meta sig halves and mask go
        up from the slot's pinned arenas (the slot is held until the
        batch retires), the filter runs on those n lanes only (the
        verdicts past them are never read, and the kernel's launch is
        chosen by n), the coloring with drain_pack on the whole batch,
        and the window adopts the new bank A at once, so the next batch
        filters against this one's inserts with no sync. An error
        propagates."""
        n = slot.n_txn
        slot.tag_hi[:], slot.tag_lo[:] = split_tags(slot.psigs)
        slot.valid[:n] = True
        dev = self.device
        tags_hi, tags_lo, valid = (t[:n].to(dev, non_blocking=True)
                                   for t in (slot.t_tag_hi, slot.t_tag_lo,
                                             slot.t_valid))
        bits_a, bits_b = self._drain.banks()
        colors = None
        block = 0
        if self._drain_pack:
            arrs = (torch.from_numpy(a).to(dev)
                    for a in self._drain_pack_arrays(slot))
            novel, bits_new, _, colors = drain_pack_step(
                tags_hi, tags_lo, valid, bits_a, bits_b, *arrs,
                n_colors=min(MAX_COLORS_DEFAULT, MAX_CTL_COLORS),
                h_bits=H_BITS_DEFAULT, cu_cap=CU_CAP_DEFAULT)
            block = self._drain_block
            self._drain_block = (block + 1) % (CTL_BLOCK_MASK + 1)
        else:
            novel, bits_new, _ = dedup_filter(tags_hi, tags_lo, valid,
                                              bits_a, bits_b)
        self._drain.commit(bits_new)
        self.fl.inc("drain_batches")
        return _DrainBatch(novel, colors, block)

    def _feed_start(self) -> None:
        self._feed_started = True

        def guarded():
            try:
                self._stager_loop()
            except BaseException as e:  # noqa: BLE001 - to the dispatcher
                self._stager_err = e

        self._feed_thread = threading.Thread(
            target=guarded, name=f"{self.name}.stager", daemon=True)
        self._feed_thread.start()

    def _stager_supervise(self) -> None:
        """Crash-only supervision of the stager (dispatcher thread): a
        raise out of the stager loop is counted and the stager restarted
        after respawn_backoff_s's delay (doubling a restart, jittered by
        the tile's Rng, capped at STAGER_BACKOFF_CAP_S); staged slots
        (the READY queue, the parked FILLING slot) and the held-back ack
        survive the restart. An injected kill is booked detected when the
        stager dies and healed when it restarts. Past stager_restart_max
        restarts the error is raised."""
        err = self._stager_err
        if err is not None:
            self._stager_err = None
            self.fl.inc("stager_restarts")
            n = self.stat_stager_restarts
            self.flightrec.record("stager_restart", n=n, err=repr(err)[:120])
            c = chaos.active()
            if c is not None and isinstance(err, chaos.ChaosFault):
                c.note(err.cls, "detected")
                self._stager_err_cls = err.cls
            if n > self._stager_restart_max:
                raise RuntimeError(
                    f"fd_feed stager died {n} times (> "
                    f"{self._stager_restart_max}); giving up") from err
            backoff_s = respawn_backoff_s(n, self._stager_backoff_s,
                                          STAGER_BACKOFF_CAP_S, self.rng)
            self._stager_restart_at = (tempo.tickcount()
                                       + int(backoff_s * 1e9))
            logging.getLogger(LOGGER).warning(
                "fd_feed stager died (%r); restart %d/%d in %.1f ms", err,
                n, self._stager_restart_max, backoff_s * 1e3)
            return
        if (self._stager_restart_at and not self._feed_stop.is_set()
                and not self._feed_thread.is_alive()
                and tempo.tickcount() >= self._stager_restart_at):
            self._stager_restart_at = 0
            self._feed_start()
            if self._stager_err_cls is not None:
                c = chaos.active()
                if c is not None:
                    c.note(self._stager_err_cls, "healed")
                self._stager_err_cls = None

    def _stager_drain(self, slot) -> int:
        """One fd_verify_drain round into slot at its fill cursors; the
        HA filter on the drain's payload hashes. Returns the txns
        staged. The chaos hooks that kill the stager or rewind the cursor
        run before the C call (a raise leaves nothing half-booked); the
        one that corrupts a staged message after the HA filter."""
        il = self.in_link
        c = chaos.active()
        if c is not None:
            c.stager_round_hook()
            c.overrun_rewind(il)
        if il.xq is not None:
            # The stager is the in-edge row's one writer (the JAX
            # :1767-1773): the depth a round, the dwell below.
            il.xq.sample_depth(il.mcache.seq_next() - il.seq)
        k0 = slot.n_txn
        mtu = self.max_msg_len
        seq = ctypes.c_uint64(il.seq)
        n = self._nd_lib.fd_verify_drain(
            il.mcache._mem, ctypes.addressof(il.dcache._buf),
            ctypes.byref(seq),
            self.batch - k0, self.batch - slot.n_lane, self.batch, mtu,
            slot.msgs.ctypes.data + slot.n_lane * mtu,
            slot.lens.ctypes.data + slot.n_lane * 4,
            slot.sigs.ctypes.data + slot.n_lane * 64,
            slot.pubs.ctypes.data + slot.n_lane * 32,
            slot.pay.ctypes.data + slot.pay_fill,
            slot.pay.nbytes - slot.pay_fill,
            slot.offs.ctypes.data + k0 * 4,
            slot.plens.ctypes.data + k0 * 4,
            slot.psigs.ctypes.data + k0 * 8,
            slot.tlanes.ctypes.data + k0 * 4,
            slot.tsorigs.ctypes.data + k0 * 4,
            slot.tspubs.ctypes.data + k0 * 4,
            slot.hashes.ctypes.data + k0 * 8,
            self._nd_counters.ctypes.data)
        self._nd_account(il)
        if n <= 0:
            # Frags consumed and filtered: the dispatcher acks them when
            # nothing is staged or in flight (_ack_if_idle).
            il.seq = seq.value
            return 0
        now = tempo.tickcount()
        if k0 == 0:
            slot.t_first = now  # the deadline's anchor
        self.drain_lat.add_many(slot.tsorigs[k0:k0 + n], now)
        # The ring dwell of the round's oldest frag, the verify_drain span
        # and the in-edge's xray dwell: exact below 2^32 ns, a wrap
        # artifact past 4 s (xray.dwell32).
        dwell = xray.dwell32(now, int(slot.tspubs[k0]))
        if dwell >= 0:
            if self._dwell_span is not None:
                self._dwell_span.observe(dwell)
            if il.xq is not None:
                il.xq.observe_dwell(dwell)
        # The round's offsets are relative to its base: make them
        # absolute, so the completion publishes every round at once.
        slot.offs[k0:k0 + n] += slot.pay_fill
        ha_cnt = ha_sz = 0
        insert = self.ha_tcache.insert
        for i, h in enumerate(slot.hashes[k0:k0 + n].tolist()):
            if insert(h):
                slot.ha_mask[k0 + i] = True
                ha_cnt += 1
                ha_sz += int(slot.plens[k0 + i])
        if ha_cnt:
            self.cnc.diag_add(CNC_DIAG_HA_FILT_CNT, ha_cnt)
            self.cnc.diag_add(CNC_DIAG_HA_FILT_SZ, ha_sz)
        if c is not None:
            c.post_stage_hook(slot, k0, n, lane0=slot.n_lane)
        last = k0 + n - 1
        slot.pay_fill = int(slot.offs[last]) + int(slot.plens[last])
        slot.n_lane += int(slot.tlanes[k0:k0 + n].sum())
        slot.n_txn += n
        slot.drain_end = seq.value
        # The consumed cursor moves after the txns are in the slot: the
        # quiescence check and the ack read both from other threads.
        il.seq = seq.value
        return n

    def _stager_loop(self) -> None:
        """Drain the in-ring into slots and commit each when it is full,
        when the ring's next txn cannot fit, when the held-back ack is
        about to starve the producer, or when the flush policy says so.
        An empty round sleeps at once (20 us, then 100 us while the slot
        holds txns whose deadline runs, backing off to 1 ms as idle
        tiles do while it holds none): the work is a batch at a time,
        and a spinning stager would take the GIL from the other
        threads."""
        pool, il = self.feed_pool, self.in_link
        idle_spins = 0
        t0 = time.thread_time_ns()
        try:
            while not self._feed_stop.is_set():
                slot = self._feed_slot
                if slot is None:
                    slot = pool.acquire(0.05)  # stalls counted by the pool
                    if slot is None:
                        continue
                    self._feed_slot = slot
                seq_before = il.seq
                n = self._stager_drain(slot)
                # The rung this slot fills toward (the batch with the
                # scheduler off).
                rung = self._sched_rung(slot)
                if slot.n_lane >= rung:
                    self._feed_commit(slot, FLUSH_FULL)
                    idle_spins = 0
                    continue
                if n > 0:
                    idle_spins = 0
                    continue
                if (slot.n_txn and il.seq == seq_before
                        and self.batch - slot.n_lane < MAX_SIG_CNT
                        and il.mcache.seq_next() > il.seq):
                    # The ring's next txn does not fit the lanes left.
                    self._feed_commit(slot, FLUSH_CAPACITY)
                    idle_spins = 0
                    continue
                if slot.n_txn:
                    if self._ring_starved():
                        self._feed_commit(slot, FLUSH_RING)
                        continue
                    verdict = self.flush_policy.due(
                        tempo.tickcount(), slot.n_lane, rung,
                        slot.t_first, starved=True,
                        device_idle=(not self._inflight
                                     and pool.ready_cnt() == 0),
                        backpressured=bool(
                            self.out_link.fctl.in_backpressure))
                    if verdict is not None:
                        self._feed_commit(slot, verdict)
                        continue
                idle_spins += 1
                pause = 20e-6 if idle_spins <= 8 else 100e-6
                if not slot.n_txn:
                    pause = max(pause, idle_pause(idle_spins + 56))
                time.sleep(pause)
        finally:
            self.stager_cpu_ns += time.thread_time_ns() - t0

    def _sched_rung(self, slot) -> int:
        """The rung scheduler's target for the slot being staged (the
        stager's; the JAX :1947-1976): staged lanes, the in-ring backlog
        from the ring's sequence numbers, the deadline slack; saturation
        when the backlog is half the ring. Counts a switch when the
        target changes. The batch with the scheduler off."""
        sched = self.rung_sched
        if sched is None:
            return self.batch
        il = self.in_link
        backlog = max(0, il.mcache.seq_next() - il.seq)
        rung = sched.pick(tempo.tickcount(), slot.n_lane, slot.t_first,
                          backlog, backlog_full=backlog * 2 >= il.mcache.depth)
        if rung != self._rung_last:
            self.fl.inc("rung_switches")
            self.fl.set_gauge("rung_cur", rung)
            self.flightrec.record("rung", b=rung, prev=self._rung_last,
                                  lanes=slot.n_lane, backlog=backlog)
            self._rung_last = rung
        return rung

    def _feed_commit(self, slot, verdict: str) -> None:
        slot.flush_verdict = verdict
        self._feed_slot = None
        self.feed_pool.commit(slot)

    def _feed_dispatch(self, slot) -> None:
        """Ship one READY slot to the engine: with the rung scheduler, on
        the smallest rung covering its lanes whose engine is WARM, else
        on the primary engine (the JAX :1989-2014), the arena's first
        rung rows copied up. The slot stays with its batch until the
        batch retires: the engine's copy reads the pinned arena after
        this returns, and the completion publishes from the slot's
        sidecar. With the breaker closed (or granting its half-open
        probe) the slot goes to the card, after the chaos dispatch hook;
        a dispatch that raises feeds the breaker, and that slot, like
        every slot while the breaker is open, is verified on the CPU lane
        (the JAX :2015-2058), counted in cpu_failover. The fd_drain filters
        the batch on the card either way (the JAX :2059-2066)."""
        rung, entry, fn = self.batch, self._engine_entry, None
        if self.rung_sched is not None:
            rung = self.rung_sched.dispatch_rung(slot.n_lane)
            if rung != self.batch:
                e = fd_engine.registry().warm_entry(
                    self._engine_spec.with_batch(rung), self.device)
                if e is None:
                    rung = self.batch
                else:
                    entry, fn = e, e.fn
            self.stat_rung_hist[rung] = self.stat_rung_hist.get(rung, 0) + 1
        if slot.n_lane < rung:
            # Lanes past the staged ones verify as pad lanes (zero len,
            # sig and pub), not as a previous batch's leftovers; only the
            # rows the rung's engine reads.
            slot.lens[slot.n_lane:rung] = 0
            slot.sigs[slot.n_lane:rung] = 0
            slot.pubs[slot.n_lane:rung] = 0
        out = None
        err = None
        c = chaos.active()
        now = tempo.tickcount()
        if self._breaker is None or self._breaker.allow_device(now):
            try:
                if c is not None:
                    c.verify_dispatch_hook()
                out = self._launch((slot.t_msgs[:rung], slot.t_lens[:rung],
                                    slot.t_sigs[:rung], slot.t_pubs[:rung]),
                                   fn)
            except Exception as e:  # noqa: BLE001 - the CPU lane serves
                err = e
                self._breaker_error(now, e)
                if isinstance(e, chaos.ChaosFault):  # the hook of c
                    c.note(e.cls, "detected")
        if out is None:
            entry = None
            out = _DeviceBatch(torch.from_numpy(self._verify_slot_cpu(slot)))
            self.fl.inc("cpu_failover")
            self.flightrec.record("cpu_failover", lanes=slot.n_lane)
            logging.getLogger(LOGGER).warning(
                "verify dispatch of %d lanes served by the CPU lane (%s)",
                slot.n_lane, repr(err) if err is not None
                else f"breaker {self._breaker.state}")
            if isinstance(err, chaos.ChaosFault):
                c.note(err.cls, "healed")
        drain = None
        if self._drain is not None and slot.n_txn:
            drain = self._drain_dispatch(slot)
        self._inflight.append(_InflightBatch(
            out=out, todo=[], t_dispatch=tempo.tickcount(), slot=slot,
            drain=drain, entry=entry))
        ev = {"device": entry is not None}
        if self.rung_sched is not None:
            ev["b"] = rung
        self._book_batch(slot.n_lane, slot.flush_verdict, **ev)
        self._xr_batch(slot.tsorigs, slot.n_txn, slot.flush_verdict,
                       entry is not None, slot_idx=slot.idx,
                       rung=rung if self.rung_sched is not None else None)

    def _feed_poll(self):
        """The dispatcher's round (poll_inputs in feed mode): supervise
        the stager, retire a batch, ship READY slots up to the in-flight
        cap and account the device's idle wall (nothing in flight and
        nothing READY)."""
        if not self._feed_started:
            self._feed_start()
        self._stager_supervise()
        self._complete(block=False)
        self._ack_if_idle()
        if self._reconfig_pending is not None and not self._inflight:
            # The live reconfig's barrier: with a request pending no new
            # batch ships until the in-flight ones retired (the stager
            # keeps staging); the swap happens in that gap.
            self._apply_reconfig()
        progressed = False
        while (self._reconfig_pending is None
               and len(self._inflight) < self.inflight_max):
            slot = self.feed_pool.pop_ready()
            if slot is None:
                break
            self._feed_dispatch(slot)
            progressed = True
        now = tempo.tickcount()
        if (self.batch_log and not self._inflight
                and self.feed_pool.ready_cnt() == 0):
            if self._feed_idle_mark:
                self.fl.inc("feed_idle_ns", now - self._feed_idle_mark)
            self._feed_idle_mark = now
        else:
            self._feed_idle_mark = 0
        return progressed, False

    def idle_sleep(self, idle_spins: int) -> float:
        """The dispatcher naps 50 us with a batch in flight (its
        completion is near) and at least 100 us otherwise (a slot is a
        drain round or more away), backing off as other tiles do."""
        if not self._feed:
            return super().idle_sleep(idle_spins)
        if self._inflight:
            return 50e-6
        return max(100e-6, idle_pause(idle_spins))

    def _publish_feed_batch(self, slot, statuses, drain=None,
                            quarantined: bool = False) -> int:
        """The feeder's completion: fold the lanes' statuses into each
        txn's verdict, count the failures in the SV slots and publish the
        passing, non-HA-duplicate txns with one fd_frag_publish_bulk_ctl
        call a credit window (spinning through backpressure, dropping the
        rest on HALT, as publish_backp), each ctl word SOM|EOM and, with
        the batch's drain outputs, the txn's verdict, color and block;
        the novel and maybe publishes are counted over the cursor range
        each call examined, and they drive the window's rotation (the JAX
        tiles.py:2236-2331). Failing txns consume the chaos audit's
        corruption records; a quarantined batch (statuses from the CPU
        lane) first sends each of them downstream as a CTL_ERR frag.
        Returns the batch's ack target."""
        n = slot.n_txn
        if n == 0:
            return slot.drain_end
        lanes = slot.tlanes[:n].astype(np.int64)
        starts = np.zeros(n, np.int64)
        np.cumsum(lanes[:-1], out=starts[1:])
        bad = (np.asarray(statuses)[:slot.n_lane] != 0).astype(np.int32)
        anybad = np.add.reduceat(bad, starts) > 0
        ha = slot.ha_mask[:n]
        ok = ~anybad & ~ha
        sv = anybad & ~ha
        sv_cnt = int(sv.sum())
        if sv_cnt:
            self.cnc.diag_add(CNC_DIAG_SV_FILT_CNT, sv_cnt)
            self.cnc.diag_add(CNC_DIAG_SV_FILT_SZ,
                              int(slot.plens[:n][sv].sum()))
            c = chaos.active()
            if c is not None:
                c.on_sv_drop(slot.psigs[:n][sv])
            if quarantined:
                for t in np.nonzero(sv)[0]:
                    off, ln = int(slot.offs[t]), int(slot.plens[t])
                    self._publish_err(slot.pay[off:off + ln].tobytes(),
                                      int(slot.psigs[t]))
        n_ok = int(ok.sum())
        if not n_ok:
            return slot.drain_end
        novel = None
        ctls = np.full(n, CTL_SOM_EOM, np.uint16)
        if drain is not None:
            novel = drain.novel.cpu().numpy()[:n]
            colors = (None if drain.colors is None
                      else drain.colors.cpu().numpy()[:n])
            ctls = encode_ctl(CTL_SOM_EOM, novel, colors, drain.block)
        mask8 = ok.astype(np.uint8)
        ol = self.out_link
        seqv = ctypes.c_uint64(ol.seq)
        chunkv = ctypes.c_uint32(ol.chunk)
        cursor = ctypes.c_uint32(0)
        bytes_out = np.zeros(1, np.uint64)
        now = tempo.tickcount()
        published = novel_pub = maybe_pub = 0
        while published < n_ok:
            t_stall = 0
            while not ol.can_publish():
                if self.cnc.signal_query() == CNC_HALT:
                    break
                if not t_stall:
                    t_stall = tempo.tickcount()
                self.cnc.diag_add(CNC_DIAG_BACKP_CNT, 1)
                time.sleep(20e-6)
            ol.stall_since(t_stall)
            if ol.cr_avail <= 0:
                break
            cur0 = cursor.value
            pub = self._nd_lib.fd_frag_publish_bulk_ctl(
                ol.mcache._mem, ctypes.addressof(ol.dcache._buf),
                ol.dcache.chunk_cnt, ol.mtu, ctypes.byref(seqv),
                ctypes.byref(chunkv), slot.pay.ctypes.data,
                slot.offs.ctypes.data, slot.plens.ctypes.data,
                slot.psigs.ctypes.data, slot.tsorigs.ctypes.data,
                ctls.ctypes.data, mask8.ctypes.data, ctypes.byref(cursor),
                n, min(ol.cr_avail, n_ok - published), now & 0xFFFFFFFF,
                bytes_out.ctypes.data)
            ol.seq = seqv.value
            ol.chunk = chunkv.value
            ol.cr_avail = max(0, ol.cr_avail - pub)
            published += pub
            if novel is not None:
                # Only the selected lanes of [cur0, cursor) went out: the
                # rotation quota counts publishes.
                w = slice(cur0, cursor.value)
                novel_pub += int((novel[w] & ok[w]).sum())
                maybe_pub += int((~novel[w] & ok[w]).sum())
            if pub <= 0:
                break
        if novel is not None:
            self.fl.inc("drain_novel", novel_pub)
            self.fl.inc("drain_maybe", maybe_pub)
            self._drain.note_published(novel_pub)
            # No rotation while an injector is armed: replayed and dropped
            # frags break the proof's "published => inserted" step.
            if self._drain.maybe_rotate(blocked=chaos.active() is not None):
                self.fl.inc("drain_rot")
        il = self.in_link
        il.fseq.diag_add(DIAG_PUB_CNT, published)
        il.fseq.diag_add(DIAG_PUB_SZ, int(bytes_out[0]))
        # The span and the exemplars of every frag published, at once.
        ol.lat_sample_many(slot.tsorigs[:n][ok][:published], now)
        return slot.drain_end

    # -- live reconfig ----------------------------------------------------

    def request_reconfig(self, req: dict) -> tuple:
        """Validate and park one live reconfig (any thread; the JAX
        :2347-2414). The dispatcher applies it at the next inflight
        barrier (_feed_poll, _apply_reconfig). Returns (accepted, detail).

        req's keys (RECONFIG_KEYS), each optional: "verify_mode"
        (auto|direct|rlc), "ladder" (rung batch sizes; the staging batch
        is always on top, since the arenas are sized to it), "frontend"
        (the rlc front half) and "drain" (auto|off). A request that could
        not give a dispatchable configuration is refused whole, the
        running one untouched: a mode the backend cannot run (rlc on
        "oracle"), a tile without the feed, a ladder with the scheduler
        off or with fewer than two usable rungs, a "decompress" flip
        (the port's decompress is always its kernel), an unknown key,
        and a request while another is pending (one barrier, one
        swap)."""

        def refuse(reason: str) -> tuple:
            self.fl.inc("reconfig_refused")
            self.flightrec.record("reconfig_refused", reason=reason)
            return False, reason

        try:
            mode = fd_engine.resolve_verify_mode(
                self.backend, req.get("verify_mode") or self.verify_mode)
        except ValueError as e:
            return refuse(str(e))
        if not self._feed:
            return refuse("reconfig requires the fd_feed staging path")
        if "decompress" in req:
            return refuse("no decompress flip: the port's decompress is "
                          "always its kernel (decompress_so.cu, "
                          "decompress_niels.cu)")
        unknown = sorted(set(req) - set(RECONFIG_KEYS))
        if unknown:
            return refuse(f"unknown reconfig keys {unknown} (want "
                          f"{'|'.join(RECONFIG_KEYS)})")
        frontend = req.get("frontend") or self.frontend
        if frontend not in FRONTENDS:
            return refuse(f"unknown frontend {frontend!r} (want "
                          f"{'|'.join(FRONTENDS)})")
        drain = req.get("drain")
        if drain is not None and drain not in fd_engine.DRAIN_MODES:
            return refuse(f"unknown drain mode {drain!r} (want auto|off)")
        ladder = req.get("ladder")
        rungs = None
        if ladder is not None:
            if not self.sched:
                return refuse("ladder swap with sched=False")
            try:
                rungs = tile_rungs(ladder, self.batch)
            except (TypeError, ValueError) as e:
                return refuse(f"unparseable ladder {ladder!r}: {e}")
            if not rungs:
                return refuse(
                    f"ladder {ladder!r} leaves < 2 usable rungs under "
                    f"staging batch {self.batch}")
        with self._reconfig_lock:
            if self._reconfig_pending is not None:
                return refuse("a reconfig is already pending (one barrier, "
                              "one swap)")
            self._reconfig_seq += 1
            pend = {"seq": self._reconfig_seq, "verify_mode": mode,
                    "frontend": frontend, "drain": drain, "ladder": rungs}
            self._reconfig_pending = pend
        self.flightrec.record("reconfig_request", seq=pend["seq"], mode=mode,
                              ladder=list(rungs) if rungs else None)
        return True, f"pending (seq {pend['seq']})"

    def _apply_reconfig(self) -> None:
        """Swap the engines in the dispatch gap (the dispatcher, only with
        nothing in flight; the JAX :2416-2510): the primary engine of the
        new spec (taken WARM from the registry, else acquired and warmed
        here, the barrier holding dispatch), the rung ladder on it (the
        request's, else the one in force), the drain re-armed or
        disarmed by a drain flip. READY and staging slots are untouched
        and ship on the new engines. Rung engines the new configuration
        no longer reaches are retired from the registry."""
        with self._reconfig_lock:
            req = self._reconfig_pending
        if req is None:
            return
        reg = fd_engine.registry()
        old = {self._engine_spec}
        if self.rung_sched is not None:
            old |= {self._engine_spec.with_batch(r)
                    for r in self.rung_sched.rungs}
        spec = fd_engine.EngineSpec.for_tile(
            self.backend, req["verify_mode"], self.batch, req["frontend"])
        e = reg.warm_entry(spec, self.device)
        cold = e is None
        if cold:
            e, warmed_now = reg.acquire(spec, warm=True, device=self.device,
                                        max_msg_len=self.max_msg_len)
            if warmed_now:
                self._account_compile(e)
        self._engine_entry, self._verify_batch_fn = e, e.fn
        self._engine_spec = spec
        self.verify_mode, self.frontend = req["verify_mode"], req["frontend"]
        rungs = req["ladder"]
        if rungs is None and self.rung_sched is not None:
            rungs = list(self.rung_sched.rungs)
        new = {spec}
        if rungs:
            new |= self._rung_setup(rungs)
        reg.retire(old - new, self.device)
        if req["drain"] is not None:
            self.drain_mode = req["drain"]
            self._drain_setup()
        with self._reconfig_lock:
            self._reconfig_pending = None
        self.fl.inc("reconfigs")
        self.flightrec.record("reconfig", seq=req["seq"], engine=spec.key,
                              rungs=list(rungs) if rungs else None,
                              cold_primary=cold, drain=req["drain"])

    # -- per-frag path ---------------------------------------------------

    def _ack_inline(self, frag: Frag) -> None:
        """A frag handled to completion in on_frag is ackable at once,
        when nothing older is still staged or in flight."""
        if not self._pending and not self._inflight:
            self._acked_seq = frag.seq + 1

    def _filter(self, frag: Frag, payload: bytes, cnt_slot: int,
                sz_slot: int) -> None:
        self.cnc.diag_add(cnt_slot, 1)
        self.cnc.diag_add(sz_slot, len(payload))
        self._ack_inline(frag)
        # A stream of filtered frags never goes idle: check the staged
        # batch's deadline here too.
        self._flush_if_due()

    def on_frag(self, frag: Frag, payload: bytes) -> None:
        if frag.ctl & CTL_ERR:
            self.fl.inc("ctl_err_drop")
            self.flightrec.record("ctl_err_drop", n=1)
            self._xr_trigger("ctl_err", tsorigs=[frag.tsorig], n=1)
            self._filter(frag, payload, CNC_DIAG_SV_FILT_CNT,
                         CNC_DIAG_SV_FILT_SZ)
            return
        try:
            txn = parse_txn(payload)
        except TxnParseError:
            self._filter(frag, payload, CNC_DIAG_SV_FILT_CNT,
                         CNC_DIAG_SV_FILT_SZ)
            return
        # The HA tag covers the whole payload: before sigverify, a
        # corrupted copy of a pending txn must not shadow the original.
        if self.ha_tcache.insert(hash(payload)):
            self._filter(frag, payload, CNC_DIAG_HA_FILT_CNT,
                         CNC_DIAG_HA_FILT_SZ)
            return
        items = txn.verify_items(payload)
        if self.backend == "oracle":
            ok = all(oracle.verify(msg, sig, pub) == 0
                     for (sig, pub, msg) in items)
            self._finish(payload, ok, tsorig=frag.tsorig)
            self._ack_inline(frag)
            return
        if not self._pending:
            self._pending_since = tempo.tickcount()
        self._pending.append((payload, items, frag.tsorig, frag.seq + 1))
        self._pending_lanes += len(items)
        self._flush_if_due()
        self._complete(block=False)

    def _dispatch_py(self, verdict: str) -> None:
        """Ship pending txns as fixed-shape batches of whole txns (a
        txn's signatures never straddle two batches). Unless forced, a
        trailing partial batch stays pending."""
        force = verdict != FLUSH_FULL
        while self._pending and (force or self._pending_lanes >= self.batch):
            take, flat = 0, []
            for _, items, _, _ in self._pending:
                if len(flat) + len(items) > self.batch:
                    break
                flat.extend(items)
                take += 1
            todo = [(payload, len(items), tsorig, seq_end)
                    for payload, items, tsorig, seq_end in self._pending[:take]]
            while len(self._inflight) >= self.inflight_max:
                self.fl.inc("inflight_stall")
                self._complete(block=True)
            pad = [(bytes(64), bytes(32), b"")] * (self.batch - len(flat))
            out = self._launch(self._engine_args(
                *_txn_batch_arrays(flat + pad, self.max_msg_len)))
            self._inflight.append(_InflightBatch(
                out=out, todo=todo, t_dispatch=tempo.tickcount(),
                entry=self._engine_entry))
            # A batch cut because the next txn does not fit is full.
            cut = FLUSH_FULL if self._pending_lanes >= self.batch else verdict
            self._book_batch(len(flat), cut, device=True)
            if self._xr_on:
                self._xr_batch([t[2] for t in todo], len(todo), cut, True)
            del self._pending[:take]
            self._pending_lanes -= len(flat)
            if self._pending:
                self._pending_since = tempo.tickcount()

    # -- shared: flush, completion, housekeeping --------------------------

    def _dispatch(self, verdict: str) -> None:
        if self._nd:
            self._dispatch_native(verdict)
        else:
            self._dispatch_py(verdict)

    def _ring_starved(self) -> bool:
        """The held-back ack is about to exhaust the producer's credits:
        a partial batch beats a stalled pipeline."""
        il = self.in_link
        return il is not None and (
            il.seq - self._acked_seq >= max(1, il.mcache.depth - 64))

    def _flush_if_due(self, starved: bool = False) -> None:
        """Dispatch the staged batch when it is full, when the ring is
        about to starve, or when the adaptive policy says so (deadline,
        or starved input with an idle device)."""
        if not self._pending:
            return
        if self._pending_lanes >= self.batch:
            self._dispatch(FLUSH_FULL)
            return
        if self._ring_starved():
            self._dispatch(FLUSH_RING)
            return
        verdict = self.flush_policy.due(
            tempo.tickcount(), self._pending_lanes, self.batch,
            self._pending_since, starved=starved,
            device_idle=not self._inflight,
            backpressured=bool(self.out_link.fctl.in_backpressure)
            if self.out_link else False)
        if verdict in (FLUSH_DEADLINE, FLUSH_STARVED):
            self._dispatch(verdict)

    def on_idle(self) -> None:
        if self._feed:
            return  # the dispatcher's poll retired and shipped already
        if self._inflight:
            self._complete(block=False)
        self._flush_if_due(starved=True)

    def housekeep(self, now: int) -> None:
        # Publish the VERIFIED cursor, not the consumed one.
        self.cnc.heartbeat(now)
        for il in self.in_links:
            il.fseq.update(min(self._acked_seq, il.seq))
        self._publish_unacked()
        self._publish_flight()
        self._housekeep_out()
        self.on_housekeep()

    def _publish_unacked(self) -> None:
        unacked = sum(max(0, il.seq - self._acked_seq)
                      for il in self.in_links)
        if unacked != self._last_unacked:
            self.cnc.diag_add(CNC_DIAG_UNACKED,
                              (unacked - self._last_unacked) & _U64)
            self._last_unacked = unacked

    def on_housekeep(self) -> None:
        # The latency backstop while the drain never goes idle.
        if self._inflight:
            self._complete(block=False)
        self._flush_if_due()

    def on_halt(self) -> None:
        """Dispatch what is staged and retire every batch in flight, so
        no device work outlives the tile; after an error, neither. In
        feed mode the stager stops first (it owns the in-ring cursor);
        then its FILLING slot and every READY slot are dispatched."""
        if self._feed:
            self._feed_stop.set()
            if self._feed_thread is not None:
                self._feed_thread.join(timeout=10.0)
        if self.error is not None:
            return
        if self._feed:
            slot = self._feed_slot
            if slot is not None:
                if slot.n_txn:
                    self._feed_commit(slot, FLUSH_HALT)
                else:
                    self._feed_slot = None
                    self.feed_pool.release(slot)
            while True:
                slot = self.feed_pool.pop_ready()
                if slot is None:
                    break
                self._feed_dispatch(slot)
            self._complete(block=True, drain_all=True)
            self._ack_if_idle()
            return
        if self._pending and self.backend == "gpu":
            self._dispatch(FLUSH_HALT)
        self._complete(block=True, drain_all=True)

    def _complete(self, block: bool, drain_all: bool = False) -> None:
        """Retire finished batches in dispatch order and publish their
        verified txns. The chaos completion hook runs first. A batch
        whose hook, readiness poll or read-back raises (an RLC pass's
        error surfaces there, not at its launch) is quarantined (the JAX
        :2967-3040): counted, a device batch's error fed to the breaker,
        its statuses re-verified on the CPU lane (_quarantine_statuses),
        its offenders published as CTL_ERR frags and, in the feed, its
        clean txns published without the drain's claims (they ran on the
        poisoned stream). A clean device batch closes a half-open breaker
        and feeds its engine's service EMA. rlc_fallback counts every
        batch whose per-lane fallback was launched, a quarantined one
        too (the JAX package counts clean ones only), so that the
        direct kernels' launches are rlc_fallback."""
        while self._inflight:
            ib = self._inflight[0]
            err = None
            try:
                if not block and not ib.is_ready():
                    return
            except Exception as e:  # noqa: BLE001 - quarantined below
                err = e
            t0 = time.perf_counter_ns()
            c = chaos.active()
            try:
                if c is not None:
                    c.verify_complete_hook()
                if err is None:
                    statuses = np.asarray(ib.out)
            except Exception as e:  # noqa: BLE001 - quarantined below
                err = e
            quarantined = err is not None
            if quarantined:
                self.fl.inc("quarantined")
                self.flightrec.record("quarantine", err=repr(err)[:120])
                if self._xr_on:
                    ids = (ib.slot.tsorigs[:ib.slot.n_txn]
                           if ib.slot is not None
                           else [t[2] for t in ib.todo])
                    self._xr_trigger("quarantine", ids, err=repr(err)[:80])
                logging.getLogger(LOGGER).warning(
                    "verify batch quarantined, re-verified on the CPU lane "
                    "(%r)", err)
                if ib.entry is not None:
                    self._breaker_error(tempo.tickcount(), err)
                fault = isinstance(err, chaos.ChaosFault)  # the hook of c
                if fault:
                    c.note(err.cls, "detected")
                self._settle()
                statuses = self._quarantine_statuses(ib)
                if fault:
                    c.note(err.cls, "healed")
            elif ib.entry is not None:
                if self._breaker is not None:
                    self._breaker.record_success()
                # The engine's service EMA (dispatch -> clean completion),
                # the rung scheduler's cost model.
                ib.entry.note_service(tempo.tickcount() - ib.t_dispatch)
            if getattr(ib.out, "used_fallback", False):
                self.fl.inc("rlc_fallback")
            if ib.slot is not None:
                batch_ack = self._publish_feed_batch(
                    ib.slot, statuses, None if quarantined else ib.drain,
                    quarantined)
            else:
                off = 0
                batch_ack = 0
                for payload, cnt, tsorig, seq_end in ib.todo:
                    batch_ack = max(batch_ack, seq_end)
                    if payload is not None:  # None: HA-filtered when staged
                        ok = cnt > 0 and bool(
                            (statuses[off:off + cnt] == 0).all())
                        self._finish(payload, ok, tsorig=tsorig)
                        if quarantined and not ok:
                            self._publish_err(payload, meta_sig(payload))
                    off += cnt
            # Pop after publishing: a quiescence check reading
            # _inflight from another thread must not see a gap. A slot
            # is released after the pop: it keeps its txns visible to
            # the check (SlotPool.idle) until then.
            self._inflight.pop(0)
            if ib.slot is not None:
                self.feed_pool.release(ib.slot)
            self.stat_complete_ns += time.perf_counter_ns() - t0
            self._acked_seq = max(self._acked_seq, batch_ack)
            self._ack_if_idle()
            if not drain_all:
                return  # retire at most one a call; keep the loop hot

    def _settle(self) -> None:
        """Before a quarantined batch's slot goes back to the pool: wait
        for the tile's stream, whose copies may still read the slot's
        pinned arenas. An error of the stream is the batch's, already
        booked."""
        if self.device is not None and self.device.type == "cuda":
            try:
                torch.cuda.current_stream(self.device).synchronize()
            except Exception:  # noqa: BLE001 - booked as the quarantine
                pass

    def _breaker_error(self, now: int, err: BaseException) -> None:
        """Feed a device error to the breaker; a trip, or a failed probe
        opening it again, is logged."""
        b = self._breaker
        if b is not None and b.record_error(now):
            logging.getLogger(LOGGER).warning(
                "verify breaker open after %r (trips %d, reprobes %d): the "
                "CPU lane serves", err, b.trips, b.reprobes)

    # -- the CPU lane ---------------------------------------------------

    def _verify_slot_cpu(self, slot) -> np.ndarray:
        """The CPU lane over a staged slot: the failover target and the
        quarantine's re-verify (the JAX :2101). The native verifier in
        one call (ballet.ed25519.native); if that raises, the oracle lane
        by lane. Never the plain PyTorch versions of the kernels."""
        t0 = time.perf_counter_ns()
        try:
            out = ed_native.verify_arrays(slot.msgs, slot.lens, slot.sigs,
                                          slot.pubs, slot.n_lane)
        except Exception as e:  # noqa: BLE001 - the oracle serves
            logging.getLogger(LOGGER).warning(
                "native ed25519 verifier failed (%r): the oracle verifies "
                "the slot lane by lane", e)
            out = np.ones(self.batch, np.int32)
            for lane in range(slot.n_lane):
                ln = int(slot.lens[lane])
                out[lane] = oracle.verify(slot.msgs[lane, :ln].tobytes(),
                                          slot.sigs[lane].tobytes(),
                                          slot.pubs[lane].tobytes())
        self.stat_cpu_lanes += slot.n_lane
        self.stat_cpu_ns += time.perf_counter_ns() - t0
        return out

    def _oracle_verify_payload(self, payload: bytes) -> bool:
        """A whole txn's verdict on the CPU lane (the JAX :2130): the
        native verifier over its signatures, the oracle if that raises."""
        try:
            items = list(parse_txn(payload).verify_items(payload))
        except TxnParseError:
            return False
        self.stat_cpu_lanes += len(items)
        try:
            return all(st == 0 for st in ed_native.verify_items(items))
        except Exception:  # noqa: BLE001 - the oracle serves
            return all(oracle.verify(msg, sig, pub) == 0
                       for (sig, pub, msg) in items)

    def _oracle_statuses_todo(self, todo) -> np.ndarray:
        """Lane statuses of a step-loop batch from whole-txn verdicts
        (the JAX :2162)."""
        t0 = time.perf_counter_ns()
        statuses = np.ones(self.batch, np.int32)
        off = 0
        for payload, cnt, _tsorig, _seq_end in todo:
            ok = payload is None or self._oracle_verify_payload(payload)
            statuses[off:off + cnt] = 0 if ok else 1
            off += cnt
        self.stat_cpu_ns += time.perf_counter_ns() - t0
        return statuses

    def _quarantine_statuses(self, ib) -> np.ndarray:
        """A poisoned batch's statuses in its own layout, from the CPU
        lane (the JAX :2151)."""
        if ib.slot is not None:
            return self._verify_slot_cpu(ib.slot)
        return self._oracle_statuses_todo(ib.todo)

    def _publish_err(self, payload: bytes, sig: int) -> None:
        """The quarantine's audit trail (the JAX :2174): an offender goes
        downstream as a CTL_ERR frag, which the dedup tile counts and
        drops before its tcache, under publish_backp's backpressure and
        HALT rules."""
        t_stall = 0
        while not self.out_link.can_publish():
            if self.cnc.signal_query() == CNC_HALT:
                return
            if not t_stall:
                t_stall = tempo.tickcount()
            self.cnc.diag_add(CNC_DIAG_BACKP_CNT, 1)
            time.sleep(20e-6)
        self.out_link.stall_since(t_stall)
        self.out_link.publish(payload, sig, ctl=CTL_SOM_EOM | CTL_ERR)
        self.fl.inc("quarantine_err_txn")

    def _ack_if_idle(self) -> None:
        """With nothing staged or in flight, everything consumed is
        handled: ack up to the consumed cursor. Only the tile's own
        thread (the dispatcher in feed mode) writes the ack."""
        if self.in_link:
            # The cursor is read before the checks: the stager makes
            # staged txns visible before it moves the cursor.
            seq = self.in_link.seq
            if (not self._pending and not self._inflight
                    and (not self._feed or self.feed_pool.idle())):
                self._acked_seq = max(self._acked_seq, seq)

    def _finish(self, payload: bytes, ok: bool, tsorig: int = 0) -> None:
        if not ok:
            self.cnc.diag_add(CNC_DIAG_SV_FILT_CNT, 1)
            self.cnc.diag_add(CNC_DIAG_SV_FILT_SZ, len(payload))
            return
        self.publish_backp(payload, meta_sig(payload), tsorig=tsorig)



class DedupTile(Tile):
    """tcache dedup on the frag meta sig (disco/dedup/fd_dedup.c), the
    counterpart of the JAX ``DedupTile``:3075. It muxes several in-links
    (in_links), as the reference's dedup does (fd_dedup.h:57-80).

    With bulk (the main path) a drained round is filtered at once
    (``_dedup_round``, the JAX :3165-3221): CTL_ERR frags are dropped
    before the tcache, the membership test is ``TCache.insert_batch``
    with the fd_drain's CTL_NOVEL claims as its ``novel`` lanes, the
    filter counters are the round's sums and the surviving frags go out
    through one ``fd_frag_publish_bulk_ctl`` call a credit window, their
    ctl words forwarded without CTL_NOVEL (the pack's color and block
    pass on). Without bulk each frag goes through ``on_frag``, the oracle
    the bulk path is held to. The drain's counters: probes skipped for a
    claim, probes made, and claims the map contradicted (the tripwire:
    0 while the filter's contract holds)."""

    name = "dedup"

    def __init__(self, wksp, cnc_name, in_link=None, out_link=None,
                 tcache_depth: int = 4096, in_links=None, bulk: bool = True,
                 **kw):
        super().__init__(wksp, cnc_name, in_link=in_link, out_link=out_link,
                         in_links=in_links, **kw)
        self.tcache = TCache(tcache_depth)
        self.bulk = bulk
        self.fl = flight.tile_lane(wksp, self.flight_label)

    stat_drain_probe_skip = _lane_stat("drain_probe_skip")
    stat_drain_probed = _lane_stat("drain_probed")
    stat_drain_false_novel = _lane_stat("drain_false_novel")

    def on_housekeep(self) -> None:
        self.fl.publish()

    def on_round(self, il: InLink, st: dict, n: int) -> None:
        if self.bulk and self.out_link is not None:
            self._dedup_round(il, st, n)
        else:
            super().on_round(il, st, n)

    def _dedup_round(self, il: InLink, st: dict, n: int) -> None:
        """One round: the masks, the counters and the bulk publish, with
        on_frag's semantics (CTL_ERR dropped before the tcache insert, a
        poisoned copy never shadowing the valid txn of the same sig; order
        and tsorig kept)."""
        lens = st["lens"][:n]
        ctls = st["ctls"][:n]
        clean = (ctls & CTL_ERR) == 0
        novel = ((ctls & CTL_NOVEL) != 0) & clean
        dup = np.zeros(n, np.bool_)
        if clean.any():
            fn0 = self.tcache.false_novel_cnt
            dup[clean] = self.tcache.insert_batch(
                st["sigs"][:n][clean],
                novel=novel[clean] if novel.any() else None)
            n_novel = int(novel.sum())
            self.fl.inc("drain_probe_skip", n_novel)
            self.fl.inc("drain_probed", int(clean.sum()) - n_novel)
            d_fn = self.tcache.false_novel_cnt - fn0
            if d_fn:
                self.fl.inc("drain_false_novel", d_fn)
                self.flightrec.record("drain_false_novel", n=d_fn)
        filt = ~clean | dup
        n_filt = int(filt.sum())
        if n_filt:
            il.fseq.diag_add(DIAG_FILT_CNT, n_filt)
            il.fseq.diag_add(DIAG_FILT_SZ, int(lens[filt].sum()))
        n_ok = n - n_filt
        if not n_ok:
            return
        mask8 = (~filt).astype(np.uint8)
        ctls_fwd = ctls & np.uint16(0xFFFF ^ CTL_NOVEL)
        ol = self.out_link
        seqv = ctypes.c_uint64(ol.seq)
        chunkv = ctypes.c_uint32(ol.chunk)
        cursor = ctypes.c_uint32(0)
        bytes_out = np.zeros(1, np.uint64)
        now = tempo.tickcount()
        now32 = now & 0xFFFFFFFF
        published = 0
        while published < n_ok:
            # publish_backp's flow control (spin through backpressure,
            # drop the rest on HALT), paid once a credit window.
            t_stall = 0
            while not ol.can_publish():
                if self.cnc.signal_query() == CNC_HALT:
                    break
                if not t_stall:
                    t_stall = tempo.tickcount()
                self.cnc.diag_add(CNC_DIAG_BACKP_CNT, 1)
                time.sleep(20e-6)
            ol.stall_since(t_stall)
            if ol.cr_avail <= 0:
                break
            pub = rings.lib().fd_frag_publish_bulk_ctl(
                ol.mcache._mem, ctypes.addressof(ol.dcache._buf),
                ol.dcache.chunk_cnt, ol.mtu, ctypes.byref(seqv),
                ctypes.byref(chunkv), st["pay"].ctypes.data,
                st["offs"].ctypes.data, st["lens"].ctypes.data,
                st["sigs"].ctypes.data, st["ts"].ctypes.data,
                ctls_fwd.ctypes.data, mask8.ctypes.data,
                ctypes.byref(cursor), n,
                min(ol.cr_avail, n_ok - published), now32,
                bytes_out.ctypes.data)
            ol.seq = seqv.value
            ol.chunk = chunkv.value
            ol.cr_avail = max(0, ol.cr_avail - pub)
            published += pub
            if pub <= 0:
                break
        il.fseq.diag_add(DIAG_PUB_CNT, published)
        il.fseq.diag_add(DIAG_PUB_SZ, int(bytes_out[0]))
        ol.lat_sample_many(st["ts"][:n][~filt][:published], now)

    def _filter(self, frag: Frag) -> None:
        self.in_cur.fseq.diag_add(DIAG_FILT_CNT, 1)
        self.in_cur.fseq.diag_add(DIAG_FILT_SZ, frag.sz)

    def on_frag(self, frag: Frag, payload: bytes) -> None:
        # A CTL_ERR frag is dropped before the tcache insert.
        if frag.ctl & CTL_ERR:
            self._filter(frag)
            return
        if frag.ctl & CTL_NOVEL:
            # The drain's claim (the JAX :3291-3315): the verdict is the
            # filter's, the insert keeps the ring's order, and the
            # tripwire drops a contradicted claim as a duplicate.
            self.fl.inc("drain_probe_skip")
            if self.tcache.insert_novel_batch([frag.sig])[0]:
                self.fl.inc("drain_false_novel")
                self.flightrec.record("drain_false_novel", n=1)
                self._filter(frag)
                return
            self.publish_backp(payload, frag.sig, tsorig=frag.tsorig)
            return
        self.fl.inc("drain_probed")
        if self.tcache.insert(frag.sig):
            self._filter(frag)
            return
        self.publish_backp(payload, frag.sig, tsorig=frag.tsorig)


def pack_txn(payload: bytes, txn_id: int,
             estimator: CuEstimator) -> Optional[PackTxn]:
    """The scheduling view of a transaction (the JAX PackTile.on_frag's
    parse and estimate, tiles.py:3382-3408): its write- and read-locked
    static accounts, rewards and estimated CUs. None when it does not
    parse or a ComputeBudgetProgram instruction is malformed."""
    try:
        txn = parse_txn(payload)
    except TxnParseError:
        return None
    rce = estimate_rewards_and_compute(
        txn, payload, lamports_per_signature=5000, estimator=estimator)
    if rce is None:
        return None
    rewards, est_cus, _cu_limit = rce
    accts = [(txn.account(payload, i), txn.is_writable(i))
             for i in range(txn.acct_cnt)]
    return PackTxn(txn_id=txn_id, rewards=rewards, est_cus=est_cus,
                   writable=frozenset(k for k, w in accts if w),
                   readonly=frozenset(k for k, w in accts if not w))


class PackTile(Tile):
    """Account-lock conflict scheduling into bank lanes (fd_frank_pack.c
    with ballet/pack's semantics), the counterpart of the JAX
    ``PackTile``:3323. A scheduled txn goes downstream with its bank in
    the sig's high 16 bits; completion is immediate (the sink stands in
    for the banks).

    scheduler "greedy": each txn enters the ``Pack`` heap and ``_drain``
    schedules what fits, rotating banks. scheduler "gc": txns gather into
    blocks of gc_block; ``_drain_gc`` colors a block with
    ``ops.pack_gc.schedule_block`` on ``device`` (the card unless the
    caller passes device="cpu"; the kernel, one launch a block), passes
    the waves through the gate (``_gate_device_waves``) and publishes
    them wave by wave, round-robin over the banks; leftovers wait for the
    next block. A frag with the fd_drain's color in its ctl word (the
    verify tile's drain_pack) joins the device block of its block id
    instead (``_dev_block``); a new block id, a full block or an idle
    poll closes it (``_close_dev_block``, the JAX :3500): its colors
    become waves, which pass the same gate. A txn whose estimate exceeds
    a bank's CU budget, that does not parse or whose compute-budget
    instructions are malformed is filtered."""

    name = "pack"

    def __init__(self, wksp, cnc_name, in_link, out_link, bank_cnt: int = 4,
                 scheduler: str = "greedy", gc_block: int = 1024,
                 device="cuda", **kw):
        super().__init__(wksp, cnc_name, in_link=in_link, out_link=out_link,
                         **kw)
        if scheduler not in ("greedy", "gc"):
            raise ValueError(f"unknown pack scheduler {scheduler!r}")
        self.pack = Pack(bank_cnt=bank_cnt)
        self.est = CuEstimator()
        self.bank_cnt = bank_cnt
        self.scheduler = scheduler
        self.gc_block = gc_block
        if scheduler == "gc":
            self.device = backend.resolve_device(device)
        self._gc_pending: list = []
        self._next_txn_id = 0
        self._payloads: dict = {}
        self._tsorig: dict = {}
        self._rr_bank = 0
        # The open device block: [(color, PackTxn)] of one block id.
        self._dev_block: list = []
        self._dev_block_id: Optional[int] = None
        self._seq0 = self.in_link.seq
        # Frags published or filtered; with in_link.seq, the quiescence
        # check's proof that no consumed frag is still held.
        self.stat_done = 0
        self.stat_cu_drop = 0
        # The gc gate's accounting: block_device + sched_fallback = blocks
        # (in the lane), of which dev_blocks came colored by the verify
        # tile's drain.
        self.fl = flight.tile_lane(wksp, self.flight_label)
        self.stat_dev_blocks = 0
        # Wall ns of schedule_block (arrays, kernel, read-back) and of
        # the gate (greedy waves, validation).
        self.stat_gc_ns = 0
        self.stat_gate_ns = 0

    stat_block_device = _lane_stat("pack_block_device")
    stat_wave_device = _lane_stat("pack_wave_device")
    stat_sched_fallback = _lane_stat("pack_sched_fallback")

    def on_housekeep(self) -> None:
        self.fl.publish()

    def drained(self) -> bool:
        """Every frag consumed so far was published or filtered."""
        return (self.stat_done >= self.in_link.seq - self._seq0
                and self.pack.pending_cnt() == 0 and not self._gc_pending
                and not self._dev_block)

    def _filter(self, sz: int = 0) -> None:
        self.in_cur.fseq.diag_add(DIAG_FILT_CNT, 1)
        if sz:
            self.in_cur.fseq.diag_add(DIAG_FILT_SZ, sz)
        self.stat_done += 1

    def on_frag(self, frag: Frag, payload: bytes) -> None:
        pt = pack_txn(payload, self._next_txn_id, self.est)
        if pt is None:
            # fd_pack.c:298-299 drops a malformed txn at insert.
            self._filter()
            return
        if pt.est_cus > self.pack.max_cu_per_bank:
            # It can never fit a bank's or a wave's budget: no scheduler
            # would ever pick it.
            self.stat_cu_drop += 1
            self._filter(len(payload))
            return
        self._next_txn_id += 1
        self._payloads[pt.txn_id] = payload
        self._tsorig[pt.txn_id] = frag.tsorig
        if self.scheduler == "gc":
            color = ctl_color(frag.ctl)
            if color >= 0:
                # A device color: frags arrive in publish order, so a
                # block's txns are contiguous and a new id closes it.
                blk = ctl_block(frag.ctl)
                if self._dev_block_id is not None \
                        and blk != self._dev_block_id:
                    self._close_dev_block()
                self._dev_block_id = blk
                self._dev_block.append((color, pt))
                if len(self._dev_block) >= self.gc_block:
                    self._close_dev_block()
                return
            self._gc_pending.append(pt)
            if len(self._gc_pending) >= self.gc_block:
                self._drain_gc()
            return
        self.pack.insert(pt)
        self._drain()

    def on_idle(self) -> None:
        if self.scheduler == "gc":
            if self._dev_block:
                self._close_dev_block()
            if self._gc_pending:
                self._drain_gc()
            return
        self._drain()

    def _drain_gc(self) -> None:
        """Color the pending block on the device and publish its waves.
        _gc_pending keeps the block until its waves are published: the
        quiescence check reads it from another thread."""
        txns = list(self._gc_pending)
        t0 = time.perf_counter_ns()
        waves, leftover = schedule_block(
            txns, pad_to=self.gc_block, max_w=MAX_ACCT_CNT,
            max_r=MAX_ACCT_CNT, device=self.device)
        t1 = time.perf_counter_ns()
        waves, leftover = self._gate_device_waves(txns, waves, leftover)
        self.stat_gc_ns += t1 - t0
        self.stat_gate_ns += time.perf_counter_ns() - t1
        self._publish_waves(waves)
        # A CU-capped leftover waits for the next block's fresh budgets.
        self._gc_pending = list(leftover)

    def _gate_device_waves(self, txns, dev_waves, dev_left):
        """The JAX package's schedule gate: the device's waves publish
        only if they are admissible (validate_schedule, on the exact lock
        sets) and match the greedy waves' rewards per CU; otherwise the
        greedy waves publish. block_device + sched_fallback = blocks."""
        cpu_waves, cpu_left = greedy_waves(txns, MAX_COLORS_DEFAULT,
                                           CU_CAP_DEFAULT)
        if validate_schedule(dev_waves) and device_beats_greedy(
                dev_waves, dev_left, cpu_waves, cpu_left):
            self.fl.inc("pack_block_device")
            self.fl.inc("pack_wave_device", len(dev_waves))
            return dev_waves, dev_left
        self.fl.inc("pack_sched_fallback")
        self.flightrec.record("pack_sched_fallback", txns=len(txns),
                              waves=len(dev_waves))
        return cpu_waves, cpu_left

    def _close_dev_block(self) -> None:
        """Publish the open device block: its colors as waves (in color
        order) through the gate, as a block of the pack's own; leftovers
        join the pending block. The gate validates the txns that arrived,
        never the hint (a subset of an admissible wave is admissible, but
        it is checked anyway). The block stays in _dev_block until its
        waves are published: the quiescence check reads it."""
        entries = list(self._dev_block)
        self.stat_dev_blocks += 1
        waves_map: dict = {}
        for color, pt in entries:
            waves_map.setdefault(color, []).append(pt)
        dev_waves = [waves_map[c] for c in sorted(waves_map)]
        t0 = time.perf_counter_ns()
        waves, leftover = self._gate_device_waves(
            [pt for _, pt in entries], dev_waves, [])
        self.stat_gate_ns += time.perf_counter_ns() - t0
        self._publish_waves(waves)
        self._gc_pending.extend(leftover)
        self._dev_block = []
        self._dev_block_id = None

    def _publish(self, txn: PackTxn, bank: int) -> None:
        payload = self._payloads.pop(txn.txn_id)
        sig = (bank << 48) | (txn.txn_id & 0xFFFFFFFFFFFF)
        self.publish_backp(payload, sig, count_diag=False,
                           tsorig=self._tsorig.pop(txn.txn_id, 0))
        self.stat_done += 1

    def _publish_waves(self, waves) -> None:
        for wave in waves:
            for txn in wave:
                # Round-robin that persists across waves, so a block of
                # one-txn waves still spreads over every bank.
                bank = self._rr_bank
                self._rr_bank = (self._rr_bank + 1) % self.bank_cnt
                self._publish(txn, bank)

    def _drain(self) -> None:
        """Schedule every non-conflicting txn that fits, rotating banks
        after each success; stop after a full cycle of refusals."""
        misses = 0
        block_ended = False
        while misses < self.bank_cnt:
            bank = self._rr_bank
            self._rr_bank = (self._rr_bank + 1) % self.bank_cnt
            txn = self.pack.schedule(bank)
            if txn is None:
                misses += 1
                if misses >= self.bank_cnt and not block_ended:
                    # Every bank refused with nothing in flight: the
                    # per-block CU budgets are spent. A new PoH slot
                    # resets them in the reference; there is no PoH
                    # clock here, so the block ends now.
                    if (self.pack.pending_cnt() > 0
                            and self.pack.inflight_cnt() == 0):
                        self.pack.end_block()
                        block_ended = True
                        misses = 0
                continue
            block_ended = False
            misses = 0
            self._publish(txn, bank)
            # Bank execution is immediate here: release the locks.
            self.pack.complete(bank, txn.txn_id)


class SinkTile(Tile):
    """Terminal consumer (bank stub): counts what it receives, by bank
    (sig >> 48) in bank_hist, and, when record_digests, keeps for each
    frag the sha256 of its payload, its tsorig and the full tick count it
    arrived at (latencies_ns and the feed's sink stage read them). t_last
    is the tick count of its last frag."""

    name = "sink"

    def __init__(self, wksp, cnc_name, in_link, record_digests: bool = False,
                 **kw):
        super().__init__(wksp, cnc_name, in_link=in_link, **kw)
        self.recv_cnt = 0
        self.recv_sz = 0
        # Frags by bank: the pack tile puts the bank in sig >> 48.
        self.bank_hist: dict = {}
        self.record_digests = record_digests
        self.digests: list = []
        self.recv_tsorig: list = []
        self.recv_ticks: list = []
        self.t_last = 0
        # The end-to-end span (source stamp -> receipt), the sink edge,
        # and its exemplar sampler, which closes each sampled txn's chain.
        self._e2e_span = flight.span(wksp, "sink")
        self._xr_ctx: Optional[xray.SpanCtx] = xray.span_ctx("sink")

    def on_frag(self, frag: Frag, payload: bytes) -> None:
        self.recv_cnt += 1
        self.recv_sz += frag.sz
        bank = frag.sig >> 48
        self.bank_hist[bank] = self.bank_hist.get(bank, 0) + 1
        now = tempo.tickcount()
        self.t_last = now
        if frag.tsorig:
            lat = (now - frag.tsorig) & 0xFFFFFFFF
            if self._e2e_span is not None:
                self._e2e_span.observe(lat)
            if self._xr_ctx is not None:
                self._xr_ctx.observe(frag.tsorig, now & 0xFFFFFFFF, lat)
        if self.record_digests:
            self.digests.append(_sha256(payload).digest())
            self.recv_tsorig.append(frag.tsorig)
            self.recv_ticks.append(now)
        self.in_cur.fseq.diag_add(DIAG_PUB_CNT, 1)
        self.in_cur.fseq.diag_add(DIAG_PUB_SZ, frag.sz)
        # Publish the cursor with the count, so a restart re-reads at
        # most this one frag.
        self.in_cur.fseq.update(frag.seq + 1)


def latencies_ns(replay: ReplayTile, sink: SinkTile) -> np.ndarray:
    """End-to-end latency of every frag the sink recorded (record_digests),
    in ns from the replay's publish to the sink's receipt, on the full
    64-bit tick count: a 32-bit tsorig alone wraps after 4.29 s. Each
    receipt is matched to the publish of the same payload whose low 32
    bits equal its tsorig; raises when a receipt matches no publish or
    more than one."""
    pubs: dict = {}
    for payload, tick in zip(replay.payloads, replay.pub_ticks):
        pubs.setdefault(_sha256(payload).digest(), []).append(tick)
    out = np.empty(len(sink.digests), np.int64)
    for i, (d, ts, now) in enumerate(zip(sink.digests, sink.recv_tsorig,
                                         sink.recv_ticks)):
        match = [t for t in pubs.get(d, ())
                 if t & 0xFFFFFFFF == ts and t <= now]
        if len(match) != 1:
            raise ValueError(f"sink frag {i} matches {len(match)} replay "
                             "publishes by payload and tsorig")
        out[i] = now - match[0]
    return out
