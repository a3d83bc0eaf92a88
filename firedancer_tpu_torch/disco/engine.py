"""Verify engines, the counterpart of ``firedancer_tpu/disco/engine.py``
(``EngineSpec``:83, ``drain_mode``:162, ``EngineEntry``:273,
``EngineRegistry``:466 with ``acquire``:519 and the background prewarm
:736-818, ``rung_ladder``:841, ``RungScheduler``:869; the RLC build at
:618-634, the drain filter's warm at :677-687).

``registry().acquire(EngineSpec(mode, 8192))`` is the entry a user calls:
it resolves the device (the Hopper card unless the caller passes
``device="cpu"``; no card raises), builds the kernels, and warms the
engine with one zero batch. ``entry.fn(msgs, lens, sigs, pubs)`` returns
(B,) int32 statuses on the engine's device in ``direct`` mode, and an
``RlcAsyncResult`` in ``rlc`` mode: one RLC pass (MSM plan ``spec.msm``,
the baseline ``u7`` by default, or the batch size's pin in
``rung_plan``; front half ``spec.frontend``, "fused" by default or
"staged", the JAX package's ``FD_FRONTEND_IMPL`` auto and xla on its
accelerator, ``current_frontend``:77) whose per-lane fallback, the
direct path, runs only when the batch equation fails.
``np.asarray(result)`` gives the statuses. The fd_drain pre-filter
rides a verify tile's dispatches on the entry's device when the tile's
``drain`` mode (``resolve_drain_mode``) arms it: ``warm_drain`` runs it
once at the batch's shape and ``snapshot()["drain"]`` says so.

The rung ladder: a feed tile whose staging batch tops two or more rungs
of ``rung_ladder`` (default "8192,16384,32768", the JAX package's
``FD_ENGINE_LADDER``) dispatches each staged slot on the smallest WARM
rung engine that covers it, and a ``RungScheduler`` sets the rung each
slot fills toward. ``prewarm_ladder`` warms the other rungs, by default
on a background thread: there each zero batch runs on a CUDA stream of
the thread's own, synchronised before the entry turns WARM, so the
dispatcher (which makes the tile's torch calls on its own stream) never
waits on it. The kernels are built by the tile's primary ``acquire``
before the thread starts, so a background warm builds and compiles
nothing; ``warm_s`` records what it took.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..msm_plan import parse_plan
from ..ops import backend, build
from ..ops.dedup_filter import dedup_filter, empty_banks
from ..ops.frontend_cuda import DEFAULT_FRONTEND, FRONTENDS
from ..ops.verify import verify_batch
from ..ops.verify_rlc import make_async_verifier
from . import flight
from .feed.policy import AdaptiveFlush

ENGINE_COLD = "cold"
ENGINE_WARMING = "warming"
ENGINE_WARM = "warm"
ENGINE_FAILED = "failed"

# The MSM plan of an rlc engine whose batch size has no pin in the
# registry's rung_plan table (the baseline).
DEFAULT_MSM = "u7"
# The rung ladder a feed tile schedules over (the JAX package's
# FD_ENGINE_LADDER default) and the prewarm policies (FD_ENGINE_PREWARM).
DEFAULT_LADDER = "8192,16384,32768"
PREWARM_POLICIES = ("background", "sync", "off")
DEFAULT_PREWARM = "background"


@dataclass(frozen=True)
class EngineSpec:
    """An engine's identity: verify mode, batch size, the MSM plan token
    of rlc mode (msm_plan.parse_plan; direct mode runs no MSM) and the
    front half of rlc mode (frontend_cuda.FRONTENDS; the direct path has
    one front half, and the key carries the field in every mode, as the
    JAX package's does)."""

    mode: str        # "direct" | "rlc"
    batch: int
    msm: str = DEFAULT_MSM
    frontend: str = DEFAULT_FRONTEND

    @property
    def key(self) -> str:
        return f"{self.mode}:B{self.batch}:fe{self.frontend}:{self.msm}"

    def with_batch(self, batch: int) -> "EngineSpec":
        return replace(self, batch=batch)

    def with_msm(self, msm: str) -> "EngineSpec":
        return replace(self, msm=msm)

    @classmethod
    def for_tile(cls, backend: str, verify_mode: str, batch: int,
                 frontend: str = DEFAULT_FRONTEND) -> "EngineSpec":
        """The spec a VerifyTile's dispatches are keyed by: the resolved
        verify mode on the card's backend ("gpu"), the backend's name on
        a host backend ("oracle"), as the JAX package's
        ``EngineSpec.for_tile``:120 keys them. An rlc spec takes its MSM
        plan from the registry's ``rung_plan`` for the batch size."""
        mode = verify_mode if backend == "gpu" else backend
        msm = registry().rung_plan(batch) if mode == "rlc" else DEFAULT_MSM
        return cls(mode, batch, msm, frontend)


# The verify tile's backends: "gpu" dispatches batches to an engine of
# this registry, "oracle" verifies each transaction on the host with the
# port's copy of the oracle.
TILE_BACKENDS = ("gpu", "oracle")


def default_verify_mode() -> str:
    """The verify mode "auto" resolves to on the card: "direct" at every
    batch size. At B = 8192 (H100 80GB HBM3, 700 W; chip_smoke.py
    phases 4-5, PERF.md section 5) a clean RLC pass keeps the device
    busy 2.71-2.72 ms, 2.2x a whole direct batch (1.24-1.25 ms by CUDA
    events), and its host clock with the read-back ran 20-27 ms against
    direct's 1.25. A batch-size sweep may revise this per B."""
    return "direct"


def resolve_verify_mode(backend: str, verify_mode: str) -> str:
    """A VerifyTile's verify mode. "auto" resolves to
    default_verify_mode() ("direct"); "direct" and "rlc" stand as given.
    Raises on an unknown mode or backend, and on "rlc" with the
    "oracle" backend, which has no batch engine for the RLC pass to run
    on: the one genuinely unsupported combination."""
    if verify_mode not in ("auto", "direct", "rlc"):
        raise ValueError(f"unknown verify_mode {verify_mode!r} "
                         "(want auto|direct|rlc)")
    if backend not in TILE_BACKENDS:
        raise ValueError(f"unknown verify backend {backend!r} "
                         f"(want {'|'.join(TILE_BACKENDS)})")
    if verify_mode == "auto":
        return default_verify_mode()
    if verify_mode == "rlc" and backend != "gpu":
        raise ValueError(
            "verify_mode='rlc' requires backend='gpu' (the host oracle "
            "has no batch engine for the RLC pass: the one genuinely "
            "unsupported combination)")
    return verify_mode


# The fd_drain modes: "auto" arms the dedup pre-filter behind every batch
# of the fd_feed runtime's verify tile, "off" disables it (the A/B hatch).
DRAIN_MODES = ("auto", "off")


def resolve_drain_mode(mode: str) -> str:
    """A verify tile's fd_drain mode, the counterpart of the JAX
    ``drain_mode``:162 (its FD_DRAIN flag; the port takes the mode as an
    argument). Raises on anything but "auto" and "off": a mistyped mode
    must not pass for a measurement of either arm."""
    if mode not in DRAIN_MODES:
        raise ValueError(f"unknown drain mode {mode!r} (want auto|off)")
    return mode


class EngineEntry:
    """One prepared verify engine on one device. ``fn`` is the verify
    callable; the dispatch counters and the service EMA are written by
    the one thread that dispatches on the engine, the state and
    ``warm_s`` under the entry's lock by whichever thread warms it (the
    tile's constructor or the registry's prewarm thread)."""

    def __init__(self, spec: EngineSpec, device: torch.device):
        self.spec = spec
        self.key = spec.key
        self.device = device
        self.state = ENGINE_COLD
        self.err: str | None = None
        self.warm_s = 0.0          # seconds of the last warm pass
        # The last warm's build found every kernel library built.
        self.warm_hit = False
        self.warms = 0             # warm passes run (zero batches)
        self.dispatches = 0
        self.lanes = 0
        self.service_ns = 0        # EMA of dispatch -> complete wall ns
        self._warmed: set = set()  # max_msg_len values warmed
        self._drain_warmed: set = set()  # h_bits values warmed
        self._lock = threading.Lock()
        # Held by fn: the verify tiles of several lanes dispatch on one
        # entry from their own threads.
        self._dispatch_lock = threading.Lock()
        self._verify = verify_batch
        if spec.mode == "rlc":
            self._verify = make_async_verifier(
                verify_batch, plan=parse_plan(spec.msm),
                frontend=spec.frontend)

    def fn(self, msgs, lens, sigs, pubs):
        """Verify one batch. Inputs are tensors or arrays; they are moved
        to the engine's device. Returns without waiting for the device:
        statuses (direct) or an RlcAsyncResult (rlc). Calls from several
        threads (one verify tile a lane) take turns: each enqueues its
        copies and launches whole, on its own thread's current stream,
        and the dispatch counters stay exact. Taking turns also spares
        the host the interpreter lock's hand-offs between threads that
        each run a batch's many small torch calls (on the CPU, three
        lanes interleaved ran 6x slower than the same batches in
        turn)."""
        dev = self.device
        with self._dispatch_lock:
            args = [torch.as_tensor(a).to(dev, non_blocking=True)
                    for a in (msgs, lens, sigs, pubs)]
            self.note_dispatch(args[0].shape[0])
            return self._verify(*args)

    def note_dispatch(self, lanes: int) -> None:
        self.dispatches += 1
        self.lanes += lanes

    def note_service(self, ns: int) -> None:
        """A measured dispatch -> complete time: EMA(1/8)."""
        self.service_ns = (ns if not self.service_ns
                           else (7 * self.service_ns + ns) // 8)

    def service_est_ns(self) -> int:
        """The service time of one batch on this engine, the rung
        scheduler's cost model: the measured EMA, 0 while unmeasured
        (the scheduler never caps on 0). The JAX package's split pair of
        EMAs (fd_pod) has no counterpart, so this is service_ns."""
        return self.service_ns

    def warm(self, max_msg_len: int = 1232) -> bool:
        """Build the kernels (on CUDA) and run one zero batch at
        (batch, max_msg_len) on the calling thread's current stream: in
        rlc mode through the RLC pass (its front half in spec.frontend)
        and its direct fallback both. That stream is synchronised before
        the entry turns WARM. Returns True when this call warmed. The
        warm is booked in flight.record_compile (the port's compile
        accounting): its seconds, and a cache hit when no kernel library
        had to be built."""
        with self._lock:
            if max_msg_len in self._warmed:
                return False
            b = self.spec.batch
            self.state = ENGINE_WARMING
            t0 = time.perf_counter()
            hit = True
            try:
                if self.device.type == "cuda":
                    hit = build.all_built()
                    build.build_all()
                zeros = (
                    torch.zeros(b, max_msg_len, dtype=torch.uint8,
                                device=self.device),
                    torch.zeros(b, dtype=torch.int32, device=self.device),
                    torch.zeros(b, 64, dtype=torch.uint8, device=self.device),
                    torch.zeros(b, 32, dtype=torch.uint8, device=self.device))
                verify_batch(*zeros).cpu()
                if self.spec.mode == "rlc":
                    np.asarray(self._verify(*zeros))
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
            except Exception as exc:
                self.state = ENGINE_FAILED
                self.err = repr(exc)[:200]
                raise
            self.warm_s = time.perf_counter() - t0
            self.warm_hit = hit
            flight.record_compile(self.key, self.warm_s, hit)
            self.warms += 1
            self._warmed.add(max_msg_len)
            self.state = ENGINE_WARM
            self.err = None
            return True

    @property
    def drain(self) -> bool:
        """The drain's pre-filter rides this engine (warm_drain ran)."""
        return bool(self._drain_warmed)

    def warm_drain(self, h_bits: int) -> bool:
        """Run the drain's pre-filter once on one lane and once on the
        batch's lanes, with an h_bits window, on the engine's device
        (building the kernels first on CUDA), so the first filter of a
        run loads nothing whichever launch its staged txns take. Returns
        True when this call warmed."""
        with self._lock:
            if h_bits in self._drain_warmed:
                return False
            if self.device.type == "cuda":
                build.build_all()
            for n in sorted({1, self.spec.batch}):
                zeros = torch.zeros(n, dtype=torch.int32, device=self.device)
                valid = torch.zeros(n, dtype=torch.bool, device=self.device)
                _, _, cnt = dedup_filter(zeros, zeros, valid,
                                         *empty_banks(h_bits, self.device))
                int(cnt)
            self._drain_warmed.add(h_bits)
            return True

    def snapshot(self) -> dict:
        return {"key": self.key, "mode": self.spec.mode,
                "batch": self.spec.batch, "msm": self.spec.msm,
                "frontend": self.spec.frontend,
                "device": str(self.device), "drain": self.drain,
                "state": self.state, "warm_s": round(self.warm_s, 3),
                "warm_hit": self.warm_hit,
                "warms": self.warms,
                "dispatches": self.dispatches, "lanes": self.lanes,
                "service_ns": self.service_ns, "err": self.err}


def _check_spec(spec: EngineSpec) -> None:
    if spec.mode not in ("direct", "rlc"):
        raise ValueError(f"unknown verify mode {spec.mode!r} "
                         "(want direct|rlc)")
    parse_plan(spec.msm)
    if spec.frontend not in FRONTENDS:
        raise ValueError(f"unknown frontend {spec.frontend!r} (want "
                         f"{'|'.join(FRONTENDS)})")


class EngineRegistry:
    """Process-wide map (spec, device) -> EngineEntry, the per-batch-size
    MSM plan pins, and the background prewarm queue."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[tuple[EngineSpec, torch.device], EngineEntry] = {}
        self._rung_plans: dict[int, str] = {}
        self._prewarm_q: deque = deque()   # (spec, device, max_msg_len)
        self._prewarm_wake = threading.Event()
        self._prewarm_stop = threading.Event()
        self._prewarm_thread: Optional[threading.Thread] = None
        # Guarded by _lock: True while a prewarm thread has committed to
        # draining the queue. The loop's exit decision and this flag's
        # flip happen under one hold of the lock, so a producer that
        # appends either sees False (and starts a thread) or is seen by
        # the loop before it exits.
        self._prewarm_running = False

    # -- per-batch-size MSM plans ------------------------------------------

    def set_rung_plan(self, batch: int, token: str) -> None:
        """Pin the MSM plan of rlc engines at a batch size (for_tile reads
        it). The token must parse (msm_plan.parse_plan); "auto" clears
        the pin, so the batch size takes DEFAULT_MSM."""
        if token != "auto":
            parse_plan(token)
        with self._lock:
            if token == "auto":
                self._rung_plans.pop(int(batch), None)
            else:
                self._rung_plans[int(batch)] = token

    def rung_plan(self, batch: int) -> str:
        """The pinned MSM plan of a batch size, DEFAULT_MSM without one."""
        with self._lock:
            return self._rung_plans.get(int(batch), DEFAULT_MSM)

    # -- entry map ---------------------------------------------------------

    def entry(self, spec: EngineSpec, device="cuda") -> EngineEntry:
        """Get or create the entry of (spec, device) without building or
        warming it (the rung scheduler's cost handle)."""
        _check_spec(spec)
        dev = backend.resolve_device(device)
        with self._lock:
            return self._entry_locked(spec, dev)

    def _entry_locked(self, spec: EngineSpec, dev) -> EngineEntry:
        e = self._entries.get((spec, dev))
        if e is None:
            e = EngineEntry(spec, dev)
            self._entries[(spec, dev)] = e
        return e

    def acquire(self, spec: EngineSpec, warm: bool = True,
                device="cuda", max_msg_len: int = 1232):
        """Resolve an engine for dispatch: (entry, warmed_now). device
        'cuda' needs a card of compute capability 9.x and raises
        RuntimeError without one; the CPU runs only when asked for."""
        e = self.entry(spec, device)
        warmed_now = e.warm(max_msg_len) if warm else False
        return e, warmed_now

    def warm_entry(self, spec: EngineSpec, device="cuda"):
        """The entry of (spec, device) if it is WARM, else None: a rung
        switch takes a warm engine or keeps the one it holds, and never
        waits on a warm."""
        dev = backend.resolve_device(device)
        with self._lock:
            e = self._entries.get((spec, dev))
        return e if e is not None and e.state == ENGINE_WARM else None

    def entries(self) -> list[EngineEntry]:
        with self._lock:
            return list(self._entries.values())

    def entry_count(self) -> int:
        """Entries in every state (a count that keeps growing means
        shapes leak past the ladder)."""
        with self._lock:
            return len(self._entries)

    def retire(self, specs, device="cuda") -> int:
        """Drop (spec, device) of each spec from the registry, and from
        the prewarm queue, so nothing re-creates it: the live reconfig's
        cleanup of rung engines the new configuration no longer reaches.
        Specs not present are ignored; returns how many were dropped.
        The caller must not retire an engine a batch in flight holds
        (the reconfig barrier guarantees none)."""
        dev = backend.resolve_device(device)
        specs = set(specs)
        dropped = 0
        with self._lock:
            for spec in specs:
                if self._entries.pop((spec, dev), None) is not None:
                    dropped += 1
            self._prewarm_q = deque(
                it for it in self._prewarm_q
                if not (it[0] in specs and it[1] == dev))
        return dropped

    def snapshot(self) -> list[dict]:
        return [e.snapshot() for e in self.entries()]

    # -- background prewarm --------------------------------------------------

    def prewarm_ladder(self, specs, device="cuda", max_msg_len: int = 1232,
                       policy: str = DEFAULT_PREWARM) -> None:
        """Warm rung engines by policy: "background" queues them for the
        registry's prewarm thread (started on first use; a rung switch
        picks each engine up once it is WARM), "sync" warms them before
        returning, "off" does nothing (the rungs stay cold and dispatch
        keeps the tile's primary engine). Any other policy raises."""
        if policy not in PREWARM_POLICIES:
            raise ValueError(f"unknown prewarm policy {policy!r} "
                             "(want background|sync|off)")
        if policy == "off":
            return
        dev = backend.resolve_device(device)
        for spec in specs:
            _check_spec(spec)
        if policy == "sync":
            for spec in specs:
                self.acquire(spec, warm=True, device=dev,
                             max_msg_len=max_msg_len)
            return
        with self._lock:
            for spec in specs:
                self._prewarm_q.append((spec, dev, max_msg_len))
            if not self._prewarm_running:
                self._prewarm_running = True
                self._prewarm_stop.clear()
                t = threading.Thread(target=self._prewarm_loop,
                                     name="fd_engine.prewarm", daemon=True)
                self._prewarm_thread = t
                t.start()
        self._prewarm_wake.set()

    def _prewarm_loop(self) -> None:
        """The queue's one consumer. An item leaves the queue and its entry
        is taken in one hold of the lock, so a retire either drops the
        item or the entry, and nothing re-creates a retired entry. The
        warm runs on a CUDA stream of this thread's own for a card's
        engine (the warm synchronises it before the entry turns WARM). A
        failed warm leaves the entry FAILED with its err, and the loop
        goes on."""
        streams: dict = {}
        while not self._prewarm_stop.is_set():
            with self._lock:
                item = self._prewarm_q.popleft() if self._prewarm_q else None
                if item is not None:
                    e = self._entry_locked(item[0], item[1])
            if item is None:
                self._prewarm_wake.wait(timeout=0.2)
                self._prewarm_wake.clear()
                with self._lock:
                    if not self._prewarm_q:
                        self._prewarm_running = False
                        return
                continue
            _, dev, max_msg_len = item
            try:
                if dev.type == "cuda":
                    if dev not in streams:
                        streams[dev] = torch.cuda.Stream(dev)
                    with torch.cuda.device(dev), \
                            torch.cuda.stream(streams[dev]):
                        e.warm(max_msg_len)
                else:
                    e.warm(max_msg_len)
            except Exception:  # noqa: BLE001 - the entry records it
                pass
        with self._lock:
            self._prewarm_running = False

    def prewarm_idle(self) -> bool:
        """No background warm queued or running."""
        with self._lock:
            return not self._prewarm_q and not self._prewarm_running

    def stop_prewarm(self, timeout: float = 10.0) -> None:
        """Drop the queue, stop the prewarm thread and join it. A later
        prewarm_ladder starts a fresh thread."""
        with self._lock:
            self._prewarm_q.clear()
        self._prewarm_stop.set()
        self._prewarm_wake.set()
        t = self._prewarm_thread
        if t is not None:
            t.join(timeout=timeout)


_REGISTRY = EngineRegistry()


def registry() -> EngineRegistry:
    return _REGISTRY


# --------------------------------------------------------------------------
# Rung ladder and scheduler.
# --------------------------------------------------------------------------


def rung_ladder(ladder=DEFAULT_LADDER, cap: Optional[int] = None,
                floor: int = 0) -> List[int]:
    """A rung ladder, a comma-separated string or a sequence of batch
    sizes: deduplicated, ascending, without rungs above cap (a tile's
    staging batch, to which its arenas are sized) or below floor (too
    small to stage a whole txn, MAX_SIG_CNT). A malformed or
    non-positive entry raises: a mistyped ladder must never schedule on
    the wrong rungs."""
    parts = (ladder or "").split(",") if isinstance(ladder, str) \
        else [str(r) for r in ladder]
    rungs = set()
    for part in parts:
        part = part.strip()
        if not part:
            continue
        try:
            b = int(part)
        except ValueError:
            raise ValueError(
                f"bad ladder entry {part!r} (want a comma-separated list "
                "of batch sizes)") from None
        if b <= 0:
            raise ValueError(f"ladder rung {b} must be positive")
        rungs.add(b)
    return sorted(r for r in rungs
                  if r >= floor and (cap is None or r <= cap))


class RungScheduler:
    """Rung selection over a batch-size ladder, the JAX package's
    ``RungScheduler``:869 (without its mesh shards: the port runs on one
    card). Pure in the caller's clock; one caller thread (the feed
    stager).

    pick(now_ns, lanes, first_ns, backlog, backlog_full) -> target rung:
        the largest rung the queue depth (staged lanes + ring backlog)
        fills, monotone in depth, stepped down while a rung's measured
        service estimate exceeds the staged batch's remaining deadline
        budget (floor: the smallest rung; a rung with cost 0 is never
        capped). backlog_full, or a backlog of a top rung, is
        saturation: depth lifts to the top rung and the slack cap goes.
    due(...) -> the embedded AdaptiveFlush's verdict with the current
        rung as the batch bound, so the deadline and starve invariants
        are AdaptiveFlush's.
    dispatch_rung(lanes) -> the smallest rung covering a staged lane
        count (the top rung bounds everything).

    cost_ns(rung) is the cost model (the rung engine's service_est_ns);
    None disables the slack cap."""

    def __init__(self, rungs, deadline_ns: int,
                 cost_ns: Optional[Callable[[int], int]] = None):
        rungs = sorted(set(int(r) for r in rungs))
        if not rungs:
            raise ValueError("RungScheduler needs at least one rung")
        if any(r <= 0 for r in rungs):
            raise ValueError(f"rungs must be positive, got {rungs}")
        self.rungs = rungs
        self.deadline_ns = deadline_ns
        self.cost_ns = cost_ns
        self.flush = AdaptiveFlush(deadline_ns)
        self.cur = rungs[0]
        self.switches = 0
        self.decisions = 0
        self.last_inputs: Tuple[int, int, int] = (0, 0, 0)

    def pick_rung(self, depth: int, slack_ns: Optional[int] = None) -> int:
        """The largest rung depth covers, capped by slack through the
        cost model: monotone non-decreasing in depth for a fixed slack."""
        i = 0
        for j, rung in enumerate(self.rungs):
            if depth >= rung:
                i = j
        if slack_ns is not None and self.cost_ns is not None:
            while i > 0:
                c = self.cost_ns(self.rungs[i])
                if not c or c <= slack_ns:
                    break
                i -= 1
        return self.rungs[i]

    def dispatch_rung(self, lanes: int) -> int:
        """The smallest rung covering lanes staged lanes."""
        for rung in self.rungs:
            if lanes <= rung:
                return rung
        return self.rungs[-1]

    def pick(self, now_ns: int, lanes: int, first_ns: int,
             backlog: int, backlog_full: bool = False) -> int:
        """The stager's target rung for the batch being staged: depth =
        staged lanes + ring backlog (txns, a lower bound of lanes); slack
        = the staged batch's remaining deadline budget (the whole budget
        while nothing is staged). Counts a switch when the rung
        changes."""
        depth = max(0, lanes) + max(0, backlog)
        if backlog_full or backlog >= self.rungs[-1]:
            depth = max(depth, self.rungs[-1])
            slack = None
        elif lanes > 0 and first_ns:
            slack = max(0, self.deadline_ns - max(0, now_ns - first_ns))
        else:
            slack = self.deadline_ns
        rung = self.pick_rung(depth, slack_ns=slack)
        self.decisions += 1
        self.last_inputs = (depth, slack, lanes)
        if rung != self.cur:
            self.switches += 1
            self.cur = rung
        return rung

    def due(self, now_ns: int, lanes: int, first_ns: int, *,
            starved: bool = False, device_idle: bool = False,
            backpressured: bool = False):
        """AdaptiveFlush's verdict at the current rung, or None."""
        return self.flush.due(
            now_ns, lanes, self.cur, first_ns, starved=starved,
            device_idle=device_idle, backpressured=backpressured)

    def decide(self, now_ns: int, lanes: int, first_ns: int,
               backlog: int, *, starved: bool = False,
               device_idle: bool = False, backpressured: bool = False,
               backlog_full: bool = False):
        """pick and due in one call: (verdict or None, rung)."""
        rung = self.pick(now_ns, lanes, first_ns, backlog,
                         backlog_full=backlog_full)
        verdict = None
        if lanes > 0:
            verdict = self.due(
                now_ns, lanes, first_ns, starved=starved,
                device_idle=device_idle, backpressured=backpressured)
        return verdict, rung
