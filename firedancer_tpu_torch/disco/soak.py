"""fd_soak, the long-horizon soak harness, the counterpart of
``firedancer_tpu/disco/soak.py``: the plan (``build_plan``:136), the
payloads (``build_payloads``:222), the paced source
(``SoakSourceTile``:248), the resource probe (``_lsq_slope``:299,
``ResourceProbe``:313), the live-reconfig channel (``_read_request``:437,
``ReconfigController``:461), the run (``run_soak``:539) and the
judgment (``judge``:637).

A soak asks not how fast but whether anything grows, leaks, wedges or
drifts under a workload that keeps changing shape:

  plan      build_plan scripts the run from one seed: a fd_siege profile
            a phase (its corpus mix and load factor, ``PROFILE_MIX``), a
            seeded drift of the offered load, and a chaos schedule that
            fires beside the phases. The same seed gives the same phase
            table and payloads as the JAX package, so a control run
            without chaos or swaps is comparable digest for digest.
  source    SoakSourceTile is the replay source paced by a token bucket
            a phase: the payload index decides the phase, the phase's
            rate how fast the index moves. Phase changes go to
            ``phase_log``.
  probes    ResourceProbe samples the tracemalloc heap, the verify
            tile's slot pool and inflight window, the engine registry's
            entries and the sentinel's alert total at a fixed cadence;
            its least-squares slopes are the sentinel's slope source
            (``sentinel.set_slope_source``), so a leak alerts during the
            run. ReconfigController is the live control channel.
  judgment  judge folds a run into one SOAK_r record (metric
            ``soak_run``, schema 2): alerts by phase, the alerts no
            injected fault class explains, the slopes against their
            budgets, the reconfig trail, the respawn rate against its
            budget (``supervisor.respawn_budget``) and the sink's
            continuity. ``tools/fd_soak.py`` writes it.

The JAX flags are options: ``SoakOptions`` (FD_SOAK_SEED,
FD_SOAK_PHASES, FD_SOAK_PHASE_S, FD_SOAK_PROBE_MS,
FD_SOAK_RESPAWN_BUDGET), the slope budgets ``SentinelOptions.budgets``
(FD_SLO_HEAP_SLOPE_KB, FD_SLO_POOL_SLOPE_MILLI, FD_SLO_COMPILE_SLOPE)
and a run's chaos the runners' ``chaos=`` (``chaos_spec``, where the JAX
``chaos_env`` gives FD_CHAOS_* variables). A reconfig request's keys are
the tile's (``tiles.RECONFIG_KEYS``: ``verify_mode``, ``ladder``,
``frontend``, ``drain``); the JAX request's ``env`` flag flips have no
counterpart. ``run_soak`` runs on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import tempfile
import threading
import time
import tracemalloc
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.rng import Rng
from . import sentinel as sentinel_mod
from .siege import PROFILES
from .supervisor import RESPAWN_BUDGET_PER_H
from .tiles import ReplayTile

SCHEMA_VERSION = 2
METRIC = "soak_run"

# Each profile's workload shape: mainnet_corpus overrides and a load
# factor. dup_storm leans on the dedup tcache, malformed_flood on the
# parse and verify rejects, slowloris starves the rings, oversize_abuse
# stretches payloads, keyupdate_churn flips the txn-version mix.
PROFILE_MIX: Dict[str, Tuple[Dict[str, float], float]] = {
    "conn_churn": ({}, 1.0),
    "dup_storm": ({"dup_rate": 0.35}, 1.1),
    "malformed_flood": ({"corrupt_rate": 0.12, "parse_err_rate": 0.15},
                        1.2),
    "slowloris": ({}, 0.35),
    "oversize_abuse": ({"max_data_sz": 900}, 0.9),
    "keyupdate_churn": ({"v0_rate": 0.7, "budget_rate": 0.4}, 1.0),
}

# The chaos classes the drift rotation arms, a phase each: window
# classes only (the point class stager_kill is crash_storm's).
_CHAOS_ROTATION: Tuple[Optional[str], ...] = (
    None, "hb_stall", None, "credit_starve",
)

# An injected class -> the SLOs it may trip besides its own
# (sentinel.FAULT_SLO): a stalled heartbeat or a killed stager stalls
# the edges too. An alert outside the injected classes' union is
# unexplained and fails the soak.
_FAULT_COLLATERAL: Dict[str, Tuple[str, ...]] = {
    "hb_stall": ("tile_heartbeat", "pipeline_progress"),
    "worker_kill": ("tile_heartbeat", "pipeline_progress"),
    "stager_kill": ("tile_heartbeat", "pipeline_progress"),
    "credit_starve": ("pipeline_progress",),
}


@dataclass(frozen=True)
class SoakOptions:
    """A soak's options, the JAX flags FD_SOAK_SEED, FD_SOAK_PHASES,
    FD_SOAK_PHASE_S, FD_SOAK_PROBE_MS and FD_SOAK_RESPAWN_BUDGET with
    their defaults (``firedancer_tpu/flags.py:992-1017``)."""

    seed: int = 606
    phases: int = 6
    phase_s: float = 600.0
    probe_ms: int = 500
    respawn_budget: int = RESPAWN_BUDGET_PER_H


@dataclass
class SoakPhase:
    """One scripted phase: payloads [start_idx, end_idx) at rate txn/s
    under profile's corpus mix, with chaos armed."""

    idx: int
    name: str
    profile: str
    chaos: Optional[str]
    rate: float                    # offered txn/s (the token bucket's)
    n_txns: int
    corpus_kw: Dict[str, float] = field(default_factory=dict)
    start_idx: int = 0
    end_idx: int = 0
    n_unique_ok: int = 0           # set by build_payloads


@dataclass
class SoakPlan:
    seed: int
    phases: Tuple[SoakPhase, ...]
    chaos_schedule: str            # chaos.parse_schedule's grammar ("" off)
    duration_s: float              # the scripted seconds
    n_txns: int


def build_plan(seed: Optional[int] = None, n_phases: Optional[int] = None,
               phase_s: Optional[float] = None, rate: float = 100.0,
               profile: str = "drift",
               max_txns: int = 200_000) -> SoakPlan:
    """The whole soak from one seed (SoakOptions' defaults for what is
    None). "drift" rotates the siege profiles a phase each with a seeded
    load drift in [0.6, 1.4)x; "crash_storm" holds one workload and
    fires a stager_kill every phase; any siege profile name pins every
    phase to it. max_txns caps the payloads (they are held in memory):
    past it each phase's count scales down, at least 32."""
    opts = SoakOptions()
    seed = opts.seed if seed is None else int(seed)
    n_phases = opts.phases if n_phases is None else int(n_phases)
    phase_s = opts.phase_s if phase_s is None else float(phase_s)
    rng = Rng(seed)
    rot0 = rng.roll(len(PROFILES))
    phases: List[SoakPhase] = []
    chaos_parts: List[str] = []
    pos = 0
    for i in range(n_phases):
        if profile == "drift":
            pname = PROFILES[(rot0 + i) % len(PROFILES)]
            chaos_cls = _CHAOS_ROTATION[i % len(_CHAOS_ROTATION)]
        elif profile == "crash_storm":
            pname = "conn_churn"
            chaos_cls = "stager_kill"
        else:
            if profile not in PROFILES:
                raise ValueError(f"unknown soak profile {profile!r}")
            pname = profile
            chaos_cls = None
        mix, factor = PROFILE_MIX[pname]
        drift = 0.6 + 0.8 * rng.float01()
        ph_rate = max(1.0, rate * factor * drift)
        n = max(32, int(ph_rate * phase_s))
        if chaos_cls == "stager_kill":
            chaos_parts.append(f"stager_kill@{400 * (i + 1)}")
        elif chaos_cls is not None:
            # Windows in pass ordinals, which depend on timing: generous,
            # and the judgment explains alerts by class, not by phase.
            lo = 200 + 5000 * i
            chaos_parts.append(f"{chaos_cls}@{lo}:{lo + 2000}")
        phases.append(SoakPhase(
            idx=i, name=f"p{i:02d}_{pname}", profile=pname,
            chaos=chaos_cls, rate=ph_rate, n_txns=n, corpus_kw=dict(mix)))
        pos += n
    if pos > max_txns:
        scale = max_txns / pos
        pos = 0
        for ph in phases:
            ph.n_txns = max(32, int(ph.n_txns * scale))
            pos += ph.n_txns
    off = 0
    for ph in phases:
        ph.start_idx = off
        off += ph.n_txns
        ph.end_idx = off
    duration = sum(ph.n_txns / ph.rate for ph in phases)
    return SoakPlan(seed=seed, phases=tuple(phases),
                    chaos_schedule=",".join(chaos_parts),
                    duration_s=duration, n_txns=off)


def chaos_spec(plan: SoakPlan) -> Optional[Tuple[int, str]]:
    """The runners' chaos= for the plan's schedule, (seed, schedule), or
    None when it schedules nothing."""
    if not plan.chaos_schedule:
        return None
    return plan.seed, plan.chaos_schedule


def build_payloads(plan: SoakPlan, sign_batch_size: int = 4096,
                   device=None) -> List[bytes]:
    """Each phase's corpus (seeded plan.seed * 1009 + its index, its
    profile's mix), signed on device (the card unless "cpu"), in one
    payload schedule. Sets each phase's n_unique_ok (the txns the sink
    must receive: the unique well-formed ones) and its exact index
    range."""
    from .corpus import mainnet_corpus

    out: List[bytes] = []
    for ph in plan.phases:
        c = mainnet_corpus(ph.n_txns, seed=plan.seed * 1009 + ph.idx,
                           sign_batch_size=sign_batch_size, device=device,
                           **ph.corpus_kw)
        ph.n_unique_ok = c.n_unique_ok
        out.extend(c.payloads)
        ph.end_idx = len(out)
    start = 0
    for ph in plan.phases:
        ph.start_idx = start
        start = ph.end_idx
        ph.n_txns = ph.end_idx - ph.start_idx
    return out


class SoakSourceTile(ReplayTile):
    """The replay source paced by the plan: the payload index decides
    the phase (so the offered multiset does not depend on timing), the
    phase's rate how fast the index moves; ahead of the bucket it sleeps
    200 us. Each phase entered appends to phase_log."""

    name = "replay"

    def __init__(self, wksp, cnc_name, out_links, payloads,
                 phases: Sequence[SoakPhase], **kw):
        super().__init__(wksp, cnc_name, out_links=out_links,
                         payloads=payloads, **kw)
        self.phases = list(phases)
        self.phase_log: List[dict] = []
        self._ph_i = -1
        self._ph_t0 = 0.0
        self._ph_pos0 = 0

    def _current_phase(self) -> Optional[SoakPhase]:
        while (self._ph_i < len(self.phases)
               and (self._ph_i < 0
                    or self.pos >= self.phases[self._ph_i].end_idx)):
            now = time.perf_counter()
            if 0 <= self._ph_i < len(self.phases) and self.phase_log:
                ent = self.phase_log[-1]
                ent["t_end"] = now
                ent["published"] = self.pos - self._ph_pos0
            self._ph_i += 1
            if self._ph_i < len(self.phases):
                ph = self.phases[self._ph_i]
                self._ph_t0 = now
                self._ph_pos0 = self.pos
                self.phase_log.append({
                    "phase": ph.name, "profile": ph.profile,
                    "chaos": ph.chaos, "offered_tps": round(ph.rate, 1),
                    "n_txns": ph.n_txns, "t_start": now,
                })
        if 0 <= self._ph_i < len(self.phases):
            return self.phases[self._ph_i]
        return None

    def step(self) -> None:
        ph = self._current_phase()
        if ph is not None and ph.rate > 0:
            allowed = (time.perf_counter() - self._ph_t0) * ph.rate
            if (self.pos - self._ph_pos0) >= allowed:
                time.sleep(200e-6)
                return
        super().step()


def _lsq_slope(pairs: Sequence[Tuple[float, float]]) -> float:
    """Least-squares slope of y over x (x in the caller's unit)."""
    n = len(pairs)
    if n < 2:
        return 0.0
    mx = sum(p[0] for p in pairs) / n
    my = sum(p[1] for p in pairs) / n
    den = sum((p[0] - mx) ** 2 for p in pairs)
    if den <= 0.0:
        return 0.0
    num = sum((p[0] - mx) * (p[1] - my) for p in pairs)
    return num / den


class ResourceProbe:
    """A sampler at a fixed cadence and the slope source of the
    sentinel's three slope rows. A sample: the tracemalloc heap KiB, the
    verify tile's outstanding feed slots and inflight batches, the
    engine registry's entries and the sentinel's alert total. The probe
    thread only appends to samples."""

    def __init__(self, wksp, interval_ms: Optional[int] = None):
        self.wksp = wksp
        self.interval_s = max(
            0.02, (SoakOptions().probe_ms if interval_ms is None
                   else int(interval_ms)) / 1e3)
        self.samples: List[dict] = []
        self.tile = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def attach(self, tile) -> None:
        self.tile = tile

    def start(self) -> "ResourceProbe":
        self._thread = threading.Thread(target=self._loop,
                                        name="soak-probe", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _sample(self) -> dict:
        from . import engine as fd_engine
        from . import flight

        row = {"t": time.perf_counter()}
        row["heap_kb"] = (tracemalloc.get_traced_memory()[0] / 1024.0
                          if tracemalloc.is_tracing() else 0.0)
        t = self.tile
        if t is not None and getattr(t, "_feed", False):
            try:
                row["pool_out"] = t.feed_pool.outstanding()
                row["inflight"] = len(t._inflight)
            except Exception:  # noqa: BLE001 - a sample without them
                pass
        try:
            row["engines"] = fd_engine.registry().entry_count()
        except Exception:  # noqa: BLE001
            row["engines"] = 0
        try:
            slos = flight.read_slos(self.wksp) or {}
            row["alerts"] = sum(int(v.get("alerts", 0))
                                for v in slos.values())
        except Exception:  # noqa: BLE001
            row["alerts"] = 0
        return row

    def _loop(self) -> None:
        self.samples.append(self._sample())
        while not self._stop.wait(self.interval_s):
            self.samples.append(self._sample())
        self.samples.append(self._sample())

    def source(self) -> dict:
        """The sentinel's slope source: growth rates in the slope rows'
        units over the samples less the window's first quarter (start-up
        allocations and first dispatches are one-time, and a short fit
        would read them as a leak). "samples" counts the samples used,
        so MIN_SLOPE_SAMPLES arms on steady-state evidence only."""
        rows = list(self.samples)
        if len(rows) >= 4:
            cut = rows[0]["t"] + 0.25 * (rows[-1]["t"] - rows[0]["t"])
            rows = [r for r in rows if r["t"] >= cut]
        out = {"samples": len(rows)}
        if len(rows) < 2:
            return out
        t0 = rows[0]["t"]
        mins = [(r["t"] - t0) / 60.0 for r in rows]
        out["heap_kb_min"] = _lsq_slope(
            list(zip(mins, (r["heap_kb"] for r in rows))))
        pool = [(m, float(r["pool_out"]) * 1000.0)
                for m, r in zip(mins, rows) if "pool_out" in r]
        if pool:
            out["pool_milli_min"] = _lsq_slope(pool)
        out["compile_per_hr"] = _lsq_slope(
            list(zip(mins, (float(r.get("engines", 0))
                            for r in rows)))) * 60.0
        return out

    def ring_hwm(self) -> dict:
        rows = list(self.samples)
        return {
            "slot_pool": max((r.get("pool_out", 0) for r in rows),
                             default=0),
            "inflight": max((r.get("inflight", 0) for r in rows),
                            default=0),
        }

    def alerts_between(self, t0: float, t1: float) -> int:
        """The alert total's rise between two instants, each read from
        the last sample at or before it."""
        rows = list(self.samples)

        def at(t: float) -> int:
            v = 0
            for r in rows:
                if r["t"] <= t:
                    v = r.get("alerts", 0)
                else:
                    break
            return v

        return max(0, at(t1) - at(t0))


def _read_request(path: Optional[str]) -> dict:
    """The request in path; {} when there is none, it does not parse or
    it is not a JSON object."""
    if not path:
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            req = json.load(f)
        return req if isinstance(req, dict) else {}
    except (OSError, ValueError):
        return {}


class ReconfigController:
    """The control channel of one verify tile: a thread polls path's
    mtime every poll_s seconds (a file present at start() does not
    fire) and the hup event (trigger()); either reads the request and
    applies it."""

    def __init__(self, path: Optional[str] = None, poll_s: float = 0.2):
        self.path = path
        self.poll_s = poll_s
        self.log: List[dict] = []
        self.tile = None
        self.hup = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def attach(self, tile) -> None:
        self.tile = tile

    def trigger(self) -> None:
        """The SIGHUP entry point (a signal handler only sets the event)."""
        self.hup.set()

    def start(self) -> "ReconfigController":
        self._thread = threading.Thread(target=self._loop,
                                        name="soak-reconfig", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def apply(self, req: dict) -> dict:
        """Park req on the tile; one log entry either way (called by the
        poll loop, or directly)."""
        tile = self.tile
        if tile is None:
            ok, detail = False, "no tile attached"
        else:
            ok, detail = tile.request_reconfig(req)
        ent = {"ok": bool(ok), "detail": detail, "t": time.perf_counter(),
               "ladder": req.get("ladder"),
               "verify_mode": req.get("verify_mode"),
               "frontend": req.get("frontend"), "drain": req.get("drain")}
        self.log.append(ent)
        return ent

    def _loop(self) -> None:
        seen = -1.0
        if self.path:
            try:
                seen = os.stat(self.path).st_mtime
            except OSError:
                seen = -1.0
        while not self._stop.wait(self.poll_s):
            fire = self.hup.is_set()
            if self.path:
                try:
                    m = os.stat(self.path).st_mtime
                except OSError:
                    m = None
                if m is not None and m != seen:
                    seen = m
                    fire = True
            if not fire:
                continue
            self.hup.clear()
            req = _read_request(self.path)
            if req:
                self.apply(req)


def run_soak(plan: SoakPlan, *, payloads: Optional[List[bytes]] = None,
             verify_backend: str = "gpu", verify_batch: int = 256,
             tcache_depth: int = 1 << 16,
             timeout_s: Optional[float] = None,
             controller: Optional[ReconfigController] = None,
             probe: Optional[ResourceProbe] = None,
             install_sighup: bool = True,
             record_digests: bool = True,
             workdir: Optional[str] = None, device="cuda",
             verify_opts: Optional[dict] = None, chaos=None, flight=None,
             sentinel=None, xray=None,
             options: Optional[SoakOptions] = None, tile_hook=None):
    """Run the plan through the fd_feed pipeline with the soak's
    instruments attached; returns (record, PipelineResult): judge's
    record, and the result for a comparison with a control run (its
    sink_digests). The payloads are build_payloads(plan) on device
    unless given. The workspace (rings 2,048 deep, 64 MiB) lives in
    workdir, else in a temporary directory removed afterwards.

    The probe (every options.probe_ms) and the controller, if given,
    attach to the verify tile as the tiles start, then tile_hook(verify)
    is called. tracemalloc runs for the whole run (started and stopped
    here unless it already ran); SIGHUP triggers the controller, when
    run_soak is called on the main thread (restored afterwards).
    verify_opts, chaos, flight, sentinel and xray go to
    run_feed_pipeline; the slope budgets are the sentinel options'.
    record_digests=False for long runs: the sink's digest ledger grows
    with every txn, the growth the heap tripwire exists to catch, and
    continuity is then judged by count."""
    from . import pipeline as pl
    from ..tango.rings import Workspace
    from .feed.runtime import run_feed_pipeline

    opts = options or SoakOptions()
    if payloads is None:
        payloads = build_payloads(plan, device=device)
    made = workdir is None
    tmp = tempfile.mkdtemp(prefix="fd_soak_") if made else workdir
    os.makedirs(tmp, exist_ok=True)
    started_tm = old_hup = None
    try:
        topo = pl.build_topology(os.path.join(tmp, "soak.wksp"), depth=2048,
                                 wksp_sz=1 << 26)
        wksp = Workspace.join(topo.wksp_path)
        src = SoakSourceTile(
            wksp, "replay.cnc",
            out_links=[pl.out_link(wksp, "replay_verify", topo.mtu)],
            payloads=payloads, phases=plan.phases)
        probe = probe or ResourceProbe(wksp, opts.probe_ms)
        started_tm = not tracemalloc.is_tracing()
        if started_tm:
            tracemalloc.start()
        if (controller is not None and install_sighup
                and threading.current_thread() is threading.main_thread()):
            old_hup = signal.signal(signal.SIGHUP,
                                    lambda *_: controller.trigger())
        sentinel_mod.set_slope_source(probe.source)

        def hook(verify) -> None:
            probe.attach(verify)
            probe.start()
            if controller is not None:
                controller.attach(verify)
                controller.start()
            if tile_hook is not None:
                tile_hook(verify)

        t0 = time.perf_counter()
        try:
            res = run_feed_pipeline(
                topo, payloads, verify_backend=verify_backend,
                verify_batch=verify_batch, tcache_depth=tcache_depth,
                timeout_s=(timeout_s if timeout_s is not None
                           else plan.duration_s * 2.0 + 60.0),
                verify_opts=verify_opts, record_digests=record_digests,
                device=device, tile_hook=hook, chaos=chaos, flight=flight,
                sentinel=sentinel, xray=xray, source_tile=src,
                source_done=src.done)
        finally:
            elapsed = time.perf_counter() - t0
            probe.stop()
            if controller is not None:
                controller.stop()
        # The run joined the source's thread: its mapping can go.
        wksp.leave()
    finally:
        sentinel_mod.set_slope_source(None)
        if old_hup is not None:
            signal.signal(signal.SIGHUP, old_hup)
        if started_tm:
            tracemalloc.stop()
        if made:
            shutil.rmtree(tmp, ignore_errors=True)
    record = judge(plan, res, src, probe, controller, elapsed,
                   backend=verify_backend, sentinel=sentinel, options=opts)
    return record, res


def judge(plan: SoakPlan, res, src: SoakSourceTile,
          probe: ResourceProbe,
          controller: Optional[ReconfigController],
          elapsed_s: float, *, backend: str = "gpu", sentinel=None,
          options: Optional[SoakOptions] = None) -> dict:
    """The SOAK_r record of a run (the JAX :637-790 field for field;
    on_device is true for the "gpu" backend). sentinel (the run's
    sentinel options) gives the slope budgets, options the respawn
    budget."""
    from .supervisor import respawn_budget

    opts = options or SoakOptions()
    sopts = sentinel_mod.as_options(sentinel)
    vs = (res.verify_stats or [{}])[0]
    slo = res.slo or {"alert_cnt": 0, "alerts": [], "slos": {}}
    alerts = list(slo.get("alerts") or [])
    chaos_snap = vs.get("chaos") or {}
    injected = sorted(
        cls for cls, c in (chaos_snap.get("counters") or {}).items()
        if isinstance(c, dict) and c.get("injected"))
    explained_slos = set()
    for cls in injected:
        explained_slos.update(_FAULT_COLLATERAL.get(cls, ()))
        direct = sentinel_mod.FAULT_SLO.get(cls)
        if direct:
            explained_slos.add(direct)
    unexplained = [
        a for a in alerts
        if not ((set(a.get("fault_classes") or ()) & set(injected))
                or a.get("slo") in explained_slos)
    ]

    # Alerts by phase, and none within 2 probe intervals of a phase
    # boundary. The probe counts totals, not causes, so a boundary blip
    # is judged only where it cannot be chaos: injected windows are in
    # pass ordinals and may straddle a boundary, and an alert that no
    # injected class explains fails the unexplained gate already.
    log = [dict(e) for e in src.phase_log]
    t_last = (probe.samples[-1]["t"] if probe.samples
              else time.perf_counter())
    boundaries_clean = True
    blame_blips = bool(unexplained) or not injected
    for i, ent in enumerate(log):
        ent.setdefault("t_end", t_last)
        ent.setdefault("published", ent.get("n_txns", 0))
        ent["alerts"] = probe.alerts_between(ent["t_start"], ent["t_end"])
        ent["duration_s"] = round(ent["t_end"] - ent["t_start"], 3)
        if i > 0 and blame_blips:
            w = 2 * probe.interval_s
            if probe.alerts_between(ent["t_start"] - w,
                                    ent["t_start"] + w):
                boundaries_clean = False
        for k in ("t_start", "t_end"):
            ent[k] = round(ent[k], 3)

    slopes = probe.source()
    budgets = {
        "heap_kb_min": sopts.budget("FD_SLO_HEAP_SLOPE_KB"),
        "pool_milli_min": sopts.budget("FD_SLO_POOL_SLOPE_MILLI"),
        "compile_per_hr": sopts.budget("FD_SLO_COMPILE_SLOPE"),
    }
    armed = slopes.get("samples", 0) >= sentinel_mod.MIN_SLOPE_SAMPLES
    within = all(
        float(slopes.get(k, 0.0)) <= b for k, b in budgets.items()
    ) if armed else True

    restarts = int(vs.get("stager_restarts", 0) or 0)
    restarts += int(getattr(res, "supervisor_restarts", 0) or 0)
    respawn = respawn_budget(restarts, elapsed_s, opts.respawn_budget)

    applied = int(vs.get("reconfigs", 0) or 0)
    refused = int(vs.get("reconfig_refused", 0) or 0)
    events = list(controller.log) if controller is not None else []

    expected_sink = sum(ph.n_unique_ok for ph in plan.phases)
    recv = int(getattr(res, "recv_cnt", 0) or 0)
    dropped = max(0, expected_sink - recv) if expected_sink else 0
    leaked = int(vs.get("slots_leaked", 0) or 0)

    failures: List[str] = []
    if unexplained:
        failures.append(
            f"{len(unexplained)} alert(s) not explained by injected "
            f"chaos {injected}")
    if not within:
        failures.append("resource slope over budget")
    if not respawn["ok"]:
        failures.append(
            f"respawn storm: {respawn['rate_per_h']:.1f}/h over budget "
            f"{respawn['budget_per_h']}/h")
    if dropped:
        failures.append(f"{dropped} txn(s) dropped vs corpus expectation")
    if leaked:
        failures.append(f"{leaked} staging slot(s) leaked")
    if not boundaries_clean:
        failures.append("burn-rate blip at a phase boundary")

    return {
        "metric": METRIC,
        "schema_version": SCHEMA_VERSION,
        "ts": datetime.now(timezone.utc).isoformat(),
        "ok": not failures,
        "on_device": backend == "gpu",
        "value": round(recv / elapsed_s, 1) if elapsed_s > 0 else 0.0,
        "unit": "txns/s",
        "seed": plan.seed,
        "duration_s": round(elapsed_s, 3),
        "backend": backend,
        "phases": log,
        "slo": {
            "alert_cnt": int(slo.get("alert_cnt", 0) or 0),
            "unexplained_alerts": len(unexplained),
            "alerts": [
                {"slo": a.get("slo"), "kind": a.get("slo_kind"),
                 "edge_or_stage": a.get("edge_or_stage"),
                 "burn_milli": a.get("burn_milli"),
                 "fault_classes": list(a.get("fault_classes") or ())}
                for a in alerts
            ],
            "explained": injected,
            "burn_continuity": {
                "boundaries": max(0, len(log) - 1),
                "clean": boundaries_clean,
            },
        },
        "slopes": {
            "samples": int(slopes.get("samples", 0)),
            "heap_kb_min": round(float(slopes.get("heap_kb_min", 0.0)), 3),
            "pool_milli_min": round(
                float(slopes.get("pool_milli_min", 0.0)), 3),
            "compile_per_hr": round(
                float(slopes.get("compile_per_hr", 0.0)), 3),
            "within_budget": within,
            "budgets": budgets,
            "ring_hwm": probe.ring_hwm(),
        },
        "reconfig": {
            "requested": applied + refused,
            "applied": applied,
            "refused": refused,
            "events": events,
        },
        "respawn": respawn,
        "continuity": {
            "offered": len(src.payloads),
            "published": src.pub_cnt,
            "expected_sink": expected_sink,
            "received": recv,
            "dropped": dropped,
            "slots_leaked": leaked,
            "digest_match": None,   # set by a comparison with a control
        },
        "autopsy_index": sorted(
            {a["autopsy"] for a in alerts if a.get("autopsy")}),
        "failures": failures,
    }
