"""fd_sentinel's SLO engine, the counterpart of
``firedancer_tpu/disco/sentinel.py`` :1-870 (the SLO table :110-201,
``set_slope_source``:250, ``set_tenant_source``:272,
``evaluate_tenant_summary``:280, ``_budget_ms``:377,
``_bad_from_bucket``:385, ``Sentinel``:406, ``start_for_run``:830,
``evaluate_edges_summary``:838) and ``dump_slo_markdown``:1657.

A declarative table of 15 SLOs, judged inside every pipeline run by a
``Sentinel``: a thread that polls the fd_flight registry every
``interval_ms``. Latency SLOs read the edge histograms with
multi-window burn-rate detection (an alert only when the error budget
burns at ``burn`` or more in both the fast and the slow window);
liveness SLOs watch that some edge advances (``pipeline_progress``)
and that every running tile's cnc heartbeat moves
(``tile_heartbeat``); the effectiveness SLO reads the drain's claim
counters. Alerts go to the "sentinel" flight recorder, the shared
``flight.slo`` rows (``render_prom``'s ``fd_flight_slo_*``) and
``PipelineResult.slo``. The runners stop the sentinel at quiescence,
before HALT and before the workspace is left, on every path.

Three rows have no source in the port yet and report no data, as the
JAX ones do on traffic that lacks them: ``quic_ingest_p99`` (no QUIC
tile), ``tenant_fairness`` (no fabric, so no tenant source is set) and
``shard_balance`` (no ``verify.shardN`` rows before multi-GPU). The
slope SLOs arm only when a soak registers a slope source.

The JAX flags are options (``SentinelOptions``: ``enabled``
FD_SENTINEL, ``interval_ms`` FD_SENTINEL_INTERVAL_MS, ``burn``,
``fast_s``, ``slow_s`` FD_SLO_BURN, FD_SLO_FAST_S, FD_SLO_SLOW_S, and
``budgets``, overrides of the FD_SLO_* budgets by flag name over
``SLO_DEFAULTS``). The JAX module's timeline, regression tracker and
prediction ledger (:872-1650) and its stage budgets and throughput
gates (:331-374, TPU-era figures that only the ledger reads) are not
ported; ``dump_slo_markdown`` renders the SLO table.

numpy and the standard library only.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from . import flight


@dataclass(frozen=True)
class SLO:
    name: str
    kind: str            # latency | liveness | balance | effectiveness |
                         # slope | fairness
    edge_or_stage: str   # edge label (lane variants aggregate in), or
                         # progress / heartbeat, shard, drain_claims, the
                         # slope resource, tenants
    objective: str
    budget_flag: str     # the FD_SLO_* budget's name (SLO_DEFAULTS)
    target: float = 0.99
    fault_classes: Tuple[str, ...] = ()


SLO_TABLE: Tuple[SLO, ...] = (
    SLO("e2e_p99", "latency", "sink",
        "end-to-end (source stamp -> sink) p99 within the queue-"
        "inclusive corpus budget (docs/LATENCY.md)",
        "FD_SLO_E2E_BUDGET_MS"),
    SLO("verify_p99", "latency", "verify_dedup",
        "source -> sigverify-complete p99 within the e2e budget "
        "(cumulative stage; the ring-dwell backlog is charged here, "
        "so this binds exactly when verify stops keeping up)",
        "FD_SLO_E2E_BUDGET_MS"),
    SLO("drain_p99", "latency", "verify_drain",
        "source publish -> stager drain (fd_feed ring dwell) p99 "
        "within the e2e budget — the input-backlog stage",
        "FD_SLO_E2E_BUDGET_MS"),
    SLO("dedup_p99", "latency", "dedup_pack",
        "source -> dedup-complete p99 within the e2e budget",
        "FD_SLO_E2E_BUDGET_MS"),
    SLO("pack_p99", "latency", "pack_sink",
        "source -> pack-scheduled p99 within the e2e budget",
        "FD_SLO_E2E_BUDGET_MS"),
    SLO("source_p99", "latency", "replay_verify",
        "source-publish span p99 stays us-scale (queue-free stage; a "
        "breach is pathological host scheduling, not load)",
        "FD_SLO_SOURCE_BUDGET_MS"),
    SLO("quic_ingest_p99", "latency", "quic_ingest",
        "QUIC front-door admission span (stream completion at the quic "
        "tile -> frag publish into the feed) p99 within budget — the "
        "queue the fd_siege admission/shedding defenses keep shallow: "
        "a breach means completed txns are stalling INSIDE the front "
        "door under attack instead of being admitted or shed",
        "FD_SLO_QUIC_INGEST_MS"),
    SLO("shard_balance", "balance", "shard",
        "fd_pod shard occupancy: on a mesh run, the busiest shard "
        "lane's dispatched lanes stay within FD_SLO_SHARD_BALANCE_PCT "
        "(percent) of the laziest's once every shard has real volume "
        "— a breach means shard placement is starving a device and "
        "aggregate throughput has degraded to the slowest shard",
        "FD_SLO_SHARD_BALANCE_PCT"),
    SLO("drain_filter_effectiveness", "effectiveness", "drain_claims",
        "fd_drain dedup pre-filter effectiveness: once the verify "
        "tiles have published real claim volume, at least "
        "FD_SLO_DRAIN_EFF_PCT percent of published clean txns must "
        "carry a definitely-novel claim (drain_novel / (drain_novel + "
        "drain_maybe)) — a collapse means the filter window is "
        "undersized or bank rotation is wedged and DedupTile has "
        "degraded to probing everything (an FD_DRAIN=off run "
        "publishes no claims and never arms this)",
        "FD_SLO_DRAIN_EFF_PCT"),
    SLO("heap_slope", "slope", "heap",
        "fd_soak heap-growth tripwire: the least-squares slope of the "
        "soak probe's tracemalloc samples stays under "
        "FD_SLO_HEAP_SLOPE_KB KiB/min once MIN_SLOPE_SAMPLES have "
        "accumulated — a breach is the multi-hour leak signature the "
        "minutes-scale gates cannot see (armed only when a soak run "
        "registers a slope source; ordinary runs stay silent)",
        "FD_SLO_HEAP_SLOPE_KB"),
    SLO("pool_occupancy_slope", "slope", "slot_pool",
        "fd_soak slot-pool occupancy tripwire: the fitted trend of "
        "outstanding fd_feed slots (not FREE) stays under "
        "FD_SLO_POOL_SLOPE_MILLI milli-slots/min — a breach means "
        "slots are leaking out of the FREE->FILLING->READY->FREE "
        "cycle (stuck inflight windows, lost releases)",
        "FD_SLO_POOL_SLOPE_MILLI"),
    SLO("compile_cache_slope", "slope", "compile_cache",
        "fd_soak compile-cache tripwire: engine-registry entries + "
        "recorded compiles accrete no faster than FD_SLO_COMPILE_SLOPE "
        "entries/hour past the prewarmed ladder — a breach is the "
        "unbounded-recompile signature (shape leak, or reconfigs that "
        "never retire old engines)",
        "FD_SLO_COMPILE_SLOPE"),
    SLO("tenant_fairness", "fairness", "tenants",
        "fd_fabric multi-tenant admission fairness: once real tenant "
        "volume has offered (MIN_TENANT_OFFERED), every HONEST tenant "
        "(offering within its FD_TENANT_RATE bucket) keeps its shed "
        "fraction under FD_SLO_TENANT_SHED_PCT percent — a breach "
        "means admission is starving a within-rate tenant while an "
        "over-offering attacker should be the only one shed (armed "
        "only when a fabric run registers a tenant source; ordinary "
        "runs stay silent)",
        "FD_SLO_TENANT_SHED_PCT"),
    SLO("pipeline_progress", "liveness", "progress",
        "some pipeline edge advances at least every FD_SLO_STALL_MS "
        "while the run is live (armed after the first frag)",
        "FD_SLO_STALL_MS",
        fault_classes=("credit_starve",)),
    SLO("tile_heartbeat", "liveness", "heartbeat",
        "every RUNning tile's cnc heartbeat advances at least every "
        "FD_SLO_HB_MS (the supervised wedge-detector signature, "
        "watched in-process)",
        "FD_SLO_HB_MS",
        fault_classes=("hb_stall", "worker_kill")),
)

SLO_NAMES: Tuple[str, ...] = tuple(s.name for s in SLO_TABLE)
SLO_BY_NAME: Dict[str, SLO] = {s.name: s for s in SLO_TABLE}
FAULT_SLO: Dict[str, str] = {
    cls: s.name for s in SLO_TABLE for cls in s.fault_classes}

# The budgets' defaults, by the JAX flag's name (ms, or the unit the
# table states: percent, KiB/min, milli-slots/min, entries/hour).
SLO_DEFAULTS: Dict[str, int] = {
    "FD_SLO_E2E_BUDGET_MS": 2500,
    "FD_SLO_SOURCE_BUDGET_MS": 10,
    "FD_SLO_STALL_MS": 2000,
    "FD_SLO_HB_MS": 1500,
    "FD_SLO_QUIC_INGEST_MS": 500,
    "FD_SLO_SHARD_BALANCE_PCT": 150,
    "FD_SLO_DRAIN_EFF_PCT": 10,
    "FD_SLO_HEAP_SLOPE_KB": 512,
    "FD_SLO_POOL_SLOPE_MILLI": 250,
    "FD_SLO_COMPILE_SLOPE": 6,
    "FD_SLO_TENANT_SHED_PCT": 1,
}

# Least samples in a window before a latency burn rate counts; least
# mean lanes a shard, drain claims, slope samples and tenant offers
# before the other kinds arm.
MIN_WINDOW_N = 16
MIN_SHARD_LANES = 16
MIN_DRAIN_CLAIMS = 256
MIN_SLOPE_SAMPLES = 8
MIN_TENANT_OFFERED = 64


@dataclass(frozen=True)
class SentinelOptions:
    """A run's sentinel options: the JAX flags FD_SENTINEL,
    FD_SENTINEL_INTERVAL_MS, FD_SLO_BURN, FD_SLO_FAST_S, FD_SLO_SLOW_S
    with their defaults, and budgets overriding SLO_DEFAULTS by flag
    name."""

    enabled: bool = True
    interval_ms: int = 250
    burn: float = 2.0
    fast_s: float = 1.0
    slow_s: float = 4.0
    budgets: Mapping[str, int] = field(default_factory=dict)

    def budget(self, flag: str) -> int:
        if flag not in SLO_DEFAULTS:
            raise KeyError(f"unknown SLO budget {flag!r}")
        return int(self.budgets.get(flag, SLO_DEFAULTS[flag]))


def as_options(spec) -> SentinelOptions:
    """SentinelOptions from None (the defaults), a bool (enabled), a
    dict of fields or SentinelOptions."""
    if spec is None:
        return SentinelOptions()
    if isinstance(spec, SentinelOptions):
        return spec
    if isinstance(spec, bool):
        return SentinelOptions(enabled=spec)
    if isinstance(spec, dict):
        return SentinelOptions(**spec)
    raise TypeError(f"sentinel options: want None, bool, dict or "
                    f"SentinelOptions, got {type(spec).__name__}")


# A soak's slope source ({"samples", "heap_kb_min", "pool_milli_min",
# "compile_per_hr"}) and a fabric's tenant source ({tenant: {"offered",
# "admitted", "shed", "honest"}}): process-wide hooks, since
# start_for_run builds the Sentinel. None: those SLOs never arm.
_SLOPE_SOURCE: Optional[Callable[[], dict]] = None
_SLOPE_KEYS = {"heap": "heap_kb_min", "slot_pool": "pool_milli_min",
               "compile_cache": "compile_per_hr"}
_TENANT_SOURCE: Optional[Callable[[], Dict[str, dict]]] = None


def set_slope_source(fn: Optional[Callable[[], dict]]) -> None:
    global _SLOPE_SOURCE
    _SLOPE_SOURCE = fn


def set_tenant_source(fn: Optional[Callable[[], Dict[str, dict]]]) -> None:
    global _TENANT_SOURCE
    _TENANT_SOURCE = fn


def evaluate_tenant_summary(tenants: Dict[str, dict],
                            budget_pct: Optional[int] = None) -> List[dict]:
    """The fairness rule over a per-tenant ledger: a violation for each
    ledger that does not reconcile (admitted + shed != offered) and,
    once MIN_TENANT_OFFERED have offered, for each honest tenant shed
    over budget_pct percent. [] is clean."""
    if budget_pct is None:
        budget_pct = SLO_DEFAULTS["FD_SLO_TENANT_SHED_PCT"]
    out: List[dict] = []
    total_offered = 0
    for name, row in sorted(tenants.items()):
        offered = int(row.get("offered", 0))
        admitted = int(row.get("admitted", 0))
        shed = int(row.get("shed", 0))
        total_offered += offered
        if admitted + shed != offered:
            out.append({"slo": "tenant_fairness", "tenant": name,
                        "kind": "parity",
                        "detail": f"admitted {admitted} + shed {shed} != "
                                  f"offered {offered}"})
    if total_offered < MIN_TENANT_OFFERED:
        return out
    for name, row in sorted(tenants.items()):
        if not row.get("honest", False):
            continue
        offered = int(row.get("offered", 0))
        shed = int(row.get("shed", 0))
        if offered > 0 and shed * 100 > budget_pct * offered:
            out.append({"slo": "tenant_fairness", "tenant": name,
                        "kind": "starved", "shed": shed, "offered": offered,
                        "budget_pct": budget_pct,
                        "detail": f"honest tenant shed {shed}/{offered} "
                                  f"(> {budget_pct}%)"})
    return out


def _budget_ms(slo: SLO, opts: Optional[SentinelOptions] = None) -> int:
    return (opts or SentinelOptions()).budget(slo.budget_flag)


def _budget_default_ms(slo: SLO) -> int:
    return SLO_DEFAULTS[slo.budget_flag]


def _bad_from_bucket(threshold_ns: int) -> int:
    """The first log2 bucket whose lower bound is at least twice the
    budget: only samples provably over 2x the budget spend error budget
    (one bucket of slack)."""
    return min((2 * threshold_ns - 1).bit_length() + 1, flight.N_BUCKETS)


@dataclass
class _SloState:
    alerting: bool = False
    alerts: int = 0
    breach_polls: int = 0
    burn_milli: int = 0


class Sentinel:
    """One run's SLO evaluator. poll() reads the shared rows and does
    integer math; start() runs it on a daemon thread every interval.
    The runner stops it before leaving the workspace (its thread reads
    the mapped rows). edges_fn() -> {edge: raw row}, tiles_fn() ->
    {tile: (signal, heartbeat)}, metrics_fn() -> {tile: {metric: value}}
    and clock are injectable."""

    def __init__(self, wksp=None, pod=None,
                 edges_fn: Optional[Callable] = None,
                 tiles_fn: Optional[Callable] = None,
                 metrics_fn: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None,
                 opts: Optional[SentinelOptions] = None):
        opts = as_options(opts)
        self.opts = opts
        self._wksp = wksp
        self._clock = clock or time.monotonic
        self._edges_fn = edges_fn or (
            (lambda: flight.read_edges_raw(wksp) or {}) if wksp is not None
            else (lambda: {}))
        self._tiles_fn = tiles_fn or self._make_pod_tiles_fn(wksp, pod)
        self._metrics_fn = metrics_fn or (
            (lambda: flight.read_tiles(wksp) or {}) if wksp is not None
            else (lambda: {}))
        self.rec = flight.recorder("sentinel")
        self.burn = float(opts.burn)
        self.fast_s = float(opts.fast_s)
        self.slow_s = float(opts.slow_s)
        self.interval_s = max(0.01, opts.interval_ms / 1e3)
        self.budgets_ms = {s.name: _budget_ms(s, opts) for s in SLO_TABLE}
        cap = int(self.slow_s / self.interval_s) + 8
        self._hist: deque = deque(maxlen=max(cap, 8))
        self._rows = {}
        for s in SLO_TABLE:
            row = flight.slo_row(wksp, s.name) if wksp is not None else None
            if row is None:
                row = np.zeros(flight.SLO_SLOTS, np.uint64)
            self._rows[s.name] = row
        self._state: Dict[str, _SloState] = {
            s.name: _SloState() for s in SLO_TABLE}
        self.alerts: List[dict] = []
        self.evals = 0
        self._progress_totals: Optional[int] = None
        self._progress_last_change: Optional[float] = None
        self._hb_seen: Dict[str, Tuple[int, float]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._stopped = False

    @staticmethod
    def _make_pod_tiles_fn(wksp, pod):
        """A heartbeat reader over every cnc the pod names."""
        if wksp is None or pod is None:
            return lambda: {}
        from ..tango.rings import Cnc

        cncs = {}
        try:
            fd = pod.subpod("firedancer").to_dict()
        except Exception:  # noqa: BLE001 - a pod without the tree
            fd = {}

        def walk(tree, prefix=""):
            for name, sub in sorted(tree.items()):
                if not isinstance(sub, dict):
                    continue
                dotted = f"{prefix}.{name}" if prefix else name
                if "cnc" in sub:
                    try:
                        cncs[dotted] = Cnc(wksp, sub["cnc"])
                    except Exception:  # noqa: BLE001 - skip a missing cnc
                        pass
                walk(sub, dotted)

        walk(fd)

        def read():
            out = {}
            for name, cnc in cncs.items():
                try:
                    out[name] = (cnc.signal_query(), cnc.heartbeat_query())
                except Exception:  # noqa: BLE001 - skip it this poll
                    continue
            return out

        return read

    # -- evaluation ------------------------------------------------------

    def _window_delta(self, now: float, window_s: float, edge_labels,
                      cur: Dict[str, np.ndarray]):
        """The bucket counts added over the window on the labels, from
        the latest history entry at least window_s old; None while the
        history is shorter."""
        base = None
        for t, snap in self._hist:
            if t <= now - window_s:
                base = snap
            else:
                break
        if base is None:
            return None
        delta = np.zeros(flight.N_BUCKETS, np.int64)
        for label in edge_labels:
            c = cur.get(label)
            if c is None:
                continue
            b = base.get(label)
            d = c[1:].astype(np.int64)
            if b is not None:
                d = d - b[1:].astype(np.int64)
            delta += d
        return delta

    def _edge_labels_for(self, slo: SLO, cur) -> List[str]:
        e = slo.edge_or_stage
        return [label for label in cur
                if label == e or label.startswith(e + ".v")]

    def _eval_latency(self, slo: SLO, now: float, cur) -> Tuple[bool, int]:
        bad_from = _bad_from_bucket(self.budgets_ms[slo.name] * 1_000_000)
        err_budget = max(1e-9, 1.0 - slo.target)
        labels = self._edge_labels_for(slo, cur)
        if not labels:
            return False, 0
        burns = []
        for w in (self.fast_s, self.slow_s):
            delta = self._window_delta(now, w, labels, cur)
            if delta is None:
                return False, 0
            n = int(delta.sum())
            if n < MIN_WINDOW_N:
                return False, 0
            bad = int(delta[bad_from:].sum())
            burns.append((bad / n) / err_budget)
        breach = all(b >= self.burn for b in burns)
        return breach, int(max(burns) * 1000)

    def _eval_balance(self, slo: SLO, now: float) -> Tuple[bool, int]:
        """Shard occupancy over the <tile>.shardN rows (none in the port
        before multi-GPU: no data)."""
        rows = self._metrics_fn() or {}
        budget_pct = self.budgets_ms[slo.name]
        groups: Dict[str, list] = {}
        for label, m in rows.items():
            base, sep, idx = label.rpartition(".shard")
            if not sep or not idx.isdigit():
                continue
            groups.setdefault(base, []).append(int(m.get("lanes", 0)))
        breach = False
        worst_milli = 0
        for occ in groups.values():
            if len(occ) < 2:
                continue
            if sum(occ) < MIN_SHARD_LANES * len(occ):
                continue
            lo, hi = min(occ), max(occ)
            ratio_milli = int(hi * 1000 / lo) if lo else (1 << 30)
            worst_milli = max(worst_milli, ratio_milli)
            if lo == 0 or hi * 100 > budget_pct * lo:
                breach = True
        return breach, worst_milli

    def _eval_drain_eff(self, slo: SLO, now: float) -> Tuple[bool, int]:
        """The novel share of the drain's published claims, summed over
        the tiles' rows, once MIN_DRAIN_CLAIMS published."""
        rows = self._metrics_fn() or {}
        novel = maybe = 0
        for m in rows.values():
            novel += int(m.get("drain_novel", 0))
            maybe += int(m.get("drain_maybe", 0))
        total = novel + maybe
        if total < MIN_DRAIN_CLAIMS:
            return False, 0
        pct = self.budgets_ms[slo.name]
        return novel * 100 < pct * total, int(novel * 1000 / total)

    def _eval_slope(self, slo: SLO, now: float) -> Tuple[bool, int]:
        src = _SLOPE_SOURCE
        if src is None:
            return False, 0
        try:
            d = src() or {}
        except Exception:  # noqa: BLE001 - a dying probe, no verdict
            return False, 0
        if int(d.get("samples") or 0) < MIN_SLOPE_SAMPLES:
            return False, 0
        v = d.get(_SLOPE_KEYS[slo.edge_or_stage])
        if v is None:
            return False, 0
        budget = max(1, self.budgets_ms[slo.name])
        milli = max(0, int(float(v) * 1000 / budget))
        return float(v) > budget, milli

    def _eval_fairness(self, slo: SLO, now: float) -> Tuple[bool, int]:
        src = _TENANT_SOURCE
        if src is None:
            return False, 0
        try:
            tenants = src() or {}
        except Exception:  # noqa: BLE001 - a dying source, no verdict
            return False, 0
        total = sum(int(r.get("offered", 0)) for r in tenants.values())
        if total < MIN_TENANT_OFFERED:
            return False, 0
        budget_pct = self.budgets_ms[slo.name]
        breach = False
        worst_milli = 0
        for row in tenants.values():
            if not row.get("honest", False):
                continue
            offered = int(row.get("offered", 0))
            shed = int(row.get("shed", 0))
            if offered <= 0:
                continue
            worst_milli = max(worst_milli, int(shed * 1000 / offered))
            if shed * 100 > budget_pct * offered:
                breach = True
        return breach, worst_milli

    def _eval_progress(self, slo: SLO, now: float, cur) -> Tuple[bool, int]:
        total = sum(int(row[1:].sum()) for row in cur.values())
        if self._progress_totals is None or total != self._progress_totals:
            self._progress_totals = total
            self._progress_last_change = now
        if not total or self._progress_last_change is None:
            return False, 0
        stall_ms = int((now - self._progress_last_change) * 1e3)
        return stall_ms > self.budgets_ms[slo.name], stall_ms

    def _eval_heartbeat(self, slo: SLO, now: float) -> Tuple[bool, int, list]:
        worst_ms = 0
        stalled = []
        for name, (signal, hb) in self._tiles_fn().items():
            if signal != 1 or not hb:
                self._hb_seen.pop(name, None)
                continue
            seen = self._hb_seen.get(name)
            if seen is None or seen[0] != hb:
                self._hb_seen[name] = (hb, now)
                continue
            age_ms = int((now - seen[1]) * 1e3)
            worst_ms = max(worst_ms, age_ms)
            if age_ms > self.budgets_ms[slo.name]:
                stalled.append(name)
        return bool(stalled), worst_ms, stalled

    def poll(self, now: Optional[float] = None) -> None:
        """One evaluation pass over every SLO."""
        if now is None:
            now = self._clock()
        cur = {label: np.asarray(row, np.uint64).copy()
               for label, row in self._edges_fn().items()}
        self.evals += 1
        for slo in SLO_TABLE:
            detail: dict = {}
            if slo.kind == "latency":
                breach, burn_milli = self._eval_latency(slo, now, cur)
            elif slo.kind == "balance":
                breach, burn_milli = self._eval_balance(slo, now)
            elif slo.kind == "effectiveness":
                breach, burn_milli = self._eval_drain_eff(slo, now)
            elif slo.kind == "slope":
                breach, burn_milli = self._eval_slope(slo, now)
            elif slo.kind == "fairness":
                breach, burn_milli = self._eval_fairness(slo, now)
            elif slo.edge_or_stage == "progress":
                breach, burn_milli = self._eval_progress(slo, now, cur)
            else:
                breach, burn_milli, stalled = self._eval_heartbeat(slo, now)
                if stalled:
                    detail["tiles"] = stalled
            st = self._state[slo.name]
            st.burn_milli = burn_milli
            if breach:
                st.breach_polls += 1
                if not st.alerting:
                    st.alerting = True
                    st.alerts += 1
                    alert = {
                        "slo": slo.name,
                        "slo_kind": slo.kind,
                        "edge_or_stage": slo.edge_or_stage,
                        "burn_milli": burn_milli,
                        "budget_ms": self.budgets_ms[slo.name],
                        "fault_classes": list(slo.fault_classes),
                        **detail,
                    }
                    self.alerts.append(alert)
                    self.rec.record("slo_alert", **alert)
            elif st.alerting:
                st.alerting = False
                self.rec.record("slo_clear", slo=slo.name,
                                burn_milli=burn_milli)
            row = self._rows[slo.name]
            row[flight.SLO_EVALS] += np.uint64(1)
            row[flight.SLO_ALERTS] = np.uint64(st.alerts)
            row[flight.SLO_BREACH_POLLS] = np.uint64(st.breach_polls)
            row[flight.SLO_BURN_MILLI] = np.uint64(max(burn_milli, 0))
            row[flight.SLO_STATE] = np.uint64(1 if st.alerting else 0)
        self._hist.append((now, cur))

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Sentinel":
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.poll()
                except Exception as e:  # noqa: BLE001 - recorded, then out
                    # The judge never takes the run down, and its death
                    # is not silent: the dump shows it.
                    self.rec.record("sentinel_error", err=repr(e)[:200])
                    return

        self._thread = threading.Thread(target=loop, name="fd_sentinel",
                                        daemon=True)
        self._thread.start()
        return self

    def alive(self) -> bool:
        """The poller thread exists and has not exited: while it lives
        the runner must not leave the workspace."""
        return self._thread is not None and self._thread.is_alive()

    def stop(self) -> dict:
        """Stop the poller (idempotent), run a last pass once its thread
        is gone, return the summary (PipelineResult.slo)."""
        if not self._stopped:
            self._stop.set()
            if self._thread is not None:
                self._thread.join(timeout=10.0)
            if self._thread is None or not self._thread.is_alive():
                try:
                    self.poll()
                except Exception:  # noqa: BLE001 - the summary stands
                    pass
            self._stopped = True
        return self.summary()

    def summary(self) -> dict:
        return {
            "evals": self.evals,
            "alert_cnt": len(self.alerts),
            "alerts": list(self.alerts),
            "slos": {
                name: {"state": "alert" if st.alerting else "ok",
                       "alerts": st.alerts,
                       "breach_polls": st.breach_polls,
                       "burn_milli": st.burn_milli}
                for name, st in self._state.items()
            },
        }


def start_for_run(wksp, pod=None, opts=None) -> Optional[Sentinel]:
    """A started Sentinel over the run's workspace when the options
    enable it, else None. The caller stops it."""
    opts = as_options(opts)
    if not opts.enabled:
        return None
    return Sentinel(wksp, pod, opts=opts).start()


def evaluate_edges_summary(edges: Dict[str, dict],
                           budgets_ms: Optional[Dict[str, int]] = None,
                           ) -> List[dict]:
    """The latency rule over edge summaries (a dump's "edges",
    PipelineResult.stage_hist): p99_ns_le at most twice the budget, one
    window over the whole run. Non-summary entries are ignored. The
    violations; [] is clean."""
    budgets = budgets_ms or {s.name: _budget_ms(s) for s in SLO_TABLE}
    out = []
    for slo in SLO_TABLE:
        if slo.kind != "latency":
            continue
        labels = [label for label in (edges or {})
                  if label == slo.edge_or_stage
                  or label.startswith(slo.edge_or_stage + ".v")]
        for label in labels:
            s = edges[label]
            if not isinstance(s, dict) or not s.get("n") \
                    or "p99_ns_le" not in s:
                continue
            limit = 2 * budgets[slo.name] * 1_000_000
            if s["p99_ns_le"] > limit:
                out.append({"slo": slo.name, "edge": label,
                            "p99_ns_le": s["p99_ns_le"],
                            "limit_ns": limit, "n": s["n"]})
    return out


_SLOPE_UNITS = {"heap": "KiB/min", "slot_pool": "milli-slots/min",
                "compile_cache": "entries/h"}


def dump_slo_markdown() -> str:
    """The SLO table as markdown: the JAX package's "SLO table" section
    (its rules and one row an SLO with the default budget)."""
    lines = [
        "# SLOs",
        "",
        "Generated from the typed spec",
        "(`firedancer_tpu_torch/disco/sentinel.py`, `dump_slo_markdown`).",
        "",
        "## SLO table",
        "",
        "Latency SLOs consume the log2 edge histograms: a sample counts",
        "against the error budget (1 - target) only when it is provably",
        "> 2x the budget (one log2 bucket of slack, the docs/LATENCY.md",
        "rule), and an alert fires only when the burn rate is >=",
        "`FD_SLO_BURN` in BOTH the fast and the slow window. Liveness",
        "SLOs alert when the stall exceeds the budget outright.",
        "Balance SLOs (fd_pod) compare per-shard dispatched-lane",
        "occupancy across the `<tile>.shardN` flight rows: armed once",
        "every shard has real volume, breached when the busiest/laziest",
        "ratio exceeds the budget (stated in percent, not ms).",
        "Effectiveness SLOs (fd_drain) watch the verify tiles'",
        "published claim counters: armed once real claim volume has",
        "published (an `FD_DRAIN=off` run publishes none and stays",
        "silent), breached when the definitely-novel share falls below",
        "the budget percentage.",
        "Slope SLOs (fd_soak) are the long-horizon resource-growth",
        "tripwires: armed only when a soak run registers a slope",
        "source (`sentinel.set_slope_source` — ordinary runs never",
        "arm them) with at least MIN_SLOPE_SAMPLES probe samples,",
        "breached when the least-squares trend of the sampled",
        "resource (tracemalloc heap, outstanding feed slots, engine-",
        "cache entries) exceeds the budget — stated per resource in",
        "KiB/min, milli-slots/min, and entries/hour respectively.",
        "The fairness SLO (fd_fabric) watches the per-tenant admission",
        "ledger: armed only when a fabric run registers a tenant source",
        "(`sentinel.set_tenant_source` — ordinary runs never arm it)",
        "with at least MIN_TENANT_OFFERED offered transactions,",
        "breached when any HONEST tenant's shed fraction exceeds the",
        "budget percentage (an over-offering attacker being shed is",
        "the defense working, never a breach).",
        "",
        "| SLO | kind | edge / stage | budget (default) | target |"
        " trips on (chaos class) | objective |",
        "|---|---|---|---|---|---|---|",
    ]
    for s in SLO_TABLE:
        if s.kind == "slope":
            unit = _SLOPE_UNITS[s.edge_or_stage]
        else:
            unit = ("%" if s.kind in ("balance", "effectiveness",
                                      "fairness") else "ms")
        budget = f"`{s.budget_flag}` = {_budget_default_ms(s)} {unit}"
        target = f"p{int(s.target * 100)}" if s.kind == "latency" else "—"
        faults = ", ".join(s.fault_classes) if s.fault_classes else "—"
        lines.append(
            f"| `{s.name}` | {s.kind} | `{s.edge_or_stage}` | {budget} | "
            f"{target} | {faults} | {s.objective} |")
    lines.append("")
    return "\n".join(lines)
