"""fd_flight, the metric registry, trace spans and flight recorder: the
counterpart of ``firedancer_tpu/disco/flight.py`` (the specs :84-216,
the regions :229-315, ``TileLane``:317, ``EdgeHist``:367, the readers
:461-513, the merges :533-595, ``verify_stats_view``:598,
``render_prom``:648, the compile records :724-766, the recorder
:773-948).

REGISTRY  ``pipeline.build_topology`` creates three regions in the
          tango workspace: ``flight.metrics`` (one row of u64 slots per
          tile, ``TILE_METRICS``), ``flight.edges`` (one log2 latency
          histogram per link edge, the stager's ``verify_drain``, the
          end-to-end ``sink`` and ``quic_ingest``) and ``flight.slo``
          (one row per fd_sentinel SLO), each with a magic and
          self-describing 32-byte labels. The layout is the JAX
          package's byte for byte (both bind the one
          ``build/libfdtango.so``), so either package's readers read
          the other's rows. Tiles, the feed's stager and dispatcher and
          the worker processes attach by label. Every row has one
          writer.
SPANS     a txn's trace id is its 32-bit ``tsorig`` stamp, minted at
          the source's publish. Every out-link publish observes
          ``(tspub - tsorig) & 0xFFFFFFFF`` into its edge's histogram,
          the bulk publishes a batch in one ``observe_many``.
RECORDER  a ring of the last ``events`` events of each tile
          (dispatches, flush verdicts, breaker transitions,
          quarantines, restarts, reconfigs, chaos injections, HALT),
          dumped to JSON on a crash, at HALT and on SIGUSR1 when
          ``dump_dir`` names a directory; a dump also carries fd_xray's
          exemplar spans and queue rows (``disco.xray``).

The JAX flags are options here (``FlightOptions``: ``enabled`` the JAX
``FD_FLIGHT``, ``events`` ``FD_FLIGHT_EVENTS``, ``dump_dir``
``FD_FLIGHT_DUMP``, ``metrics_prom`` ``FD_METRICS_PROM``, with their
defaults). A runner installs its run's options for the run
(``configured``) and a worker process for its life (``configure``);
tiles read them when they are built, never per frag. With ``enabled``
False the recorders and the span histograms are off and the metric
lanes stay on (``verify_stats`` is a view over them), as in the JAX
package.

A lane's increment is a Python int add; ``TileLane.publish`` folds the
local values into the shared row at housekeeping (counters as deltas,
gauges last write wins). Compile accounting: the port compiles no graph,
so ``record_compile`` books each engine's warm (the kernels' build at
first use and the warm batch; ``disco.engine.EngineEntry.warm``), and a
cache hit is a warm whose build found every library already built.

numpy and the standard library only: no torch, no JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..tango import tempo

# The artifact schema of the flight dumps (the JAX package's).
ARTIFACT_SCHEMA_VERSION = 3

_U64 = (1 << 64) - 1


# -- options ------------------------------------------------------------------


@dataclass(frozen=True)
class FlightOptions:
    """A run's fd_flight options, the JAX flags FD_FLIGHT,
    FD_FLIGHT_EVENTS, FD_FLIGHT_DUMP and FD_METRICS_PROM with their
    defaults."""

    enabled: bool = True                 # recorders and span histograms
    events: int = 256                    # ring capacity of each recorder
    dump_dir: Optional[str] = None       # flight dumps on crash/HALT/signal
    metrics_prom: Optional[str] = None   # Prometheus text after each run

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


_OPTS = FlightOptions()


def as_options(spec) -> FlightOptions:
    """FlightOptions from None (the options in force), a bool (enabled,
    the rest default), a dict of fields or FlightOptions."""
    if spec is None:
        return _OPTS
    if isinstance(spec, FlightOptions):
        return spec
    if isinstance(spec, bool):
        return FlightOptions(enabled=spec)
    if isinstance(spec, dict):
        return FlightOptions(**spec)
    raise TypeError(f"flight options: want None, bool, dict or "
                    f"FlightOptions, got {type(spec).__name__}")


def options() -> FlightOptions:
    return _OPTS


def configure(spec) -> FlightOptions:
    """Install options for this process (a worker's life)."""
    global _OPTS
    _OPTS = as_options(spec)
    return _OPTS


@contextlib.contextmanager
def configured(spec):
    """Install options for the with block (a run) and restore the
    previous ones afterwards, also when the block raises."""
    global _OPTS
    prev = _OPTS
    _OPTS = as_options(spec)
    try:
        yield _OPTS
    finally:
        _OPTS = prev


def enabled() -> bool:
    """The recorders and span histograms are on (FD_FLIGHT). Read where
    a handle is built, never per frag."""
    return _OPTS.enabled


# -- metric specs -------------------------------------------------------------


@dataclass(frozen=True)
class Metric:
    name: str
    kind: str          # "counter" (delta-accumulated) | "gauge"
    doc: str


# One row of these per tile in the flight.metrics region (the JAX order,
# kinds and docs); tiles leave the slots they never write at 0.
TILE_METRICS: Tuple[Metric, ...] = (
    Metric("batches", "counter", "verify batches dispatched"),
    Metric("lanes", "counter",
           "signature lanes in dispatched batches (fill_ratio = lanes / "
           "(batches * batch))"),
    Metric("flush_timeout", "counter",
           "partial batches flushed by deadline expiry (ROADMAP round-6 "
           "gate: ~0 at steady state)"),
    Metric("flush_starved", "counter",
           "partial batches flushed by the starved-input early-out"),
    Metric("inflight_stall", "counter",
           "dispatches that blocked on the in-flight batch cap"),
    Metric("rlc_fallback", "counter",
           "batches that took the per-lane fallback after the RLC batch "
           "equation failed"),
    Metric("cpu_failover", "counter",
           "batches served by the CPU oracle lane (breaker open or "
           "dispatch error)"),
    Metric("quarantined", "counter",
           "poisoned batches re-verified on the CPU oracle lane at "
           "completion"),
    Metric("quarantine_err_txn", "counter",
           "quarantine offenders published downstream as CTL_ERR audit "
           "frags"),
    Metric("ctl_err_drop", "counter",
           "producer-flagged CTL_ERR frags dropped at the ctl word"),
    Metric("stager_restarts", "counter",
           "fd_feed stager-thread supervision respawns"),
    Metric("slot_stall", "counter",
           "stager slot acquires that had to wait for a FREE slot"),
    Metric("feed_idle_ns", "counter",
           "dispatcher device-idle estimate (nothing in flight AND "
           "nothing READY), ns"),
    Metric("compile_cnt", "counter",
           "verify-engine (pre)compiles paid by this tile"),
    Metric("compile_ns", "counter",
           "total wall ns spent in verify-engine (pre)compiles"),
    Metric("compile_cache_hit", "counter",
           "(pre)compiles that resolved fast enough to be persistent-"
           "cache hits (< 1 s heuristic)"),
    Metric("rung_switches", "counter",
           "fd_engine rung-scheduler target-B changes (ladder moves "
           "between the 8k/16k/32k-style rungs)"),
    Metric("rung_cur", "gauge",
           "current fd_engine scheduler target B (0 = scheduler off)"),
    Metric("breaker_state", "gauge",
           "verify failover breaker state: 0 closed, 1 open, 2 half_open, "
           "3 disabled/absent"),
    Metric("breaker_trips", "gauge",
           "times the failover circuit opened from closed"),
    Metric("breaker_reprobes", "gauge",
           "half-open device re-probes attempted"),
    Metric("admit_shed", "counter",
           "txns shed by per-connection token-bucket admission at the "
           "QUIC tile (FD_QUIC_ADMIT_RATE/_BURST)"),
    Metric("queue_shed", "counter",
           "txns shed by credit-aware lowest-priority load shedding "
           "when the front-door ready queue exceeds FD_QUIC_SHED_DEPTH"),
    Metric("conn_quarantine", "counter",
           "abusive peers quarantined by the connection-level circuit "
           "breaker (FD_QUIC_ABUSE_THRESHOLD trips within 1 s)"),
    Metric("quarantine_drop", "counter",
           "datagrams dropped at the socket from quarantined peers "
           "(cooldown window; half-open re-admit after it)"),
    Metric("drain_batches", "counter",
           "verify batches dispatched with the fused fd_drain dedup "
           "pre-filter aux graph"),
    Metric("drain_novel", "counter",
           "published clean txns the device filter claimed DEFINITELY "
           "novel (ctl CTL_NOVEL set)"),
    Metric("drain_maybe", "counter",
           "published clean txns left maybe-dup (host TCache stays the "
           "authority)"),
    Metric("drain_rot", "counter",
           "fd_drain filter window rotations (bank B <- A after the "
           "eviction-covering publish quota)"),
    Metric("drain_probe_skip", "counter",
           "clean frags whose dup verdict came from the device novel "
           "claim — the TCache probe skipped as decision authority"),
    Metric("drain_probed", "counter",
           "clean frags probed against the host TCache (maybe-dup "
           "lanes)"),
    Metric("drain_false_novel", "counter",
           "tripwire: novel claims the TCache contradicted (one-sided "
           "contract breach; frag dropped as duplicate, ~0 always)"),
    Metric("pack_wave_device", "counter",
           "pack waves published from device pack_gc wave colors"),
    Metric("pack_block_device", "counter",
           "pack blocks whose device schedule validated and beat (or "
           "tied) CPU greedy rewards/CU"),
    Metric("pack_sched_fallback", "counter",
           "pack blocks that fell back to the exact CPU greedy "
           "schedule (validation miss or losing rewards/CU)"),
    Metric("reconfigs", "counter",
           "live reconfigs applied at the inflight-window barrier "
           "(ladder swap / engine-flag flip / drain-mode change, zero "
           "dropped txns by construction)"),
    Metric("reconfig_refused", "counter",
           "live reconfig requests refused at validation (invalid "
           "mode/backend combo, unusable ladder, or a swap already "
           "pending)"),
)

TILE_IDX: Dict[str, int] = {m.name: i for i, m in enumerate(TILE_METRICS)}
_TILE_KIND: Tuple[str, ...] = tuple(m.kind for m in TILE_METRICS)

BREAKER_STATE_CODE = {"closed": 0, "open": 1, "half_open": 2, "disabled": 3}
BREAKER_STATE_NAME = {v: k for k, v in BREAKER_STATE_CODE.items()}

# An edge row: [sum_ns, bucket_0 .. bucket_{N-1}]; bucket b counts
# samples of bit_length b (ns in [2^(b-1), 2^b)), the last one clamps.
N_BUCKETS = 40
EDGE_SLOTS = 1 + N_BUCKETS

# Region header [magic, n_rows, n_slots, 0]; a row is 4 u64 of utf-8
# label (32 bytes, NUL-padded) and n_slots u64.
_METRICS_REGION = "flight.metrics"
_EDGES_REGION = "flight.edges"
_SLO_REGION = "flight.slo"
_MAGIC_TILES = 0xF11687_0001
_MAGIC_EDGES = 0xF11687_0002
_MAGIC_SLO = 0xF11687_0003
_LABEL_U64 = 4

# An SLO row: [evals, alerts, breach_polls, burn_milli, state]; the
# sentinel of the run is its one writer.
SLO_SLOTS = 5
SLO_EVALS, SLO_ALERTS, SLO_BREACH_POLLS, SLO_BURN_MILLI, SLO_STATE = range(5)


def _region_footprint(n_rows: int, n_slots: int) -> int:
    return 8 * (4 + n_rows * (_LABEL_U64 + n_slots))


def _pack_label(label: str) -> bytes:
    b = label.encode()[: _LABEL_U64 * 8 - 1]
    return b + b"\x00" * (_LABEL_U64 * 8 - len(b))


def _view(wksp, region: str) -> np.ndarray:
    return np.frombuffer(wksp.view(region), np.uint64)


def create_regions(wksp, tile_labels, edge_labels, slo_labels=()) -> None:
    """Allocate and label the registry regions (build_topology); no
    slo_labels skips the SLO region."""
    regions = [
        (_METRICS_REGION, _MAGIC_TILES, tile_labels, len(TILE_METRICS)),
        (_EDGES_REGION, _MAGIC_EDGES, edge_labels, EDGE_SLOTS),
    ]
    if slo_labels:
        regions.append((_SLO_REGION, _MAGIC_SLO, slo_labels, SLO_SLOTS))
    for region, magic, labels, n_slots in regions:
        labels = list(labels)
        wksp.alloc(region, _region_footprint(len(labels), n_slots))
        a = _view(wksp, region)
        a[:] = 0
        a[0] = magic
        a[1] = len(labels)
        a[2] = n_slots
        for i, label in enumerate(labels):
            row = 4 + i * (_LABEL_U64 + n_slots)
            a[row: row + _LABEL_U64] = np.frombuffer(
                _pack_label(label), np.uint64)


def _region_rows(wksp, region: str, magic: int, n_slots: int):
    """[(label, u64 row view)] of a region, None when the workspace lacks
    it or it has another layout."""
    try:
        a = _view(wksp, region)
    except KeyError:
        return None
    if a.size < 4 or int(a[0]) != magic or int(a[2]) != n_slots:
        return None
    out = []
    for i in range(int(a[1])):
        row = 4 + i * (_LABEL_U64 + n_slots)
        label = a[row: row + _LABEL_U64].tobytes().split(b"\x00")[0]
        out.append((label.decode("utf-8", "replace"),
                    a[row + _LABEL_U64: row + _LABEL_U64 + n_slots]))
    return out


def _attach_row(wksp, region: str, magic: int, n_slots: int, label: str):
    if wksp is None:
        return None
    try:
        rows = _region_rows(wksp, region, magic, n_slots)
    except Exception:  # noqa: BLE001 - a raw workspace: a local row
        return None
    for lab, row in rows or ():
        if lab == label:
            return row
    return None


# -- writers ------------------------------------------------------------------


class TileLane:
    """One tile's metric row. inc and set_gauge write a local list of
    Python ints; publish folds it into the shared row (counters as
    deltas, so a second incarnation accumulates; gauges last write
    wins). Each metric has one writing thread."""

    __slots__ = ("label", "v", "_shm", "_last")

    def __init__(self, label: str, shm_row=None):
        self.label = label
        self.v = [0] * len(TILE_METRICS)
        self._shm = shm_row
        self._last = [0] * len(TILE_METRICS)

    @property
    def shared(self) -> bool:
        return self._shm is not None

    def inc(self, name: str, n: int = 1) -> None:
        self.v[TILE_IDX[name]] += n

    def set_gauge(self, name: str, v: int) -> None:
        self.v[TILE_IDX[name]] = int(v)

    def get(self, name: str) -> int:
        return self.v[TILE_IDX[name]]

    def publish(self) -> None:
        if self._shm is None:
            return
        # A snapshot first: another thread's increment that lands during
        # the publish is carried by the next one.
        cur = list(self.v)
        last = self._last
        if cur == last:
            return
        shm = self._shm
        for i, kind in enumerate(_TILE_KIND):
            if kind == "counter":
                d = cur[i] - last[i]
                if d:
                    shm[i] = (int(shm[i]) + d) & _U64
            elif cur[i] != int(shm[i]):
                shm[i] = cur[i] & _U64
        self._last = cur

    def as_dict(self) -> Dict[str, int]:
        return {m.name: self.v[i] for i, m in enumerate(TILE_METRICS)}


class EdgeHist:
    """The log2 latency histogram of one edge, written in place (the
    shared row, or a local one); one producing thread an edge."""

    __slots__ = ("label", "row")

    def __init__(self, label: str, row=None):
        self.label = label
        self.row = row if row is not None else np.zeros(EDGE_SLOTS, np.uint64)

    def observe(self, ns: int) -> None:
        ns = int(ns)
        b = ns.bit_length()
        if b >= N_BUCKETS:
            b = N_BUCKETS - 1
        row = self.row
        row[0] = (int(row[0]) + ns) & _U64   # sum_ns wraps mod 2^64
        row[1 + b] += 1

    def observe_many(self, ns_arr) -> None:
        """A batch of samples in one call (the bulk publishes), bucketed
        as the JAX package does (floor log2 + 1, clamped)."""
        a = np.asarray(ns_arr, np.int64)
        if a.size == 0:
            return
        b = np.zeros(a.shape, np.int64)
        pos = a > 0
        b[pos] = np.floor(np.log2(a[pos])).astype(np.int64) + 1
        np.clip(b, 0, N_BUCKETS - 1, out=b)
        self.row[1:] += np.bincount(b, minlength=N_BUCKETS).astype(np.uint64)
        self.row[0] = (int(self.row[0]) + int(a.sum())) & _U64

    def count(self) -> int:
        return int(self.row[1:].sum())

    def percentile_ns(self, q: float) -> int:
        """Upper bound of the bucket holding the q-quantile (factor-2
        resolution over the whole population)."""
        buckets = self.row[1:]
        n = int(buckets.sum())
        if n == 0:
            return 0
        target = q * n
        acc = 0
        for b in range(N_BUCKETS):
            acc += int(buckets[b])
            if acc >= target:
                return (1 << b) if b else 0
        return 1 << (N_BUCKETS - 1)

    def summary(self) -> Dict[str, int]:
        return {
            "n": self.count(),
            "p50_ns_le": self.percentile_ns(0.50),
            "p99_ns_le": self.percentile_ns(0.99),
            "sum_ns": int(self.row[0]),
        }


def tile_lane(wksp, label: str) -> TileLane:
    """The tile's lane on its shared row, or a local lane where the
    workspace has no registry row for label."""
    return TileLane(label, _attach_row(wksp, _METRICS_REGION, _MAGIC_TILES,
                                       len(TILE_METRICS), label))


def edge_hist(wksp, label: str) -> EdgeHist:
    return EdgeHist(label, _attach_row(wksp, _EDGES_REGION, _MAGIC_EDGES,
                                       EDGE_SLOTS, label))


def span(wksp, label: Optional[str]) -> Optional[EdgeHist]:
    """An edge's span histogram when flight is enabled and the edge has a
    name, else None (the publish paths test None, not the options)."""
    if not label or not enabled():
        return None
    return edge_hist(wksp, label)


def slo_row(wksp, label):
    return _attach_row(wksp, _SLO_REGION, _MAGIC_SLO, SLO_SLOTS, label)


# -- readers ------------------------------------------------------------------


def read_tiles(wksp) -> Optional[Dict[str, Dict[str, int]]]:
    """{tile: {metric: value}}, None without the region."""
    rows = _region_rows(wksp, _METRICS_REGION, _MAGIC_TILES,
                        len(TILE_METRICS))
    if rows is None:
        return None
    return {label: {m.name: int(row[i]) for i, m in enumerate(TILE_METRICS)}
            for label, row in rows}


def read_edges(wksp) -> Optional[Dict[str, Dict[str, int]]]:
    """{edge: EdgeHist.summary()}, None without the region."""
    rows = _region_rows(wksp, _EDGES_REGION, _MAGIC_EDGES, EDGE_SLOTS)
    if rows is None:
        return None
    return {label: EdgeHist(label, row).summary() for label, row in rows}


def read_edges_raw(wksp) -> Optional[Dict[str, np.ndarray]]:
    """{edge: a copy of its raw row} (mergeable; the sentinel's window
    deltas)."""
    rows = _region_rows(wksp, _EDGES_REGION, _MAGIC_EDGES, EDGE_SLOTS)
    if rows is None:
        return None
    return {label: np.array(row, dtype=np.uint64) for label, row in rows}


def read_slos(wksp) -> Optional[Dict[str, Dict[str, int]]]:
    rows = _region_rows(wksp, _SLO_REGION, _MAGIC_SLO, SLO_SLOTS)
    if rows is None:
        return None
    keys = ("evals", "alerts", "breach_polls", "burn_milli", "state")
    return {label: {k: int(row[i]) for i, k in enumerate(keys)}
            for label, row in rows}


# -- merges: counters sum, histograms add, breaker_state the most severe ------

_BREAKER_SEVERITY = {1: 3, 2: 2, 0: 1, 3: 0}


def merge_tile_metrics(rows) -> Dict[str, int]:
    out = {m.name: 0 for m in TILE_METRICS}
    breaker = 3
    for row in rows:
        for m in TILE_METRICS:
            v = int(row.get(m.name, 0))
            if m.name == "breaker_state":
                if (_BREAKER_SEVERITY.get(v, 0)
                        > _BREAKER_SEVERITY.get(breaker, 0)):
                    breaker = v
            else:
                out[m.name] += v
    out["breaker_state"] = breaker
    return out


def merge_edge_rows(rows) -> np.ndarray:
    out = np.zeros(EDGE_SLOTS, np.uint64)
    sum_ns = 0
    for row in rows:
        a = np.asarray(row, np.uint64)
        out[1:] += a[1:]
        sum_ns = (sum_ns + int(a[0])) & _U64
    out[0] = np.uint64(sum_ns)
    return out


def snapshot_raw(wksp) -> Dict[str, dict]:
    return {"metrics": read_tiles(wksp) or {},
            "edges": read_edges_raw(wksp) or {}}


def merge_snapshots(snaps) -> Dict[str, dict]:
    metric_rows: Dict[str, List[dict]] = {}
    edge_rows: Dict[str, List[np.ndarray]] = {}
    for s in snaps:
        for label, row in (s.get("metrics") or {}).items():
            metric_rows.setdefault(label, []).append(row)
        for label, row in (s.get("edges") or {}).items():
            edge_rows.setdefault(label, []).append(row)
    edges_raw = {label: merge_edge_rows(rows)
                 for label, rows in edge_rows.items()}
    return {
        "metrics": {label: merge_tile_metrics(rows)
                    for label, rows in metric_rows.items()},
        "edges_raw": edges_raw,
        "edges": {label: EdgeHist(label, row).summary()
                  for label, row in edges_raw.items()},
    }


def verify_stats_view(wksp, label: str, batch: int) -> Optional[dict]:
    """The verify_stats record of one tile from the shared rows (the
    cross-process view; the runners read the tile's own lane through
    feed.runtime.verify_tile_stats, with the same lane keys)."""
    tiles = read_tiles(wksp)
    if tiles is None or label not in tiles:
        return None
    t = tiles[label]
    batches = t["batches"]
    return {
        "batches": batches,
        "lanes": t["lanes"],
        "fill_ratio": round(t["lanes"] / float(batches * batch), 4)
        if batches else 0.0,
        "flush_timeout": t["flush_timeout"],
        "flush_starved": t["flush_starved"],
        "inflight_stall": t["inflight_stall"],
        "rlc_fallback": t["rlc_fallback"],
        "slot_stall": t["slot_stall"],
        "device_idle_est_ms": round(t["feed_idle_ns"] / 1e6, 2),
        "stager_restarts": t["stager_restarts"],
        "cpu_failover": t["cpu_failover"],
        "quarantined": t["quarantined"],
        "quarantine_err_txn": t["quarantine_err_txn"],
        "ctl_err_drop": t["ctl_err_drop"],
        "breaker_state": BREAKER_STATE_NAME.get(
            t["breaker_state"], "disabled"),
        "breaker_trips": t["breaker_trips"],
        "breaker_reprobes": t["breaker_reprobes"],
        "compile_cnt": t["compile_cnt"],
        "compile_ms": round(t["compile_ns"] / 1e6, 1),
        "compile_cache_hit": t["compile_cache_hit"],
        "rung_switches": t["rung_switches"],
        "rung_cur": t["rung_cur"],
        "rung_hist": {},
        "rung_ladder": [],
        "drain_batches": t["drain_batches"],
        "drain_novel": t["drain_novel"],
        "drain_maybe": t["drain_maybe"],
        "drain_rot": t["drain_rot"],
    }


def render_prom(wksp) -> str:
    """The registry as Prometheus text (and this process's compile
    records), the JAX package's families and lines."""
    lines: List[str] = []
    tiles = read_tiles(wksp) or {}
    for m in TILE_METRICS:
        prom_kind = "gauge" if m.kind == "gauge" else "counter"
        lines.append(f"# HELP fd_flight_{m.name} {m.doc}")
        lines.append(f"# TYPE fd_flight_{m.name} {prom_kind}")
        for label, t in sorted(tiles.items()):
            lines.append(f'fd_flight_{m.name}{{tile="{label}"}} {t[m.name]}')
    edges = _region_rows(wksp, _EDGES_REGION, _MAGIC_EDGES, EDGE_SLOTS) or []
    lines.append("# HELP fd_flight_edge_latency_ns trace-span latency "
                 "(tsorig -> tspub) per pipeline edge, log2 buckets")
    lines.append("# TYPE fd_flight_edge_latency_ns histogram")
    for label, row in edges:
        acc = 0
        for b in range(N_BUCKETS):
            acc += int(row[1 + b])
            lines.append(f'fd_flight_edge_latency_ns_bucket{{edge="{label}",'
                         f'le="{1 << b}"}} {acc}')
        lines.append(f'fd_flight_edge_latency_ns_bucket{{edge="{label}",'
                     f'le="+Inf"}} {acc}')
        lines.append(f'fd_flight_edge_latency_ns_sum{{edge="{label}"}} '
                     f'{int(row[0])}')
        lines.append(f'fd_flight_edge_latency_ns_count{{edge="{label}"}} '
                     f'{acc}')
    slos = _region_rows(wksp, _SLO_REGION, _MAGIC_SLO, SLO_SLOTS) or []
    if slos:
        fams = (
            ("evals", SLO_EVALS, "counter", "sentinel evaluation passes"),
            ("alerts", SLO_ALERTS, "counter",
             "ok->alert transitions (burn-rate breaches)"),
            ("breach_polls", SLO_BREACH_POLLS, "counter",
             "evaluation passes spent in breach"),
            ("burn_milli", SLO_BURN_MILLI, "gauge",
             "current burn rate x1000 (stall/heartbeat-age ms for "
             "liveness SLOs)"),
            ("state", SLO_STATE, "gauge", "0 ok, 1 alerting"),
        )
        for name, slot, kind, doc in fams:
            lines.append(f"# HELP fd_flight_slo_{name} {doc}")
            lines.append(f"# TYPE fd_flight_slo_{name} {kind}")
            for label, row in slos:
                lines.append(f'fd_flight_slo_{name}{{slo="{label}"}} '
                             f"{int(row[slot])}")
    recs = compile_records()
    lines.append("# HELP fd_flight_compile_seconds verify-engine compile "
                 "wall time per engine key (mode x B x shards x frontend)")
    lines.append("# TYPE fd_flight_compile_seconds gauge")
    for r in recs:
        lines.append(
            f'fd_flight_compile_seconds{{engine="{r["engine"]}",'
            f'cache_hit_est="{str(r["cache_hit_est"]).lower()}"}} '
            f'{r["seconds"]}')
    lines.append("")
    return "\n".join(lines)


def parse_prom(text: str) -> Dict[str, float]:
    """{series: value} of Prometheus text (HELP/TYPE lines checked for
    form); raises ValueError on a malformed line. A reader's check that
    render_prom's output parses."""
    out: Dict[str, float] = {}
    for n, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if parts[1] not in ("HELP", "TYPE") or len(parts) < 4:
                raise ValueError(f"line {n}: bad comment {line!r}")
            continue
        series, _, value = line.rpartition(" ")
        if not series or (("{" in series) != series.endswith("}")):
            raise ValueError(f"line {n}: bad sample {line!r}")
        out[series] = float(value)
    return out


# -- compile accounting (this process's warms) --------------------------------

_compiles: List[dict] = []
_compile_lock = threading.Lock()
_COMPILE_CAP = 256


def record_compile(engine: str, seconds: float, cache_hit: bool) -> dict:
    """Book one engine warm: its key, seconds and whether its build found
    every library built (the record keeps the JAX key cache_hit_est)."""
    rec = {"engine": engine, "seconds": round(seconds, 3),
           "cache_hit_est": bool(cache_hit), "ts": time.time()}
    with _compile_lock:
        _compiles.append(rec)
        del _compiles[:-_COMPILE_CAP]
    return rec


def compile_records() -> List[dict]:
    with _compile_lock:
        return list(_compiles)


# -- the flight recorder ------------------------------------------------------

_recorders: Dict[str, "FlightRecorder"] = {}
_recorders_lock = threading.Lock()


class FlightRecorder:
    """A ring of (tick, kind, fields) events, written under a lock
    (several threads record into one: the chaos injector's note fires
    from the source, the stager and the dispatcher)."""

    __slots__ = ("name", "buf", "pos", "n", "_lock")

    def __init__(self, name: str, cap: int):
        self.name = name
        self.buf: List[Optional[tuple]] = [None] * max(cap, 8)
        self.pos = 0
        self.n = 0
        self._lock = threading.Lock()

    def record(self, kind: str, **fields) -> None:
        t = tempo.tickcount()
        with self._lock:
            self.buf[self.pos] = (t, kind, fields or None)
            self.pos = (self.pos + 1) % len(self.buf)
            self.n += 1

    def events(self) -> List[dict]:
        """The events held, oldest first."""
        with self._lock:
            buf = list(self.buf)
            pos, n = self.pos, self.n
        cap = len(buf)
        start = pos if n >= cap else 0
        out = []
        for i in range(min(n, cap)):
            e = buf[(start + i) % cap]
            if e is None:
                continue
            t, kind, fields = e
            d = {"t": t, "kind": kind}
            if fields:
                d.update(fields)
            out.append(d)
        return out


class _NullRecorder:
    __slots__ = ()
    name = "null"
    n = 0

    def record(self, kind: str, **fields) -> None:
        pass

    def events(self) -> List[dict]:
        return []


_NULL = _NullRecorder()


def recorder(name: str):
    """A fresh recorder registered under name (the latest wins: each
    tile incarnation gets its own ring), a no-op one when flight is
    off."""
    if not enabled():
        return _NULL
    rec = FlightRecorder(name, _OPTS.events)
    with _recorders_lock:
        _recorders[name] = rec
    return rec


def dump(reason: str, wksp=None) -> dict:
    """The postmortem: every recorder's ring, the compile records, the
    fd_xray section (this process's exemplar spans and, given a
    workspace still joined, its queue rows; the JAX :874-897) and, given
    the workspace, the registry's rows. A reader that predates the xray
    section ignores the key."""
    with _recorders_lock:
        recs = dict(_recorders)
    out: dict = {
        "schema_version": ARTIFACT_SCHEMA_VERSION,
        "kind": "fd_flight_dump",
        "reason": reason,
        "pid": os.getpid(),
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "recorders": {name: {"n_total": r.n, "events": r.events()}
                      for name, r in sorted(recs.items())},
        "compiles": compile_records(),
    }
    from . import xray  # xray imports this module

    try:
        out["xray"] = {"spans": xray.dump_spans()}
    except Exception:  # noqa: BLE001 - the dump must not raise
        pass
    # A left workspace's handle is None: reading it would crash.
    if wksp is not None and getattr(wksp, "_h", None):
        try:
            out["metrics"] = read_tiles(wksp)
            out["edges"] = read_edges(wksp)
            out["slos"] = read_slos(wksp)
            if "xray" in out:
                out["xray"]["queue"] = xray.read_queue(wksp)
        except Exception:  # noqa: BLE001 - the dump must not raise
            pass
    return out


def maybe_dump(reason: str, wksp=None,
               opts: Optional[FlightOptions] = None) -> Optional[str]:
    """Write the dump as JSON into opts.dump_dir (the options in force by
    default); the path, or None when no directory is set, flight is off
    or the write failed. Never raises: a failing postmortem must not
    hide the fault it records."""
    opts = opts or _OPTS
    try:
        if not opts.dump_dir or not opts.enabled:
            return None
        os.makedirs(opts.dump_dir, exist_ok=True)
        slug = "".join(c if c.isalnum() else "_" for c in reason)[:48]
        path = os.path.join(opts.dump_dir, f"flight_{os.getpid()}_"
                            f"{int(time.time() * 1e3)}_{slug}.json")
        with open(path, "w") as f:
            json.dump(dump(reason, wksp=wksp), f, indent=1)
        return path
    except Exception:  # noqa: BLE001 - see the docstring
        return None


_dump_target: tuple = (None, _OPTS)


def _on_signal(signum, frame) -> None:
    w, opts = _dump_target
    maybe_dump("signal", wksp=w, opts=opts)


def install_dump_signal(wksp=None) -> None:
    """SIGUSR1 -> a flight dump of wksp into the dump_dir of the options
    in force now. Each call rebinds the workspace and options (a run
    installs it; the handler then reads the current run's rows) and puts
    the handler back if another took SIGUSR1 since; a no-op off the main
    thread or with flight off."""
    global _dump_target
    if not enabled():
        return
    _dump_target = (wksp, _OPTS)
    import signal

    try:
        if signal.getsignal(signal.SIGUSR1) is not _on_signal:
            signal.signal(signal.SIGUSR1, _on_signal)
    except (ValueError, OSError):
        pass  # not the main thread
