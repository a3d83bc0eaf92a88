"""fd_xray, exemplar traces, per-edge queue attribution and autopsies: the
counterpart of ``firedancer_tpu/disco/xray.py`` (``dwell32``:87, the
sampling :144-186, ``SpanRing``:198, ``ring``:260, ``dump_spans``:272,
``SpanCtx``:282, the queue region :333-455, ``waterfall``:494,
``waterfall_reconciles``:545, ``suspect_ranking``:576, ``_top_slowest``:644,
``run_summary``:679, ``build_autopsy``:721, ``maybe_autopsy``:770,
``AutopsyFlusher``:796, ``to_chrome_trace``:861).

EXEMPLARS  full span chains of a sampled subset of txns. Head sampling is
           a pure function of the trace id (the 32-bit ``tsorig`` stamp
           minted at the source's publish): every tile hashes the id with
           the same multiplicative mix and compares it with the same
           threshold, so every stage, thread and worker process samples
           the same txns with no coordination, and the spans of one txn
           meet by id. Tail triggers take any txn past the first log2
           bucket beyond twice its edge's latency budget (the sentinel's
           rule, on the budgets of the run's ``SentinelOptions``), and
           the verify tile records quarantine, breaker and CTL_ERR events.
           Spans land in bounded rings, one writer an edge, ride in every
           flight dump and a worker's result file, and export as Chrome
           trace-event JSON (``tools/fd_xray.py --chrome-trace``).
QUEUE      the ``xray.queue`` workspace region beside the flight registry:
           an rx row an edge (the consumer's sampled dwell, producer
           ``tspub`` to its drain; its idle ns; ring depth samples) and a
           tx row (the producer's credit-stall ns and count; available
           credit samples), one writer a row. Its layout is the JAX
           package's byte for byte, so either package reads the other's
           rows. ``waterfall`` splits each stage's latency into queue
           wait and service; fd_top's XRAY panel shows the rows live.
AUTOPSY    on a sentinel alert (written by the flusher thread, so the
           poller never waits on file IO), a tile's crash and HALT: one
           ``xray_autopsy_*.json`` with the window's exemplars, the
           registry's rows, the waterfall, the chaos injector's state, the
           run's options and a ranking of suspected stages.

The JAX flags are options here (``XrayOptions``: ``enabled`` FD_XRAY,
``sample`` FD_XRAY_SAMPLE, ``ring`` FD_XRAY_RING, ``queue_sample``
FD_XRAY_QUEUE_SAMPLE, ``dir`` FD_XRAY_DIR, with their defaults), installed
for a run as ``flight.FlightOptions`` are (``configured``), together with
the run's sentinel options (the tail thresholds' budgets) and its
``verify_opts``; the autopsy's ``options`` block (the JAX ``flags``) is
that snapshot. ``enabled()`` is the options' and fd_flight's, as in the
JAX package; hot paths test their handles for None.

numpy and the standard library only.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue as _queue
import threading
import time
from dataclasses import asdict, dataclass, fields
from typing import Dict, List, Optional

import numpy as np

from . import flight, sentinel

_U64 = (1 << 64) - 1
_U32 = 0xFFFFFFFF

# The Knuth multiplicative mix over the 32-bit trace id: one constant
# everywhere, so the stages' sampling decisions agree bit for bit.
_HASH_MULT = 0x9E3779B1

# A dwell at or past this is a 32-bit tick-wrap artifact, not a wait.
_DWELL_WRAP_NS = 4_000_000_000


def dwell32(now_ns: int, ts32: int) -> int:
    """A queue dwell from a 32-bit tick stamp against a full-width now,
    or -1 when it cannot be trusted: the modular difference is exact for
    any dwell below 2^32 ns however often the clock wrapped, and one in
    [_DWELL_WRAP_NS, 2^32) is taken as a wrap artifact."""
    d = (int(now_ns) - int(ts32)) & _U32
    return d if d < _DWELL_WRAP_NS else -1


# The trigger classes a span can carry.
TRIGGERS = ("head", "tail", "quarantine", "breaker", "ctl_err", "crash")

# The xray.queue region: an rx row an edge (consumer-written) and a tx
# row (producer-written). rx = an EdgeHist row of dwells + [idle_ns,
# depth_sum, depth_n]; tx = [stall_ns, stall_cnt, cr_sum, cr_n] in the
# leading slots of the same width.
_QUEUE_REGION = "xray.queue"
_MAGIC_QUEUE = 0xF11687_0004
Q_SLOTS = flight.EDGE_SLOTS + 3
RX_IDLE_NS = flight.EDGE_SLOTS
RX_DEPTH_SUM = flight.EDGE_SLOTS + 1
RX_DEPTH_N = flight.EDGE_SLOTS + 2
TX_STALL_NS, TX_STALL_CNT, TX_CR_SUM, TX_CR_N = 0, 1, 2, 3

# The cumulative-edge chain the waterfall decomposes: (consumer stage,
# the ring it drains, the span that marks the stage complete).
STAGE_CHAIN = (
    ("verify", "replay_verify", "verify_dedup"),
    ("dedup", "verify_dedup", "dedup_pack"),
    ("pack", "dedup_pack", "pack_sink"),
    ("sink", "pack_sink", "sink"),
)


# -- options ------------------------------------------------------------------


@dataclass(frozen=True)
class XrayOptions:
    """A run's fd_xray options, the JAX flags FD_XRAY, FD_XRAY_SAMPLE,
    FD_XRAY_RING, FD_XRAY_QUEUE_SAMPLE and FD_XRAY_DIR with their
    defaults."""

    enabled: bool = True          # exemplars, queue rows and autopsies
    sample: int = 64              # head-sample 1 in this many (0: none)
    ring: int = 512               # spans each ring keeps
    queue_sample: int = 16        # every this many drained frags a dwell
    dir: Optional[str] = None     # autopsies on alert, crash and HALT

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


_OPTS = XrayOptions()
# The run's sentinel options (the tail thresholds' and the suspects'
# budgets) and verify_opts (the autopsy's options block).
_SENTINEL = sentinel.SentinelOptions()
_VERIFY_OPTS: Optional[dict] = None


def as_options(spec) -> XrayOptions:
    """XrayOptions from None (the options in force), a bool (enabled, the
    rest default), a dict of fields or XrayOptions."""
    if spec is None:
        return _OPTS
    if isinstance(spec, XrayOptions):
        return spec
    if isinstance(spec, bool):
        return XrayOptions(enabled=spec)
    if isinstance(spec, dict):
        return XrayOptions(**spec)
    raise TypeError(f"xray options: want None, bool, dict or XrayOptions, "
                    f"got {type(spec).__name__}")


def options() -> XrayOptions:
    return _OPTS


def sentinel_options() -> sentinel.SentinelOptions:
    return _SENTINEL


def configure(spec, sentinel_spec=None) -> XrayOptions:
    """Install options for this process (a worker's life); sentinel_spec
    gives the budgets (sentinel.as_options)."""
    global _OPTS, _SENTINEL
    _OPTS = as_options(spec)
    _SENTINEL = sentinel.as_options(sentinel_spec)
    return _OPTS


@contextlib.contextmanager
def configured(spec, sentinel_spec=None, verify_opts=None):
    """Install a run's options for the with block: xray's, the sentinel's
    (the budgets; None keeps those in force) and its verify_opts (None
    keeps them); the previous ones come back afterwards, also when the
    block raises."""
    global _OPTS, _SENTINEL, _VERIFY_OPTS
    prev = (_OPTS, _SENTINEL, _VERIFY_OPTS)
    _OPTS = as_options(spec)
    if sentinel_spec is not None:
        _SENTINEL = sentinel.as_options(sentinel_spec)
    if verify_opts is not None:
        _VERIFY_OPTS = dict(verify_opts)
    try:
        yield _OPTS
    finally:
        _OPTS, _SENTINEL, _VERIFY_OPTS = prev


def enabled() -> bool:
    """xray is on: its options' and fd_flight's (with flight off there are
    no spans to sample from). Read where a handle is built."""
    return _OPTS.enabled and flight.enabled()


def sample_threshold() -> int:
    """The hash threshold of 1-in-sample head sampling (0: none; the tail
    triggers stay armed)."""
    n = _OPTS.sample
    if n <= 0:
        return 0
    return (1 << 32) // n


def sampled(trace_id: int, threshold: Optional[int] = None) -> bool:
    """The one head-sampling decision, a pure function of the trace id;
    id 0 (no source stamp) never samples."""
    if not trace_id:
        return False
    if threshold is None:
        threshold = sample_threshold()
    return ((trace_id * _HASH_MULT) & _U32) < threshold


def sampled_mask(ids, threshold: Optional[int] = None) -> np.ndarray:
    """sampled over an array of ids (the bulk paths)."""
    if threshold is None:
        threshold = sample_threshold()
    a = np.asarray(ids, np.uint64)
    h = (a * np.uint64(_HASH_MULT)) & np.uint64(_U32)
    return (h < np.uint64(threshold)) & (a != 0)


def tail_threshold_ns(edge: str,
                      opts: Optional[sentinel.SentinelOptions] = None) -> int:
    """An edge's tail-capture threshold: the lower bound of the first log2
    bucket past twice its latency budget (sentinel._bad_from_bucket), the
    budget from opts (the run's sentinel options by default); lane
    variants share the base edge's. 0 where no latency SLO covers it."""
    opts = opts or _SENTINEL
    base = edge.split(".v")[0]
    for slo in sentinel.SLO_TABLE:
        if slo.kind == "latency" and slo.edge_or_stage == base:
            budget_ns = opts.budget(slo.budget_flag) * 1_000_000
            return 1 << (sentinel._bad_from_bucket(budget_ns) - 1)
    return 0


# -- exemplar span rings ------------------------------------------------------


class SpanRing:
    """A bounded ring of spans (trace, tsorig, tspub, trigger, extra) and
    the count of every trigger recorded. Locked: triggers land from the
    dispatcher thread while publishes run on the tile's."""

    __slots__ = ("name", "buf", "pos", "n", "counts", "_lock")

    def __init__(self, name: str, cap: int):
        self.name = name
        self.buf: List[Optional[tuple]] = [None] * max(cap, 8)
        self.pos = 0
        self.n = 0
        self.counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def record(self, trace_id: int, tsorig: int, tspub: int, trigger: str,
               extra: Optional[dict] = None) -> None:
        with self._lock:
            self.buf[self.pos] = (trace_id, tsorig, tspub, trigger, extra)
            self.pos = (self.pos + 1) % len(self.buf)
            self.n += 1
            self.counts[trigger] = self.counts.get(trigger, 0) + 1

    def record_many(self, traces: list, tspubs: list, trigger: str) -> None:
        """record(t, t, tspub, trigger) for each pair in order, in one
        lock: every span counts, and only the last ring's worth is
        written, which leaves the ring as the one-by-one records would
        (a bulk publish past its tail threshold tails most of a batch)."""
        n = len(traces)
        if not n:
            return
        with self._lock:
            cap = len(self.buf)
            for i in range(max(0, n - cap), n):
                t = traces[i]
                self.buf[self.pos] = (t, t, tspubs[i], trigger, None)
                self.pos = (self.pos + 1) % cap
            self.n += n
            self.counts[trigger] = self.counts.get(trigger, 0) + n

    def spans(self) -> List[dict]:
        """The spans held, oldest first."""
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
            trace_id, tsorig, tspub, trigger, extra = e
            d = {"trace": trace_id, "tsorig": tsorig, "tspub": tspub,
                 "lat_ns": (tspub - tsorig) & _U32, "trigger": trigger}
            if extra:
                d.update(extra)
            out.append(d)
        return out


class _NullRing:
    __slots__ = ()
    name = "null"
    n = 0
    counts: Dict[str, int] = {}

    def record(self, trace_id, tsorig, tspub, trigger, extra=None) -> None:
        pass

    def record_many(self, traces, tspubs, trigger) -> None:
        pass

    def spans(self) -> List[dict]:
        return []


_NULL_RING = _NullRing()
_rings: Dict[str, SpanRing] = {}
_rings_lock = threading.Lock()


def ring(name: str):
    """A fresh ring registered under name (the latest wins: each tile
    incarnation gets its own), a no-op one with xray off."""
    if not enabled():
        return _NULL_RING
    r = SpanRing(name, _OPTS.ring)
    with _rings_lock:
        _rings[name] = r
    return r


def reset_rings() -> None:
    """Forget every ring of this process: a runner's first step, so its
    run summary and dumps hold its own spans and none of an earlier
    run's rings that this run does not build again (in the feed the
    source's and the downstream tiles' rings live in the workers)."""
    with _rings_lock:
        _rings.clear()


def dump_spans() -> Dict[str, dict]:
    """{ring: {n_total, counts, spans}} of every ring of this process."""
    with _rings_lock:
        rings = dict(_rings)
    return {
        name: {"n_total": r.n, "counts": dict(r.counts), "spans": r.spans()}
        for name, r in sorted(rings.items())
    }


class SpanCtx:
    """One publish edge's exemplar sampler beside its span histogram: a
    hash and a compare a frag decide the head capture, one compare the
    tail. The thresholds are read once, at construction."""

    __slots__ = ("edge", "ring", "thr", "tail_ns")

    def __init__(self, edge: str):
        self.edge = edge
        self.ring = ring(f"edge:{edge}")
        self.thr = sample_threshold()
        self.tail_ns = tail_threshold_ns(edge)

    def observe(self, tsorig: int, tspub: int, lat: int) -> None:
        if sampled(tsorig, self.thr):
            self.ring.record(tsorig, tsorig, tspub, "head")
        elif self.tail_ns and lat >= self.tail_ns and lat < _DWELL_WRAP_NS:
            self.ring.record(tsorig, tsorig, tspub, "tail")

    def observe_many(self, ts_arr, lats) -> None:
        """A batch at once (the bulk publishes): the masks in numpy, the
        heads then the tails each recorded in one call."""
        ts = np.asarray(ts_arr, np.uint64)
        la = np.asarray(lats, np.int64)
        head = sampled_mask(ts, self.thr)
        pub = (ts + la.astype(np.uint64)) & np.uint64(_U32)
        if head.any():
            self.ring.record_many(ts[head].tolist(), pub[head].tolist(),
                                  "head")
        if self.tail_ns:
            tail = (~head) & (la >= self.tail_ns) \
                & (la < _DWELL_WRAP_NS) & (ts != 0)
            if tail.any():
                self.ring.record_many(ts[tail].tolist(), pub[tail].tolist(),
                                      "tail")


def span_ctx(edge: str) -> Optional[SpanCtx]:
    """An out-link's or the sink's sampler when xray is on, else None."""
    if not enabled():
        return None
    return SpanCtx(edge)


# -- the xray.queue region ----------------------------------------------------


def create_region(wksp, edge_labels) -> None:
    """Allocate and label the region (build_topology): an rx and a tx row
    an edge, labelled up front so attachers never race a claim."""
    labels = [f"{e}|rx" for e in edge_labels] + \
             [f"{e}|tx" for e in edge_labels]
    wksp.alloc(_QUEUE_REGION, flight._region_footprint(len(labels), Q_SLOTS))
    a = np.frombuffer(wksp.view(_QUEUE_REGION), np.uint64)
    a[:] = 0
    a[0] = _MAGIC_QUEUE
    a[1] = len(labels)
    a[2] = Q_SLOTS
    for i, label in enumerate(labels):
        row = 4 + i * (flight._LABEL_U64 + Q_SLOTS)
        a[row: row + flight._LABEL_U64] = np.frombuffer(
            flight._pack_label(label), np.uint64)


def _attach(wksp, label: str):
    if wksp is None:
        return None
    try:
        return flight._attach_row(wksp, _QUEUE_REGION, _MAGIC_QUEUE, Q_SLOTS,
                                  label)
    except Exception:  # noqa: BLE001 - a raw workspace: a local row
        return None


class EdgeRx:
    """An edge's consumer row: the sampled dwell histogram, idle ns and
    depth samples. One writer: the thread that drains the edge (the
    consuming tile's, the stager for the feeder's in-edge)."""

    __slots__ = ("label", "row", "hist")

    def __init__(self, label: str, row=None):
        self.label = label
        self.row = row if row is not None else np.zeros(Q_SLOTS, np.uint64)
        self.hist = flight.EdgeHist(label, self.row[: flight.EDGE_SLOTS])

    def observe_dwell(self, ns: int) -> None:
        if 0 <= ns < _DWELL_WRAP_NS:
            self.hist.observe(ns)

    def add_idle(self, ns: int) -> None:
        self.row[RX_IDLE_NS] = np.uint64(
            (int(self.row[RX_IDLE_NS]) + ns) & _U64)

    def sample_depth(self, depth: int) -> None:
        self.row[RX_DEPTH_SUM] += np.uint64(max(depth, 0))
        self.row[RX_DEPTH_N] += np.uint64(1)


class EdgeTx:
    """An edge's producer row: credit-stall wall ns (the time spent
    spinning in the backpressure loops) and count, and sampled available
    credits. One writer: the edge's producing tile."""

    __slots__ = ("label", "row")

    def __init__(self, label: str, row=None):
        self.label = label
        self.row = row if row is not None else np.zeros(Q_SLOTS, np.uint64)

    def add_stall(self, ns: int) -> None:
        if ns > 0:
            self.row[TX_STALL_NS] = np.uint64(
                (int(self.row[TX_STALL_NS]) + ns) & _U64)
            self.row[TX_STALL_CNT] += np.uint64(1)

    def sample_credits(self, cr: int) -> None:
        self.row[TX_CR_SUM] += np.uint64(max(cr, 0))
        self.row[TX_CR_N] += np.uint64(1)


def edge_rx(wksp, label: str) -> Optional[EdgeRx]:
    """The consumer's row (tiles.InLink); None with xray off, a local row
    where the workspace has no region or no row for label."""
    if not enabled():
        return None
    return EdgeRx(label, _attach(wksp, f"{label}|rx"))


def edge_tx(wksp, label: str) -> Optional[EdgeTx]:
    """The producer's row (tiles.OutLink)."""
    if not enabled():
        return None
    return EdgeTx(label, _attach(wksp, f"{label}|tx"))


def read_queue(wksp) -> Optional[Dict[str, dict]]:
    """{edge: {dwell summary, idle ns, depth, stall ns and count, credits}}
    from the region, None without it."""
    rows = flight._region_rows(wksp, _QUEUE_REGION, _MAGIC_QUEUE, Q_SLOTS)
    if rows is None:
        return None
    rx: Dict[str, np.ndarray] = {}
    tx: Dict[str, np.ndarray] = {}
    for label, row in rows:
        base, _, side = label.rpartition("|")
        (rx if side == "rx" else tx)[base] = row
    out: Dict[str, dict] = {}
    for edge in rx:
        r, t = rx[edge], tx.get(edge)
        dwell = flight.EdgeHist(edge, r[: flight.EDGE_SLOTS]).summary()
        depth_n = int(r[RX_DEPTH_N])
        cr_n = int(t[TX_CR_N]) if t is not None else 0
        out[edge] = {
            "dwell": dwell,
            "idle_ns": int(r[RX_IDLE_NS]),
            "depth_avg": round(int(r[RX_DEPTH_SUM]) / depth_n, 1)
            if depth_n else 0.0,
            "depth_samples": depth_n,
            "stall_ns": int(t[TX_STALL_NS]) if t is not None else 0,
            "stall_cnt": int(t[TX_STALL_CNT]) if t is not None else 0,
            "cr_avail_avg": round(int(t[TX_CR_SUM]) / cr_n, 1)
            if cr_n else 0.0,
        }
    return out


# -- the waterfall ------------------------------------------------------------


def _mean_ns(summary: Optional[dict]) -> Optional[float]:
    if not summary or not summary.get("n"):
        return None
    return summary["sum_ns"] / summary["n"]


def _lane_labels(d: Dict[str, dict], base: str) -> List[str]:
    """base and its lane variants (replay_verify.v1, ...)."""
    return [label for label in d
            if label == base or label.startswith(base + ".v")]


def _merged_summary(d: Optional[Dict[str, dict]], base: str,
                    pick=lambda row: row) -> Optional[dict]:
    """One summary over a base edge and its lanes: n and sum_ns add, the
    p99 bound is the largest lane's."""
    rows = [pick(d[label]) for label in _lane_labels(d or {}, base)]
    rows = [r for r in rows if isinstance(r, dict) and r.get("n")]
    if not rows:
        return None
    return {
        "n": sum(r["n"] for r in rows),
        "sum_ns": sum(r.get("sum_ns", 0) for r in rows),
        "p99_ns_le": max(r.get("p99_ns_le", 0) for r in rows),
    }


def waterfall(edges: Optional[Dict[str, dict]],
              queue: Optional[Dict[str, dict]]) -> List[dict]:
    """Queue wait against service, stage by stage over STAGE_CHAIN: the
    queue term is the in-edge's dwell histogram (verify's the stager's
    verify_drain span), service the residual of the cumulative spans'
    means (cum_out - cum_in - queue, floored at 0); lanes fold into their
    base edge."""
    edges = edges or {}
    queue = queue or {}
    out: List[dict] = []
    for stage, in_edge, out_edge in STAGE_CHAIN:
        cum_in = _mean_ns(_merged_summary(edges, in_edge))
        cum_out = _mean_ns(_merged_summary(edges, out_edge))
        if stage == "verify" and "verify_drain" in edges:
            q_summary = _merged_summary(edges, "verify_drain")
        else:
            q_summary = _merged_summary(
                queue, in_edge, pick=lambda row: row.get("dwell") or {})
        q_mean = _mean_ns(q_summary) or 0.0
        q_rows = [queue[label] for label in _lane_labels(queue, in_edge)]
        service = None
        if cum_in is not None and cum_out is not None:
            service = max(0.0, cum_out - cum_in - q_mean)
        out.append({
            "stage": stage,
            "in_edge": in_edge,
            "out_edge": out_edge,
            "queue_mean_ns": round(q_mean, 1),
            "queue_p99_ns_le": (q_summary or {}).get("p99_ns_le", 0),
            "queue_n": (q_summary or {}).get("n", 0),
            "service_mean_ns": round(service, 1)
            if service is not None else None,
            "cum_mean_ns": round(cum_out, 1) if cum_out is not None else None,
            "cum_p99_ns_le": (_merged_summary(edges, out_edge)
                              or {}).get("p99_ns_le", 0),
            "stall_ns": sum(r.get("stall_ns", 0) for r in q_rows),
            "idle_ns": sum(r.get("idle_ns", 0) for r in q_rows),
            "depth_avg": round(sum(r.get("depth_avg", 0.0)
                                   for r in q_rows), 1),
        })
    return out


def waterfall_reconciles(edges: Dict[str, dict], wf: List[dict],
                         slack_factor: float = 2.0) -> bool:
    """The source's mean plus every stage's queue and service lands within
    slack_factor (one log2 bucket) of the sink span's mean; True when the
    chain is not fully populated."""
    src = _mean_ns(_merged_summary(edges, "replay_verify"))
    sink = _mean_ns(_merged_summary(edges, "sink"))
    if src is None or sink is None:
        return True
    total = src
    for st in wf:
        if st["service_mean_ns"] is None:
            return True
        total += st["queue_mean_ns"] + st["service_mean_ns"]
    lo, hi = sink / slack_factor, sink * slack_factor
    return lo <= total <= hi


# -- postmortems --------------------------------------------------------------


def options_snapshot() -> dict:
    """The run's options (the JAX autopsy's FD_* flag snapshot): flight,
    sentinel, xray, the chaos injector's seed and schedule (None when
    none is armed) and the verify tile's verify_opts."""
    from . import chaos

    c = chaos.active()
    return {
        "flight": flight.options().as_dict(),
        "sentinel": dict(asdict(_SENTINEL),
                         budgets=dict(_SENTINEL.budgets)),
        "xray": _OPTS.as_dict(),
        "chaos": None if c is None else {
            "seed": c.seed, "schedule": c.schedule_text},
        "verify_opts": dict(_VERIFY_OPTS) if _VERIFY_OPTS is not None
        else None,
    }


def suspect_ranking(edges: Optional[Dict[str, dict]],
                    slos: Optional[Dict[str, dict]],
                    alerts: Optional[List[dict]] = None,
                    opts: Optional[sentinel.SentinelOptions] = None,
                    ) -> List[dict]:
    """Suspected stages, ranked: alert-backed ones first (score: the burn,
    a liveness SLO's stall over its budget), then latency stages by
    budget share (p99_ns_le over twice the budget). Without an alert
    list the SLO rows in alert state stand in (a crash's autopsy). Each
    entry says why. Budgets from opts (the run's sentinel options)."""
    opts = opts or _SENTINEL
    out: List[dict] = []
    budgets = {s.name: opts.budget(s.budget_flag) for s in sentinel.SLO_TABLE}
    if not alerts and slos:
        alerts = [
            {
                "slo": name,
                "edge_or_stage": sentinel.SLO_BY_NAME[name].edge_or_stage,
                "burn_milli": int(row.get("burn_milli", 0)),
                "fault_classes": list(
                    sentinel.SLO_BY_NAME[name].fault_classes),
                "from_slo_rows": True,
            }
            for name, row in sorted(slos.items())
            if name in sentinel.SLO_BY_NAME
            and (row.get("state") or row.get("alerts"))
        ]
    for a in alerts or []:
        budget = max(budgets.get(a.get("slo"), 0), 1)
        burn = a.get("burn_milli", 0) / 1000.0
        slo = sentinel.SLO_BY_NAME.get(a.get("slo"))
        score = (burn / budget if slo is not None and slo.kind == "liveness"
                 else burn)
        out.append({
            "stage": a.get("edge_or_stage", "?"),
            "slo": a.get("slo"),
            "score": round(max(score, 1.0), 3),
            "alerted": True,
            "fault_classes": a.get("fault_classes", []),
            "why": f"sentinel alert on {a.get('slo')} "
                   f"(burn_milli={a.get('burn_milli')})",
        })
    alerted = {o["slo"] for o in out}
    for slo in sentinel.SLO_TABLE:
        if slo.kind != "latency" or slo.name in alerted:
            continue
        labels = [label for label in (edges or {})
                  if label == slo.edge_or_stage
                  or label.startswith(slo.edge_or_stage + ".v")]
        limit = 2 * budgets[slo.name] * 1_000_000
        for label in labels:
            s = edges[label]
            if not s.get("n") or limit <= 0:
                continue
            out.append({
                "stage": label,
                "slo": slo.name,
                "score": round(s["p99_ns_le"] / limit, 3),
                "alerted": False,
                "fault_classes": list(slo.fault_classes),
                "why": f"p99_ns_le {s['p99_ns_le']:,} vs limit "
                       f"{limit:,} (2x {slo.budget_flag})",
            })
    out.sort(key=lambda o: (not o["alerted"], -o["score"]))
    return out


def _top_slowest(spans_by_ring: Dict[str, dict], k: int = 3) -> List[dict]:
    """The k slowest exemplar traces with each edge's latency (a trace's
    spans over the edge rings)."""
    traces: Dict[int, List[dict]] = {}
    for name, sect in spans_by_ring.items():
        if not name.startswith("edge:"):
            continue
        edge = name[5:]
        for s in sect.get("spans", []):
            if s.get("trigger") not in ("head", "tail"):
                continue
            traces.setdefault(s["trace"], []).append(dict(s, edge=edge))
    scored = []
    for trace, spans in traces.items():
        spans.sort(key=lambda s: (s["tspub"] - s["tsorig"]) & _U32)
        e2e = next((s for s in spans if s["edge"] == "sink"), spans[-1])
        scored.append({
            "trace": trace,
            "lat_ns": e2e["lat_ns"],
            "trigger": e2e["trigger"],
            "stages": {s["edge"]: s["lat_ns"] for s in spans},
        })
    scored.sort(key=lambda t: -t["lat_ns"])
    return scored[:k]


def exemplar_counts(spans_by_ring: Dict[str, dict]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for sect in spans_by_ring.values():
        for trig, n in (sect.get("counts") or {}).items():
            out[trig] = out.get(trig, 0) + n
    return out


def merge_spans(spans: Dict[str, dict],
                extra: Optional[Dict[str, dict]]) -> Dict[str, dict]:
    """spans with another process's sections added: a ring in both gets
    both's spans and their n_total and counts summed."""
    spans = dict(spans)
    for name, sect in (extra or {}).items():
        if name in spans:
            merged = dict(sect)
            merged["spans"] = spans[name].get("spans", []) + \
                list(sect.get("spans", []))
            merged["n_total"] = spans[name].get("n_total", 0) + \
                sect.get("n_total", 0)
            counts = dict(spans[name].get("counts", {}))
            for k, v in (sect.get("counts") or {}).items():
                counts[k] = counts.get(k, 0) + v
            merged["counts"] = counts
            spans[name] = merged
        else:
            spans[name] = sect
    return spans


def run_summary(wksp=None, extra_spans: Optional[Dict[str, dict]] = None,
                alerts: Optional[List[dict]] = None) -> Optional[dict]:
    """PipelineResult.xray: exemplar counts by trigger, distinct sampled
    traces, the three slowest exemplars by stage, the waterfall and the
    top suspects, from this process's rings (and the workers' spans) and
    the workspace's rows; None with xray off."""
    if not enabled():
        return None
    spans = merge_spans(dump_spans(), extra_spans)
    traces = set()
    for name, sect in spans.items():
        if name.startswith("edge:"):
            traces.update(s["trace"] for s in sect.get("spans", [])
                          if s.get("trigger") in ("head", "tail"))
    edges = flight.read_edges(wksp) if wksp is not None else None
    queue = read_queue(wksp) if wksp is not None else None
    wf = waterfall(edges, queue)
    return {
        "sample_rate": _OPTS.sample,
        "exemplars": exemplar_counts(spans),
        "traces": len(traces),
        "top_slowest": _top_slowest(spans),
        "waterfall": wf,
        "suspects": suspect_ranking(edges, None, alerts)[:5],
    }


def build_autopsy(reason: str, wksp=None,
                  alerts: Optional[List[dict]] = None,
                  extra_spans: Optional[Dict[str, dict]] = None) -> dict:
    """One self-contained postmortem (what ``tools/fd_report.py
    --autopsy`` renders): suspects, exemplar spans, the waterfall and
    queue rows, the registry's rows, the chaos injector's state and the
    run's options."""
    from . import chaos

    spans = dump_spans()
    for name, sect in (extra_spans or {}).items():
        spans.setdefault(name, sect)
    edges = slos = metrics = queue = None
    # A left workspace's handle is None: reading it would crash.
    if wksp is not None and getattr(wksp, "_h", None):
        try:
            edges = flight.read_edges(wksp)
            slos = flight.read_slos(wksp)
            metrics = flight.read_tiles(wksp)
            queue = read_queue(wksp)
        except Exception:  # noqa: BLE001 - the autopsy must not raise
            pass
    c = chaos.active()
    return {
        "schema_version": flight.ARTIFACT_SCHEMA_VERSION,
        "kind": "xray_autopsy",
        "reason": reason,
        "pid": os.getpid(),
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "alerts": list(alerts or []),
        "suspects": suspect_ranking(edges, slos, alerts),
        "exemplars": {
            "counts": exemplar_counts(spans),
            "top_slowest": _top_slowest(spans),
            "spans": spans,
        },
        "waterfall": waterfall(edges, queue),
        "queue": queue,
        "edges": edges,
        "metrics": metrics,
        "slos": slos,
        "chaos": None if c is None else dict(
            c.snapshot(), schedule=c.schedule_text),
        "options": options_snapshot(),
    }


def maybe_autopsy(reason: str, wksp=None,
                  alerts: Optional[List[dict]] = None,
                  extra_spans: Optional[Dict[str, dict]] = None,
                  opts: Optional[XrayOptions] = None) -> Optional[str]:
    """Write the autopsy into opts.dir (the options in force by default);
    the path, or None when no directory is set, xray is off or the write
    failed. Never raises: a failing postmortem must not hide the fault
    it records."""
    opts = opts or _OPTS
    try:
        if not opts.dir or not opts.enabled or not flight.enabled():
            return None
        os.makedirs(opts.dir, exist_ok=True)
        slug = "".join(c if c.isalnum() else "_" for c in reason)[:48]
        path = os.path.join(opts.dir, f"xray_autopsy_{os.getpid()}_"
                            f"{int(time.time() * 1e3)}_{slug}.json")
        doc = build_autopsy(reason, wksp=wksp, alerts=alerts,
                            extra_spans=extra_spans)
        # Written under a temporary name and renamed: a reader polling
        # the directory never sees half a file.
        with open(path + ".tmp", "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(path + ".tmp", path)
        return path
    except Exception:  # noqa: BLE001 - see the docstring
        return None


class AutopsyFlusher:
    """The alert autopsies' writer, a daemon thread: the sentinel's poll
    enqueues and never waits on file IO; this thread bundles and writes.
    It reads the mapped rows, so the sentinel stops it before the runner
    leaves the workspace."""

    def __init__(self, wksp=None, opts: Optional[XrayOptions] = None):
        self._wksp = wksp
        self._opts = opts or _OPTS
        self._q: _queue.Queue = _queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.written: List[str] = []

    def start(self) -> "AutopsyFlusher":
        self._thread = threading.Thread(target=self._loop,
                                        name="fd_xray_autopsy", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.25)
            except _queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if item is None:
                return
            reason, alerts = item
            path = maybe_autopsy(reason, wksp=self._wksp, alerts=alerts,
                                 opts=self._opts)
            if path:
                self.written.append(path)

    def request(self, reason: str, alerts: Optional[List[dict]] = None
                ) -> None:
        self._q.put((reason, list(alerts or [])))

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self) -> None:
        """Write what is queued, then stop (idempotent)."""
        self._stop.set()
        self._q.put(None)
        if self._thread is not None:
            self._thread.join(timeout=10.0)


def flusher_for_run(wksp=None) -> Optional[AutopsyFlusher]:
    """A started flusher when alert autopsies can fire (xray on and a
    directory set), else None; the sentinel stops it."""
    if not enabled() or not _OPTS.dir:
        return None
    return AutopsyFlusher(wksp, _OPTS).start()


# -- Chrome trace-event export ------------------------------------------------


def to_chrome_trace(spans_by_ring: Dict[str, dict]) -> dict:
    """Spans as Chrome trace-event JSON (Perfetto, chrome://tracing): a
    complete ("X") event a span, ts the trace id's mint tick (us), dur
    its latency (us), a pid a ring, tid the trace id, so a sampled txn's
    chain lines up as one row a stage."""
    events = []
    pids = {}
    for name, sect in sorted(spans_by_ring.items()):
        pid = pids.setdefault(name, len(pids) + 1)
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name},
        })
        for s in sect.get("spans", []):
            events.append({
                "name": name[5:] if name.startswith("edge:") else name,
                "cat": s.get("trigger", "span"),
                "ph": "X",
                "ts": s["tsorig"] / 1e3,
                "dur": max(s.get("lat_ns", 0), 1) / 1e3,
                "pid": pid,
                "tid": s.get("trace", 0),
                "args": {k: v for k, v in s.items()
                         if k not in ("tsorig", "tspub")},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
