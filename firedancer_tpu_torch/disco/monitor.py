"""Diag-counter snapshots and the dashboard, the counterpart of
``firedancer_tpu/disco/monitor.py`` (``snapshot``:47, ``render``:156,
``watch``:243), the role of the reference's fd_frank_mon: every tile's
cnc and every link's fseq read into plain dicts under the JAX package's
names (``tile.<name>``, ``link.<name>``), and rendered as heartbeat age,
backpressure, filter counts and per-link rates.

``snapshot(wksp, pod)`` walks the pod that ``pipeline.build_topology``
records (``fdctl monitor`` reads it from the pod file), as the JAX one
does; ``snapshot(wksp, tiles, links)`` takes the names instead
(``pipeline.topology_tiles`` and ``topology_links``: the runners'
form). Either form overlays the fd_flight registry as the JAX one does
(:117-154): each tile's metric row as ``fl_<metric>`` in its
``tile.<name>`` row, each edge's span summary as ``span.<edge>``, each
fd_sentinel SLO row as ``slo.<name>`` and each edge's fd_xray queue row
as ``xq.<edge>`` (its dwell summary as ``dwell_*`` beside the stall,
idle, depth and credit fields); the FEEDER panel of ``render`` shows the
breaker and quarantine columns from them.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

from ..tango import tempo
from ..tango.rings import (
    DIAG_FILT_CNT,
    DIAG_FILT_SZ,
    DIAG_OVRNP_CNT,
    DIAG_OVRNR_CNT,
    DIAG_PUB_CNT,
    DIAG_PUB_SZ,
    DIAG_SLOW_CNT,
    Cnc,
    FSeq,
    MCache,
    Workspace,
)
from ..utils.pod import Pod
from . import flight, xray
from .tiles import (
    CNC_DIAG_BACKP_CNT,
    CNC_DIAG_HA_FILT_CNT,
    CNC_DIAG_HA_FILT_SZ,
    CNC_DIAG_IN_BACKP,
    CNC_DIAG_SV_FILT_CNT,
    CNC_DIAG_SV_FILT_SZ,
)

_SIGNAL_NAMES = {0: "boot", 1: "run", 2: "halt", 3: "fail"}


def _tile_row(cnc: Cnc) -> Dict[str, int]:
    return {
        "signal": cnc.signal_query(),
        "heartbeat": cnc.heartbeat_query(),
        "in_backp": cnc.diag(CNC_DIAG_IN_BACKP),
        "backp_cnt": cnc.diag(CNC_DIAG_BACKP_CNT),
        "ha_filt_cnt": cnc.diag(CNC_DIAG_HA_FILT_CNT),
        "ha_filt_sz": cnc.diag(CNC_DIAG_HA_FILT_SZ),
        "sv_filt_cnt": cnc.diag(CNC_DIAG_SV_FILT_CNT),
        "sv_filt_sz": cnc.diag(CNC_DIAG_SV_FILT_SZ),
    }


def _link_row(fs: FSeq, mc: Optional[MCache]) -> Dict[str, int]:
    d = {
        "seq": fs.query(),
        "pub_cnt": fs.diag(DIAG_PUB_CNT),
        "pub_sz": fs.diag(DIAG_PUB_SZ),
        "filt_cnt": fs.diag(DIAG_FILT_CNT),
        "filt_sz": fs.diag(DIAG_FILT_SZ),
        "ovrnp_cnt": fs.diag(DIAG_OVRNP_CNT),
        "ovrnr_cnt": fs.diag(DIAG_OVRNR_CNT),
        "slow_cnt": fs.diag(DIAG_SLOW_CNT),
    }
    if mc is not None:
        d["tx_seq"] = mc.seq_next()
    return d


def _walk_objects(tree: dict, prefix: str = "") -> Iterator[Tuple[str, dict]]:
    """(dotted name, subtree) of every pod node naming a cnc or a link
    (a lane's link, replay_verify.v1, nests one level down)."""
    for name, sub in sorted(tree.items()):
        if not isinstance(sub, dict):
            continue
        dotted = f"{prefix}.{name}" if prefix else name
        if "cnc" in sub or "fseq" in sub:
            yield dotted, sub
        yield from _walk_objects(sub, dotted)


def snapshot(wksp: Workspace, tiles: Union[Pod, Sequence[str]],
             links: Optional[Sequence[str]] = None,
             ) -> Dict[str, Dict[str, int]]:
    """One diag snapshot: with a pod (and no links), of every cnc and
    link the pod names; else of each tile's cnc (``<tile>.cnc``) and
    each link's fseq and mcache (``<link>.fseq``, ``<link>.mcache``)."""
    out: Dict[str, Dict[str, int]] = {}
    if links is None:
        for name, sub in _walk_objects(tiles.subpod("firedancer").to_dict()):
            if "cnc" in sub:
                out[f"tile.{name}"] = _tile_row(Cnc(wksp, sub["cnc"]))
            if "fseq" in sub:
                mc = MCache(wksp, sub["mcache"]) if "mcache" in sub else None
                out[f"link.{name}"] = _link_row(FSeq(wksp, sub["fseq"]), mc)
    else:
        for name in tiles:
            out[f"tile.{name}"] = _tile_row(Cnc(wksp, f"{name}.cnc"))
        for name in links:
            out[f"link.{name}"] = _link_row(FSeq(wksp, f"{name}.fseq"),
                                            MCache(wksp, f"{name}.mcache"))
    _flight_overlay(wksp, out)
    return out


def _flight_overlay(wksp: Workspace, out: dict) -> None:
    """The registry's rows into a snapshot (where the workspace has
    them): metrics as fl_* into the tiles' rows, spans, SLO rows and the
    xray queue rows."""
    for label, metrics in (flight.read_tiles(wksp) or {}).items():
        row = out.get(f"tile.{label}")
        if row is not None:
            row.update({f"fl_{k}": v for k, v in metrics.items()})
    for label, summ in (flight.read_edges(wksp) or {}).items():
        out[f"span.{label}"] = summ
    for label, row in (flight.read_slos(wksp) or {}).items():
        out[f"slo.{label}"] = row
    for label, row in (xray.read_queue(wksp) or {}).items():
        d = dict(row)
        dwell = d.pop("dwell", {}) or {}
        d.update({f"dwell_{k}": v for k, v in dwell.items()})
        out[f"xq.{label}"] = d


def render(
    snap: Dict[str, Dict[str, int]],
    prev: Optional[Dict[str, Dict[str, int]]] = None,
    dt_s: float = 1.0,
    ansi: bool = True,
) -> str:
    """The dashboard text, as the JAX ``render`` lays it out: tiles
    (state, heartbeat age on ``tempo.tickcount``, backpressure, filters),
    the feeder panel for tiles that report feed batches, then links (seq
    progress, rates against the prev snapshot over dt_s)."""
    now = tempo.tickcount()
    bold = "\x1b[1m" if ansi else ""
    rst = "\x1b[0m" if ansi else ""
    lines = []
    lines.append(
        f"{bold}{'TILE':<14}{'state':>6}{'hb-age-ms':>11}{'backp':>8}"
        f"{'ha-filt':>9}{'sv-filt':>9}{'rst':>5}{'boff-ms':>9}{rst}"
    )
    for name, d in sorted(snap.items()):
        if not name.startswith("tile."):
            continue
        hb_age = (now - d["heartbeat"]) / 1e6 if d["heartbeat"] else -1
        lines.append(
            f"{name[5:]:<14}{_SIGNAL_NAMES.get(d['signal'], '?'):>6}"
            f"{hb_age:>11.1f}{d['backp_cnt']:>8}"
            f"{d['ha_filt_cnt']:>9}{d['sv_filt_cnt']:>9}"
            f"{d.get('restarts', 0):>5}{d.get('backoff_ms', 0):>9}"
        )
    # The feeder panel: tiles that dispatched feeder batches, with the
    # JAX panel's columns (those the port's snapshot lacks read 0).
    _BRK = {0: "clsd", 1: "OPEN", 2: "half", 3: "-"}
    feeders = [
        (name, d) for name, d in sorted(snap.items())
        if name.startswith("tile.")
        and (d.get("feed_batches") or d.get("fl_batches"))
    ]
    if feeders:
        lines.append("")
        lines.append(
            f"{bold}{'FEEDER':<14}{'batches':>9}{'lanes':>9}{'dl-fl':>7}"
            f"{'st-fl':>7}{'stall':>7}{'idle-ms':>9}"
            f"{'brk':>6}{'trip':>6}{'quar':>6}{'q-err':>7}{'cpu-fo':>8}"
            f"{rst}"
        )
        for name, d in feeders:
            p = (prev or {}).get(name, {})
            idle_ns = d.get("feed_idle_ns", d.get("fl_feed_idle_ns", 0))
            idle_ms = (idle_ns - p.get(
                "feed_idle_ns", p.get("fl_feed_idle_ns", 0))) / 1e6
            brk = _BRK.get(d.get("fl_breaker_state", 3), "?")
            lines.append(
                f"{name[5:]:<14}"
                f"{d.get('feed_batches', d.get('fl_batches', 0)):>9}"
                f"{d.get('feed_lanes', d.get('fl_lanes', 0)):>9}"
                f"{d.get('feed_deadline_flush', d.get('fl_flush_timeout', 0)):>7}"
                f"{d.get('feed_starved_flush', d.get('fl_flush_starved', 0)):>7}"
                f"{d.get('feed_slot_stall', d.get('fl_slot_stall', 0)):>7}"
                f"{idle_ms:>9.1f}"
                f"{brk:>6}{d.get('fl_breaker_trips', 0):>6}"
                f"{d.get('fl_quarantined', 0):>6}"
                f"{d.get('fl_quarantine_err_txn', 0):>7}"
                f"{d.get('fl_cpu_failover', 0):>8}"
            )
    lines.append("")
    lines.append(
        f"{bold}{'LINK':<16}{'tx_seq':>9}{'rx_seq':>9}{'pub/s':>10}"
        f"{'MB/s':>8}{'filt':>7}{'ovrn':>6}{'slow':>6}{rst}"
    )
    for name, d in sorted(snap.items()):
        if not name.startswith("link."):
            continue
        p = (prev or {}).get(name, {})
        rate = (d["pub_cnt"] - p.get("pub_cnt", 0)) / max(dt_s, 1e-9)
        mbps = (d["pub_sz"] - p.get("pub_sz", 0)) / max(dt_s, 1e-9) / 1e6
        ovrn = d["ovrnp_cnt"] + d["ovrnr_cnt"]
        lines.append(
            f"{name[5:]:<16}{d.get('tx_seq', 0):>9}{d['seq']:>9}"
            f"{rate:>10.0f}{mbps:>8.2f}{d['filt_cnt']:>7}{ovrn:>6}"
            f"{d['slow_cnt']:>6}"
        )
    return "\n".join(lines)


def watch(wksp: Workspace, pod: Pod, interval_s: float = 1.0,
          iterations: int = 0) -> None:
    """The live dashboard loop (fdctl monitor); iterations=0 runs until
    interrupted."""
    prev = None
    i = 0
    while not iterations or i < iterations:
        snap = snapshot(wksp, pod)
        print("\x1b[2J\x1b[H" + render(snap, prev, interval_s))
        prev = snap
        time.sleep(interval_s)
        i += 1
