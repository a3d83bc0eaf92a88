#!/usr/bin/env python3
"""fd_report: fd_xray's read-back modes, the counterpart of
``scripts/fd_report.py``'s ``--waterfall`` and ``--autopsy``
(``render_waterfall``, ``waterfall_cmd``, ``autopsy_cmd``).

    python3 firedancer_tpu_torch/tools/fd_report.py --waterfall FILE
    python3 firedancer_tpu_torch/tools/fd_report.py --autopsy FILE

``--waterfall`` prints the queue-wait against service decomposition of
each stage (``xray.waterfall``) of a flight dump (its edges and xray
queue rows), an autopsy or a JSON file holding a run's ``stage_hist``
and ``xray`` summary, and whether it reconciles with the edge spans
within one log2 bucket. ``--autopsy`` renders an ``xray_autopsy_*.json``:
the suspected stage first, then the alerts, the chaos injector's state,
the waterfall, the slowest exemplars and the run's options. The JAX
script's other modes read its benchmark history and artifacts, which
the port does not have yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _fmt_row(cols, widths) -> str:
    return "  ".join(str(c)[:w].ljust(w) for c, w in zip(cols, widths))


def _load_edges_queue(doc: dict):
    """(edges, queue) of a flight dump ({edges, xray.queue}), a run's
    record (stage_hist) or an autopsy ({edges, queue})."""
    edges = doc.get("edges") or doc.get("stage_hist") or {}
    queue = doc.get("queue") or (doc.get("xray") or {}).get("queue") or {}
    return edges, queue


def render_waterfall(wf: List[dict], edges=None) -> str:
    from firedancer_tpu_torch.disco import xray

    widths = (8, 14, 12, 12, 12, 12, 10, 10, 7)
    lines = ["== XRAY WATERFALL (queue-wait vs service per stage) =="]
    lines.append(_fmt_row(
        ("stage", "in-edge", "queue-mean", "service", "cum-mean",
         "cum-p99<=", "stall-ms", "idle-ms", "depth"), widths))
    for st in wf:
        lines.append(_fmt_row((
            st["stage"], st["in_edge"],
            f"{st['queue_mean_ns'] / 1e6:.2f}ms",
            "-" if st["service_mean_ns"] is None
            else f"{st['service_mean_ns'] / 1e6:.2f}ms",
            "-" if st["cum_mean_ns"] is None
            else f"{st['cum_mean_ns'] / 1e6:.2f}ms",
            f"{st['cum_p99_ns_le'] / 1e6:.1f}ms",
            f"{st['stall_ns'] / 1e6:.1f}",
            f"{st['idle_ns'] / 1e6:.1f}",
            st["depth_avg"]), widths))
    if edges is not None:
        ok = xray.waterfall_reconciles(edges, wf)
        lines.append("reconciliation vs EdgeHist totals (one log2 bucket): "
                     + ("OK" if ok else "FAILED"))
    return "\n".join(lines)


def waterfall_cmd(path: str) -> int:
    from firedancer_tpu_torch.disco import xray

    with open(path) as f:
        doc = json.load(f)
    wf = doc.get("waterfall")
    if not isinstance(wf, list):
        wf = (doc.get("xray") or {}).get("waterfall")
    edges, queue = _load_edges_queue(doc)
    if not isinstance(wf, list):
        if not edges:
            print(f"fd_report: {path} carries no edge histograms")
            return 1
        wf = xray.waterfall(edges, queue)
    print(render_waterfall(wf, edges or None))
    return 0


def autopsy_cmd(path: str) -> int:
    """The suspected stage first (the answer to the page), then the
    alerts, the chaos state, the waterfall and the top exemplars."""
    with open(path) as f:
        a = json.load(f)
    if a.get("kind") != "xray_autopsy":
        print(f"fd_report: {path} is not an xray autopsy "
              f"(kind={a.get('kind')!r})")
        return 1
    print(f"== XRAY AUTOPSY [{a.get('reason')}] at {a.get('ts')} "
          f"(pid {a.get('pid')}) ==")
    suspects = a.get("suspects") or []
    if suspects:
        top = suspects[0]
        print(f"SUSPECTED STAGE: {top['stage']} "
              f"(slo={top.get('slo')}, score={top.get('score')}, "
              f"{'ALERTED' if top.get('alerted') else 'budget share'})")
        for s in suspects[1:5]:
            print(f"  also: {s['stage']} score={s.get('score')} "
                  f"— {s.get('why')}")
        print(f"  why: {top.get('why')}")
    for al in a.get("alerts") or []:
        print(f"alert: {al.get('slo')} burn_milli={al.get('burn_milli')} "
              f"fault_classes={al.get('fault_classes')}")
    chaos = a.get("chaos")
    if chaos:
        print(f"chaos: seed={chaos.get('seed')} "
              f"schedule={chaos.get('schedule')!r} "
              f"counters={chaos.get('counters')}")
    print()
    print(render_waterfall(a.get("waterfall") or [], a.get("edges")))
    ex = a.get("exemplars") or {}
    print()
    print(f"exemplars by trigger: {ex.get('counts')}")
    for t in (ex.get("top_slowest") or [])[:3]:
        stages = " -> ".join(f"{k}:{v / 1e6:.1f}ms"
                             for k, v in (t.get("stages") or {}).items())
        print(f"  trace {t['trace']}: {t['lat_ns'] / 1e6:.1f}ms "
              f"[{t.get('trigger')}] {stages}")
    if a.get("options"):
        print(f"options: {a['options']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--waterfall", metavar="FILE",
                      help="the queue-wait vs service decomposition of a "
                           "dump, an autopsy or a run's record")
    mode.add_argument("--autopsy", metavar="FILE",
                      help="render an xray_autopsy_*.json")
    args = ap.parse_args(argv)
    if args.waterfall:
        return waterfall_cmd(args.waterfall)
    return autopsy_cmd(args.autopsy)


if __name__ == "__main__":
    sys.exit(main())
