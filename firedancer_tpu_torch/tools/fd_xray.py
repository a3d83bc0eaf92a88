#!/usr/bin/env python3
"""fd_xray: exemplar traces out of fd_xray's artifacts, the counterpart of
``scripts/fd_xray.py``.

    python3 firedancer_tpu_torch/tools/fd_xray.py --chrome-trace FILE... \\
        [-o OUT]
    python3 firedancer_tpu_torch/tools/fd_xray.py [--spans] FILE... \\
        [--limit 20]

A FILE is any artifact with a spans section: a flight dump (its "xray"
section; ``flight.FlightOptions.dump_dir``), an ``xray_autopsy_*.json``
(``xray.XrayOptions.dir``) or a worker's result file. Sampling is a pure
function of the trace id, so the spans of one txn in different
processes' files meet by id: several files merge. ``--chrome-trace``
writes Chrome trace-event JSON (Perfetto, chrome://tracing: a row an
edge, a complete event a span); ``--spans`` (the default) lists the
span chains by trace, slowest first. ``tools/fd_report.py --waterfall``
renders the queue-wait and service decomposition, ``--autopsy`` an
autopsy.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def spans_section(doc: dict) -> dict:
    """The {ring: {n_total, counts, spans}} section of a flight dump, a
    worker's result file or an autopsy; {} when it has none."""
    x = doc.get("xray") or {}
    if "spans" in x:
        return x["spans"]
    ex = doc.get("exemplars") or {}
    if isinstance(ex.get("spans"), dict):
        return ex["spans"]
    return {}


def load_spans(paths) -> dict:
    """The spans sections of the files, merged ring by ring."""
    merged: dict = {}
    for path in paths:
        with open(path) as f:
            doc = json.load(f)
        for name, sect in spans_section(doc).items():
            m = merged.setdefault(name,
                                  {"n_total": 0, "counts": {}, "spans": []})
            m["n_total"] += sect.get("n_total", 0)
            for k, v in (sect.get("counts") or {}).items():
                m["counts"][k] = m["counts"].get(k, 0) + v
            m["spans"].extend(sect.get("spans") or [])
    return merged


def chains(spans_by_ring: dict) -> list:
    """The spans by trace id, each chain ordered by latency, the slowest
    chains first."""
    traces: dict = {}
    for name, sect in spans_by_ring.items():
        for s in sect.get("spans") or []:
            traces.setdefault(s["trace"], []).append(dict(s, ring=name))
    out = []
    for trace, spans in traces.items():
        spans.sort(key=lambda s: s.get("lat_ns", 0))
        out.append({
            "trace": trace,
            "e2e_lat_ns": spans[-1].get("lat_ns", 0),
            "triggers": sorted({s.get("trigger") for s in spans}),
            "spans": spans,
        })
    out.sort(key=lambda t: -t["e2e_lat_ns"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="+",
                    help="flight dumps, autopsies, worker result files")
    ap.add_argument("--chrome-trace", action="store_true",
                    help="write Chrome trace-event JSON")
    ap.add_argument("--spans", action="store_true",
                    help="list the span chains, slowest first (default)")
    ap.add_argument("-o", "--out", default="",
                    help="output file (default: standard output)")
    ap.add_argument("--limit", type=int, default=20,
                    help="chains --spans lists (default 20)")
    args = ap.parse_args(argv)

    from firedancer_tpu_torch.disco import xray

    spans = load_spans(args.files)
    if not spans:
        print("fd_xray: no xray spans in the given files", file=sys.stderr)
        return 1
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        if args.chrome_trace:
            json.dump(xray.to_chrome_trace(spans), out, indent=1)
            out.write("\n")
            return 0
        for c in chains(spans)[:args.limit]:
            out.write(f"trace {c['trace']}: {c['e2e_lat_ns'] / 1e6:.2f}ms "
                      f"{c['triggers']}\n")
            for s in c["spans"]:
                extra = {k: v for k, v in s.items()
                         if k not in ("trace", "tsorig", "tspub", "lat_ns",
                                      "trigger", "ring")}
                out.write(f"    {s['ring']:<24} {s['lat_ns'] / 1e6:>9.3f}ms "
                          f"[{s['trigger']}]"
                          + (f" {extra}" if extra else "") + "\n")
        return 0
    finally:
        if args.out:
            out.close()


if __name__ == "__main__":
    sys.exit(main())
