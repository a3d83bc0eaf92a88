#!/usr/bin/env python3
"""fd_top: a live view of a running pipeline's fd_flight registry, the
counterpart of ``scripts/fd_top.py``.

    python3 firedancer_tpu_torch/tools/fd_top.py --wksp RUN.wksp \\
        --pod TOPO.pod [--interval 1.0] [--iterations 0] [--prom] \\
        [--no-ansi]

It joins the workspace of a running pipeline by its pod (the file
``fdctl configure init`` writes, or ``Topology.pod.serialize()``) and
prints, every interval, the monitor's TILE, FEEDER and LINK panels
(``disco.monitor.render``), then the SPAN panel (each edge's always-on
log2 histogram: n and the p50/p99 upper bucket bounds), the XRAY panel
(fd_xray's queue row of each edge: the sampled dwell's p50/p99 bounds
and count, the ring's mean depth, the producer's credit-stall ms, the
consumer's idle ms and the mean available credits), the SLO panel
(each fd_sentinel SLO's state, evaluations, alerts, breach polls and
burn) and the VERIFY panel (the verify tiles' rows, the warm
accounting among them). ``--iterations 0`` runs until interrupted.
``--prom`` prints the registry's Prometheus text once instead
(``flight.render_prom``, the text a run writes to its ``metrics_prom``
file).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _fmt_ns(ns: int) -> str:
    if ns >= 1_000_000_000:
        return f"{ns / 1e9:.1f}s"
    if ns >= 1_000_000:
        return f"{ns / 1e6:.1f}ms"
    if ns >= 1_000:
        return f"{ns / 1e3:.0f}us"
    return f"{ns}ns"


def render_flight(snap: dict, ansi: bool = True) -> str:
    """The SPAN, XRAY, SLO and VERIFY panels of a monitor.snapshot(), the
    JAX fd_top's text."""
    bold = "\x1b[1m" if ansi else ""
    rst = "\x1b[0m" if ansi else ""
    lines = []
    spans = [(k[5:], d) for k, d in sorted(snap.items())
             if k.startswith("span.")]
    if spans:
        lines.append(
            f"{bold}{'SPAN':<16}{'n':>10}{'p50<=':>12}{'p99<=':>12}{rst}")
        for name, d in spans:
            lines.append(
                f"{name:<16}{d['n']:>10}"
                f"{_fmt_ns(d['p50_ns_le']):>12}{_fmt_ns(d['p99_ns_le']):>12}")
    xqs = [(k[3:], d) for k, d in sorted(snap.items())
           if k.startswith("xq.")]
    if xqs:
        lines.append("")
        lines.append(
            f"{bold}{'XRAY edge':<16}{'q-p50<=':>10}{'q-p99<=':>10}"
            f"{'q-n':>8}{'depth':>7}{'stall-ms':>10}{'idle-ms':>9}"
            f"{'cr-avg':>8}{rst}")
        for name, d in xqs:
            lines.append(
                f"{name:<16}"
                f"{_fmt_ns(d.get('dwell_p50_ns_le', 0)):>10}"
                f"{_fmt_ns(d.get('dwell_p99_ns_le', 0)):>10}"
                f"{d.get('dwell_n', 0):>8}"
                f"{d.get('depth_avg', 0.0):>7}"
                f"{d.get('stall_ns', 0) / 1e6:>10.1f}"
                f"{d.get('idle_ns', 0) / 1e6:>9.1f}"
                f"{d.get('cr_avail_avg', 0.0):>8}")
    slos = [(k[4:], d) for k, d in sorted(snap.items())
            if k.startswith("slo.")]
    if slos:
        lines.append("")
        lines.append(
            f"{bold}{'SLO':<20}{'state':>7}{'evals':>8}{'alerts':>8}"
            f"{'breach':>8}{'burn':>8}{rst}")
        for name, d in slos:
            state = "ALERT" if d.get("state") else "ok"
            lines.append(
                f"{name:<20}{state:>7}{d.get('evals', 0):>8}"
                f"{d.get('alerts', 0):>8}{d.get('breach_polls', 0):>8}"
                f"{d.get('burn_milli', 0) / 1e3:>8.2f}")
    verifies = [(k[5:], d) for k, d in sorted(snap.items())
                if k.startswith("tile.") and "fl_batches" in d
                and k[5:].startswith("verify")]
    if verifies:
        lines.append("")
        lines.append(
            f"{bold}{'VERIFY':<12}{'batches':>9}{'rlc-fb':>8}{'quar':>6}"
            f"{'cpu-fo':>8}{'stgr-rst':>9}{'compiles':>9}{'comp-ms':>9}"
            f"{'hit':>5}{rst}")
        for name, d in verifies:
            lines.append(
                f"{name:<12}{d['fl_batches']:>9}{d['fl_rlc_fallback']:>8}"
                f"{d['fl_quarantined']:>6}{d['fl_cpu_failover']:>8}"
                f"{d['fl_stager_restarts']:>9}{d['fl_compile_cnt']:>9}"
                f"{d['fl_compile_ns'] / 1e6:>9.0f}"
                f"{d['fl_compile_cache_hit']:>5}")
    return "\n".join(lines)


def render_once(wksp, pod, prev=None, dt_s: float = 1.0, ansi: bool = True):
    """One frame: the monitor's panels and the flight panels. Returns
    (text, snapshot); the snapshot gives the next frame's rates."""
    from firedancer_tpu_torch.disco.monitor import render, snapshot

    snap = snapshot(wksp, pod)
    parts = [render(snap, prev, dt_s, ansi=ansi)]
    fl = render_flight(snap, ansi=ansi)
    if fl:
        parts += ["", fl]
    return "\n".join(parts), snap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wksp", required=True, help="workspace file")
    ap.add_argument("--pod", required=True, help="serialized topology pod")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--iterations", type=int, default=0,
                    help="frames to print; 0 runs until interrupted")
    ap.add_argument("--prom", action="store_true",
                    help="print the Prometheus text once and exit")
    ap.add_argument("--no-ansi", action="store_true")
    args = ap.parse_args(argv)

    from firedancer_tpu_torch.disco import flight
    from firedancer_tpu_torch.tango.rings import Workspace
    from firedancer_tpu_torch.utils.pod import Pod

    wksp = Workspace.join(args.wksp)
    try:
        with open(args.pod, "rb") as f:
            pod = Pod.deserialize(f.read())
        if args.prom:
            sys.stdout.write(flight.render_prom(wksp))
            return 0
        ansi = not args.no_ansi
        prev = None
        i = 0
        try:
            while not args.iterations or i < args.iterations:
                frame, prev = render_once(wksp, pod, prev, args.interval,
                                          ansi=ansi)
                if ansi:
                    sys.stdout.write("\x1b[2J\x1b[H")
                print(frame, flush=True)
                i += 1
                if args.iterations and i >= args.iterations:
                    break
                time.sleep(args.interval)
        except KeyboardInterrupt:
            pass
        return 0
    finally:
        wksp.leave()


if __name__ == "__main__":
    sys.exit(main())
