#!/usr/bin/env python3
"""fd_soak: the phase-scripted soak runner, the counterpart of
``scripts/fd_soak.py``.

Runs the fd_feed pipeline for a horizon under a seeded drifting
workload (``disco.soak.build_plan``: the siege profiles rotate phase by
phase, the corpus mix and offered load shift with them, the plan's
chaos fires beside them) and judges it (``disco.soak.judge``): the
resource slopes against their budgets, the respawn rate, the alerts
by phase and the live-reconfig trail. Writes the record to ``--out``,
by default the next free ``build/soak/SOAK_rNN.json`` of the checkout,
and prints one JSON summary line; exits 0 if the soak was judged ok.

    python3 firedancer_tpu_torch/tools/fd_soak.py --hours 1 --rate 400
    python3 firedancer_tpu_torch/tools/fd_soak.py --profile crash_storm \\
        --hours 0.5 --rate 200
    # a live reconfig: edit the file (or kill -HUP the process)
    python3 firedancer_tpu_torch/tools/fd_soak.py --reconfig req.json \\
        --hours 1

``--profile crash_storm`` fires a stager_kill every phase and is judged
against the respawn budget (the JAX ``scripts/soak_crash_test.sh``).
The JAX FD_SOAK_* and FD_SLO_* variables are options here:
``--seed``, ``--phases``, ``--phase-s``, ``--probe-ms``,
``--respawn-budget`` and ``--budget FD_SLO_...=N`` (repeatable). It runs
on the card; ``main(argv, device="cpu")`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

OUT_DIR = os.path.join(REPO, "build", "soak")


def next_artifact_path(out_dir: str) -> str:
    """The first SOAK_rNN.json not yet in out_dir."""
    taken = {os.path.basename(p)
             for p in glob.glob(os.path.join(out_dir, "SOAK_r[0-9]*.json"))}
    n = 1
    while f"SOAK_r{n:02d}.json" in taken:
        n += 1
    return os.path.join(out_dir, f"SOAK_r{n:02d}.json")


def _budget(text: str):
    name, _, value = text.partition("=")
    return name.strip(), int(value)


def main(argv=None, device="cuda") -> int:
    from firedancer_tpu_torch.disco import engine, soak
    from firedancer_tpu_torch.disco.sentinel import SentinelOptions

    defaults = soak.SoakOptions()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hours", type=float, default=None,
                    help="the horizon (sets phase_s = hours*3600/phases)")
    ap.add_argument("--phases", type=int, default=defaults.phases)
    ap.add_argument("--phase-s", type=float, default=None,
                    help=f"seconds a phase (default {defaults.phase_s})")
    ap.add_argument("--rate", type=float, default=100.0,
                    help="base offered load, txn/s (drifts by phase)")
    ap.add_argument("--seed", type=int, default=defaults.seed)
    ap.add_argument("--profile", default="drift",
                    help="drift | crash_storm | a siege profile name")
    ap.add_argument("--backend", default="gpu",
                    choices=engine.TILE_BACKENDS)
    ap.add_argument("--batch", type=int, default=256,
                    help="the verify tile's staging batch")
    ap.add_argument("--reconfig", default=None,
                    help="a live-reconfig request file (JSON): SIGHUP or "
                         "a change of its mtime applies it mid-run")
    ap.add_argument("--digests", action="store_true",
                    help="record the sink's digests (host memory that "
                         "grows with every txn: short runs only)")
    ap.add_argument("--no-chaos", action="store_true",
                    help="drop the plan's chaos schedule")
    ap.add_argument("--max-txns", type=int, default=200_000,
                    help="cap of the payload schedule (held in memory)")
    ap.add_argument("--timeout-s", type=float, default=None)
    ap.add_argument("--probe-ms", type=int, default=defaults.probe_ms)
    ap.add_argument("--respawn-budget", type=int,
                    default=defaults.respawn_budget,
                    help="restarts an hour")
    ap.add_argument("--budget", type=_budget, action="append", default=[],
                    metavar="FD_SLO_NAME=N",
                    help="an SLO budget (sentinel.SLO_DEFAULTS' names)")
    ap.add_argument("--out", default=None,
                    help="the record's path (default: the next "
                         "build/soak/SOAK_rNN.json)")
    args = ap.parse_args(argv)

    phase_s = args.phase_s if args.phase_s is not None else defaults.phase_s
    if args.hours is not None:
        phase_s = args.hours * 3600.0 / max(1, args.phases)
    options = soak.SoakOptions(seed=args.seed, phases=args.phases,
                               phase_s=phase_s, probe_ms=args.probe_ms,
                               respawn_budget=args.respawn_budget)
    plan = soak.build_plan(seed=options.seed, n_phases=options.phases,
                           phase_s=options.phase_s, rate=args.rate,
                           profile=args.profile, max_txns=args.max_txns)
    controller = (soak.ReconfigController(path=args.reconfig)
                  if args.reconfig else None)
    sentinel = SentinelOptions(budgets=dict(args.budget))
    for name, _ in args.budget:
        sentinel.budget(name)   # an unknown name raises here
    record, _res = soak.run_soak(
        plan, verify_backend=args.backend, verify_batch=args.batch,
        timeout_s=args.timeout_s, controller=controller,
        record_digests=args.digests, device=device,
        chaos=None if args.no_chaos else soak.chaos_spec(plan),
        sentinel=sentinel, options=options)

    out = args.out or next_artifact_path(OUT_DIR)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({
        "ok": record["ok"], "artifact": out,
        "duration_s": record["duration_s"], "txns_s": record["value"],
        "phases": len(record["phases"]),
        "alerts": record["slo"]["alert_cnt"],
        "unexplained": record["slo"]["unexplained_alerts"],
        "reconfigs": record["reconfig"]["applied"],
        "respawn_ok": record["respawn"]["ok"],
        "failures": record["failures"],
    }))
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
