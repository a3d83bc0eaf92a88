#!/usr/bin/env python3
"""bench_log_check: the SOAK_r record's validator, the counterpart of
``scripts/bench_log_check.py`` ``validate_soak``:796-898 and the
``_SOAK_*`` tables it reads (:779-793).

    python3 firedancer_tpu_torch/tools/bench_log_check.py FILE...

prints each file's shape errors and exits 1 if any file has one. The
JAX script's other validators read the benchmark log and artifacts,
which the port does not have yet.

The ok-consistency clauses carry the weight: a record that says the
soak survived must carry the evidence, zero unexplained alerts, the
slopes within budget, the respawn rate inside its budget, no dropped
txn or leaked slot and, when a reconfig was applied under digest
recording, an intact continuity verdict.
"""

from __future__ import annotations

import json
import sys
from typing import List

# The oldest record schema this validator reads.
SCHEMA_VERSION_MIN = 2

_SOAK_REQUIRED = {
    "value": (int, float),        # sustained txns/s
    "unit": str,
    "ok": bool,
    "on_device": bool,
    "seed": int,
    "duration_s": (int, float),
    "backend": str,
}
_SOAK_SLO_REQUIRED = ("alert_cnt", "unexplained_alerts")
_SOAK_SLOPE_REQUIRED = ("samples", "heap_kb_min", "pool_milli_min",
                        "compile_per_hr")
_SOAK_RECONFIG_REQUIRED = ("requested", "applied", "refused")
_SOAK_CONTINUITY_REQUIRED = ("offered", "published", "received",
                             "dropped", "slots_leaked")


def validate_soak(rec: dict) -> List[str]:
    """Shape errors for one SOAK_r*.json artifact ([] = valid)."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return ["artifact is not a JSON object"]
    if rec.get("metric") != "soak_run":
        errs.append(f"metric must be soak_run, got {rec.get('metric')!r}")
    sv = rec.get("schema_version")
    if not isinstance(sv, int) or isinstance(sv, bool) \
            or sv < SCHEMA_VERSION_MIN:
        errs.append(f"schema_version must be an int >= "
                    f"{SCHEMA_VERSION_MIN}, got {sv!r}")
    ts = rec.get("ts")
    if not isinstance(ts, str) or "T" not in ts:
        errs.append(f"missing/odd ISO 'ts': {ts!r}")
    for key, typ in _SOAK_REQUIRED.items():
        v = rec.get(key)
        if v is None or not isinstance(v, typ) \
                or (isinstance(v, bool) and typ is not bool):
            errs.append(f"'{key}' missing or not {typ}: {v!r}")
    phases = rec.get("phases")
    if not isinstance(phases, list) or not phases:
        errs.append("'phases' must be a non-empty list")
    else:
        for p in phases:
            if not isinstance(p, dict) or not isinstance(
                    p.get("phase"), str) or not isinstance(
                    p.get("profile"), str):
                errs.append("phase entries need phase/profile strings")
                break
            if not isinstance(p.get("alerts"), int) \
                    or isinstance(p.get("alerts"), bool):
                errs.append("phase entries need an integer alert count")
                break
    slo = rec.get("slo")
    if not isinstance(slo, dict):
        errs.append("'slo' block missing")
    else:
        for key in _SOAK_SLO_REQUIRED:
            v = slo.get(key)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"'slo.{key}' missing or not a "
                            f"non-negative int: {v!r}")
    slopes = rec.get("slopes")
    if not isinstance(slopes, dict):
        errs.append("'slopes' block missing")
    else:
        for key in _SOAK_SLOPE_REQUIRED:
            v = slopes.get(key)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                errs.append(f"'slopes.{key}' missing or not a number: "
                            f"{v!r}")
        if not isinstance(slopes.get("within_budget"), bool):
            errs.append("'slopes.within_budget' missing or not a bool")
    rc = rec.get("reconfig")
    if not isinstance(rc, dict):
        errs.append("'reconfig' block missing")
    else:
        for key in _SOAK_RECONFIG_REQUIRED:
            v = rc.get(key)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"'reconfig.{key}' missing or not a "
                            f"non-negative int: {v!r}")
        if not isinstance(rc.get("events"), list):
            errs.append("'reconfig.events' must be a list")
    rs = rec.get("respawn")
    if not isinstance(rs, dict) or not isinstance(rs.get("ok"), bool):
        errs.append("'respawn' block with a bool ok required")
    cont = rec.get("continuity")
    if not isinstance(cont, dict):
        errs.append("'continuity' block missing")
    else:
        for key in _SOAK_CONTINUITY_REQUIRED:
            v = cont.get(key)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"'continuity.{key}' missing or not a "
                            f"non-negative int: {v!r}")
        if cont.get("digest_match") not in (None, True, False):
            errs.append("'continuity.digest_match' must be "
                        "true/false/null")
    if not isinstance(rec.get("autopsy_index"), list):
        errs.append("'autopsy_index' must be a list")
    if not isinstance(rec.get("failures"), list):
        errs.append("'failures' must be a list")
    if not errs and rec["ok"]:
        # An artifact that SAYS the soak survived must carry evidence
        # consistent with it.
        if slo["unexplained_alerts"] != 0:
            errs.append(f"ok: true but unexplained_alerts="
                        f"{slo['unexplained_alerts']}")
        if not slopes["within_budget"]:
            errs.append("ok: true but slopes.within_budget: false "
                        "(a resource-growth tripwire fired)")
        if not rs["ok"]:
            errs.append("ok: true but respawn.ok: false "
                        "(crash-respawn storm over budget)")
        if cont["dropped"] != 0:
            errs.append(f"ok: true but continuity.dropped="
                        f"{cont['dropped']}")
        if cont["slots_leaked"] != 0:
            errs.append(f"ok: true but continuity.slots_leaked="
                        f"{cont['slots_leaked']}")
        if rc["applied"] > 0 and cont.get("digest_match") is False:
            errs.append("ok: true but a reconfig was applied and "
                        "continuity.digest_match: false (the swap "
                        "was not zero-downtime)")
    return errs


def main(argv=None) -> int:
    bad = 0
    for path in (sys.argv[1:] if argv is None else argv):
        try:
            with open(path, encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError) as e:
            print(f"{path}: not JSON ({e})")
            bad += 1
            continue
        errs = validate_soak(rec)
        for e in errs:
            print(f"{path}: {e}")
        bad += bool(errs)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
