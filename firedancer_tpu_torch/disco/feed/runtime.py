"""The run records of the fd_feed runtime that the in-process runner
also fills, from ``firedancer_tpu/disco/feed/runtime.py``
(``latency_percentiles``:48, ``verify_tile_stats``:60). The runtime
itself (the staging feeder and its worker process) is not ported yet.
"""

from __future__ import annotations

from typing import Dict


def latency_percentiles(samples) -> Dict[str, int]:
    """{n, p50_ns, p99_ns} of a latency sample list (0s when empty)."""
    if len(samples) == 0:
        return {"n": 0, "p50_ns": 0, "p99_ns": 0}
    s = sorted(samples)
    return {
        "n": len(s),
        "p50_ns": int(s[len(s) // 2]),
        "p99_ns": int(s[(len(s) * 99) // 100]),
    }


def verify_tile_stats(v) -> Dict[str, object]:
    """The verify_stats record of one VerifyTile, the fields of the JAX
    record that the port's stat_* counters fill (its feed, chaos, rung,
    shard, drain and reconfig fields have no counterpart yet)."""
    fill = v.stat_lanes / float(v.stat_batches * v.batch) \
        if v.stat_batches else 0.0
    return {
        "batches": v.stat_batches,
        "lanes": v.stat_lanes,
        "fill_ratio": round(fill, 4),
        "flush_timeout": v.stat_flush_timeout,
        "flush_starved": v.stat_flush_starved,
        "inflight_stall": v.stat_inflight_stall,
        "mode": v.verify_mode,
        "rlc_fallback": v.stat_rlc_fallback,
        "feed": False,
        "ctl_err_drop": v.stat_ctl_err,
    }
