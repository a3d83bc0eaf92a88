"""The respawn-rate budget of fd_soak's judgment, the counterpart of
``firedancer_tpu/disco/supervisor.py`` ``respawn_budget``:48-71.

The JAX module's crash-only process supervisor (one OS process a tile,
kill and respawn on a wedged heartbeat) is not ported: the port's
restarts are the verify tile's stager thread's (``VerifyTile
._stager_supervise``), which the soak judges against the same budget.
"""

from __future__ import annotations

from typing import Optional

# Restarts an hour: SoakOptions.respawn_budget's default (the JAX
# FD_SOAK_RESPAWN_BUDGET).
RESPAWN_BUDGET_PER_H = 30


def respawn_budget(restarts: int, elapsed_s: float,
                   budget_per_h: Optional[int] = None) -> dict:
    """The respawn-rate verdict of a run: budget_per_h restarts an hour
    (RESPAWN_BUDGET_PER_H when None) pro-rated over elapsed_s, with at
    least one full hour's budget, so a compressed run is judged against
    the hourly allowance. A storm of restarts that each succeeded fails
    the soak all the same."""
    if budget_per_h is None:
        budget_per_h = RESPAWN_BUDGET_PER_H
    allowed = max(float(budget_per_h),
                  budget_per_h * max(0.0, elapsed_s) / 3600.0)
    return {
        "restarts": int(restarts),
        "elapsed_s": round(float(elapsed_s), 1),
        "budget_per_h": int(budget_per_h),
        "allowed": round(allowed, 2),
        "rate_per_h": round(restarts * 3600.0 / elapsed_s, 2)
        if elapsed_s > 0 else 0.0,
        "ok": int(restarts) <= allowed,
    }
