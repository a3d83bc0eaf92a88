"""fd_siege's profile names, the counterpart of
``firedancer_tpu/disco/siege.py`` ``PROFILES``:64-71.

The JAX module drives an adversarial QUIC swarm under each profile
(``build_profile``, ``make_swarm``, the tenants) against the QUIC tile.
The port has the tile (``disco.quic_tile``, ``pipeline.run_quic_pipeline``)
but not the swarm yet, so it keeps only the names, which fd_soak reuses
as drifting workload shapes on the replay path (``soak.PROFILE_MIX``).
The swarm is the next slice of ROADMAP queue 1 item 9.
"""

from __future__ import annotations

PROFILES = (
    "conn_churn",
    "dup_storm",
    "malformed_flood",
    "slowloris",
    "oversize_abuse",
    "keyupdate_churn",
)
