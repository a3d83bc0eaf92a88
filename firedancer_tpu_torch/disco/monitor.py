"""Diag-counter snapshots, the counterpart of
``firedancer_tpu/disco/monitor.py`` (``snapshot``:47), the role of the
reference's fd_frank_mon: every tile's cnc and every link's fseq read
into plain dicts under the JAX package's names (``tile.<name>``,
``link.<name>``). The port has no pod: the tiles and links are
``pipeline.TILES`` and ``pipeline.LINKS``, which are passed in.
"""

from __future__ import annotations

from typing import Dict, Sequence

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
from .tiles import (
    CNC_DIAG_BACKP_CNT,
    CNC_DIAG_HA_FILT_CNT,
    CNC_DIAG_HA_FILT_SZ,
    CNC_DIAG_IN_BACKP,
    CNC_DIAG_SV_FILT_CNT,
    CNC_DIAG_SV_FILT_SZ,
)


def snapshot(wksp: Workspace, tiles: Sequence[str],
             links: Sequence[str]) -> Dict[str, Dict[str, int]]:
    """One diag snapshot of each tile's cnc (``<tile>.cnc``) and each
    link's fseq and mcache (``<link>.fseq``, ``<link>.mcache``)."""
    out: Dict[str, Dict[str, int]] = {}
    for name in tiles:
        cnc = Cnc(wksp, f"{name}.cnc")
        out[f"tile.{name}"] = {
            "signal": cnc.signal_query(),
            "heartbeat": cnc.heartbeat_query(),
            "in_backp": cnc.diag(CNC_DIAG_IN_BACKP),
            "backp_cnt": cnc.diag(CNC_DIAG_BACKP_CNT),
            "ha_filt_cnt": cnc.diag(CNC_DIAG_HA_FILT_CNT),
            "ha_filt_sz": cnc.diag(CNC_DIAG_HA_FILT_SZ),
            "sv_filt_cnt": cnc.diag(CNC_DIAG_SV_FILT_CNT),
            "sv_filt_sz": cnc.diag(CNC_DIAG_SV_FILT_SZ),
        }
    for name in links:
        fs = FSeq(wksp, f"{name}.fseq")
        out[f"link.{name}"] = {
            "seq": fs.query(),
            "pub_cnt": fs.diag(DIAG_PUB_CNT),
            "pub_sz": fs.diag(DIAG_PUB_SZ),
            "filt_cnt": fs.diag(DIAG_FILT_CNT),
            "filt_sz": fs.diag(DIAG_FILT_SZ),
            "ovrnp_cnt": fs.diag(DIAG_OVRNP_CNT),
            "ovrnr_cnt": fs.diag(DIAG_OVRNR_CNT),
            "slow_cnt": fs.diag(DIAG_SLOW_CNT),
            "tx_seq": MCache(wksp, f"{name}.mcache").seq_next(),
        }
    return out
