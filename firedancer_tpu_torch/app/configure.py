"""Idempotent configure stages (the fdctl configure stage framework), the
counterpart of ``firedancer_tpu/app/configure.py`` (``STAGES``,
``configure_cmd``, ``keygen``, ``read_keypair``).

As in the reference (src/app/fdctl/configure/configure.c) each stage
has init, check and fini; ``configure init all`` walks the stages in
order, skipping those whose check passes, and fini tears them down in
reverse. The stages:

  scratch    the scratch directory (no hugetlbfs mounts: the workspace
             file is plain mmap-able storage)
  keys       the ed25519 identity keypair (fdctl keygen)
  workspace  the workspace file with every ring of
             ``disco.pipeline.build_topology`` over
             ``[layout] verify_tile_count`` lanes, and the pod file
             (configure/frank.c's workspace stage)

The identity key is derived on the host by the port's oracle
(``ballet/ed25519/oracle.py``), as the JAX package derives it with its
own: one key needs no device, so configure runs without a card.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from . import config as cfgmod


@dataclass
class Stage:
    name: str
    init: Callable[[Dict[str, Any]], None]
    check: Callable[[Dict[str, Any]], bool]  # True = already configured
    fini: Callable[[Dict[str, Any]], None]


# -- scratch ------------------------------------------------------------


def _scratch_init(cfg) -> None:
    os.makedirs(cfg["scratch_directory"], exist_ok=True)


def _scratch_check(cfg) -> bool:
    return os.path.isdir(cfg["scratch_directory"])


def _scratch_fini(cfg) -> None:
    # Only the directory itself, and only when the other stages left it
    # empty: never a recursive delete of an operator-given path.
    try:
        os.rmdir(cfg["scratch_directory"])
    except OSError:
        pass


# -- keys ---------------------------------------------------------------


def keygen(path: str, seed: Optional[bytes] = None) -> bytes:
    """Write a Solana-style keypair JSON (64 ints: seed || pubkey), the
    fdctl keygen (app/fdctl/keygen.c). Returns the pubkey."""
    from ..ballet.ed25519 import oracle

    seed = seed if seed is not None else os.urandom(32)
    _, _, pub = oracle.keypair_from_seed(seed)
    with open(path, "w") as f:
        json.dump(list(seed + pub), f)
    os.chmod(path, 0o600)
    return pub


def read_keypair(path: str):
    """(seed, pubkey) of a keypair JSON; raises ValueError unless the
    pubkey is the seed's."""
    from ..ballet.ed25519 import oracle

    with open(path) as f:
        raw = bytes(json.load(f))
    if len(raw) != 64:
        raise ValueError(f"{path}: expected 64 bytes, got {len(raw)}")
    seed, pub = raw[:32], raw[32:]
    _, _, derived = oracle.keypair_from_seed(seed)
    if derived != pub:
        raise ValueError(f"{path}: pubkey does not match seed")
    return seed, pub


def _keys_init(cfg) -> None:
    path = cfgmod.identity_key_path(cfg)
    if os.path.exists(path):
        # It exists but failed its check: not ours to overwrite.
        raise ValueError(f"{path}: exists but is not a valid keypair; "
                         "remove it or point identity_seed_path elsewhere")
    keygen(path)


def _keys_check(cfg) -> bool:
    path = cfgmod.identity_key_path(cfg)
    if not os.path.exists(path):
        return False
    try:
        read_keypair(path)
        return True
    except (ValueError, json.JSONDecodeError):
        return False


def _keys_fini(cfg) -> None:
    # A key the operator named (identity_seed_path) is not ours to
    # delete; only the generated identity is removed.
    if cfg["tiles"]["quic"]["identity_seed_path"]:
        return
    path = cfgmod.identity_key_path(cfg)
    if os.path.exists(path):
        os.unlink(path)


# -- workspace (rings + pod) --------------------------------------------


def _workspace_init(cfg) -> None:
    from ..disco.pipeline import build_topology

    layout = cfg["layout"]
    topo = build_topology(
        cfgmod.wksp_path(cfg),
        depth=layout["depth"],
        mtu=layout["mtu"],
        wksp_sz=layout["wksp_sz"],
        verify_lanes=layout["verify_tile_count"],
    )
    with open(cfgmod.pod_path(cfg), "wb") as f:
        f.write(topo.pod.serialize())


def _workspace_check(cfg) -> bool:
    from ..utils.pod import Pod

    wksp, podf = cfgmod.wksp_path(cfg), cfgmod.pod_path(cfg)
    if not (os.path.exists(wksp) and os.path.exists(podf)):
        return False
    try:
        with open(podf, "rb") as f:
            pod = Pod.deserialize(f.read())
    except (OSError, ValueError, struct.error):  # a corrupt pod file
        return False
    layout = cfg["layout"]
    # Every layout knob the pod records must match, or a config edit and
    # a re-init would keep the stale topology.
    return (
        pod.query_ulong("firedancer.mtu", 0) == layout["mtu"]
        and pod.query_ulong("firedancer.replay_verify.depth", 0)
        == layout["depth"]
        and pod.query_ulong("firedancer.layout.verify_lane_cnt", 0)
        == layout["verify_tile_count"]
    )


def _workspace_fini(cfg) -> None:
    for p in (cfgmod.wksp_path(cfg), cfgmod.pod_path(cfg)):
        if os.path.exists(p):
            os.unlink(p)


STAGES: List[Stage] = [
    Stage("scratch", _scratch_init, _scratch_check, _scratch_fini),
    Stage("keys", _keys_init, _keys_check, _keys_fini),
    Stage("workspace", _workspace_init, _workspace_check, _workspace_fini),
]


def configure_cmd(
    command: str, cfg: Dict[str, Any], stages: Optional[List[str]] = None,
    log=print,
) -> bool:
    """`configure {init,check,fini} [stage...|all]`. Returns success."""
    sel = [s for s in STAGES if stages is None or s.name in stages]
    if stages is not None:
        unknown = set(stages) - {s.name for s in STAGES}
        if unknown:
            raise ValueError(f"unknown stages: {sorted(unknown)}")
    ok = True
    if command == "init":
        for s in sel:
            if s.check(cfg):
                log(f"configure: {s.name}: already configured, skipping")
            else:
                log(f"configure: {s.name}: init")
                s.init(cfg)
    elif command == "check":
        for s in sel:
            good = s.check(cfg)
            log(f"configure: {s.name}: {'ok' if good else 'NOT configured'}")
            ok &= good
    elif command == "fini":
        for s in reversed(sel):
            log(f"configure: {s.name}: fini")
            s.fini(cfg)
    else:
        raise ValueError(f"bad configure command {command!r}")
    return ok
