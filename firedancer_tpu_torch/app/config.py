"""Operator configuration (fdctl config.c + default.toml analog), the
counterpart of ``firedancer_tpu/app/config.py`` (``DEFAULTS``,
``_merge``, ``load_config``, ``ConfigError``, the path helpers).

Three tiers, as in the reference (src/app/fdctl/config.c,
config/default.toml): (1) the built-in defaults below; (2) an operator
TOML file, its path from the CLI or the FIREDANCER_CONFIG_TOML
environment variable, whose keys override the defaults; (3) the pod
that ``configure`` writes and the runners read. Unknown keys and
mistyped values are refused, as the reference's parser refuses them, so
a typo fails loudly; an int widens to a float, the one coercion.

The one difference from the JAX package: ``tiles.verify.backend``
takes the port's verify backends, ``disco.engine.TILE_BACKENDS``
("gpu", the default, which verifies on the card, and "oracle", the
port's host oracle). The JAX package's "cpu" and "tpu" are refused with
a ``ConfigError`` that names them, never mapped onto another backend.
"""

from __future__ import annotations

import copy
import os
import tomllib
from typing import Any, Dict, Optional

ENV_CONFIG = "FIREDANCER_CONFIG_TOML"

DEFAULTS: Dict[str, Any] = {
    "name": "fd1",
    "scratch_directory": "/tmp/firedancer_tpu",
    "layout": {
        # Verify lanes: a verify tile each, fed round-robin by the
        # replay and muxed back in by dedup (default.toml [layout]).
        "verify_tile_count": 1,
        "tile_cpus": [],       # cores to pin the tiles to, topology
                               # order (fd_tile affinity); [] = unpinned
        "depth": 128,          # mcache depth of each link
        "mtu": 1232,           # FD_TPU_MTU
        "wksp_sz": 1 << 24,
    },
    "tiles": {
        "verify": {
            "backend": "gpu",      # gpu (the card) | oracle (the host
                                   # oracle): disco.engine.TILE_BACKENDS
            "mode": "auto",        # auto | direct | rlc
                                   # (engine.resolve_verify_mode)
            "batch": 128,
            "max_msg_len": 0,      # 0 = mtu
            "tcache_depth": 4096,
        },
        "pack": {
            "bank_cnt": 4,
        },
        "quic": {
            "identity_seed_path": "",  # "" = generated under scratch
            # Stateless Retry for the public ingest port (RFC 9000
            # section 8.1.2): run_quic_pipeline's quic_retry. fdctl's
            # run drives the replay and synth sources, so it reads
            # neither key yet.
            "retry": False,
        },
    },
    "development": {
        "synth": {
            "txn_cnt": 64,
            "dup_frac": 0.1,
            "bad_frac": 0.1,
            "seed": 42,
        },
        "timeout_s": 60.0,
    },
}


class ConfigError(Exception):
    pass


def _merge(base: Dict[str, Any], over: Dict[str, Any], path: str = "") -> None:
    for k, v in over.items():
        where = f"{path}.{k}" if path else k
        if k not in base:
            raise ConfigError(f"unknown config key: {where}")
        if isinstance(base[k], dict):
            if not isinstance(v, dict):
                raise ConfigError(f"{where}: expected a table")
            _merge(base[k], v, where)
        else:
            if isinstance(base[k], float) and isinstance(v, int) and not isinstance(v, bool):
                v = float(v)  # int -> float widening is the one tolerated coercion
            if type(base[k]) is not type(v):
                raise ConfigError(
                    f"{where}: expected {type(base[k]).__name__}, "
                    f"got {type(v).__name__}"
                )
            base[k] = v


def _check_backend(cfg: Dict[str, Any]) -> None:
    from ..disco.engine import TILE_BACKENDS

    backend = cfg["tiles"]["verify"]["backend"]
    if backend not in TILE_BACKENDS:
        raise ConfigError(
            f"tiles.verify.backend: {backend!r} is not a backend of the "
            f"PyTorch port (want {' or '.join(map(repr, TILE_BACKENDS))})")


def load_config(path: Optional[str] = None) -> Dict[str, Any]:
    """defaults <- TOML file (arg, else $FIREDANCER_CONFIG_TOML)."""
    cfg = copy.deepcopy(DEFAULTS)
    path = path or os.environ.get(ENV_CONFIG) or None
    if path:
        with open(path, "rb") as f:
            try:
                over = tomllib.load(f)
            except tomllib.TOMLDecodeError as e:
                raise ConfigError(f"{path}: {e}") from None
        _merge(cfg, over)
        _check_backend(cfg)
    return cfg


def wksp_path(cfg: Dict[str, Any]) -> str:
    return os.path.join(cfg["scratch_directory"], f"{cfg['name']}.wksp")


def pod_path(cfg: Dict[str, Any]) -> str:
    return os.path.join(cfg["scratch_directory"], f"{cfg['name']}.pod")


def identity_key_path(cfg: Dict[str, Any]) -> str:
    p = cfg["tiles"]["quic"]["identity_seed_path"]
    return p or os.path.join(cfg["scratch_directory"], "identity.json")
