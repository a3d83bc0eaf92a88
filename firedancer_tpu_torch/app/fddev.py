"""fddev, the developer CLI (the reference's app/fddev/dev.c:31-51), the
counterpart of ``firedancer_tpu/app/fddev.py``.

``fddev dev`` is ``configure init all`` and ``run`` in one step, then
``configure fini all`` unless ``--keep``: the one-command dev loop over
the tile graph with the synthetic load (or a capture). Like ``fdctl
run`` it runs on the card; ``main(argv, device="cpu")`` runs the plain
PyTorch versions on the CPU.

  fddev [--config cfg.toml] dev [--source {synth,pcap}] [--pcap FILE] [--keep]
"""

from __future__ import annotations

import argparse

from . import config as cfgmod
from . import fdctl
from .configure import configure_cmd


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(prog="fddev")
    p.add_argument("--config")
    sub = p.add_subparsers(dest="cmd", required=True)
    pd = sub.add_parser("dev")
    pd.add_argument("--source", default="synth", choices=("synth", "pcap"))
    pd.add_argument("--pcap")
    pd.add_argument("--keep", action="store_true",
                    help="keep the workspace after the run")
    args = p.parse_args(argv)

    cfg = cfgmod.load_config(args.config)
    configure_cmd("init", cfg, None)
    try:
        return fdctl.cmd_run(cfg, args, device)
    finally:
        if not args.keep:
            configure_cmd("fini", cfg, None)


if __name__ == "__main__":
    raise SystemExit(main())
