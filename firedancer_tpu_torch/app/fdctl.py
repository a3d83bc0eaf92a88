"""fdctl, the production CLI (the reference's app/fdctl/main.c command
table), the counterpart of ``firedancer_tpu/app/fdctl.py``:

  fdctl [--config cfg.toml] configure {init,check,fini} [stage...|all]
  fdctl [--config cfg.toml] run [--source {synth,pcap}] [--pcap FILE]
  fdctl [--config cfg.toml] monitor [--once] [--interval S]
  fdctl [--config cfg.toml] security [--json]
  fdctl [--config cfg.toml] keygen [--out PATH]

``run`` drives the tile pipeline (source -> verify -> dedup -> pack ->
sink, ``disco.pipeline.run_pipeline``) on the workspace and pod that
``configure init all`` made, over ``[layout] verify_tile_count`` verify
lanes, and prints the JAX CLI's JSON result line. One lane runs the
fd_feed runtime; more than one run the in-process step loop, since the
feed serves one lane (the run warns and keeps the reason). The synthetic
source is the reference's synth-load harness
(frank/load/fd_frank_verify_synth_load.c: the duplicate and corrupt-
signature fractions of ``[development.synth]``); ``--source pcap`` reads
a classic pcap or a pcapng capture.

``run`` signs the synthetic load and verifies on the card; without one
it raises. ``main(argv, device="cpu")`` and ``cmd_run(cfg, args,
device="cpu")`` run the plain PyTorch versions on the CPU instead (the
tests); the CLI has no flag for it, as the JAX CLI has none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List

from . import config as cfgmod
from .configure import STAGES, configure_cmd, keygen


def synth_payloads(cfg: Dict[str, Any], device=None) -> List[bytes]:
    """The synthetic load of ``[development.synth]``, byte for byte the
    JAX ``synth_payloads``: txn_cnt one-signer txns drawn from the seed
    with the same numpy generator, then txn_cnt * dup_frac exact repeats
    and txn_cnt * bad_frac copies with a corrupt signature byte. Public
    keys come from one ``ops.sign.keygen_batch`` call and signatures
    from ``disco.corpus.sign_jobs`` (Ed25519 signing is deterministic),
    on the card unless device is "cpu"."""
    import numpy as np

    from ..ballet.txn import build_txn
    from ..disco.corpus import _splice_signatures, public_keys, sign_jobs

    s = cfg["development"]["synth"]
    rng = np.random.RandomState(s["seed"])
    n = s["txn_cnt"]
    seeds = [bytes([i & 0xFF, (i >> 8) & 0xFF, s["seed"] & 0xFF]) + bytes(29)
             for i in range(n)]
    pubs = public_keys(seeds, device) if n else []
    jobs: list = []

    def defer(msg: bytes, seed: bytes) -> bytes:
        jobs.append((msg, seed))
        return bytes(64)

    unsigned = [
        build_txn(
            signer_seeds=[seeds[i]],
            pubs=[pubs[i]],
            sign_fn=defer,
            extra_accounts=[rng.randint(0, 256, 32, dtype=np.uint8).tobytes()],
            n_readonly_unsigned=1,
            instrs=[(1, [0], b"synth%d" % i)],
            recent_blockhash=rng.randint(0, 256, 32, dtype=np.uint8).tobytes(),
        )
        for i in range(n)
    ]
    sigs = sign_jobs(jobs, device=device) if jobs else []
    txns = [_splice_signatures(p, [sig]) for p, sig in zip(unsigned, sigs)]
    out = list(txns)
    out += [txns[int(rng.randint(0, n))] for _ in range(int(n * s["dup_frac"]))]
    for _ in range(int(n * s["bad_frac"])):
        t = bytearray(txns[int(rng.randint(0, n))])
        t[5] ^= 0xFF  # corrupt a signature byte
        out.append(bytes(t))
    return out


def _load_topo(cfg: Dict[str, Any]):
    from ..disco.pipeline import Topology
    from ..utils.pod import Pod

    with open(cfgmod.pod_path(cfg), "rb") as f:
        pod = Pod.deserialize(f.read())
    return Topology(
        wksp_path=cfgmod.wksp_path(cfg),
        depth=cfg["layout"]["depth"],
        mtu=cfg["layout"]["mtu"],
        pod=pod,
    )


def cmd_run(cfg: Dict[str, Any], args, device=None) -> int:
    """``fdctl run``: the payloads of args.source through run_pipeline on
    the configured topology; prints the JSON result line."""
    from ..disco.pipeline import run_pipeline

    if args.source == "synth":
        payloads = synth_payloads(cfg, device)
    elif args.source == "pcap":
        if not args.pcap:
            print("run --source pcap requires --pcap FILE", file=sys.stderr)
            return 1
        from ..utils.pcap import read_capture

        payloads = read_capture(args.pcap)  # classic pcap or pcapng
    else:
        print(f"unknown source {args.source!r}", file=sys.stderr)
        return 1

    tiles_cfg = cfg["tiles"]
    res = run_pipeline(
        _load_topo(cfg),
        payloads,
        verify_backend=tiles_cfg["verify"]["backend"],
        verify_batch=tiles_cfg["verify"]["batch"],
        verify_max_msg_len=tiles_cfg["verify"]["max_msg_len"] or None,
        bank_cnt=tiles_cfg["pack"]["bank_cnt"],
        timeout_s=cfg["development"]["timeout_s"],
        tcache_depth=tiles_cfg["verify"]["tcache_depth"],
        verify_opts={"verify_mode": tiles_cfg["verify"]["mode"]},
        tile_cpus=[int(c) for c in cfg["layout"]["tile_cpus"]] or None,
        device=device,
    )
    # Filters are counted by verify lane (tile.verify, tile.verify.v1...).
    sv_filt = sum(d.get("sv_filt_cnt", 0) for name, d in res.diag.items()
                  if name.startswith("tile.verify"))
    ha_filt = sum(d.get("ha_filt_cnt", 0) for name, d in res.diag.items()
                  if name.startswith("tile.verify"))
    print(json.dumps({
        "sent": len(payloads),
        "recv_cnt": res.recv_cnt,
        "recv_sz": res.recv_sz,
        "bank_hist": {str(k): v for k, v in sorted(res.bank_hist.items())},
        "elapsed_s": round(res.elapsed_s, 3),
        "verify_sv_filt": sv_filt,
        "verify_ha_filt": ha_filt,
    }))
    return 0


def cmd_monitor(cfg: Dict[str, Any], args) -> int:
    from ..disco.monitor import render, snapshot, watch
    from ..tango.rings import Workspace

    topo = _load_topo(cfg)
    wksp = Workspace.join(topo.wksp_path)
    try:
        if args.once:
            print(render(snapshot(wksp, topo.pod), ansi=not args.no_ansi))
        else:
            watch(wksp, topo.pod, interval_s=args.interval,
                  iterations=args.iters or 0)
    finally:
        wksp.leave()
    return 0


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(prog="fdctl")
    p.add_argument("--config", help="operator TOML (or $FIREDANCER_CONFIG_TOML)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("configure")
    pc.add_argument("action", choices=("init", "check", "fini"))
    pc.add_argument("stages", nargs="*", default=[],
                    help=f"stages ({', '.join(s.name for s in STAGES)}) or 'all'")

    pr = sub.add_parser("run")
    pr.add_argument("--source", default="synth", choices=("synth", "pcap"))
    pr.add_argument("--pcap")

    pm = sub.add_parser("monitor")
    pm.add_argument("--once", action="store_true")
    pm.add_argument("--no-ansi", action="store_true")
    pm.add_argument("--interval", type=float, default=1.0)
    pm.add_argument("--iters", type=int, default=None)

    ps = sub.add_parser("security")
    ps.add_argument("--json", action="store_true")

    pk = sub.add_parser("keygen")
    pk.add_argument("--out", default=None)

    args = p.parse_args(argv)

    if args.cmd == "security":
        # The host report needs no loadable config: a broken TOML is
        # often why the operator is here.
        from .security import report

        print(report(as_json=args.json))
        return 0

    cfg = cfgmod.load_config(args.config)

    if args.cmd == "configure":
        stages = None if (not args.stages or args.stages == ["all"]) else args.stages
        ok = configure_cmd(args.action, cfg, stages)
        return 0 if ok else 1
    if args.cmd == "run":
        return cmd_run(cfg, args, device)
    if args.cmd == "monitor":
        return cmd_monitor(cfg, args)
    if args.cmd == "keygen":
        path = args.out or cfgmod.identity_key_path(cfg)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        pub = keygen(path)
        print(f"wrote {path} (pubkey {pub.hex()})")
        return 0
    return 1


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:  # stdout piped into head etc.
        raise SystemExit(0)
