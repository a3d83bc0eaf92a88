"""Admin CLIs for the shared-memory objects (the reference's fd_wksp_ctl,
fd_pod_ctl and fd_tango_ctl), the counterpart of
``firedancer_tpu/app/ctl.py``: offline queries of the workspace and pod
files, so an operator can inspect a stopped (or live) pipeline without
joining a tile.

  python -m firedancer_tpu_torch.app.ctl wksp usage  PATH
  python -m firedancer_tpu_torch.app.ctl wksp list   PATH
  python -m firedancer_tpu_torch.app.ctl wksp query  PATH NAME
  python -m firedancer_tpu_torch.app.ctl pod  list   POD_PATH [PREFIX]
  python -m firedancer_tpu_torch.app.ctl pod  query  POD_PATH KEY
  python -m firedancer_tpu_torch.app.ctl tango mcache PATH NAME
  python -m firedancer_tpu_torch.app.ctl tango fseq   PATH NAME
  python -m firedancer_tpu_torch.app.ctl tango cnc    PATH NAME

Every command prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys


def _wksp(args) -> int:
    from ..tango.rings import Workspace

    w = Workspace.join(args.path)
    try:
        if args.cmd == "usage":
            print(json.dumps(w.usage()))
        elif args.cmd == "list":
            print(json.dumps([
                {"name": n, "off": o, "sz": s} for n, o, s in w.alloc_list()
            ]))
        elif args.cmd == "query":
            try:
                off, sz = w.query(args.name)
            except KeyError:
                print(json.dumps({"error": f"no alloc {args.name!r}"}))
                return 1
            print(json.dumps({"name": args.name, "off": off, "sz": sz}))
    finally:
        w.leave()
    return 0


def _pod(args) -> int:
    from ..utils.pod import Pod

    with open(args.path, "rb") as f:
        pod = Pod.deserialize(f.read())

    def enc(v):
        return v.hex() if isinstance(v, (bytes, bytearray)) else v

    if args.cmd == "list":
        out = {k: enc(v) for k, v in pod.iter_leaves()
               if not args.name or k.startswith(args.name)}
        print(json.dumps(out))
    elif args.cmd == "query":
        v = pod.query(args.name)
        if v is None:
            print(json.dumps({"error": f"no key {args.name!r}"}))
            return 1
        print(json.dumps({args.name: enc(v)}))
    return 0


def _tango(args) -> int:
    from ..tango.rings import Cnc, FSeq, MCache, Workspace

    w = Workspace.join(args.path)
    try:
        if args.cmd == "mcache":
            mc = MCache(w, args.name)
            print(json.dumps({
                "name": args.name, "depth": mc.depth,
                "seq_next": mc.seq_next(),
            }))
        elif args.cmd == "fseq":
            fs = FSeq(w, args.name)
            diag_names = ("pub_cnt", "pub_sz", "filt_cnt", "filt_sz",
                          "ovrnp_cnt", "ovrnr_cnt", "slow_cnt")
            print(json.dumps({
                "name": args.name, "seq": fs.query(),
                "diag": {n: fs.diag(i) for i, n in enumerate(diag_names)},
            }))
        elif args.cmd == "cnc":
            cnc = Cnc(w, args.name)
            sig = cnc.signal_query()
            sig_name = {0: "boot", 1: "run", 2: "halt", 3: "fail"}.get(
                sig, str(sig))
            print(json.dumps({
                "name": args.name, "signal": sig_name,
                "heartbeat": cnc.heartbeat_query(),
            }))
    except KeyError:
        print(json.dumps({"error": f"no alloc {args.name!r}"}))
        return 1
    finally:
        w.leave()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fdctl-ctl")
    sub = ap.add_subparsers(dest="family", required=True)
    for fam, cmds in (
        ("wksp", ("usage", "list", "query")),
        ("pod", ("list", "query")),
        ("tango", ("mcache", "fseq", "cnc")),
    ):
        p = sub.add_parser(fam)
        p.add_argument("cmd", choices=cmds)
        p.add_argument("path")
        p.add_argument("name", nargs="?")
    args = ap.parse_args(argv)
    needs_name = {("wksp", "query"), ("pod", "query"),
                  ("tango", "mcache"), ("tango", "fseq"), ("tango", "cnc")}
    if (args.family, args.cmd) in needs_name and args.name is None:
        ap.error(f"{args.family} {args.cmd} requires NAME")
    return {"wksp": _wksp, "pod": _pod, "tango": _tango}[args.family](args)


if __name__ == "__main__":
    sys.exit(main())
