"""A tile worker process, the counterpart of
``firedancer_tpu/disco/worker.py`` (``build_tile``:24, ``main``:97).

    python -m firedancer_tpu_torch.disco.worker --wksp W --tile NAME \\
        [--opts JSON] [--max-ns N] [--result FILE]

The worker joins the workspace file W, builds tile NAME on the links of
``pipeline.link_names`` (the port has no pod) and runs it until HALT.
NAME is replay, dedup, pack or sink, or a comma list ("dedup,pack,sink")
run on threads of this one interpreter, as the fd_feed runtime's
downstream worker. A heartbeat thread beats every tile's cnc while the
tiles are built (importing torch takes seconds). A tile thread that
raises halts its siblings and the worker exits 1. The worker does no
device work: its tiles are built with ``device="cpu"``, which only the
gc pack would use, so a pack with ``pack_scheduler="gc"`` is refused:
its colouring would run the plain version on the host, unseen by the
main process (the fd_feed runtime keeps the gc pack in process).

The result file (JSON) holds, by tile, the tile's thread CPU seconds and
the latency samples of its out-link (``tiles.LatReservoir`` as [stamps,
ticks]); the replay's publish ticks (by payload index), the sink's
counters with, when recording, each frag's digest, tsorig and receipt
tick, and the pack's and the dedup tile's counters. The main process
reads the end-to-end latency and stage_latency from them.

Options (``--opts``): mtu, tcache_depth, bank_cnt, pack_scheduler,
record_digests, cpu_map (a core by tile name to pin it to), flight (the
run's ``flight.FlightOptions`` fields, installed for the worker's life),
xray (``xray.XrayOptions`` fields) and slo_budgets (the run's
``SentinelOptions.budgets``), and for the replay payloads_path (a
pickled list of payloads).

fd_flight (the JAX :200-202, :289-294): the tiles attach their rows of
the workspace's registry by label (their lanes and spans land in the
main process's view), the worker installs the SIGUSR1 dump and, after a
clean HALT, writes a ``halt:worker:<tiles>`` dump where the options name
a directory.

fd_xray (the JAX :314-342): the worker installs the run's xray options
(``xray``, with the sentinel's ``slo_budgets`` for the tail thresholds)
for its life; its tiles' queue rows are the workspace's, and its span
rings, which are this process's, go home in the result file's ``xray``
section and ride in its HALT dump.
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys
import threading


def build_tile(wksp, name: str, opts: dict):
    """Tile name on its links of the topology (pipeline.build_tile), the
    replay's payloads unpickled from opts["payloads_path"]. Raises
    ValueError for a gc pack: the worker has no device."""
    if name == "pack" and opts.get("pack_scheduler", "greedy") == "gc":
        raise ValueError("a worker runs no gc pack: it has no device, and "
                         "the gc pack runs in the fd_feed runtime's "
                         "process")
    from firedancer_tpu_torch.disco import pipeline
    from firedancer_tpu_torch.disco.tiles import LatReservoir

    opts = dict(opts)
    for k in ("flight", "xray", "slo_budgets"):
        opts.pop(k, None)
    payloads = ()
    cpu = opts.pop("cpu_map", {}).get(name)
    path = opts.pop("payloads_path", None)
    if name == "replay":
        with open(path, "rb") as f:
            payloads = pickle.load(f)
    tile = pipeline.build_tile(wksp, name, payloads=payloads, device="cpu",
                               **opts)
    if tile.out_link is not None:
        tile.out_link.lat = LatReservoir()
    tile.cpu_idx = cpu
    return tile


def tile_result(name: str, tile) -> dict:
    """One tile's part of the result file."""
    from firedancer_tpu_torch.disco.pipeline import _dedup_stats, _pack_stats

    out = {"cpu_s": tile.cpu_ns / 1e9}
    if tile.out_link is not None:
        ts, now = tile.out_link.lat.samples()
        out["lat"] = [ts.tolist(), now.tolist()]
    if name == "replay":
        out["pub_ticks"] = list(tile.pub_ticks)
    elif name == "pack":
        out["stats"] = _pack_stats(tile)
    elif name == "dedup":
        out["stats"] = _dedup_stats(tile)
    elif name == "sink":
        out.update(recv_cnt=tile.recv_cnt, recv_sz=tile.recv_sz,
                   bank_hist={str(k): v for k, v in tile.bank_hist.items()},
                   t_last=tile.t_last,
                   digests=[d.hex() for d in tile.digests],
                   recv_tsorig=list(tile.recv_tsorig),
                   recv_ticks=list(tile.recv_ticks))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--wksp", required=True)
    ap.add_argument("--tile", required=True)
    ap.add_argument("--opts", default="{}")
    ap.add_argument("--max-ns", type=int, default=600_000_000_000)
    ap.add_argument("--result", default="")
    args = ap.parse_args(argv)
    names = [t for t in args.tile.split(",") if t]
    opts = json.loads(args.opts)

    from firedancer_tpu_torch.disco import flight, xray
    from firedancer_tpu_torch.tango import tempo
    from firedancer_tpu_torch.tango.rings import CNC_HALT, Cnc, Workspace

    flight.configure(opts.get("flight"))
    xray.configure(opts.get("xray"),
                   {"budgets": opts.get("slo_budgets") or {}})
    wksp = Workspace.join(args.wksp)
    flight.install_dump_signal(wksp)
    cncs = [Cnc(wksp, f"{t}.cnc") for t in names]
    built = threading.Event()

    def boot_beat():
        while not built.is_set():
            for cnc in cncs:
                cnc.heartbeat(tempo.tickcount())
            built.wait(0.5)

    beat = threading.Thread(target=boot_beat, daemon=True)
    beat.start()
    try:
        tiles = [build_tile(wksp, t, opts) for t in names]
    finally:
        built.set()
        beat.join(timeout=2.0)

    # The tiles keep the interpreter's 5 ms switch interval: an idle
    # tile sleeps (tiles.idle_pause), so none holds the GIL spinning.
    # At the JAX worker's 100 us every wake of an idle or backpressured
    # tile takes the GIL from the pack within 100 us, and the
    # downstream worker ran several times slower (PERF.md section 5).
    errors = []

    def guarded(tile):
        try:
            tile.run(args.max_ns)
        except BaseException:  # noqa: BLE001 - reported, fatal below
            import traceback

            traceback.print_exc()
            errors.append(tile.name)
            for c in cncs:  # take the sibling tiles down too
                c.signal(CNC_HALT)

    threads = [threading.Thread(target=guarded, args=(t,), name=t.name,
                                daemon=True) for t in tiles]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        print(f"worker: tile(s) died: {errors}", file=sys.stderr)
        return 1
    flight.maybe_dump(f"halt:worker:{args.tile}", wksp=wksp)
    if args.result:
        out = {name: tile_result(name, t) for name, t in zip(names, tiles)}
        out["xray"] = {"spans": xray.dump_spans()}
        with open(args.result, "w") as f:
            json.dump(out, f)
    wksp.leave()
    return 0


if __name__ == "__main__":
    sys.exit(main())
