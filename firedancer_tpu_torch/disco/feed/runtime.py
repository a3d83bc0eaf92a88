"""The fd_feed runtime, the counterpart of
``firedancer_tpu/disco/feed/runtime.py`` (``latency_percentiles``:48,
``verify_tile_stats``:60, ``_spawn_worker``:151, ``run_feed_pipeline``:167).

The topology is the ring graph of ``pipeline.build_topology``; what
changes is where the stages run:

    replay worker   the source (``python -m firedancer_tpu_torch.disco.worker
                    --tile replay``)
    main process    the verify tile in feed mode: a stager thread whose
                    ring drain is one GIL-releasing C call a round, and
                    the dispatcher thread, which makes every torch call
    downstream      dedup, pack and sink on threads of one worker
    worker          (``--tile dedup,pack,sink``)

The workers share the workspace file and never touch CUDA. With
``feed_proc=False`` (and always with the gc pack, whose pending block
the quiescence check must read) every tile runs on a thread of the main
process. The verify tile arms the fd_drain unless ``verify_opts`` say
``drain="off"`` (``tiles.VerifyTile``; the JAX package's default
``FD_DRAIN=auto``): the pre-filter runs beside each batch on the card
and its verdicts reach the dedup tile in the ctl word, in process or in
the downstream worker alike.

Quiescence is read from shared memory: the source exhausted, the feeder
drained (the stager's cursor caught up, no staged slot, nothing in
flight) and every downstream consumer's cursor caught up to its producer
and unchanged over a settle window of 5 passes of 5 ms (the pack's
CU-deferred pending set is invisible to the rings). A worker that exits
or a tile thread that raises before HALT is fatal.

Latencies: ``tempo.tickcount`` is ``time.perf_counter_ns``, one clock
for every process, so the replay's publish ticks and the sink's receipts
meet in the main process (the workers' result files carry them), and
``latency_p50_ns``/``latency_p99_ns`` come from ``tiles.latencies_ns`` on
the 64-bit tick. Each stage's samples are matched to the replay's
publish ticks by ``stage_latencies``: the out-links' and the stager's
(``tiles.LatReservoir``, set on the feed's links only) and the sink's
receipts, which like the end-to-end latency need ``record_digests``.

fd_flight and fd_sentinel (the JAX :223, :545-559): the run installs
its flight options (``flight=``, passed on to the workers, which attach
their tiles' rows by label) and the SIGUSR1 dump, runs a sentinel
(``sentinel=``) from the tiles' start to quiescence, stopped before
HALT and on every raise before the workspace is left, and reads
``stage_hist``, ``slo`` and ``flight_tiles`` at the end
(``pipeline.finish_flight_run``). ``verify_tile_stats`` is a view over
the verify tile's flight lane.

fd_xray (the JAX :545-568): the run installs its xray options (``xray=``,
passed on to the workers with the sentinel's budgets), starts with this
process's span rings emptied, and builds ``PipelineResult.xray`` and the
HALT autopsy from this process's rings and the spans each worker's
result file carries (the source's, and dedup's, pack's and the sink's).
"""

from __future__ import annotations

import json
import os
import pickle
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

# Stages of stage_latency: the source's publish, its ring dwell up to
# the stager's drain, then each tile's publish and the sink's receipt.
STAGES = ("replay_pub", "verify_drain", "verify_pub", "dedup_pub",
          "pack_pub", "sink")
SETTLE_PASSES = 5
SETTLE_S = 0.005
BOOT_WAIT_S = 60.0
LOGGER = "firedancer_tpu_torch.disco.feed"


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


def stage_latencies(pub_ticks, ts, now) -> np.ndarray:
    """ns from the source's publish to each sample's tick: stamp ts[i]
    (the low 32 bits of a publish tick) is matched to the latest publish
    tick at or before now[i] with those low bits. A sample matching no
    publish is dropped."""
    pub = np.sort(np.asarray(pub_ticks, np.int64))
    ts = np.asarray(ts, np.int64)
    now = np.asarray(now, np.int64)
    if not len(pub) or not len(ts):
        return np.zeros(0, np.int64)
    lo = pub & 0xFFFFFFFF
    order = np.lexsort((pub, lo))
    lo_s, pub_s = lo[order], pub[order]
    a = np.searchsorted(lo_s, ts, "left")
    b = np.searchsorted(lo_s, ts, "right")
    out = np.full(len(ts), -1, np.int64)
    cand = pub_s[np.minimum(a, len(pub_s) - 1)]
    one = ((b - a) == 1) & (cand <= now)
    out[one] = now[one] - cand[one]
    for i in np.nonzero((b - a) > 1)[0]:
        seg = pub_s[a[i]:b[i]]
        k = np.searchsorted(seg, now[i], "right") - 1
        if k >= 0:
            out[i] = now[i] - seg[k]
    return out[out >= 0]


def stage_latency(pub_ticks, samples: Dict[str, tuple]) -> Dict[str, dict]:
    """The stage_latency record: latency_percentiles of each stage's
    matched samples ((stamps, ticks) by stage name)."""
    return {name: latency_percentiles(stage_latencies(pub_ticks, *smp))
            for name, smp in samples.items()}


def verify_tile_stats(v) -> Dict[str, object]:
    """The verify_stats record of one VerifyTile, a view over its flight
    lane (``v.fl``; the JAX :60-147) and the tile-only fields: the
    dispatch counters, the healing lane's (``stager_restarts``,
    ``cpu_failover``, ``quarantined``, ``quarantine_err_txn``,
    ``ctl_err_drop``, ``breaker_state`` ("disabled" without a breaker,
    as in the step loop), ``breaker_trips``, ``breaker_reprobes``,
    ``slots_leaked``; all 0 and "closed" on a fault-free feed run), the
    warm accounting (``compile_cnt``, ``compile_ms``,
    ``compile_cache_hit``: the warms this tile paid), the rung ladder's
    (``rung_hist`` keyed by str(rung), ``rung_ladder``,
    ``rung_switches``, ``rung_cur``; {} / [] / 0 / 0 with the scheduler
    off), the drain's and the live reconfig's; ``chaos`` (the injector's
    snapshot) only while one is armed. The JAX shard fields wait for
    multi-GPU; the CPU lane's lanes and wall time stay on the tile
    (``stat_cpu_lanes``, ``stat_cpu_ns``)."""
    from .. import chaos

    m = v.fl.as_dict()
    lanes, batches = m["lanes"], m["batches"]
    fill = lanes / float(batches * v.batch) if batches else 0.0
    feed = bool(v._feed)
    breaker = v._breaker
    st = {
        "batches": batches,
        "lanes": lanes,
        "fill_ratio": round(fill, 4),
        "flush_timeout": m["flush_timeout"],
        "flush_starved": m["flush_starved"],
        "inflight_stall": m["inflight_stall"],
        "mode": v.verify_mode,
        "rlc_fallback": m["rlc_fallback"],
        "feed": feed,
        "slot_stall": v.feed_pool.slot_stall if feed else 0,
        "slot_stall_ms": (round(v.feed_pool.stall_ns / 1e6, 2)
                          if feed else 0.0),
        "device_idle_est_ms": round(m["feed_idle_ns"] / 1e6, 2),
        "stager_restarts": m["stager_restarts"],
        "cpu_failover": m["cpu_failover"],
        "quarantined": m["quarantined"],
        "quarantine_err_txn": m["quarantine_err_txn"],
        "ctl_err_drop": m["ctl_err_drop"],
        "breaker_state": (breaker.state if breaker is not None
                          else "disabled"),
        "breaker_trips": breaker.trips if breaker is not None else 0,
        "breaker_reprobes": breaker.reprobes if breaker is not None else 0,
        "slots_leaked": v.feed_pool.outstanding() if feed else 0,
        "compile_cnt": m["compile_cnt"],
        "compile_ms": round(m["compile_ns"] / 1e6, 1),
        "compile_cache_hit": m["compile_cache_hit"],
        "drain_batches": m["drain_batches"],
        "drain_novel": m["drain_novel"],
        "drain_maybe": m["drain_maybe"],
        "drain_rot": m["drain_rot"],
        "rung_hist": {str(k): n for k, n in sorted(v.stat_rung_hist.items())},
        "rung_ladder": (list(v.rung_sched.rungs)
                        if v.rung_sched is not None else []),
        "rung_switches": m["rung_switches"],
        "rung_cur": m["rung_cur"],
        "reconfigs": m["reconfigs"],
        "reconfig_refused": m["reconfig_refused"],
    }
    c = chaos.active()
    if c is not None:
        st["chaos"] = c.snapshot()
    return st


def _repo() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


def _spawn_worker(tile: str, wksp_path: str, opts: dict, max_ns: int,
                  result_path: str, log_dir: str) -> subprocess.Popen:
    """Start ``python -m firedancer_tpu_torch.disco.worker`` for tile (a
    comma list runs several on threads of one worker), its stderr in
    log_dir. The worker sees no CUDA device."""
    cmd = [sys.executable, "-m", "firedancer_tpu_torch.disco.worker",
           "--wksp", wksp_path, "--tile", tile, "--opts", json.dumps(opts),
           "--max-ns", str(max_ns), "--result", result_path]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    log = os.path.join(log_dir, f"{tile.split(',')[0]}.log")
    with open(log, "ab") as stderr:
        return subprocess.Popen(cmd, cwd=_repo(), stderr=stderr, env=env)


def _tail(path: str) -> str:
    if not os.path.exists(path):
        return ""
    with open(path, "rb") as f:
        return f.read()[-2000:].decode("utf-8", "replace")


def usable_cores() -> int:
    """Cores this process may run on: a process pinned to fewer than the
    host has gains nothing from workers that share its cores."""
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1


def run_feed_pipeline(topo, payloads, verify_backend: str = "gpu",
                      verify_batch: int = 128,
                      verify_max_msg_len: Optional[int] = None,
                      bank_cnt: int = 4, timeout_s: float = 60.0,
                      tcache_depth: int = 4096,
                      verify_opts: Optional[dict] = None,
                      record_digests: bool = False,
                      pack_scheduler: str = "greedy", device="cuda",
                      feed_proc: Optional[bool] = None, tile_hook=None,
                      tile_cpus: Optional[List[int]] = None, chaos=None,
                      flight=None, sentinel=None, xray=None):
    """pipeline.run_pipeline's contract through the fd_feed runtime
    (run_pipeline routes here); returns a PipelineResult with feed=True,
    the feeder's verify_stats, stage_latency and CPU seconds by process.
    feed_proc: True runs the source and dedup/pack/sink in worker
    processes, False on threads here, None (auto) processes when this
    process may run on 4 or more cores (usable_cores: its affinity mask,
    where the JAX rule counts the host's); pack_scheduler "gc" always
    runs in process. tile_hook, if given, is called with the verify tile
    right after the tile threads start (a live reconfig's control
    channel, the JAX :367-371). tile_cpus pins replay, verify, dedup,
    pack and sink to its cores in that order, wrapping when short, a
    worker's tiles through its cpu_map option. chaos (None, a
    (seed, schedule) pair or a ChaosInjector) is armed for the run
    (disco.chaos.armed) and forces every tile into this process, so that
    one injector books every site (the JAX :249-257). flight, sentinel
    and xray are the run's options (pipeline.run_pipeline). Raises on a
    tile error, a worker's early exit and a timeout."""
    from .. import chaos as chaos_mod
    from .. import flight as flight_mod
    from .. import xray as xray_mod

    vopts = dict(verify_opts or {}, feed=True)
    with flight_mod.configured(flight), \
            xray_mod.configured(xray, sentinel, vopts), \
            chaos_mod.armed(chaos):
        return _run_feed(topo, payloads, verify_backend, verify_batch,
                         verify_max_msg_len, bank_cnt, timeout_s,
                         tcache_depth, verify_opts, record_digests,
                         pack_scheduler, device, feed_proc, tile_hook,
                         tile_cpus, sentinel)


def _run_feed(topo, payloads, verify_backend, verify_batch,
              verify_max_msg_len, bank_cnt, timeout_s, tcache_depth,
              verify_opts, record_digests, pack_scheduler, device,
              feed_proc, tile_hook, tile_cpus, sentinel_opts):
    """run_feed_pipeline's body, with the run's flight options installed
    and its injector (if any) armed."""
    from ...tango.rings import CNC_HALT, Cnc, FSeq, MCache, Workspace
    from .. import chaos as chaos_mod
    from .. import flight
    from .. import pipeline as pl
    from .. import sentinel as sentinel_mod
    from .. import xray
    from ..monitor import snapshot
    from ..tiles import LatReservoir, VerifyTile, latencies_ns

    use_proc = (usable_cores() >= 4 if feed_proc is None
                else bool(feed_proc))
    if pack_scheduler == "gc" or chaos_mod.active() is not None:
        # The gc pack holds a block of txns no ring cursor shows: the
        # quiescence check reads it, which needs the pack in process. An
        # armed injector's counters are this process's.
        use_proc = False
    mtu = topo.mtu
    xray.reset_rings()
    wksp = Workspace.join(topo.wksp_path)
    flight.install_dump_signal(wksp)  # SIGUSR1 -> a live dump
    vopts = dict(verify_opts or {}, feed=True)
    verify = VerifyTile(wksp, "verify.cnc", pl.in_link(wksp, "replay_verify"),
                        pl.out_link(wksp, "verify_dedup", mtu),
                        backend=verify_backend, batch=verify_batch,
                        max_msg_len=verify_max_msg_len or mtu,
                        tcache_depth=tcache_depth, device=device, **vopts)
    verify.out_link.lat = LatReservoir()
    opts = {"mtu": mtu, "tcache_depth": tcache_depth, "bank_cnt": bank_cnt,
            "pack_scheduler": pack_scheduler,
            "record_digests": record_digests}
    replay = dedup = pack = sink = None
    tiles = [verify]
    if not use_proc:
        replay, dedup, pack, sink = (
            pl.build_tile(wksp, name, payloads=payloads, device=device,
                          **opts)
            for name in ("replay", "dedup", "pack", "sink"))
        tiles = [replay, verify, dedup, pack, sink]
        for t in (replay, dedup, pack):
            t.out_link.lat = LatReservoir()
    if tile_cpus:
        cpu_map = {name: tile_cpus[i % len(tile_cpus)] for i, name in
                   enumerate(("replay", "verify", "dedup", "pack", "sink"))}
        for t in tiles:
            t.cpu_idx = cpu_map[t.name]
        opts["cpu_map"] = cpu_map
    # The workers run under this run's flight and xray options (and the
    # sentinel's budgets, their tail thresholds).
    wopts = dict(opts, flight=flight.options().as_dict(),
                 xray=xray.options().as_dict(),
                 slo_budgets=dict(xray.sentinel_options().budgets))

    tile_max_ns = int((timeout_s + 30.0) * 1e9)
    errors: list = []

    def target(t):
        try:
            t.run(tile_max_ns)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=target, args=(t,), name=t.name,
                                daemon=True) for t in tiles]
    tmp = tempfile.mkdtemp(prefix="fd_feed_")
    results = {"replay": os.path.join(tmp, "replay.json"),
               "downstream": os.path.join(tmp, "downstream.json")}
    procs: Dict[str, subprocess.Popen] = {}
    snt = None
    ru_self = resource.getrusage(resource.RUSAGE_SELF)
    ru_kids = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.perf_counter()
    try:
        if use_proc:
            procs["downstream"] = _spawn_worker(
                "dedup,pack,sink", topo.wksp_path, wopts, tile_max_ns,
                results["downstream"], tmp)
            payloads_path = os.path.join(tmp, "payloads.pkl")
            with open(payloads_path, "wb") as f:
                pickle.dump(list(payloads), f)
            procs["replay"] = _spawn_worker(
                "replay", topo.wksp_path,
                dict(wopts, payloads_path=payloads_path), tile_max_ns,
                results["replay"], tmp)
        for th in threads:
            th.start()
        snt = sentinel_mod.start_for_run(wksp, topo.pod, sentinel_opts)
        if tile_hook is not None:
            tile_hook(verify)

        links = [(MCache(wksp, f"{k}.mcache"), FSeq(wksp, f"{k}.fseq"))
                 for k in ("verify_dedup", "dedup_pack", "pack_sink")]
        worker_cncs = [Cnc(wksp, f"{t}.cnc") for t in
                       ("replay", "dedup", "pack", "sink")] if use_proc \
            else []
        src_mcache = MCache(wksp, "replay_verify.mcache")
        n_payloads = len(payloads)

        def feeder_drained() -> bool:
            return (verify.in_link.seq >= src_mcache.seq_next()
                    and verify.feed_pool.idle() and not verify._inflight)

        deadline = t0 + timeout_s
        settle, last = 0, None
        died = None
        done = False
        while time.perf_counter() < deadline:
            for name, proc in procs.items():
                if proc.poll() is not None:
                    died = (name, proc.returncode)
                    break
            if died or errors:
                break
            cursors = tuple((mc.seq_next(), fs.query()) for mc, fs in links)
            if (src_mcache.seq_next() >= n_payloads and feeder_drained()
                    and all(fs >= mc for mc, fs in cursors)
                    and (pack is None or pack.drained())
                    and cursors == last):
                settle += 1
                if settle >= SETTLE_PASSES:
                    done = True
                    break
            else:
                settle = 0
            last = cursors
            time.sleep(SETTLE_S)
        # At quiescence, before HALT: the drain books no stall.
        slo = snt.stop() if snt is not None else None

        # A worker tile still in BOOT would overwrite HALT with RUN when
        # it reaches its loop: wait (bounded) until each has left BOOT
        # or its process is gone.
        if procs and died is None:
            boot_deadline = time.perf_counter() + BOOT_WAIT_S
            while time.perf_counter() < boot_deadline:
                if any(p.poll() is not None for p in procs.values()):
                    break
                if all(c.signal_query() != 0 for c in worker_cncs):
                    break
                time.sleep(0.01)
        for t in tiles:
            t.cnc.signal(CNC_HALT)
        for c in worker_cncs:
            c.signal(CNC_HALT)
        join_deadline = time.perf_counter() + timeout_s + 35.0
        for th in threads:
            th.join(timeout=max(0.1, join_deadline - time.perf_counter()))
        if died is None:
            for name, proc in procs.items():
                try:
                    proc.wait(timeout=60.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                if proc.returncode != 0 and died is None:
                    died = (name, proc.returncode)
        elapsed = time.perf_counter() - t0
        ru_self2 = resource.getrusage(resource.RUSAGE_SELF)
        ru_kids2 = resource.getrusage(resource.RUSAGE_CHILDREN)

        if errors:
            raise errors[0]
        if died is not None:
            name, rc = died
            log = os.path.join(tmp, ("dedup" if name == "downstream"
                                     else name) + ".log")
            raise RuntimeError(f"fd_feed {name} worker exited rc={rc} "
                               f"mid-run; stderr tail:\n{_tail(log)}")
        if not done:
            raise TimeoutError(f"the feed pipeline did not drain within "
                               f"{timeout_s} s")

        if use_proc:
            with open(results["downstream"]) as f:
                down = json.load(f)
            with open(results["replay"]) as f:
                rep_doc = json.load(f)
            rep = rep_doc["replay"]
            replay_rec = SimpleNamespace(payloads=payloads,
                                         pub_ticks=rep["pub_ticks"])
            s = down["sink"]
            sink_rec = SimpleNamespace(
                recv_cnt=s["recv_cnt"], recv_sz=s["recv_sz"],
                bank_hist={int(k): v for k, v in s["bank_hist"].items()},
                t_last=s["t_last"],
                digests=[bytes.fromhex(d) for d in s["digests"]],
                recv_tsorig=s["recv_tsorig"], recv_ticks=s["recv_ticks"])
            samples = {
                "replay_pub": rep["lat"],
                "dedup_pub": down["dedup"]["lat"],
                "pack_pub": down["pack"]["lat"]}
            tile_cpu = {"replay": rep["cpu_s"],
                        **{k: down[k]["cpu_s"]
                           for k in ("dedup", "pack", "sink")}}
            pack_stats = down["pack"]["stats"]
            dedup_stats = down["dedup"]["stats"]
            worker_spans = xray.merge_spans(
                (down.get("xray") or {}).get("spans") or {},
                (rep_doc.get("xray") or {}).get("spans"))
        else:
            worker_spans = None
            replay_rec, sink_rec = replay, sink
            samples = {"replay_pub": replay.out_link.lat.samples(),
                       "dedup_pub": dedup.out_link.lat.samples(),
                       "pack_pub": pack.out_link.lat.samples()}
            tile_cpu = {t.name: t.cpu_ns / 1e9
                        for t in (replay, dedup, pack, sink)}
            pack_stats = pl._pack_stats(pack)
            dedup_stats = pl._dedup_stats(dedup)
        samples["verify_drain"] = verify.drain_lat.samples()
        samples["verify_pub"] = verify.out_link.lat.samples()
        samples["sink"] = (sink_rec.recv_tsorig, sink_rec.recv_ticks)
        pub_ticks = replay_rec.pub_ticks
        tile_cpu["verify"] = verify.cpu_ns / 1e9
        tile_cpu["verify.stager"] = verify.stager_cpu_ns / 1e9
        lat = latencies_ns(replay_rec, sink_rec) if record_digests else []
        p = latency_percentiles(lat)
        res = pl.PipelineResult(
            recv_cnt=sink_rec.recv_cnt,
            recv_sz=sink_rec.recv_sz,
            bank_hist=dict(sink_rec.bank_hist),
            diag=snapshot(wksp, pl.TILES, pl.LINKS),
            elapsed_s=elapsed,
            span_s=((sink_rec.t_last - pub_ticks[0]) / 1e9
                    if sink_rec.recv_cnt else 0.0),
            latency_p50_ns=p["p50_ns"],
            latency_p99_ns=p["p99_ns"],
            verify_stats=[verify_tile_stats(verify)],
            sink_digests=(list(sink_rec.digests) if record_digests
                          else None),
            tile_cpu_s=tile_cpu,
            pack_stats=pack_stats,
            dedup_stats=dedup_stats,
            feed=True,
            stage_latency=stage_latency(
                pub_ticks, {k: samples[k] for k in STAGES}),
        )
        pl.finish_flight_run(wksp, res, slo, extra_spans=worker_spans)
        res.proc_cpu_s["main"] = round(
            ru_self2.ru_utime + ru_self2.ru_stime - ru_self.ru_utime
            - ru_self.ru_stime, 6)
        if use_proc:
            res.proc_cpu_s["workers"] = round(
                ru_kids2.ru_utime + ru_kids2.ru_stime - ru_kids.ru_utime
                - ru_kids.ru_stime, 6)
        return res
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if snt is not None:
            snt.stop()  # idempotent: a raise must stop the poller too
        # Only after every tile thread and the sentinel have ended: a
        # thread still reading or writing the mapping would fault.
        if all(not th.is_alive() for th in threads) and (
                snt is None or not snt.alive()):
            wksp.leave()
        shutil.rmtree(tmp, ignore_errors=True)
