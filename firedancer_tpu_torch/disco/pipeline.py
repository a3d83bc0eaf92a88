"""Topology of the tile graph and its in-process runner, the counterpart
of ``firedancer_tpu/disco/pipeline.py`` (``lane_link``:58,
``build_topology``:64, ``LINKS``, ``TILES``, ``Topology``,
``PipelineResult``:191, ``_run_tiles``:245, ``run_pipeline``:483).

``build_topology`` creates the workspace file, the four links
(mcache, dcache and fseq each) and a cnc per tile, under the JAX
package's names, so either package's tiles can join it, and records
them in ``Topology.pod`` (``utils.pod.Pod``), which ``app.configure``
writes to the pod file. ``verify_lanes`` > 1 adds each further verify
lane's ``replay_verify.v<i>`` and ``verify_dedup.v<i>`` links and its
``verify.v<i>`` cnc (the reference's ``verify_tile_count``): the replay
fans out round-robin and the dedup tile muxes the lanes back in. Tiles
join a link by its name (``link_names``); the producer of a link takes
credits from the link's own fseq, which its consumer publishes.

``run_pipeline`` drives replay -> verify -> dedup -> pack -> sink and
returns a ``PipelineResult``. As in the JAX package it routes through the
fd_feed runtime (``feed.runtime.run_feed_pipeline``: the staging-slot
feeder, the source and the downstream tiles in worker processes) unless
the caller passes ``feed=False`` or the feed cannot serve the topology
(``_feed_fallback_reason``:429 there, warned and recorded; the feed
serves one verify lane); else it runs the in-process step loop (the JAX
``FD_FEED=0`` runner), a verify tile a lane, until the chain has
drained (``pipeline_quiesced``). ``run_tiles`` and ``chain_quiesced``
also drive the shorter replay -> verify -> sink chain.

fd_flight and fd_sentinel (the JAX :98-158, :320-336): the workspace
holds the registry's regions (``flight.create_regions``: a metric row a
tile, a span histogram a link edge and ``verify_drain``, ``sink`` and
``quic_ingest``, a row an SLO) and the pod ``firedancer.flight.schema``.
Both runners take ``flight`` and ``sentinel`` options
(``flight.FlightOptions``, ``sentinel.SentinelOptions``, or a bool for
on/off; the JAX flags' defaults, both on), install the SIGUSR1 dump,
run a ``Sentinel`` beside the tiles and stop it at quiescence, before
HALT and before the workspace is left, on every path;
``finish_flight_run`` writes the HALT dump and the Prometheus text
where the options name them and reads ``PipelineResult.stage_hist``.

fd_xray (the JAX :128-131, :146-149, :232-236, :419-421): the workspace
holds the ``xray.queue`` region (an rx and a tx row a span edge), both
runners take ``xray`` options (``xray.XrayOptions`` or a bool; on by
default, as the JAX FD_XRAY) and start with this process's span rings
emptied, ``finish_flight_run`` writes the HALT autopsy where the options
name a directory, and ``PipelineResult.xray`` is the run's summary
(``xray.run_summary``; None with xray off).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..ballet.txn import MAX_SIG_CNT
from ..tango import rings
from ..tango.rings import CNC_HALT, Cnc, DCache, FSeq, MCache, Workspace
from ..utils.pod import Pod
from . import flight
from . import sentinel as sentinel_mod
from . import xray as xray_mod
from .feed.runtime import (
    LOGGER,
    latency_percentiles,
    verify_tile_stats,
)
from .monitor import snapshot
from .tiles import (
    FD_TPU_MTU,
    DedupTile,
    InLink,
    LinkNames,
    OutLink,
    PackTile,
    ReplayTile,
    SinkTile,
    VerifyTile,
    latencies_ns,
)

LINKS = ("replay_verify", "verify_dedup", "dedup_pack", "pack_sink")
TILES = ("replay", "verify", "dedup", "pack", "sink", "quic")
# The span edges beside the links: the stager's ring dwell, the
# end-to-end span and the QUIC tile's admission span.
SPAN_EDGES = ("verify_drain", "sink", "quic_ingest")


# The links each further verify lane adds.
LANE_LINKS = ("replay_verify", "verify_dedup")


@dataclass
class Topology:
    wksp_path: str
    depth: int = 128
    mtu: int = FD_TPU_MTU
    # The wiring build_topology recorded; an empty pod reads as one lane.
    pod: Pod = field(default_factory=Pod)

    @property
    def verify_lanes(self) -> int:
        return self.pod.query_ulong("firedancer.layout.verify_lane_cnt", 1)


def lane_link(link: str, lane: int) -> str:
    """Name of a per-lane link or tile: lane 0 keeps the plain name, lane
    i > 0 is ``<link>.v<i>`` (the reference's verify.v%i naming)."""
    return link if lane == 0 else f"{link}.v{lane}"


def topology_links(lanes: int = 1) -> List[str]:
    """The links of a topology of lanes verify lanes: LINKS, then each
    further lane's."""
    return list(LINKS) + [lane_link(k, i) for k in LANE_LINKS
                          for i in range(1, lanes)]


def topology_tiles(lanes: int = 1) -> List[str]:
    """The tiles (cncs) of a topology of lanes verify lanes."""
    return list(TILES) + [lane_link("verify", i) for i in range(1, lanes)]


def topology_edges(lanes: int = 1) -> List[str]:
    """The span histogram edges of a topology: its links, then
    SPAN_EDGES."""
    return topology_links(lanes) + list(SPAN_EDGES)


def link_names(link: str) -> LinkNames:
    return LinkNames(f"{link}.mcache", f"{link}.dcache", f"{link}.fseq")


def dcache_size(depth: int, mtu: int = FD_TPU_MTU) -> int:
    """Bytes of a link's dcache: room for depth + 2 frags of mtu."""
    return 64 * ((mtu + 63) // 64) * (depth + 2)


def build_topology(wksp_path: str, depth: int = 128, mtu: int = FD_TPU_MTU,
                   wksp_sz: int = 1 << 24, verify_lanes: int = 1) -> Topology:
    """Create the workspace and every link and cnc of verify_lanes verify
    lanes; the file stays for tiles to join (Workspace.join). The pod
    records each link's mcache, dcache, fseq and depth, each tile's cnc,
    ``firedancer.mtu``, ``firedancer.layout.verify_lane_cnt`` and
    ``firedancer.flight.schema``, under the JAX package's keys. The
    fd_flight regions follow (a row a tile, a span a topology_edges
    edge, a row an SLO) and fd_xray's queue region (an rx and a tx row a
    topology_edges edge), as the JAX package lays them out."""
    if verify_lanes < 1:
        raise ValueError(f"verify_lanes must be at least 1, got "
                         f"{verify_lanes}")
    links = topology_links(verify_lanes)
    tiles = topology_tiles(verify_lanes)
    edges = topology_edges(verify_lanes)
    need = len(links) * dcache_size(depth, mtu)
    if wksp_sz < need:
        raise ValueError(f"wksp_sz {wksp_sz} holds less than the links' "
                         f"dcaches ({need} bytes at depth {depth}, "
                         f"{len(links)} links)")
    pod = Pod()
    wksp = Workspace.create(wksp_path, wksp_sz)
    try:
        for link in links:
            names = link_names(link)
            MCache(wksp, names.mcache, depth=depth, create=True)
            DCache(wksp, names.dcache, data_sz=dcache_size(depth, mtu),
                   create=True)
            FSeq(wksp, names.fseq, create=True)
            pod.insert_cstr(f"firedancer.{link}.mcache", names.mcache)
            pod.insert_cstr(f"firedancer.{link}.dcache", names.dcache)
            pod.insert_cstr(f"firedancer.{link}.fseq", names.fseq)
            pod.insert_ulong(f"firedancer.{link}.depth", depth)
        for tile in tiles:
            Cnc(wksp, f"{tile}.cnc", create=True)
            pod.insert_cstr(f"firedancer.{tile}.cnc", f"{tile}.cnc")
        flight.create_regions(wksp, tiles, edges,
                              slo_labels=sentinel_mod.SLO_NAMES)
        xray_mod.create_region(wksp, edges)
    finally:
        wksp.leave()
    pod.insert_ulong("firedancer.mtu", mtu)
    pod.insert_ulong("firedancer.layout.verify_lane_cnt", verify_lanes)
    pod.insert_ulong("firedancer.flight.schema",
                     flight.ARTIFACT_SCHEMA_VERSION)
    return Topology(wksp_path=wksp_path, depth=depth, mtu=mtu, pod=pod)


def in_link(wksp: Workspace, link: str) -> InLink:
    """The consumer side of link, with the link's xray queue row (edge =
    link)."""
    return InLink(wksp, link_names(link), edge=link)


def out_link(wksp: Workspace, link: str, mtu: int = FD_TPU_MTU) -> OutLink:
    """The producer side of link, with its consumer's fseq as the one
    reliable consumer of the credit flow control and the link's span
    histogram (edge = link)."""
    names = link_names(link)
    return OutLink(wksp, names, mtu=mtu,
                   reliable_fseqs=[FSeq(wksp, names.fseq)], edge=link)


def build_tile(wksp: Workspace, name: str, mtu: int = FD_TPU_MTU,
               payloads=(), tcache_depth: int = 4096, bank_cnt: int = 4,
               pack_scheduler: str = "greedy", record_digests: bool = False,
               device="cuda", lanes: int = 1):
    """Tile name (replay, dedup, pack or sink) on its links of the
    topology: the one constructor of the runners' tiles, in process and in
    the worker processes (worker.py). Over lanes verify lanes the replay
    fans out to each lane's replay_verify and the dedup tile muxes each
    lane's verify_dedup."""
    if name == "replay":
        return ReplayTile(wksp, "replay.cnc", out_links=[
            out_link(wksp, lane_link("replay_verify", i), mtu)
            for i in range(lanes)], payloads=payloads)
    if name == "dedup":
        return DedupTile(wksp, "dedup.cnc",
                         in_links=[in_link(wksp, lane_link("verify_dedup", i))
                                   for i in range(lanes)],
                         out_link=out_link(wksp, "dedup_pack", mtu),
                         tcache_depth=tcache_depth)
    if name == "pack":
        return PackTile(wksp, "pack.cnc", in_link(wksp, "dedup_pack"),
                        out_link(wksp, "pack_sink", mtu), bank_cnt=bank_cnt,
                        scheduler=pack_scheduler, device=device)
    if name == "sink":
        return SinkTile(wksp, "sink.cnc", in_link(wksp, "pack_sink"),
                        record_digests=record_digests)
    raise ValueError(f"unknown tile {name!r} (want replay, dedup, pack "
                     "or sink)")


def chain_quiesced(replay, verifies, sink) -> bool:
    """replay -> verify -> sink has drained: the source is exhausted,
    each verify tile (one, or a list: one a lane, in the order of the
    replay's out-links and the sink's in-links) consumed all of its lane
    with nothing staged (in its slots, in feed mode) or in flight, and
    the sink (or any next tile) consumed all each verify published."""
    if not isinstance(verifies, (list, tuple)):
        verifies = [verifies]
    if not replay.done():
        return False
    for src, verify, dst in zip(replay.out_links, verifies, sink.in_links):
        if not (verify.in_link.seq >= src.seq
                and not verify._pending
                and (not verify._feed or verify.feed_pool.idle())
                and not verify._inflight
                and dst.seq >= verify.out_link.seq):
            return False
    return True


def run_tiles(tiles, quiesced, timeout_s: float = 60.0,
              sentinel=None, pre_wait=None) -> float:
    """Run each tile on a thread until quiesced() (or timeout_s, or a
    tile raising), stop the run's sentinel (if given), then signal HALT
    through every cnc and join. pre_wait, if given, is called once the
    threads run and returns a function called after they joined (the
    QUIC run's client thread). Returns the seconds it ran; raises the
    first tile error, and TimeoutError when the tiles never quiesced."""
    errors: list = []

    def target(t):
        try:
            t.run(int((timeout_s + 30.0) * 1e9))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=target, args=(t,), name=t.name,
                                daemon=True) for t in tiles]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    done = False
    post_wait = None
    try:
        if pre_wait is not None:
            post_wait = pre_wait()
        while time.perf_counter() - t0 < timeout_s and not errors:
            if quiesced():
                done = True
                break
            time.sleep(0.002)
    finally:
        # At quiescence and before HALT, so the drain books no stall.
        if sentinel is not None:
            sentinel.stop()
    for t in tiles:
        t.cnc.signal(CNC_HALT)
    for th in threads:
        th.join(timeout=timeout_s + 35.0)
    if post_wait is not None:
        post_wait()
    elapsed = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if not done:
        raise TimeoutError(f"tiles did not drain within {timeout_s} s")
    return elapsed


def pipeline_quiesced(replay, verifies, dedup, pack, sink) -> bool:
    """replay -> verify -> dedup -> pack -> sink has drained: the source
    is exhausted and each stage consumed all its producer published, with
    nothing staged, in flight or pending (the JAX runner's check,
    pipeline.py:345-360, and pack.drained(): every frag the pack consumed
    was published or filtered); verifies is one verify tile or a list,
    one a lane. Each stage is read after its producer, so a stage found
    drained gets no more input."""
    if not chain_quiesced(replay, verifies, dedup):
        return False
    if pack.in_link.seq < dedup.out_link.seq or not pack.drained():
        return False
    return sink.in_link.seq >= pack.out_link.seq


@dataclass
class PipelineResult:
    recv_cnt: int
    recv_sz: int
    bank_hist: Dict[int, int]
    diag: Dict[str, Dict[str, int]]
    elapsed_s: float
    # Seconds from the replay's first publish to the sink's last frag.
    span_s: float = 0.0
    # End-to-end latency (replay publish -> sink), ns, on the full tick
    # count (tiles.latencies_ns); 0 without record_digests.
    latency_p50_ns: int = 0
    latency_p99_ns: int = 0
    verify_stats: List[Dict[str, object]] = field(default_factory=list)
    # sha256 of every payload the sink received (record_digests).
    sink_digests: Optional[List[bytes]] = None
    # fd_flight's span histograms by edge, {n, p50_ns_le, p99_ns_le,
    # sum_ns}, over the whole population (read from the workspace).
    stage_hist: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # fd_sentinel's run summary (Sentinel.summary; None with it off).
    slo: Optional[dict] = None
    # The flight metric rows by tile at the end of the run (read_tiles;
    # every process's lanes, published).
    flight_tiles: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # The port's own records: thread CPU seconds by tile, the pack
    # tile's counters (scheduler, blocks, the gc gate, CU-cap drops) and
    # the dedup tile's fd_drain counters (probe_skip, probed,
    # false_novel; the JAX tile's fl_drain_* lane counters).
    tile_cpu_s: Dict[str, float] = field(default_factory=dict)
    pack_stats: Dict[str, object] = field(default_factory=dict)
    dedup_stats: Dict[str, int] = field(default_factory=dict)
    # True when the fd_feed runtime ran; otherwise why it could not
    # serve the topology (None when the caller passed feed=False).
    feed: bool = False
    feed_fallback_reason: Optional[str] = None
    # The feed's {n, p50_ns, p99_ns} by stage (feed.runtime.STAGES),
    # from the source's publish on the 64-bit tick; the sink's stage
    # needs record_digests.
    stage_latency: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # CPU seconds of the run by process (the feed): "main", and with
    # worker processes "workers", theirs after they exited.
    proc_cpu_s: Dict[str, float] = field(default_factory=dict)
    # fd_xray's run summary (xray.run_summary: exemplar counts by
    # trigger, sampled traces, the slowest exemplars, the waterfall, the
    # suspects); None with xray off.
    xray: Optional[dict] = None
    # The QUIC tile's record (quic_tile.quic_tile_stats) of a
    # run_quic_pipeline run; None for the other runners.
    quic: Optional[dict] = None


def _pack_stats(pack: PackTile) -> Dict[str, object]:
    return {
        "scheduler": pack.scheduler,
        "blocks": pack.stat_block_device + pack.stat_sched_fallback,
        "dev_blocks": pack.stat_dev_blocks,
        "block_device": pack.stat_block_device,
        "wave_device": pack.stat_wave_device,
        "sched_fallback": pack.stat_sched_fallback,
        "cu_drop": pack.stat_cu_drop,
        "gc_s": pack.stat_gc_ns / 1e9,
        "gate_s": pack.stat_gate_ns / 1e9,
    }


def _dedup_stats(dedup: DedupTile) -> Dict[str, int]:
    return {"probe_skip": dedup.stat_drain_probe_skip,
            "probed": dedup.stat_drain_probed,
            "false_novel": dedup.stat_drain_false_novel}


def finish_flight_run(wksp: Workspace, res: "PipelineResult",
                      slo_summary: Optional[dict] = None,
                      extra_spans: Optional[dict] = None) -> None:
    """The end of a run, with the tiles halted and the sentinel stopped
    (the JAX :138-158, :419-421): the HALT dump, the HALT autopsy (with
    the run's alerts and the worker processes' spans, extra_spans) and
    the Prometheus text where the run's options name them, and res's
    stage_hist, slo, flight_tiles and xray from the workspace."""
    opts = flight.options()
    alerts = (slo_summary or {}).get("alerts")
    flight.maybe_dump("halt", wksp=wksp)
    xray_mod.maybe_autopsy("halt", wksp=wksp, alerts=alerts,
                           extra_spans=extra_spans)
    if opts.metrics_prom:
        try:
            with open(opts.metrics_prom, "w") as f:
                f.write(flight.render_prom(wksp))
        except OSError:
            pass
    res.stage_hist = flight.read_edges(wksp) or {}
    res.flight_tiles = flight.read_tiles(wksp) or {}
    res.slo = slo_summary
    res.xray = xray_mod.run_summary(wksp, extra_spans=extra_spans,
                                    alerts=alerts)


def pin_tiles(tiles, tile_cpus: Optional[List[int]]) -> None:
    """Core pinning (the reference's layout.affinity): the configured CPU
    list assigned to tiles in topology order, wrapping when short."""
    for i, t in enumerate(tiles if tile_cpus else ()):
        t.cpu_idx = tile_cpus[i % len(tile_cpus)]


def _run_tiles(wksp: Workspace, replay, verify_backend: str,
               verify_batch: int, verify_max_msg_len: int, bank_cnt: int,
               timeout_s: float, tcache_depth: int, verify_opts: dict,
               record_digests: bool, pack_scheduler: str,
               device, lanes: int = 1,
               tile_cpus: Optional[List[int]] = None, pod=None,
               sentinel_opts=None, pre_wait=None):
    """Wire the source's lanes (replay, a ReplayTile, or any source with
    its out_links, done(), payloads and pub_ticks, as the QUIC tile) through
    a verify tile each (lane i on
    ``verify.v<i>.cnc`` and its lane's links) -> dedup -> pack -> sink,
    run the tiles until pipeline_quiesced (raising on a tile error or a
    timeout) beside the run's sentinel (stopped on every path), snapshot
    the diag counters of every tile and link and finish the flight
    run. Returns (result, the sentinel or None)."""
    verifies = []
    for i in range(lanes):
        v = VerifyTile(wksp, f"{lane_link('verify', i)}.cnc",
                       in_link(wksp, lane_link("replay_verify", i)),
                       out_link(wksp, lane_link("verify_dedup", i)),
                       backend=verify_backend, batch=verify_batch,
                       max_msg_len=verify_max_msg_len,
                       tcache_depth=tcache_depth, device=device,
                       **verify_opts)
        v.name = lane_link("verify", i)
        verifies.append(v)
    dedup, pack, sink = (
        build_tile(wksp, name, tcache_depth=tcache_depth, bank_cnt=bank_cnt,
                   pack_scheduler=pack_scheduler,
                   record_digests=record_digests, device=device,
                   lanes=lanes)
        for name in ("dedup", "pack", "sink"))
    tiles = [replay, *verifies, dedup, pack, sink]
    pin_tiles(tiles, tile_cpus)
    snt = sentinel_mod.start_for_run(wksp, pod, sentinel_opts)
    try:
        elapsed = run_tiles(
            tiles,
            lambda: pipeline_quiesced(replay, verifies, dedup, pack, sink),
            timeout_s=timeout_s, sentinel=snt, pre_wait=pre_wait)
    finally:
        slo = snt.stop() if snt is not None else None
    lat = latencies_ns(replay, sink) if record_digests else []
    res = PipelineResult(
        recv_cnt=sink.recv_cnt,
        recv_sz=sink.recv_sz,
        bank_hist=dict(sink.bank_hist),
        diag=snapshot(wksp, topology_tiles(lanes), topology_links(lanes)),
        elapsed_s=elapsed,
        span_s=((sink.t_last - replay.pub_ticks[0]) / 1e9
                if sink.recv_cnt else 0.0),
        verify_stats=[verify_tile_stats(v) for v in verifies],
        sink_digests=list(sink.digests) if record_digests else None,
        tile_cpu_s={t.name: t.cpu_ns / 1e9 for t in tiles},
        pack_stats=_pack_stats(pack),
        dedup_stats=_dedup_stats(dedup),
    )
    p = latency_percentiles(lat)
    res.latency_p50_ns, res.latency_p99_ns = p["p50_ns"], p["p99_ns"]
    finish_flight_run(wksp, res, slo)
    return res, snt


def _feed_fallback_reason(verify_backend: str, verify_batch: int,
                          verify_opts: Optional[dict],
                          lanes: int = 1) -> Optional[str]:
    """None when the fd_feed runtime can serve the topology, else why
    not: the feed needs the gpu backend, exactly one verify lane (the
    JAX reason word for word), a batch any parsed txn fits, the current
    drain ABI and the native drain."""
    if verify_backend != "gpu":
        return f"verify backend {verify_backend!r} (the feed needs gpu)"
    if lanes != 1:
        return f"verify_lane_cnt={lanes} (feed serves exactly 1 lane)"
    if verify_batch < MAX_SIG_CNT:
        return (f"verify_batch={verify_batch} < MAX_SIG_CNT={MAX_SIG_CNT} "
                "(a parsed txn must fit a fresh slot)")
    try:
        rings.require_drain()
    except Exception as e:  # noqa: BLE001 - the reason is the error
        return f"native ring library: {e}"
    if verify_opts and verify_opts.get("native_drain") is False:
        return "verify_opts disabled the native drain"
    return None


def run_pipeline(topo: Topology, payloads: List[bytes],
                 verify_backend: str = "gpu", verify_batch: int = 128,
                 verify_max_msg_len: Optional[int] = None,
                 bank_cnt: int = 4, timeout_s: float = 60.0,
                 tcache_depth: int = 4096,
                 verify_opts: Optional[dict] = None,
                 record_digests: bool = False,
                 pack_scheduler: str = "greedy",
                 device="cuda", feed: Optional[bool] = None,
                 feed_proc: Optional[bool] = None,
                 tile_cpus: Optional[List[int]] = None,
                 chaos=None, flight=None, sentinel=None,
                 xray=None) -> PipelineResult:
    """Replay-sourced pipeline: payloads -> verify -> dedup -> pack ->
    sink, over the topology's verify lanes (topo.pod). feed None or True
    runs the fd_feed runtime when it can serve the topology (feed_proc:
    its process layout, run_feed_pipeline), and otherwise warns on the
    firedancer_tpu_torch.disco.feed logger, keeps the reason in
    feed_fallback_reason and runs the in-process step loop, which
    feed=False asks for; the feed serves one lane, so more than one
    always runs the step loop. The verify engine and the gc pack run on
    device: the card unless the caller passes device="cpu". tile_cpus
    pins the tiles to cores in topology order (pin_tiles). chaos, None,
    a (seed, schedule) pair or a disco.chaos.ChaosInjector, is armed
    for the run in either runner (a pair gives a fresh injector, so the
    run replays its faults) and uninstalled when the run ends or raises;
    the feed then runs every tile in process. flight, sentinel and xray
    are the run's fd_flight, fd_sentinel and fd_xray options (None: the
    flight and xray options in force and the sentinel's defaults, all
    on; a bool turns one on or off; see the module docstring). Shutdown is by quiescence
    (source exhausted and every link drained); filtered frags never
    reach the sink, so the caller reads recv_cnt and the diag
    counters."""
    from . import chaos as chaos_mod
    from . import flight as flight_mod

    with flight_mod.configured(flight), \
            xray_mod.configured(xray, sentinel, verify_opts or {}), \
            chaos_mod.armed(chaos) as inj:
        return _run_pipeline(topo, payloads, verify_backend, verify_batch,
                             verify_max_msg_len, bank_cnt, timeout_s,
                             tcache_depth, verify_opts, record_digests,
                             pack_scheduler, device, feed, feed_proc,
                             tile_cpus, inj, sentinel)


def _run_pipeline(topo, payloads, verify_backend, verify_batch,
                  verify_max_msg_len, bank_cnt, timeout_s, tcache_depth,
                  verify_opts, record_digests, pack_scheduler, device, feed,
                  feed_proc, tile_cpus, inj, sentinel) -> PipelineResult:
    """run_pipeline's body, its flight options installed and its
    injector inj (or None) armed."""
    reason = None
    lanes = topo.verify_lanes
    if feed is None or feed:
        reason = _feed_fallback_reason(verify_backend, verify_batch,
                                       verify_opts, lanes)
        if reason is None:
            from .feed.runtime import run_feed_pipeline

            return run_feed_pipeline(
                topo, payloads, verify_backend=verify_backend,
                verify_batch=verify_batch,
                verify_max_msg_len=verify_max_msg_len, bank_cnt=bank_cnt,
                timeout_s=timeout_s, tcache_depth=tcache_depth,
                verify_opts=verify_opts, record_digests=record_digests,
                pack_scheduler=pack_scheduler, device=device,
                feed_proc=feed_proc, tile_cpus=tile_cpus, chaos=inj,
                sentinel=sentinel)
        logging.getLogger(LOGGER).warning(
            "fd_feed cannot serve this topology, falling back to the "
            "in-process step loop: %s", reason)
    xray_mod.reset_rings()
    wksp = Workspace.join(topo.wksp_path)
    flight.install_dump_signal(wksp)  # SIGUSR1 -> a live dump
    replay = build_tile(wksp, "replay", payloads=payloads, lanes=lanes)
    res, snt = _run_tiles(wksp, replay, verify_backend, verify_batch,
                     verify_max_msg_len or topo.mtu, bank_cnt, timeout_s,
                     tcache_depth, dict(verify_opts or {}), record_digests,
                          pack_scheduler, device, lanes, tile_cpus, topo.pod,
                          sentinel)
    # Only after every tile thread and the sentinel have ended: on an
    # error, or a poller that outlived its join, the mapping is kept,
    # since a thread still reading or writing it would fault.
    if snt is None or not snt.alive():
        wksp.leave()
    res.feed_fallback_reason = reason
    return res


def run_quic_pipeline(topo: Topology, client_fn, n_txns: int,
                      identity_seed: bytes = b"\x11" * 32,
                      verify_backend: str = "gpu", verify_batch: int = 128,
                      verify_max_msg_len: Optional[int] = None,
                      bank_cnt: int = 4, timeout_s: float = 60.0,
                      tile_cpus: Optional[List[int]] = None,
                      quic_retry: bool = False, record_digests: bool = False,
                      feed: Optional[bool] = None,
                      quic_idle_timeout: float = 10.0, quic_stop_when=None,
                      device="cuda", verify_opts: Optional[dict] = None,
                      feed_proc: Optional[bool] = None, chaos=None,
                      flight=None, sentinel=None, xray=None,
                      quic=None) -> PipelineResult:
    """The ingest path: QUIC tile -> verify -> dedup -> pack -> sink (the
    JAX :559-655, its arguments and the port's run_pipeline's device,
    verify_opts, feed_proc, chaos, flight, sentinel and xray; the verify
    backend the card's, "gpu", by default).

    The QUIC tile (``disco.quic_tile.QuicTile``, its options quic: None,
    a bool for the defenses, a dict or ``QuicOptions``) binds an
    ephemeral localhost UDP port; client_fn is called on a helper thread
    with the listen address once the tiles run, and must deliver n_txns
    transactions over QUIC, one a unidirectional stream. The run ends
    when the tile has seen n_txns completed streams, admitted or shed
    each (and, with chaos armed, every scheduled quic_* fault landed and
    healed) and every link has drained, or raises at timeout_s. As
    run_pipeline it routes through the fd_feed runtime with the tile as
    its source where the feed can serve the topology, else through the
    in-process step loop (warned, the reason in feed_fallback_reason).
    The run's injector is handed to the tile. res.quic is
    ``quic_tile_stats``; the end-to-end latency is from the tile's
    publish (record_digests)."""
    from . import chaos as chaos_mod
    from . import flight as flight_mod

    with flight_mod.configured(flight), \
            xray_mod.configured(xray, sentinel, verify_opts or {}), \
            chaos_mod.armed(chaos) as inj:
        return _run_quic_pipeline(
            topo, client_fn, n_txns, identity_seed, verify_backend,
            verify_batch, verify_max_msg_len, bank_cnt, timeout_s,
            tile_cpus, quic_retry, record_digests, feed, quic_idle_timeout,
            quic_stop_when, device, verify_opts, feed_proc, inj, sentinel,
            quic)


def _run_quic_pipeline(topo, client_fn, n_txns, identity_seed,
                       verify_backend, verify_batch, verify_max_msg_len,
                       bank_cnt, timeout_s, tile_cpus, quic_retry,
                       record_digests, feed, quic_idle_timeout,
                       quic_stop_when, device, verify_opts, feed_proc, inj,
                       sentinel, quic_opts) -> PipelineResult:
    """run_quic_pipeline's body, its options installed and its injector
    inj (or None) armed."""
    from .quic_tile import QuicTile, quic_tile_stats

    lanes = topo.verify_lanes
    reason = None
    xray_mod.reset_rings()
    wksp = Workspace.join(topo.wksp_path)
    quic = QuicTile(
        wksp, "quic.cnc", out_link(wksp, "replay_verify", topo.mtu),
        identity_seed=identity_seed, stop_after=n_txns, retry=quic_retry,
        idle_timeout=quic_idle_timeout, record_digests=record_digests,
        stop_when=quic_stop_when, options=quic_opts, chaos=inj)

    def pre_wait():
        client = threading.Thread(target=client_fn,
                                  args=(quic.listen_addr,), daemon=True,
                                  name="quic-client")
        client.start()
        return lambda: client.join(timeout=5.0)

    snt = None
    try:
        if feed is None or feed:
            reason = _feed_fallback_reason(verify_backend, verify_batch,
                                           verify_opts, lanes)
            if reason is None:
                from .feed.runtime import run_feed_pipeline

                res = run_feed_pipeline(
                    topo, [], verify_backend=verify_backend,
                    verify_batch=verify_batch,
                    verify_max_msg_len=verify_max_msg_len,
                    bank_cnt=bank_cnt, timeout_s=timeout_s,
                    verify_opts=verify_opts, record_digests=record_digests,
                    device=device, feed_proc=feed_proc, tile_cpus=tile_cpus,
                    chaos=inj, sentinel=sentinel, source_tile=quic,
                    source_done=quic.done, pre_wait=pre_wait)
                res.quic = quic_tile_stats(quic)
                return res
            logging.getLogger(LOGGER).warning(
                "fd_feed cannot serve the QUIC topology, falling back to "
                "the in-process step loop: %s", reason)
        if lanes != 1:
            raise ValueError(f"run_quic_pipeline serves one verify lane, "
                             f"the topology has {lanes}")
        flight.install_dump_signal(wksp)  # SIGUSR1 -> a live dump
        res, snt = _run_tiles(
            wksp, quic, verify_backend, verify_batch,
            verify_max_msg_len or topo.mtu, bank_cnt, timeout_s, 4096,
            dict(verify_opts or {}), record_digests, "greedy", device,
            lanes, tile_cpus, topo.pod, sentinel, pre_wait=pre_wait)
        res.feed_fallback_reason = reason
        res.quic = quic_tile_stats(quic)
        return res
    finally:
        if not quic.halted:
            quic.sock.close()  # the tile never ran, or outlived its join
        # Only after the tile's thread and the sentinel have ended: a
        # thread still writing the mapping would fault.
        elif snt is None or not snt.alive():
            wksp.leave()
