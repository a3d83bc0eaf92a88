"""The port's fd_feed runtime against the JAX package's, on the CPU.

* ``SlotPool``: the port's and the JAX pool go through the same
  acquire / commit / pop / release sequence state for state and stall
  for stall (``tests/test_feed.py:29-110``), and hand slots over in
  commit order between a stager thread and a slow consumer.
* Parity on a port ``mainnet_corpus`` at B = 32 (``device="cpu"``):
  ``run_pipeline`` with the feed in process (no ``feed=`` argument: the
  default) on a ring 32 deep, with the feed's worker processes, and
  with ``feed=False``,
  and the JAX feed runner (``verify_backend="cpu"``, ``FD_DRAIN=off``,
  ``FD_FEED_PROC=0``) deliver ``expected_sink_digests`` and count the
  same HA and SV filters; the worker run's six stage latencies
  (``replay_pub`` included) all have samples; the fd_drain, armed by
  default, filters every feed batch and its verdicts balance against the
  dedup tile's probes in process and in the worker's result file.
* The ring 32 deep: the held-back ack and the credits drive the
  feeder, nothing overruns, the sink is exact.
* Routing: the oracle backend warns and records its fallback reason; a
  worker refuses a gc pack;
  ``_feed_fallback_reason``'s rules; an engine that fails to build and
  an error of the fd_drain's launch raise and publish nothing (no host
  failover: that covers the dispatch and the completion of a built
  engine, ``tests/test_torch_chaos.py``); stager and
  dispatcher hold under a 10 us switch interval; ``stage_latencies``
  matches stamps past the 32-bit wrap; ``LatReservoir`` keeps a uniform
  sample.
"""

import json
import logging
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from firedancer_tpu.disco import pipeline as jpipe
from firedancer_tpu.disco.feed import slots as jslots
from firedancer_tpu_torch.disco import corpus as pcorpus
from firedancer_tpu_torch.disco import pipeline as ppipe
from firedancer_tpu_torch.disco import tiles as ptiles
from firedancer_tpu_torch.disco import worker as pworker
from firedancer_tpu_torch.disco.feed import runtime as pruntime
from firedancer_tpu_torch.disco.feed import slots as pslots
from firedancer_tpu_torch.tango import rings as prings

torch.set_num_threads(1)

B = 32
DEPTH = 256
# The in-process feed run's ring: shallower than the corpus, so the
# held-back ack's ring flush and the credits pace the feeder.
SMALL_DEPTH = 32


# -- slots -------------------------------------------------------------------


def _pool_trace(mod, ops):
    """Run ops on a pool of mod: each op's result and the pool's
    observers after it."""
    pool = mod.SlotPool(3, batch=8, max_msg_len=64)
    held, trace = {}, []
    for op, arg in ops:
        if op == "acquire":
            s = pool.acquire(0.01)
            held[arg] = s
            got = None if s is None else s.idx
        elif op == "stage":
            held[arg].n_txn = 2
            got = None
        elif op == "commit":
            pool.commit(held[arg])
            got = held[arg].state
        elif op == "pop":
            s = pool.pop_ready()
            held[arg] = s
            got = None if s is None else s.idx
        else:
            pool.release(held.pop(arg))
            got = None
        trace.append((op, got, [s.state for s in pool.slots],
                      pool.slot_stall, pool.ready_cnt(), pool.outstanding(),
                      pool.idle()))
    return trace


OPS = [("acquire", "a"), ("acquire", "b"), ("stage", "a"), ("commit", "a"),
       ("acquire", "c"), ("acquire", "d"), ("commit", "b"), ("pop", "x"),
       ("stage", "c"), ("commit", "c"), ("pop", "y"), ("release", "x"),
       ("acquire", "e"), ("pop", "z"), ("release", "y"), ("release", "z"),
       ("acquire", "f"), ("acquire", "g"), ("commit", "e")]


def test_slot_pool_matches_jax():
    assert _pool_trace(pslots, OPS) == _pool_trace(jslots, OPS)
    trace = _pool_trace(pslots, OPS)
    assert trace[5][1] is None and trace[5][3] == 1   # stalled, counted


@pytest.mark.parametrize("mod", [pslots, jslots], ids=["port", "jax"])
def test_slot_pool_fifo_under_threads(mod):
    """Slots come out in commit order while the stager waits on a slow
    consumer (the JAX test's scenario on both pools)."""
    pool = mod.SlotPool(3, batch=8, max_msg_len=64)
    committed, popped = [], []

    def stager():
        for i in range(40):
            s = None
            while s is None:
                s = pool.acquire(0.1)
            s.n_txn = 1
            s.drain_end = i + 1
            committed.append(i + 1)
            pool.commit(s)

    t = threading.Thread(target=stager, daemon=True)
    t.start()
    deadline = time.time() + 20
    while len(popped) < 40 and time.time() < deadline:
        s = pool.pop_ready()
        if s is None:
            time.sleep(0.002)
            continue
        popped.append(s.drain_end)
        pool.release(s)
    t.join(timeout=5)
    assert not t.is_alive()
    assert popped == committed == list(range(1, 41))
    assert pool.slot_stall > 0 and pool.stall_ns > 0
    assert pool.outstanding() == 0 and pool.idle()


def test_slot_arenas_are_tensors_with_numpy_views():
    pool = pslots.SlotPool(2, batch=8, max_msg_len=64)
    s = pool.slots[0]
    s.msgs[3, 5] = 7
    s.lens[2] = 1232
    assert int(s.t_msgs[3, 5]) == 7 and int(s.t_lens[2]) == 1232
    assert s.t_lens.dtype == torch.int32 and not s.t_msgs.is_pinned()
    with pytest.raises(ValueError):
        pslots.SlotPool(1, batch=8, max_msg_len=64)
    with pytest.raises(ValueError):
        pool.commit(s)   # FREE, never acquired


# -- parity --------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    """tests/test_feed.py's mix: duplicates, corrupt signatures and
    parse errors among 64 unique txns."""
    return pcorpus.mainnet_corpus(n=64, seed=5, dup_rate=0.1,
                                  corrupt_rate=0.06, parse_err_rate=0.04,
                                  sign_batch_size=128, max_data_sz=140,
                                  device="cpu")


def _port_run(path, corpus, depth=DEPTH, **kw):
    topo = ppipe.build_topology(str(path), depth=depth)
    return ppipe.run_pipeline(topo, corpus.payloads, verify_batch=B,
                              record_digests=True, device="cpu",
                              timeout_s=180.0, **kw)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    d = tmp_path_factory.mktemp("feed")
    return {"feed": _port_run(d / "f.wksp", corpus, depth=SMALL_DEPTH,
                              feed_proc=False),
            "proc": _port_run(d / "p.wksp", corpus, feed=True,
                              feed_proc=True),
            "legacy": _port_run(d / "l.wksp", corpus, feed=False)}


def _filters(res):
    v = res.diag["tile.verify"]
    return v["ha_filt_cnt"], v["sv_filt_cnt"]


@pytest.mark.parametrize("mode", ["feed", "proc", "legacy"])
def test_port_runs_exact(corpus, runs, mode):
    res = runs[mode]
    n = Counter(int(e) for e in corpus.expected)
    assert Counter(res.sink_digests) == pcorpus.expected_sink_digests(corpus)
    assert res.recv_cnt == corpus.n_unique_ok
    assert _filters(res) == (n[pcorpus.DUP],
                             n[pcorpus.BAD_SIG] + n[pcorpus.BAD_PARSE])
    assert res.feed == (mode != "legacy")
    assert res.feed_fallback_reason is None
    assert 0 < res.latency_p50_ns <= res.latency_p99_ns
    vs = res.verify_stats[0]
    assert vs["feed"] == res.feed
    assert vs["cpu_failover"] == 0 and vs["stager_restarts"] == 0
    assert vs["slots_leaked"] == 0
    assert vs["lanes"] <= vs["batches"] * B
    if res.feed:
        assert set(res.stage_latency) == set(pruntime.STAGES)
        assert "verify.stager" in res.tile_cpu_s
        assert res.proc_cpu_s["main"] > 0
        # The receipts' latency is the sink stage's, on the same tick.
        assert res.stage_latency["sink"]["n"] == res.recv_cnt


def test_worker_run_ships_every_stage(runs):
    res = runs["proc"]
    for stage in pruntime.STAGES:
        d = res.stage_latency[stage]
        assert d["n"] > 0 and 0 <= d["p50_ns"] <= d["p99_ns"], stage
    lat = res.stage_latency
    assert lat["sink"]["p50_ns"] >= lat["verify_pub"]["p50_ns"]
    assert res.proc_cpu_s["workers"] > 0
    assert set(res.tile_cpu_s) == {"replay", "verify", "verify.stager",
                                   "dedup", "pack", "sink"}
    assert sum(res.bank_hist.values()) == res.recv_cnt
    assert res.pack_stats["scheduler"] == "greedy"


def test_worker_run_ships_the_drain_counters(runs):
    """The drain is armed by default; the dedup worker's counters come
    home in its result file and balance against verify's verdicts."""
    for mode in ("feed", "proc"):
        vs, dd = runs[mode].verify_stats[0], runs[mode].dedup_stats
        assert vs["drain_batches"] == vs["batches"]
        assert dd["probe_skip"] + dd["probed"] \
            == vs["drain_novel"] + vs["drain_maybe"] > 0
        assert dd["probe_skip"] > 0 and dd["false_novel"] == 0
    assert runs["legacy"].dedup_stats["probe_skip"] == 0


def test_jax_feed_runner_gives_the_same_sink(corpus, runs, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv("FD_DRAIN", "off")
    monkeypatch.setenv("FD_FEED_PROC", "0")
    topo = jpipe.build_topology(str(tmp_path / "j.wksp"), depth=DEPTH)
    jres = jpipe.run_pipeline(topo, corpus.payloads, verify_backend="cpu",
                              verify_batch=B, record_digests=True,
                              timeout_s=180.0, feed=True)
    assert jres.feed
    want = pcorpus.expected_sink_digests(corpus)
    assert Counter(jres.sink_digests) == want
    for res in runs.values():
        assert Counter(res.sink_digests) == Counter(jres.sink_digests)
        assert _filters(res) == _filters(jres)
    assert set(runs["feed"].verify_stats[0]) <= set(jres.verify_stats[0])


def test_small_ring_backpressure(corpus, runs):
    """The in-process feed run: a ring of 32 against 75 payloads (the
    JAX test's ring and corpus size): slots commit on the held-back
    ack's ring flush and the credits; nothing overruns."""
    res = runs["feed"]
    assert res.verify_stats[0]["batches"] >= 2
    assert res.feed
    assert Counter(res.sink_digests) == pcorpus.expected_sink_digests(corpus)
    for name, d in res.diag.items():
        if name.startswith("link."):
            assert d["ovrnr_cnt"] == 0 and d["ovrnp_cnt"] == 0, (name, d)


# -- routing and errors --------------------------------------------------------


def test_oracle_backend_falls_back_loudly(corpus, tmp_path, caplog):
    topo = ppipe.build_topology(str(tmp_path / "o.wksp"), depth=DEPTH)
    with caplog.at_level(logging.WARNING, pruntime.LOGGER):
        res = ppipe.run_pipeline(topo, corpus.payloads,
                                 verify_backend="oracle", record_digests=True,
                                 device="cpu", timeout_s=180.0)
    assert not res.feed
    assert "oracle" in res.feed_fallback_reason
    assert any("falling back" in r.message for r in caplog.records)
    assert Counter(res.sink_digests) == pcorpus.expected_sink_digests(corpus)


def test_worker_refuses_a_gc_pack(tmp_path):
    """A worker has no device: the gc pack stays in the runtime's
    process, and the worker entry point refuses it."""
    topo = ppipe.build_topology(str(tmp_path / "g.wksp"), depth=DEPTH)
    with pytest.raises(ValueError, match="no gc pack"):
        pworker.main(["--wksp", topo.wksp_path, "--tile", "dedup,pack,sink",
                      "--opts", json.dumps({"pack_scheduler": "gc"})])


def test_feed_fallback_reasons(monkeypatch):
    reason = ppipe._feed_fallback_reason
    assert reason("gpu", B, None) is None
    assert reason("gpu", B, {"inflight": 4}) is None
    assert "MAX_SIG_CNT" in reason("gpu", 16, None)
    assert "native drain" in reason("gpu", B, {"native_drain": False})
    assert "gpu" in reason("oracle", B, None)

    def stale():
        raise RuntimeError("lacks the current drain entry points")

    monkeypatch.setattr(prings, "require_drain", stale)
    assert "drain entry points" in reason("gpu", B, None)


def test_feed_engine_error_raises_without_failover(corpus, tmp_path,
                                                  monkeypatch):
    """The CPU lane takes over only at the dispatch or the completion of
    a built engine (tests/test_torch_chaos.py). An engine that cannot be
    built or warmed raises out of the tile's construction, and an error
    of the batch's fd_drain launch (no breaker covers it) raises out of
    the feeder: nothing is published and no failover is counted."""
    topo = ppipe.build_topology(str(tmp_path / "e.wksp"), depth=DEPTH)
    w = prings.Workspace.join(topo.wksp_path)
    replay = ptiles.ReplayTile(w, "replay.cnc",
                               ppipe.out_link(w, "replay_verify"),
                               payloads=corpus.payloads)

    def broken(*args, **kw):
        raise RuntimeError("engine failed")

    with monkeypatch.context() as m:
        m.setattr(ptiles.fd_engine.EngineRegistry, "acquire", broken)
        with pytest.raises(RuntimeError, match="engine failed"):
            ptiles.VerifyTile(w, "verify.cnc",
                              ppipe.in_link(w, "replay_verify"),
                              ppipe.out_link(w, "verify_dedup"),
                              batch=B, device="cpu", feed=True)
    verify = ptiles.VerifyTile(w, "verify.cnc",
                               ppipe.in_link(w, "replay_verify"),
                               ppipe.out_link(w, "verify_dedup"),
                               batch=B, device="cpu", feed=True)
    sink = ptiles.SinkTile(w, "sink.cnc", ppipe.in_link(w, "verify_dedup"))
    verify._drain_dispatch = broken
    with pytest.raises(RuntimeError, match="engine failed"):
        ppipe.run_tiles([replay, verify, sink],
                        lambda: ppipe.chain_quiesced(replay, verify, sink),
                        timeout_s=60.0)
    assert verify.error is not None and not verify._feed_thread.is_alive()
    assert verify.out_link.seq == 0 and sink.recv_cnt == 0
    vs = pruntime.verify_tile_stats(verify)
    assert vs["cpu_failover"] == 0 and vs["quarantined"] == 0
    w.leave()


def test_feed_chain_under_fast_thread_switching(corpus, tmp_path):
    """Stager and dispatcher under a 10 us switch interval, two slots, a
    ring of 32 and an engine that passes every lane (statuses of 0, so
    the run is short): each distinct payload that parses reaches the
    sink once, and every slot comes back to the pool."""
    from hashlib import sha256

    from firedancer_tpu_torch.ballet.txn import TxnParseError, parse_txn

    def parses(p):
        try:
            parse_txn(p)
        except TxnParseError:
            return False
        return True

    want = Counter({sha256(p).digest(): 1 for p in corpus.payloads
                    if parses(p)})
    topo = ppipe.build_topology(str(tmp_path / "s.wksp"), depth=32)
    w = prings.Workspace.join(topo.wksp_path)
    replay = ptiles.ReplayTile(w, "replay.cnc",
                               ppipe.out_link(w, "replay_verify"),
                               payloads=corpus.payloads)
    verify = ptiles.VerifyTile(w, "verify.cnc",
                               ppipe.in_link(w, "replay_verify"),
                               ppipe.out_link(w, "verify_dedup"),
                               batch=B, device="cpu", feed=True,
                               feed_slots=2)
    sink = ptiles.SinkTile(w, "sink.cnc", ppipe.in_link(w, "verify_dedup"),
                           record_digests=True)
    verify._verify_batch_fn = lambda *a: torch.zeros(B, dtype=torch.int32)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ppipe.run_tiles([replay, verify, sink],
                        lambda: ppipe.chain_quiesced(replay, verify, sink),
                        timeout_s=60.0)
    finally:
        sys.setswitchinterval(old)
    assert Counter(sink.digests) == want
    assert verify.stat_batches >= 2
    assert verify.feed_pool.outstanding() == 0
    assert not verify._feed_thread.is_alive()
    assert verify.cnc.diag(ptiles.CNC_DIAG_UNACKED) == 0
    w.leave()


@pytest.mark.parametrize("kw", [{"backend": "oracle"},
                                {"native_drain": False}])
def test_feed_needs_gpu_and_native_drain(tmp_path, kw):
    topo = ppipe.build_topology(str(tmp_path / "n.wksp"), depth=DEPTH)
    w = prings.Workspace.join(topo.wksp_path)
    with pytest.raises(ValueError, match="feed=True"):
        ptiles.VerifyTile(w, "verify.cnc", ppipe.in_link(w, "replay_verify"),
                          ppipe.out_link(w, "verify_dedup"), batch=B,
                          device="cpu", feed=True, **kw)
    w.leave()


def test_stage_latencies_past_the_32_bit_wrap():
    t0 = (1 << 40) + 77
    pubs = [t0, t0 + 1_000, t0 + (1 << 32), t0 + (1 << 32) + 5]
    ts = [p & 0xFFFFFFFF for p in (pubs[1], *pubs)] + [12345]
    now = [pubs[1] + 5_000_000_000, pubs[0] + 100, pubs[1] + 40,
           pubs[2] + 9, pubs[3] + 1, t0 + 10]
    # A receipt 5 s after its publish keeps its latency; pubs[0] and
    # pubs[2] share their low 32 bits, and each sample matches the
    # latest of them at or before its tick; stamp 12345 matches none.
    got = pruntime.stage_latencies(pubs, ts, now)
    assert got.tolist() == [5_000_000_000, 100, 40, 9, 1]


def test_lat_reservoir_uniform_sample():
    r = ptiles.LatReservoir(seed=1)
    n = 4 * r.CAP
    ts = np.arange(1, n + 1, dtype=np.uint32)
    for lo in range(0, n, 1000):
        r.add_many(ts[lo:lo + 1000], 7)
    r.add(0, 9)          # no stamp: skipped
    got_ts, got_now = r.samples()
    assert r.seen == n and len(got_ts) == r.CAP
    assert (got_now == 7).all() and len(set(got_ts.tolist())) == r.CAP
    # Each quarter of the stream keeps about a quarter of the sample.
    quarters = np.bincount((got_ts.astype(np.int64) - 1) // r.CAP)
    assert (abs(quarters - r.CAP / 4) < r.CAP / 16).all()
