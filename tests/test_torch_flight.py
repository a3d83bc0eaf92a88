"""The port's fd_flight (``firedancer_tpu_torch/disco/flight.py``,
``tools/fd_top.py`` and the runners' hooks) against the JAX package's,
on the CPU.

* The specs: the 37 metrics (names, kinds, docs, order), the breaker
  codes, the histogram shape, the region magics and the schema version
  equal the JAX ones.
* Regions built from the same labels (one verify lane and three) are
  byte for byte equal, before and after the same lane publishes (two
  incarnations: counters accumulate, gauges last write wins), span
  observes and SLO row writes; each package's ``read_tiles``,
  ``read_edges``, ``read_edges_raw`` and ``read_slos`` read the other's
  workspace.
* ``EdgeHist``: 10^5 seeded latencies with 0, 1, every 2^k - 1, 2^k and
  2^k + 1 (k < 64) and the 32-bit wrap of (tspub - tsorig) planted, one
  by one and in batches: equal rows, ``percentile_ns`` and summaries
  (exact: integer counts).
* ``merge_tile_metrics``, ``merge_edge_rows``, ``merge_snapshots``,
  ``snapshot_raw``, ``verify_stats_view`` and ``render_prom`` (the
  compile records of both packages set to the same list) equal the JAX
  results on the same rows; ``parse_prom`` reads the text back.
* The recorder's ring, the dump's envelope, ``maybe_dump`` into the
  options' directory and the SIGUSR1 dump.
* Runs on the CPU with the engines' verify on the native verifier
  (``tests/test_torch_chaos.py``'s ``native_engine``), every run on a
  fresh workspace: the feed in process and the step loop give each
  link's span ``n``, the sink's and ``recv_cnt`` equal to the JAX
  runner's on the same corpus (the traffic fixes them; batch counts and
  flush verdicts follow timing and are not compared), ``verify_stats``
  equals the verify row of the registry field for field, the sentinel
  ran and raised no alert, ``render_prom`` and the monitor's overlay and
  fd_top's panels (equal to the JAX fd_top's ``render_flight`` on the
  same snapshot) read it. The trace id (tsorig) survives staging, the
  quarantine's re-verify on the CPU lane and a worker process bit for
  bit (``tests/test_flight.py:243-331``), and a seeded chaos run's HALT
  dump records each class's injections as the injector counted them
  (``:410-434``).
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import pytest
import torch

from firedancer_tpu.disco import flight as jflight
from firedancer_tpu.disco import pipeline as jpipe
from firedancer_tpu.disco import sentinel as jsentinel
from firedancer_tpu.disco.corpus import expected_sink_digests
from firedancer_tpu.disco.corpus import mainnet_corpus as jmainnet_corpus
from firedancer_tpu.tango import rings as jrings
from firedancer_tpu_torch.disco import chaos as pchaos
from firedancer_tpu_torch.disco import engine as pengine
from firedancer_tpu_torch.disco import flight as pflight
from firedancer_tpu_torch.disco import monitor as pmonitor
from firedancer_tpu_torch.disco import pipeline as ppipe
from firedancer_tpu_torch.disco import sentinel as psentinel
from firedancer_tpu_torch.disco import tiles as ptiles
from firedancer_tpu_torch.ballet.ed25519 import native as pnative
from firedancer_tpu_torch.tango import rings as prings

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINKS = ("replay_verify", "verify_dedup", "dedup_pack", "pack_sink")


def _load_script(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- specs --------------------------------------------------------------------


def test_metric_specs_equal_jax():
    assert [(m.name, m.kind, m.doc) for m in pflight.TILE_METRICS] == \
        [(m.name, m.kind, m.doc) for m in jflight.TILE_METRICS]
    assert len(pflight.TILE_METRICS) == 37
    assert pflight.TILE_IDX == jflight.TILE_IDX
    assert pflight.BREAKER_STATE_CODE == jflight.BREAKER_STATE_CODE
    for k in ("N_BUCKETS", "EDGE_SLOTS", "SLO_SLOTS", "SLO_EVALS",
              "SLO_STATE", "ARTIFACT_SCHEMA_VERSION", "_MAGIC_TILES",
              "_MAGIC_EDGES", "_MAGIC_SLO", "_METRICS_REGION",
              "_EDGES_REGION", "_SLO_REGION"):
        assert getattr(pflight, k) == getattr(jflight, k), k


# -- regions ------------------------------------------------------------------


def _labels(lanes):
    return (ppipe.topology_tiles(lanes), ppipe.topology_edges(lanes),
            psentinel.SLO_NAMES)


def _write_rows(fl, wksp, tiles, edges, seed):
    """The same lane publishes, span observes and SLO writes through one
    package's API."""
    rng = np.random.RandomState(seed)
    for label in tiles:
        for _ in range(2):       # two incarnations of the tile
            lane = fl.tile_lane(wksp, label)
            for m in fl.TILE_METRICS:
                v = int(rng.randint(0, 1 << 40))
                if m.kind == "counter":
                    lane.inc(m.name, v)
                else:
                    lane.set_gauge(m.name, v)
            lane.publish()
            lane.inc("batches", 3)
            lane.publish()
    for label in edges:
        h = fl.edge_hist(wksp, label)
        for ns in rng.randint(0, 1 << 33, 50).tolist():
            h.observe(ns)
        h.observe_many(rng.randint(0, 1 << 33, 200))
    for i, name in enumerate(psentinel.SLO_NAMES):
        row = fl.slo_row(wksp, name)
        row[:] = np.arange(i, i + fl.SLO_SLOTS, dtype=np.uint64)


@pytest.mark.parametrize("lanes", [1, 3])
def test_regions_byte_equal_and_read_across(tmp_path, lanes):
    tiles, edges, slos = _labels(lanes)
    pw = prings.Workspace.create(str(tmp_path / "p.wksp"), 1 << 22)
    jw = jrings.Workspace.create(str(tmp_path / "j.wksp"), 1 << 22)
    try:
        pflight.create_regions(pw, tiles, edges, slo_labels=slos)
        jflight.create_regions(jw, tiles, edges, slo_labels=slos)
        regions = ("flight.metrics", "flight.edges", "flight.slo")
        for r in regions:
            assert bytes(pw.view(r)) == bytes(jw.view(r)), r
        _write_rows(pflight, pw, tiles, edges, seed=lanes)
        _write_rows(jflight, jw, tiles, edges, seed=lanes)
        for r in regions:
            assert bytes(pw.view(r)) == bytes(jw.view(r)), r
        # Each package reads the other's workspace.
        pj = prings.Workspace.join(str(tmp_path / "j.wksp"))
        jp = jrings.Workspace.join(str(tmp_path / "p.wksp"))
        try:
            for fn in ("read_tiles", "read_edges", "read_slos"):
                want = getattr(jflight, fn)(jw)
                assert getattr(pflight, fn)(pj) == want, fn
                assert getattr(jflight, fn)(jp) == want, fn
            raw_p = pflight.read_edges_raw(pj)
            raw_j = jflight.read_edges_raw(jp)
            assert list(raw_p) == list(raw_j) == list(edges)
            for k in edges:
                assert np.array_equal(raw_p[k], raw_j[k])
        finally:
            pj.leave()
            jp.leave()
        assert pflight.tile_lane(pw, "no-such-tile").shared is False
    finally:
        pw.leave()
        jw.leave()


def test_build_topology_regions_equal_jax(tmp_path):
    """The topologies' registries: the same labels, byte-equal rows."""
    pt = ppipe.build_topology(str(tmp_path / "p.wksp"), depth=64,
                              verify_lanes=2)
    jt = jpipe.build_topology(str(tmp_path / "j.wksp"), depth=64,
                              wksp_sz=1 << 24, verify_lanes=2)
    pw = prings.Workspace.join(pt.wksp_path)
    jw = jrings.Workspace.join(jt.wksp_path)
    try:
        for r in ("flight.metrics", "flight.edges", "flight.slo"):
            assert bytes(pw.view(r)) == bytes(jw.view(r)), r
        assert pt.pod.query_ulong("firedancer.flight.schema", 0) == \
            jt.pod.query_ulong("firedancer.flight.schema", 0) == 3
    finally:
        pw.leave()
        jw.leave()


# -- EdgeHist -----------------------------------------------------------------


def _latencies(seed=7, n=100_000):
    """(one by one, batch): 0, 1, 2^k - 1, 2^k, 2^k + 1 for k < 64 and
    64 wrapped (tspub - tsorig) & 0xFFFFFFFF one by one; the rest, the
    same kinds below 2^62 and seeded draws, as an int64 batch."""
    rng = np.random.RandomState(seed)
    special = [0, 1]
    for k in range(1, 64):
        special += [(1 << k) - 1, 1 << k, (1 << k) + 1]
    tsorig = rng.randint(0xFFFF0000, 1 << 32, 64).astype(np.int64)
    tspub = rng.randint(0, 1 << 16, 64).astype(np.int64)
    wrap = ((tspub - tsorig) & 0xFFFFFFFF).tolist()
    one = special + wrap
    small = [x for x in special if x < (1 << 62)] + wrap
    rest = n - len(one) - len(small)
    body = np.concatenate([
        np.array(small, np.int64),
        rng.randint(0, 1 << 32, rest // 2).astype(np.int64),
        np.left_shift(1, rng.randint(0, 62, rest - rest // 2)).astype(
            np.int64)])
    rng.shuffle(body)
    return one, body


def test_edge_hist_buckets_and_percentiles_equal_jax():
    one, batch = _latencies()
    assert len(one) + len(batch) == 100_000
    ph, jh = pflight.EdgeHist("e"), jflight.EdgeHist("e")
    for ns in one:
        ph.observe(ns)
        jh.observe(ns)
    for chunk in np.array_split(batch, 7):
        ph.observe_many(chunk)
        jh.observe_many(chunk)
    assert np.array_equal(ph.row, jh.row)
    assert ph.count() == jh.count() == 100_000
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert ph.percentile_ns(q) == jh.percentile_ns(q), q
    assert ph.summary() == jh.summary()
    # One by one against bit_length (the bucket's definition).
    for ns in (0, 1, 2, 3, (1 << 32) - 1, 1 << 32, 1 << 38, (1 << 39) - 1,
               1 << 39, (1 << 64) - 1):
        h = pflight.EdgeHist("x")
        h.observe(ns)
        b = min(ns.bit_length(), pflight.N_BUCKETS - 1)
        assert int(h.row[1 + b]) == 1 and h.count() == 1, ns
    assert pflight.EdgeHist("x").summary() == \
        jflight.EdgeHist("x").summary()


# -- merges, views, prom ------------------------------------------------------


@pytest.fixture
def filled(tmp_path):
    tiles, edges, slos = _labels(1)
    pw = prings.Workspace.create(str(tmp_path / "m.wksp"), 1 << 22)
    pflight.create_regions(pw, tiles, edges, slo_labels=slos)
    _write_rows(pflight, pw, tiles, edges, seed=3)
    jw = jrings.Workspace.join(str(tmp_path / "m.wksp"))
    yield pw, jw
    jw.leave()
    pw.leave()


def test_merges_views_and_prom_equal_jax(filled, monkeypatch):
    pw, jw = filled
    snaps_p = [pflight.snapshot_raw(pw), pflight.snapshot_raw(pw)]
    snaps_j = [jflight.snapshot_raw(jw), jflight.snapshot_raw(jw)]
    mp, mj = pflight.merge_snapshots(snaps_p), jflight.merge_snapshots(snaps_j)
    assert mp["metrics"] == mj["metrics"] and mp["edges"] == mj["edges"]
    for k in mj["edges_raw"]:
        assert np.array_equal(mp["edges_raw"][k], mj["edges_raw"][k])
    rows = list(pflight.read_tiles(pw).values())
    for code in (0, 1, 2, 3):
        rows[1]["breaker_state"] = code
        assert pflight.merge_tile_metrics(rows) == \
            jflight.merge_tile_metrics(rows)
    raw = list(pflight.read_edges_raw(pw).values())
    assert np.array_equal(pflight.merge_edge_rows(raw),
                          jflight.merge_edge_rows(raw))
    for label in ("verify", "pack", "nope"):
        assert pflight.verify_stats_view(pw, label, 128) == \
            jflight.verify_stats_view(jw, label, 128)
    recs = [{"engine": "direct:B128:fefused:u7", "seconds": 1.5,
             "cache_hit_est": False, "ts": 0.0},
            {"engine": "rlc:B8192:festaged:u7", "seconds": 0.25,
             "cache_hit_est": True, "ts": 1.0}]
    monkeypatch.setattr(pflight, "_compiles", list(recs))
    monkeypatch.setattr(jflight, "_compiles", list(recs))
    text = pflight.render_prom(pw)
    assert text == jflight.render_prom(jw)
    series = pflight.parse_prom(text)
    assert series['fd_flight_batches{tile="verify"}'] == \
        pflight.read_tiles(pw)["verify"]["batches"]
    with pytest.raises(ValueError):
        pflight.parse_prom("fd_flight_batches{tile=\"x\" 3")


def test_compile_records_book_a_warm():
    rec = pflight.record_compile("direct:B64:fefused:u7", 0.0123456, True)
    assert rec["seconds"] == 0.012 and rec["cache_hit_est"] is True
    assert pflight.compile_records()[-1] == rec


# -- recorder and dumps -------------------------------------------------------


def test_recorder_ring_equals_jax():
    pr, jr = pflight.FlightRecorder("r", 8), jflight.FlightRecorder("r", 8)
    for i in range(13):
        pr.record("ev", i=i)
        jr.record("ev", i=i)
    strip = lambda evs: [{k: v for k, v in e.items() if k != "t"}  # noqa
                         for e in evs]
    assert strip(pr.events()) == strip(jr.events())
    assert [e["i"] for e in pr.events()] == list(range(5, 13))
    assert pr.n == jr.n == 13
    with pflight.configured(False):
        assert pflight.recorder("off").events() == []


def test_dump_into_the_options_directory(tmp_path):
    d = tmp_path / "dumps"
    assert pflight.maybe_dump("nothing") is None   # no directory set
    with pflight.configured({"dump_dir": str(d)}):
        rec = pflight.recorder("dumptest")
        rec.record("hello", x=1)
        path = pflight.maybe_dump("unit-test")
    assert path and os.path.dirname(path) == str(d)
    with open(path) as f:
        dump = json.load(f)
    assert dump["kind"] == "fd_flight_dump" and dump["reason"] == "unit-test"
    assert dump["schema_version"] == jflight.ARTIFACT_SCHEMA_VERSION
    assert dump["recorders"]["dumptest"]["events"][-1]["x"] == 1
    with pflight.configured({"dump_dir": str(d), "enabled": False}):
        assert pflight.maybe_dump("off") is None


def test_sigusr1_dumps_the_workspace(tmp_path, filled):
    pw, _ = filled
    d = tmp_path / "sig"
    # Another handler (the JAX package's, a test's) took SIGUSR1 since a
    # run installed the port's: the next install takes it back.
    signal.signal(signal.SIGUSR1, lambda *a: None)
    with pflight.configured({"dump_dir": str(d)}):
        pflight.install_dump_signal(pw)
    os.kill(os.getpid(), signal.SIGUSR1)
    for _ in range(100):
        if d.exists() and os.listdir(d):
            break
        time.sleep(0.01)
    (name,) = os.listdir(d)
    with open(d / name) as f:
        dump = json.load(f)
    assert dump["reason"] == "signal"
    assert dump["metrics"] == pflight.read_tiles(pw)
    assert dump["slos"] == pflight.read_slos(pw)
    pflight._dump_target = (None, pflight.options())


# -- runs ---------------------------------------------------------------------


@pytest.fixture
def native_engine(monkeypatch):
    """The engines' verify on the CPU is the native verifier's."""

    def fn(self, msgs, lens, sigs, pubs):
        arrs = [np.ascontiguousarray(torch.as_tensor(a).numpy())
                for a in (msgs, lens, sigs, pubs)]
        self.note_dispatch(len(arrs[0]))
        return torch.from_numpy(pnative.verify_arrays(*arrs, len(arrs[0])))

    monkeypatch.setattr(pengine.EngineEntry, "fn", fn)


def _clean_corpus(n=48, seed=11):
    """tests/test_flight.py:182-187."""
    return jmainnet_corpus(n=n, seed=seed, dup_rate=0.0, corrupt_rate=0.0,
                           parse_err_rate=0.0, sign_batch_size=64,
                           max_data_sz=120)


def _jax_run(tmp_path, name, corpus, monkeypatch, feed):
    for k, v in (("FD_FEED", "1" if feed else "0"), ("FD_FEED_PROC", "0")):
        monkeypatch.setenv(k, v)
    topo = jpipe.build_topology(str(tmp_path / f"{name}.wksp"), depth=512,
                                wksp_sz=1 << 26)
    return jpipe.run_pipeline(topo, corpus.payloads, verify_backend="cpu",
                              timeout_s=120.0, record_digests=True,
                              feed=feed)


def _port_run(tmp_path, name, corpus, **kw):
    topo = ppipe.build_topology(str(tmp_path / f"{name}.wksp"), depth=512,
                                wksp_sz=1 << 26)
    kw.setdefault("feed_proc", False)
    res = ppipe.run_pipeline(topo, corpus.payloads, verify_batch=128,
                             record_digests=True, device="cpu",
                             timeout_s=120.0, **kw)
    return topo, res


def _check_flight(res):
    """The registry's accounting of a clean run: a link's span counts
    every frag published on it, the sink's every receipt; verify_stats
    is the verify row; the sentinel ran quiet."""
    for link in LINKS:
        assert res.stage_hist[link]["n"] == res.diag[f"link.{link}"]["tx_seq"]
    assert res.stage_hist["sink"]["n"] == res.recv_cnt
    row = res.flight_tiles["verify"]
    vs = res.verify_stats[0]
    for k, v in vs.items():
        if k in row and k != "breaker_state":
            assert row[k] == v, k
    assert row["breaker_state"] == \
        pflight.BREAKER_STATE_CODE[vs["breaker_state"]]
    assert res.flight_tiles["dedup"]["drain_probed"] \
        + res.flight_tiles["dedup"]["drain_probe_skip"] \
        == res.diag["link.verify_dedup"]["tx_seq"]
    assert res.slo is not None and res.slo["evals"] >= 1
    assert res.slo["alert_cnt"] == 0, res.slo["alerts"]


@pytest.mark.parametrize("feed", [True, False], ids=["feed", "step"])
def test_runs_span_every_frag_as_jax(native_engine, tmp_path, monkeypatch,
                                     feed):
    corpus = _clean_corpus(n=200, seed=29)
    prom = tmp_path / "m.prom"
    topo, res = _port_run(tmp_path, "p", corpus, feed=feed,
                          flight={"metrics_prom": str(prom)})
    jres = _jax_run(tmp_path, "j", corpus, monkeypatch, feed)
    assert res.feed == jres.feed == feed
    assert Counter(res.sink_digests) == Counter(jres.sink_digests) == \
        expected_sink_digests(corpus)
    for edge in (*LINKS, "sink"):
        assert res.stage_hist[edge]["n"] == jres.stage_hist[edge]["n"], edge
    assert res.stage_hist["quic_ingest"]["n"] == 0
    if feed:
        assert res.stage_hist["verify_drain"]["n"] >= 1
    _check_flight(res)
    series = pflight.parse_prom(prom.read_text())
    assert series['fd_flight_batches{tile="verify"}'] == \
        res.verify_stats[0]["batches"]
    assert series['fd_flight_edge_latency_ns_count{edge="sink"}'] == \
        res.recv_cnt


def test_monitor_and_fd_top_read_a_run(native_engine, tmp_path):
    corpus = _clean_corpus(n=64, seed=37)
    topo, res = _port_run(tmp_path, "mon", corpus)
    w = prings.Workspace.join(topo.wksp_path)
    try:
        snap = pmonitor.snapshot(w, topo.pod)
        assert snap == pmonitor.snapshot(w, ppipe.TILES, ppipe.LINKS)
        assert snap["tile.verify"]["fl_batches"] == \
            res.verify_stats[0]["batches"]
        assert snap["span.sink"]["n"] == res.recv_cnt
        assert snap["slo.e2e_p99"]["evals"] == res.slo["evals"]
        text = pmonitor.render(snap, ansi=False)
        assert "clsd" in text and "quar" in text
        ptop = _load_script("p_fd_top",
                            os.path.join(ROOT, "firedancer_tpu_torch",
                                         "tools", "fd_top.py"))
        jtop = _load_script("j_fd_top",
                            os.path.join(ROOT, "scripts", "fd_top.py"))
        for ansi in (False, True):
            assert ptop.render_flight(snap, ansi=ansi) == \
                jtop.render_flight(snap, ansi=ansi)
        pod = tmp_path / "topo.pod"
        pod.write_bytes(topo.pod.serialize())
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "firedancer_tpu_torch",
                                          "tools", "fd_top.py"),
             "--wksp", topo.wksp_path, "--pod", str(pod), "--prom"],
            capture_output=True, text=True, timeout=120, check=True).stdout
        assert pflight.parse_prom(out)[
            'fd_flight_lanes{tile="verify"}'] == res.verify_stats[0]["lanes"]
    finally:
        w.leave()


def test_flight_off_keeps_the_lanes(native_engine, tmp_path):
    corpus = _clean_corpus(n=48, seed=43)
    _, res = _port_run(tmp_path, "off", corpus, flight=False,
                       sentinel=False)
    assert res.slo is None
    assert all(h["n"] == 0 for h in res.stage_hist.values())
    assert res.flight_tiles["verify"]["batches"] == \
        res.verify_stats[0]["batches"] >= 1
    assert Counter(res.sink_digests) == expected_sink_digests(corpus)


# -- the trace id's path ------------------------------------------------------


def _staging_harness(tmp_path, name):
    """tests/test_flight.py:190-212 on the port: a topology, the source's
    out-link and a feed-mode VerifyTile driven by hand."""
    topo = ppipe.build_topology(str(tmp_path / f"{name}.wksp"), depth=1024,
                                wksp_sz=1 << 25)
    w = prings.Workspace.join(topo.wksp_path)
    src = ppipe.out_link(w, "replay_verify")
    v = ptiles.VerifyTile(w, "verify.cnc", ppipe.in_link(w, "replay_verify"),
                          ppipe.out_link(w, "verify_dedup"), batch=128,
                          feed=True, device="cpu")
    return w, src, v


def _publish_ids(src, corpus, base):
    want = {}
    for i, p in enumerate(corpus.payloads):
        assert src.can_publish()
        src.publish(p, ptiles.meta_sig(p), tsorig=base + i)
        want[ptiles.meta_sig(p)] = base + i
    return want


def _stage_and_complete(v, n):
    slot = v.feed_pool.acquire(0.5)
    staged = 0
    while staged < n:
        k = v._stager_drain(slot)
        if k <= 0:
            break
        staged += k
    assert staged == n
    ids = sorted(int(t) for t in slot.tsorigs[:staged])
    v._feed_dispatch(slot)
    v._complete(block=True, drain_all=True)
    return ids


def _out_ring(w, n):
    mc = prings.MCache(w, "verify_dedup.mcache")
    got = []
    for seq in range(n):
        r, frag = mc.poll(seq)
        assert r == prings.POLL_FRAG
        got.append((frag.sig, frag.tsorig))
    return dict(got)


def test_trace_id_survives_feed_staging(native_engine, tmp_path):
    corpus = _clean_corpus()
    w, src, v = _staging_harness(tmp_path, "stage")
    try:
        want = _publish_ids(src, corpus, 10_000)
        assert _stage_and_complete(v, len(want)) == sorted(want.values())
        assert _out_ring(w, len(want)) == want
        assert v.stat_batches == 1
        edges = pflight.read_edges(w)
        assert edges["replay_verify"]["n"] == len(want)
        assert edges["verify_dedup"]["n"] == len(want)
        assert edges["verify_drain"]["n"] >= 1
    finally:
        w.leave()


def test_trace_id_survives_quarantine_reverify(native_engine, tmp_path):
    corpus = _clean_corpus(seed=13)
    w, src, v = _staging_harness(tmp_path, "quar")
    try:
        with pchaos.armed((1, "backend_raise@1")):
            want = _publish_ids(src, corpus, 77_000)
            _stage_and_complete(v, len(want))
        assert v.stat_quarantined == 1
        assert _out_ring(w, len(want)) == want
        kinds = [e["kind"] for e in v.flightrec.events()]
        assert "quarantine" in kinds and "dispatch" in kinds
    finally:
        w.leave()


def test_trace_id_survives_the_worker_boundary(tmp_path):
    """Frags with known ids into verify_dedup, drained by a worker
    process (dedup -> pack -> sink): its sink records the published
    ids, and its tiles' spans and lanes land in this process's view."""
    corpus = _clean_corpus(n=32, seed=17)
    topo = ppipe.build_topology(str(tmp_path / "wb.wksp"), depth=512,
                                wksp_sz=1 << 25)
    w = prings.Workspace.join(topo.wksp_path)
    result = tmp_path / "down.json"
    opts = {"tcache_depth": 4096, "bank_cnt": 4, "pack_scheduler": "greedy",
            "record_digests": True, "flight": {"enabled": True}}
    proc = subprocess.Popen(
        [sys.executable, "-m", "firedancer_tpu_torch.disco.worker",
         "--wksp", topo.wksp_path, "--tile", "dedup,pack,sink",
         "--opts", json.dumps(opts), "--max-ns", str(120_000_000_000),
         "--result", str(result)],
        cwd=ROOT, stderr=subprocess.PIPE,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    try:
        out = ppipe.out_link(w, "verify_dedup")
        want = []
        for i, p in enumerate(corpus.payloads):
            deadline = time.time() + 60
            while not out.can_publish():
                assert time.time() < deadline, "no credits from the worker"
                time.sleep(0.002)
            out.publish(p, ptiles.meta_sig(p), tsorig=500_000 + i)
            want.append(500_000 + i)
        sink_fseq = prings.FSeq(w, "pack_sink.fseq")
        deadline = time.time() + 60
        while sink_fseq.query() < len(want):
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.time() < deadline
            time.sleep(0.01)
        for t in ("dedup", "pack", "sink"):
            prings.Cnc(w, f"{t}.cnc").signal(prings.CNC_HALT)
        assert proc.wait(timeout=60) == 0
        res = json.loads(result.read_text())
        assert sorted(res["sink"]["recv_tsorig"]) == sorted(want)
        edges = pflight.read_edges(w)
        for edge in ("verify_dedup", "dedup_pack", "pack_sink", "sink"):
            assert edges[edge]["n"] == len(want), edge
        assert pflight.read_tiles(w)["dedup"]["drain_probed"] == len(want)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        w.leave()


# -- chaos and the HALT dump --------------------------------------------------


def test_halt_dump_records_the_chaos_counters(native_engine, tmp_path):
    """tests/test_flight.py:410-434 on the port: a seeded chaos run's
    HALT dump holds each class's injected events as the injector counted
    them (injected = detected = healed), and the verify recorder the
    healing's own events."""
    d = tmp_path / "dumps"
    corpus = _clean_corpus(n=200, seed=31)
    _, res = _port_run(tmp_path, "chaos", corpus,
                       chaos=(42, "slot_corrupt@2,backend_raise@1,"
                              "stager_kill@3"),
                       flight={"dump_dir": str(d)})
    counters = res.verify_stats[0]["chaos"]["counters"]
    (name,) = [n for n in os.listdir(d) if n.endswith("_halt.json")]
    with open(d / name) as f:
        dump = json.load(f)
    recorded: dict = {}
    for e in dump["recorders"]["chaos"]["events"]:
        if e["kind"] == "chaos" and e.get("event") == "injected":
            recorded[e["cls"]] = recorded.get(e["cls"], 0) + e.get("n", 1)
    for cls, c in counters.items():
        assert c["injected"] == c["detected"] == c["healed"] >= 1, (cls, c)
        assert recorded.get(cls, 0) == c["injected"], (cls, recorded)
    kinds = {e["kind"] for e in dump["recorders"]["verify"]["events"]}
    assert {"quarantine", "stager_restart", "halt"} <= kinds
    assert dump["metrics"]["verify"]["quarantined"] == 1
    assert dump["edges"]["sink"]["n"] == res.recv_cnt
    assert jsentinel.evaluate_edges_summary(dump["edges"]) == \
        psentinel.evaluate_edges_summary(dump["edges"])
