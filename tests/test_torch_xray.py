"""The port's fd_xray (``firedancer_tpu_torch/disco/xray.py``, its hooks in
the tiles, the runners, the worker, the dump, the sentinel, the monitor
and fd_top, and ``tools/fd_xray.py`` and ``tools/fd_report.py``) against
the JAX package's ``firedancer_tpu.disco.xray``, on the CPU.

* Pure functions on the same inputs: ``sampled`` and ``sampled_mask`` at
  sample 1, 64 and 0 (ids 0-50,000, 0, 2^32 - 1 and seeded ids),
  ``tail_threshold_ns`` on every edge at the default budgets and at
  changed ones (the JAX flags against ``SentinelOptions``), ``dwell32``
  across the 32-bit wrap, the span rings' bound and per-trigger counts
  and ``SpanCtx``'s head and tail captures.
* The queue region: built from the same labels and after the same
  writes, byte for byte equal; each package's ``read_queue`` reads the
  other's workspace.
* Analysis on the same seeded histograms and spans (the
  ``tests/test_xray.py`` scenarios and seeded ones): ``waterfall``,
  ``waterfall_reconciles``, ``suspect_ranking``, ``_top_slowest``,
  ``exemplar_counts``, ``run_summary``'s merge of worker spans,
  ``to_chrome_trace`` and fd_report's waterfall text; the autopsy's keys
  (the JAX ``flags`` block is the port's ``options``); no autopsy
  without a directory; old dumps without an xray section still parse.
* Runs on the CPU (the engines' verify on the native verifier), on one
  seeded corpus: the port's step loop, its feed in process across a
  quarantine and its feed with worker processes, and the JAX package's
  step loop and feed across the same quarantine, hold the same
  properties: each edge's head count is ``sampled_mask`` over the ids
  the edge published (read back from its ring), every trace id sampled
  at the sink has a span on each upstream edge with a non-decreasing
  latency, every link's queue row has dwells, the waterfall reconciles
  with the spans, the HALT autopsy parses, the quarantine's trigger
  names the batch's ids, and ``PipelineResult.xray`` has the JAX keys.
  With xray off a run records no span and no row and the sink's
  multiset is unchanged.
"""

import contextlib
import importlib.util
import io
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

from firedancer_tpu.disco import flight as jflight
from firedancer_tpu.disco import pipeline as jpipe
from firedancer_tpu.disco import sentinel as jsentinel
from firedancer_tpu.disco import xray as jx
from firedancer_tpu.disco.corpus import expected_sink_digests
from firedancer_tpu.disco.corpus import mainnet_corpus as jmainnet_corpus
from firedancer_tpu.tango import rings as jrings
from firedancer_tpu_torch.ballet.ed25519 import native as pnative
from firedancer_tpu_torch.disco import engine as pengine
from firedancer_tpu_torch.disco import flight as pflight
from firedancer_tpu_torch.disco import monitor as pmonitor
from firedancer_tpu_torch.disco import pipeline as ppipe
from firedancer_tpu_torch.disco import sentinel as psentinel
from firedancer_tpu_torch.disco import xray as px
from firedancer_tpu_torch.tango import rings as prings

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINKS = ("replay_verify", "verify_dedup", "dedup_pack", "pack_sink")
CHAIN = LINKS + ("sink",)
U32 = 0xFFFFFFFF


def _load(name, *rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, *rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PTOOL_REPORT = _load("p_fd_report", "firedancer_tpu_torch", "tools",
                     "fd_report.py")
JTOOL_REPORT = _load("j_fd_report", "scripts", "fd_report.py")


@pytest.fixture(autouse=True)
def _clean_rings():
    """Both packages' ring registries start empty (they are process
    globals, and the runs leave theirs)."""
    with jx._rings_lock:
        jx._rings.clear()
    px.reset_rings()
    yield


# -- sampling, tail thresholds, dwell -----------------------------------------


def _ids():
    rng = np.random.RandomState(5)
    return np.concatenate([
        np.arange(0, 50_001, dtype=np.uint64),
        np.array([0, U32, U32 - 1, 1], np.uint64),
        rng.randint(0, 1 << 32, 20_000, dtype=np.uint64)])


@pytest.mark.parametrize("sample", [1, 64, 0])
def test_sampling_equals_jax(monkeypatch, sample):
    monkeypatch.setenv("FD_XRAY_SAMPLE", str(sample))
    ids = _ids()
    with px.configured({"sample": sample}):
        assert px.sample_threshold() == jx.sample_threshold()
        pm = px.sampled_mask(ids)
        assert np.array_equal(pm, jx.sampled_mask(ids))
        for i in range(0, len(ids), 613):
            assert px.sampled(int(ids[i])) == jx.sampled(int(ids[i])) \
                == bool(pm[i])
        assert not px.sampled(0) and not pm[ids == 0].any()
    if sample == 64:
        assert 0.5 / 64 < pm.mean() < 2.0 / 64
    if sample == 0:
        assert not pm.any()


def test_tail_threshold_equals_jax(monkeypatch):
    edges = ppipe.topology_edges(2) + ["no_such_edge"]
    for e in edges:
        assert px.tail_threshold_ns(e) == jx.tail_threshold_ns(e), e
    assert px.tail_threshold_ns("no_such_edge") == 0
    budgets = {"FD_SLO_E2E_BUDGET_MS": 100, "FD_SLO_SOURCE_BUDGET_MS": 3,
               "FD_SLO_QUIC_INGEST_MS": 1}
    for k, v in budgets.items():
        monkeypatch.setenv(k, str(v))
    opts = psentinel.SentinelOptions(budgets=budgets)
    with px.configured(None, opts):
        for e in edges:
            assert px.tail_threshold_ns(e) == jx.tail_threshold_ns(e), e
        assert px.tail_threshold_ns("sink") >= 2 * 100_000_000
        assert px.tail_threshold_ns("replay_verify.v1") == \
            px.tail_threshold_ns("replay_verify")
    assert px.tail_threshold_ns("sink", opts) == jx.tail_threshold_ns("sink")


def test_dwell32_across_the_wrap():
    rng = np.random.RandomState(3)
    cases = [(0, 0), (5, 0), (0, U32), (1 << 32, U32), (3 << 32, 7),
             (U32, 0), (4_000_000_000, 0), (3_999_999_999, 0),
             ((7 << 32) + 100, U32 - 50)]
    cases += [(int(n), int(t)) for n, t in zip(
        rng.randint(0, 1 << 62, 500, dtype=np.int64),
        rng.randint(0, 1 << 32, 500, dtype=np.int64))]
    for now, ts in cases:
        assert px.dwell32(now, ts) == jx.dwell32(now, ts), (now, ts)
    assert px.dwell32((9 << 32) + 10, U32 - 9) == 20
    assert px.dwell32(4_000_000_000, 0) == -1


def test_span_rings_and_ctx_equal_jax(monkeypatch):
    monkeypatch.setenv("FD_XRAY_RING", "16")
    monkeypatch.setenv("FD_SLO_E2E_BUDGET_MS", "1")
    with px.configured({"ring": 16}, {"budgets": {"FD_SLO_E2E_BUDGET_MS":
                                                   1}}):
        rp, rj = px.ring("edge:ringtest"), jx.ring("edge:ringtest")
        for r in (rp, rj):
            for i in range(40):
                r.record(i, i, i + 5, "head" if i % 3 else "tail",
                         {"k": i} if i % 5 == 0 else None)
        assert rp.spans() == rj.spans()
        assert len(rp.spans()) == 16 and rp.n == 40
        assert rp.counts == rj.counts
        assert [s["trace"] for s in rp.spans()] == list(range(24, 40))
        cp, cj = px.span_ctx("sink"), jx.span_ctx("sink")
        assert (cp.thr, cp.tail_ns) == (cj.thr, cj.tail_ns)
        rng = np.random.RandomState(9)
        ts = rng.randint(0, 1 << 32, 3000, dtype=np.uint64)
        ts[:5] = 0
        lats = rng.randint(0, 1 << 33, 3000).astype(np.int64)
        for c in (cp, cj):
            for t, lat in zip(ts[:1500].tolist(), lats[:1500].tolist()):
                c.observe(t, (t + lat) & U32, lat)
            c.observe_many(ts[1500:], lats[1500:])
        assert cp.ring.spans() == cj.ring.spans()
        assert cp.ring.counts == cj.ring.counts
        assert set(cp.ring.counts) == {"head", "tail"}
        assert sorted(px.dump_spans()) == sorted(jx.dump_spans())


def test_options_and_off_handles():
    assert px.as_options(False) == px.XrayOptions(enabled=False)
    assert px.as_options({"sample": 8}).sample == 8
    assert px.as_options(None) is px.options()
    with pytest.raises(TypeError):
        px.as_options(3)
    with px.configured(False):
        assert not px.enabled()
        assert px.span_ctx("sink") is None
        assert px.edge_rx(None, "x") is None and px.edge_tx(None, "x") is None
        assert px.ring("edge:off").spans() == []
        assert px.run_summary() is None
        assert px.flusher_for_run() is None
    with pflight.configured(False):
        assert not px.enabled()           # xray rides on fd_flight
    assert px.enabled() and px.options() == px.XrayOptions()


# -- the queue region ---------------------------------------------------------


def _queue_writes(x, wksp, edges, seed):
    rng = np.random.RandomState(seed)
    for e in edges:
        rx, tx = x.edge_rx(wksp, e), x.edge_tx(wksp, e)
        for ns in rng.randint(0, 1 << 33, 64).tolist():
            rx.observe_dwell(ns)
        rx.observe_dwell(-5)
        rx.observe_dwell(4_000_000_000)
        rx.add_idle(int(rng.randint(0, 1 << 40)))
        for d in rng.randint(-3, 5000, 9).tolist():
            rx.sample_depth(d)
        for ns in rng.randint(-10, 1 << 30, 7).tolist():
            tx.add_stall(ns)
        for c in rng.randint(-2, 4096, 11).tolist():
            tx.sample_credits(c)


@pytest.mark.parametrize("lanes", [1, 3])
def test_queue_region_byte_equal_and_read_across(tmp_path, lanes):
    edges = ppipe.topology_edges(lanes)
    pw = prings.Workspace.create(str(tmp_path / "p.wksp"), 1 << 22)
    jw = jrings.Workspace.create(str(tmp_path / "j.wksp"), 1 << 22)
    try:
        px.create_region(pw, edges)
        jx.create_region(jw, edges)
        assert bytes(pw.view("xray.queue")) == bytes(jw.view("xray.queue"))
        _queue_writes(px, pw, edges, seed=lanes)
        _queue_writes(jx, jw, edges, seed=lanes)
        assert bytes(pw.view("xray.queue")) == bytes(jw.view("xray.queue"))
        pj = prings.Workspace.join(str(tmp_path / "j.wksp"))
        jp = jrings.Workspace.join(str(tmp_path / "p.wksp"))
        try:
            want = jx.read_queue(jw)
            assert list(want) == list(edges)
            assert px.read_queue(pj) == want
            assert jx.read_queue(jp) == want
            assert px.read_queue(pw) == want
        finally:
            pj.leave()
            jp.leave()
        # An unknown label is a local row, not an error.
        stray = px.edge_rx(pw, "nope")
        stray.observe_dwell(1)
        assert "nope" not in px.read_queue(pw)
    finally:
        pw.leave()
        jw.leave()


def test_build_topology_queue_region_equals_jax(tmp_path):
    pt = ppipe.build_topology(str(tmp_path / "p.wksp"), depth=64,
                              verify_lanes=2)
    jt = jpipe.build_topology(str(tmp_path / "j.wksp"), depth=64,
                              wksp_sz=1 << 24, verify_lanes=2)
    pw = prings.Workspace.join(pt.wksp_path)
    jw = jrings.Workspace.join(jt.wksp_path)
    try:
        assert bytes(pw.view("xray.queue")) == bytes(jw.view("xray.queue"))
        assert px.read_queue(pw) == jx.read_queue(jw)
    finally:
        pw.leave()
        jw.leave()


def test_in_link_dwell_round_samples_every_nth(tmp_path):
    """The bulk drain's dwell sample: every queue_sample-th frag of the
    link's stream across rounds, stamps of 0 skipped (the JAX
    _dedup_round's stride, :3195-3205), and a stride below 1 clamps."""
    topo = ppipe.build_topology(str(tmp_path / "d.wksp"), depth=64)
    w = prings.Workspace.join(topo.wksp_path)
    try:
        with px.configured({"queue_sample": 4}):
            il = ppipe.in_link(w, "dedup_pack")
        assert il.xq_every == 4
        ts = np.full(64, 1, np.uint32)
        ts[4] = 0     # the second round's frag 8
        # Frags 4, 8, ..., 32 of the stream are due: 8, less frag 8.
        for n in (3, 10, 1, 18):
            il.dwell_round(ts, n)
        assert il.xq_cnt == 32
        assert il.xq.hist.count() == 7
        with px.configured({"queue_sample": 0}):
            assert ppipe.in_link(w, "pack_sink").xq_every == 1
    finally:
        w.leave()


# -- waterfall, suspects, spans -----------------------------------------------


def _hs(fl, vals):
    h = fl.EdgeHist("t")
    for v in vals:
        h.observe(int(v))
    return h.summary()


def _scenarios():
    """(edges, queue) pairs: the tests/test_xray.py chains (a plain one, a
    broken reconciliation, lane variants) and seeded random ones."""
    out = []
    for fl in (pflight,):
        edges = {"replay_verify": _hs(fl, [1_000] * 100),
                 "verify_drain": _hs(fl, [6_000_000] * 100),
                 "verify_dedup": _hs(fl, [10_001_000] * 100),
                 "dedup_pack": _hs(fl, [12_001_000] * 100),
                 "pack_sink": _hs(fl, [15_001_000] * 100),
                 "sink": _hs(fl, [16_001_000] * 100)}
        queue = {"verify_dedup": {"dwell": _hs(fl, [1_000_000] * 50)},
                 "dedup_pack": {"dwell": _hs(fl, [2_000_000] * 50)},
                 "pack_sink": {"dwell": _hs(fl, [500_000] * 50)}}
        out.append((edges, queue))
        bad = {k: {"dwell": _hs(fl, [400_000_000] * 50)}
               for k in ("verify_dedup", "dedup_pack", "pack_sink")}
        out.append((edges, bad))
        lanes = {"replay_verify": _hs(fl, [1_000] * 100),
                 "verify_dedup": _hs(fl, [10_000_000] * 50),
                 "verify_dedup.v1": _hs(fl, [30_000_000] * 50),
                 "dedup_pack": _hs(fl, [21_000_000] * 100),
                 "pack_sink": _hs(fl, [22_000_000] * 100),
                 "sink": _hs(fl, [23_000_000] * 100)}
        lq = {"verify_dedup": {"dwell": _hs(fl, [1_000_000] * 10),
                               "stall_ns": 5, "idle_ns": 7, "depth_avg": 1.0},
              "verify_dedup.v1": {"dwell": _hs(fl, [3_000_000] * 10),
                                  "stall_ns": 5, "idle_ns": 7,
                                  "depth_avg": 2.0}}
        out.append((lanes, lq))
        out.append((None, None))
        out.append(({"sink": _hs(fl, [5])}, {}))
    rng = np.random.RandomState(17)
    for _ in range(12):
        names = ppipe.topology_edges(int(rng.randint(1, 3)))
        edges = {e: _hs(pflight, rng.randint(0, 1 << 31, rng.randint(0, 40)))
                 for e in names if rng.rand() < 0.9}
        queue = {e: {"dwell": _hs(pflight, rng.randint(0, 1 << 30,
                                                       rng.randint(0, 20))),
                     "stall_ns": int(rng.randint(0, 1 << 30)),
                     "idle_ns": int(rng.randint(0, 1 << 30)),
                     "depth_avg": float(rng.randint(0, 100)) / 4}
                 for e in names if rng.rand() < 0.8}
        out.append((edges, queue))
    return out


def test_waterfall_and_reconciliation_equal_jax():
    for edges, queue in _scenarios():
        wf = px.waterfall(edges, queue)
        assert wf == jx.waterfall(edges, queue)
        for slack in (2.0, 1.5):
            assert px.waterfall_reconciles(edges or {}, wf, slack) == \
                jx.waterfall_reconciles(edges or {}, wf, slack)
        assert PTOOL_REPORT.render_waterfall(wf, edges) == \
            JTOOL_REPORT.render_waterfall(wf, edges)
    (edges, queue), (_, bad) = _scenarios()[:2]
    wf = px.waterfall(edges, queue)
    assert [s["stage"] for s in wf] == ["verify", "dedup", "pack", "sink"]
    assert wf[0]["queue_mean_ns"] == pytest.approx(6_000_000)
    assert wf[0]["service_mean_ns"] == pytest.approx(4_000_000)
    assert px.waterfall_reconciles(edges, wf)
    assert not px.waterfall_reconciles(edges, px.waterfall(edges, bad))
    lanes, lq = _scenarios()[2]
    d = px.waterfall(lanes, lq)[1]
    assert (d["queue_n"], d["stall_ns"], d["idle_ns"]) == (20, 10, 14)


def test_suspect_ranking_equals_jax(monkeypatch):
    slos = {"tile_heartbeat": {"evals": 10, "alerts": 1, "breach_polls": 3,
                               "burn_milli": 1800, "state": 1},
            "e2e_p99": {"evals": 10, "alerts": 0, "breach_polls": 0,
                        "burn_milli": 0, "state": 0},
            "pipeline_progress": {"evals": 3, "alerts": 2, "breach_polls": 1,
                                  "burn_milli": 9000, "state": 0}}
    edges = {"sink": {"n": 100, "p50_ns_le": 1 << 20, "p99_ns_le": 1 << 34,
                      "sum_ns": 100 << 20},
             "verify_dedup": {"n": 9, "p50_ns_le": 1 << 20,
                              "p99_ns_le": 1 << 31, "sum_ns": 9 << 20},
             "verify_dedup.v1": {"n": 4, "p50_ns_le": 1 << 20,
                                 "p99_ns_le": 1 << 29, "sum_ns": 4 << 20},
             "replay_verify": {"n": 0, "p50_ns_le": 0, "p99_ns_le": 0,
                               "sum_ns": 0}}
    alerts = [{"slo": "tile_heartbeat", "edge_or_stage": "heartbeat",
               "burn_milli": 2_000, "fault_classes": ["hb_stall"]},
              {"slo": "e2e_p99", "edge_or_stage": "sink",
               "burn_milli": 45_000, "fault_classes": []}]
    cases = [({}, slos, None), (edges, None, alerts), (edges, slos, alerts),
             (edges, slos, None), (None, None, None), (edges, {}, [])]
    for e, s, a in cases:
        assert px.suspect_ranking(e, s, a) == jx.suspect_ranking(e, s, a)
    ranked = px.suspect_ranking({}, slos, None)
    assert ranked[0]["slo"] == "pipeline_progress" and ranked[0]["alerted"]
    ranked = px.suspect_ranking(edges, None, alerts)
    assert ranked[0]["stage"] == "sink" and ranked[1]["stage"] == "heartbeat"
    passive = [r["score"] for r in ranked if not r["alerted"]]
    assert passive == sorted(passive, reverse=True)
    monkeypatch.setenv("FD_SLO_E2E_BUDGET_MS", "7")
    monkeypatch.setenv("FD_SLO_HB_MS", "300")
    opts = psentinel.SentinelOptions(budgets={"FD_SLO_E2E_BUDGET_MS": 7,
                                              "FD_SLO_HB_MS": 300})
    with px.configured(None, opts):
        for e, s, a in cases:
            assert px.suspect_ranking(e, s, a) == jx.suspect_ranking(e, s, a)


def _seeded_spans(seed=23):
    rng = np.random.RandomState(seed)
    out = {}
    traces = rng.randint(1, 1 << 32, 40).tolist()
    for ring_name in [f"edge:{e}" for e in CHAIN] + ["tile:verify"]:
        spans = []
        counts = {}
        for t in traces:
            if rng.rand() < 0.2:
                continue
            trig = ("head" if rng.rand() < 0.7 else
                    "tail" if rng.rand() < 0.8 else "quarantine")
            lat = int(rng.randint(0, 1 << 30))
            spans.append({"trace": t, "tsorig": t, "tspub": (t + lat) & U32,
                          "lat_ns": lat, "trigger": trig})
            counts[trig] = counts.get(trig, 0) + 1
        out[ring_name] = {"n_total": len(spans), "counts": counts,
                          "spans": spans}
    return out


def test_span_analysis_and_chrome_trace_equal_jax():
    for seed in (23, 29, 31):
        spans = _seeded_spans(seed)
        for k in (1, 3, 10):
            assert px._top_slowest(spans, k) == jx._top_slowest(spans, k)
        assert px.exemplar_counts(spans) == jx.exemplar_counts(spans)
        doc = px.to_chrome_trace(spans)
        assert doc == jx.to_chrome_trace(spans)
        doc = json.loads(json.dumps(doc))
        xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        assert len(xs) == sum(len(s["spans"]) for s in spans.values())
    one = {"edge:sink": {"n_total": 1, "counts": {"head": 1},
                         "spans": [{"trace": 7, "tsorig": 7, "tspub": 5007,
                                    "lat_ns": 5000, "trigger": "head"}]}}
    (e,) = [e for e in px.to_chrome_trace(one)["traceEvents"]
            if e["ph"] == "X"]
    assert (e["name"], e["dur"], e["tid"]) == ("sink", 5.0, 7)


def test_run_summary_merge_equals_jax():
    extra = {**{k: v for k, v in _seeded_spans(41).items()
                if k != "edge:pack_sink"},
             "edge:sink": {"n_total": 2, "counts": {"head": 1, "tail": 1},
                           "spans": [{"trace": 11, "tsorig": 11,
                                      "tspub": 3011, "lat_ns": 3000,
                                      "trigger": "head"}]}}
    for x in (px, jx):
        r = x.ring("edge:pack_sink")
        r.record(11, 11, 2011, "head")
        r.record(12, 12, 99, "tail")
        x.ring("edge:sink").record(11, 11, 3500, "head")
    ps, js = px.run_summary(extra_spans=extra), jx.run_summary(
        extra_spans=extra)
    assert ps == js
    assert sorted(ps) == ["exemplars", "sample_rate", "suspects",
                          "top_slowest", "traces", "waterfall"]
    assert ps["exemplars"]["head"] >= 3 and ps["exemplars"]["tail"] >= 2
    merged = px.merge_spans(px.dump_spans(), extra)
    assert merged["edge:sink"]["n_total"] == 3
    assert merged["edge:sink"]["counts"] == {"head": 2, "tail": 1}


def test_autopsy_keys_equal_jax_and_tools_read_it(tmp_path, monkeypatch):
    monkeypatch.setenv("FD_XRAY_DIR", str(tmp_path / "j"))
    alerts = [{"slo": "e2e_p99", "edge_or_stage": "sink", "burn_milli": 3000,
               "fault_classes": []}]
    topo = ppipe.build_topology(str(tmp_path / "a.wksp"), depth=64)
    w = prings.Workspace.join(topo.wksp_path)
    try:
        for x, wk in ((px, w), (jx, None)):
            x.ring("edge:sink").record(11, 11, 5011, "head")
            x.ring("tile:verify").record(11, 11, 6000, "quarantine",
                                         {"traces": [11]})
        pa = px.build_autopsy("unit", wksp=w, alerts=alerts)
        ja = jx.build_autopsy("unit", alerts=alerts)
        assert set(pa) - {"options"} == set(ja) - {"flags"}
        assert pa["exemplars"] == ja["exemplars"]
        assert pa["suspects"][0] == ja["suspects"][0]
        assert pa["kind"] == "xray_autopsy"
        assert pa["schema_version"] == jflight.ARTIFACT_SCHEMA_VERSION
        assert set(pa["options"]) == {"flight", "sentinel", "xray", "chaos",
                                      "verify_opts"}
        assert pa["queue"] == px.read_queue(w)
        with px.configured({"dir": str(tmp_path / "p")},
                           verify_opts={"drain": "off"}):
            path = px.maybe_autopsy("unit:test", wksp=w, alerts=alerts)
        dump_doc = pflight.dump("unit", wksp=w)
        assert dump_doc["xray"]["queue"] == px.read_queue(w)
        jpath = jx.maybe_autopsy("unit:test", alerts=alerts)
    finally:
        w.leave()
    a = json.loads(open(path).read())
    assert a["reason"] == "unit:test" and a["options"]["verify_opts"] == {
        "drain": "off"}
    assert set(a) - {"options"} == \
        set(json.loads(open(jpath).read())) - {"flags"}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert PTOOL_REPORT.main(["--autopsy", path]) == 0
    out = buf.getvalue()
    assert "SUSPECTED STAGE: sink" in out and "XRAY WATERFALL" in out
    dump = tmp_path / "dump.json"
    dump.write_text(json.dumps(dump_doc))
    for f in (path, str(dump)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert PTOOL_REPORT.main(["--waterfall", f]) == 0
        assert "reconciliation vs EdgeHist totals" in buf.getvalue()
    tool = _load("p_fd_xray", "firedancer_tpu_torch", "tools", "fd_xray.py")
    trace = tmp_path / "t.json"
    assert tool.main(["--chrome-trace", path, jpath, "-o", str(trace)]) == 0
    doc = json.loads(trace.read_text())
    assert len([e for e in doc["traceEvents"] if e["ph"] == "X"]) == 4
    assert tool.chains(tool.load_spans([path, jpath]))[0]["trace"] == 11


def test_no_autopsy_without_a_directory(tmp_path):
    assert px.options().dir is None
    assert px.maybe_autopsy("nothing") is None
    with px.configured({"dir": str(tmp_path / "x"), "enabled": False}):
        assert px.maybe_autopsy("off") is None
    assert not (tmp_path / "x").exists()


def test_dumps_carry_xray_and_old_dumps_parse(tmp_path):
    px.ring("edge:sink").record(42, 42, 99, "head")
    d = pflight.dump("unit")
    assert d["xray"]["spans"]["edge:sink"]["counts"] == {"head": 1}
    old = {k: v for k, v in d.items() if k != "xray"}
    edges = {"sink": {"n": 10, "p50_ns_le": 1024, "p99_ns_le": 2048,
                      "sum_ns": 10240}}
    budgets = {s.name: 1000 for s in psentinel.SLO_TABLE}
    v_old = psentinel.evaluate_edges_summary(edges, budgets)
    v_new = psentinel.evaluate_edges_summary(
        dict(edges, xray={"spans": {}}, queue=[1, 2, 3]), budgets)
    assert v_old == v_new == jsentinel.evaluate_edges_summary(edges, budgets)
    tool = _load("p_fd_xray2", "firedancer_tpu_torch", "tools", "fd_xray.py")
    p_old, p_new = tmp_path / "old.json", tmp_path / "new.json"
    p_old.write_text(json.dumps(old))
    p_new.write_text(json.dumps(d))
    assert tool.load_spans([str(p_old)]) == {}
    assert tool.main([str(p_old)]) == 1
    assert tool.load_spans([str(p_old), str(p_new)]) == \
        d["xray"]["spans"]


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


SAMPLE = 8
N_TXN = 200


@pytest.fixture(scope="module")
def corpus():
    return jmainnet_corpus(n=N_TXN, seed=29, dup_rate=0.0, corrupt_rate=0.0,
                           parse_err_rate=0.0, sign_batch_size=64,
                           max_data_sz=120)


def _published_ids(rings_mod, w, link):
    """Every trace id a link published, read back from its mcache (the
    rings are deeper than the corpus, so no meta was overwritten)."""
    mc = rings_mod.MCache(w, f"{link}.mcache")
    n = mc.seq_next()
    assert n <= mc.depth
    out = []
    for seq in range(n):
        r, frag = mc.poll(seq)
        assert r == rings_mod.POLL_FRAG
        out.append(frag.tsorig)
    return np.asarray(out, np.uint64)


def _autopsy(d, reason="halt"):
    names = [n for n in os.listdir(d) if n.endswith(f"_{reason}.json")]
    assert len(names) == 1, os.listdir(d)
    a = json.loads(open(os.path.join(d, names[0])).read())
    assert a["kind"] == "xray_autopsy" and a["reason"] == reason
    return a


def _check_run(x, rings_mod, fl, wksp_path, res, autopsy, corpus,
               queued=LINKS):
    """The tentpole's run properties, read through package x's own
    functions on its own workspace (the sink received what the pack
    published); the queued links' rows must hold dwells and depths."""
    spans = autopsy["exemplars"]["spans"]
    w = rings_mod.Workspace.join(wksp_path)
    try:
        thr = (1 << 32) // SAMPLE
        for edge in LINKS:
            ids = _published_ids(rings_mod, w, edge)
            sect = spans[f"edge:{edge}"]
            want = int(x.sampled_mask(ids, thr).sum())
            assert sect["counts"].get("head", 0) == want, edge
            heads = {s["trace"] for s in sect["spans"]
                     if s["trigger"] == "head"}
            assert heads == {int(t) for t in ids[x.sampled_mask(ids, thr)]}
        sink = spans["edge:sink"]
        want = x.sampled_mask(_published_ids(rings_mod, w, "pack_sink"), thr)
        assert sink["counts"].get("head", 0) == int(want.sum()) > 0
        by_edge = {e: {s["trace"]: s for s in spans[f"edge:{e}"]["spans"]}
                   for e in CHAIN}
        for s in sink["spans"]:
            if s["trigger"] != "head":
                continue
            lats = [by_edge[e][s["trace"]]["lat_ns"] for e in CHAIN]
            assert lats == sorted(lats), (s["trace"], lats)
        q = x.read_queue(w)
        for edge in queued:
            assert q[edge]["dwell"]["n"] > 0, edge
            assert q[edge]["depth_samples"] > 0, edge
        edges = fl.read_edges(w)
    finally:
        w.leave()
    wf = res.xray["waterfall"]
    assert wf == x.waterfall(edges, q)
    assert x.waterfall_reconciles(edges, wf)
    assert sorted(res.xray) == ["exemplars", "sample_rate", "suspects",
                                "top_slowest", "traces", "waterfall"]
    assert res.xray["sample_rate"] == SAMPLE
    assert res.xray["traces"] >= int(want.sum())
    assert Counter(res.sink_digests) == expected_sink_digests(corpus)


def _port_run(tmp_path, name, corpus, **kw):
    topo = ppipe.build_topology(str(tmp_path / f"{name}.wksp"), depth=512,
                                wksp_sz=1 << 26)
    kw.setdefault("feed_proc", False)
    d = str(tmp_path / f"{name}.x")
    res = ppipe.run_pipeline(
        topo, corpus.payloads, verify_batch=128, record_digests=True,
        device="cpu", timeout_s=120.0,
        xray=kw.pop("xray", {"sample": SAMPLE, "dir": d}), **kw)
    return topo, res, d


@pytest.mark.parametrize("mode", ["step", "feed_quarantine", "feed_workers"])
def test_port_runs_hold_the_tentpole(native_engine, tmp_path, corpus, mode):
    kw = {"step": {"feed": False},
          "feed_quarantine": {"feed": True, "chaos": (1, "backend_raise@1")},
          "feed_workers": {"feed": True, "feed_proc": True}}[mode]
    topo, res, d = _port_run(tmp_path, mode, corpus, **kw)
    assert res.feed == (mode != "step")
    a = _autopsy(d)
    _check_run(px, prings, pflight, topo.wksp_path, res, a, corpus)
    assert set(a["options"]) == {"flight", "sentinel", "xray", "chaos",
                                 "verify_opts"}
    tile = a["exemplars"]["spans"]["tile:verify"]
    ctx = [s for s in tile["spans"] if s["trigger"] == "head"]
    assert ctx and all(s["batch"] >= 1 and "engine" in s and "verdict" in s
                       for s in ctx)
    if mode == "feed_quarantine":
        assert res.verify_stats[0]["quarantined"] == 1
        (quar,) = [s for s in tile["spans"] if s["trigger"] == "quarantine"]
        assert quar["traces"] and tile["counts"]["quarantine"] == 1
        assert a["options"]["chaos"] == {"seed": 1,
                                         "schedule": "backend_raise@1"}
        assert a["chaos"]["counters"]["backend_raise"]["injected"] == 1
    if mode == "feed_workers":
        assert "slot" in ctx[0]
    # The live views read the rows: the monitor's xq rows, fd_top's panel.
    w = prings.Workspace.join(topo.wksp_path)
    try:
        snap = pmonitor.snapshot(w, topo.pod)
    finally:
        w.leave()
    assert snap["xq.verify_dedup"]["dwell_n"] > 0
    top = _load("p_fd_top", "firedancer_tpu_torch", "tools", "fd_top.py")
    jtop = _load("j_fd_top", "scripts", "fd_top.py")
    assert "XRAY edge" in top.render_flight(snap, ansi=False)
    assert top.render_flight(snap) == jtop.render_flight(snap)


@pytest.mark.parametrize("feed", [False, True], ids=["step", "feed"])
def test_jax_runs_hold_the_tentpole(tmp_path, monkeypatch, corpus, feed):
    """The JAX runners on the same corpus hold the same properties (its
    feed across the same injected quarantine)."""
    d = str(tmp_path / "jx")
    env = {"FD_FEED": "1" if feed else "0", "FD_FEED_PROC": "0",
           "FD_XRAY_SAMPLE": str(SAMPLE), "FD_XRAY_DIR": d}
    if feed:
        env.update(FD_CHAOS="1", FD_CHAOS_SEED="1",
                   FD_CHAOS_SCHEDULE="backend_raise@1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    topo = jpipe.build_topology(str(tmp_path / "j.wksp"), depth=512,
                                wksp_sz=1 << 26)
    res = jpipe.run_pipeline(topo, corpus.payloads, verify_backend="cpu",
                             timeout_s=120.0, record_digests=True, feed=feed)
    assert res.feed == feed
    # The JAX step loop's verify tile books no queue row for its in-edge
    # (its native drain leaves it to the feed's stager); the port's does.
    a = _autopsy(d)
    _check_run(jx, jrings, jflight, topo.wksp_path, res, a, corpus,
               queued=LINKS if feed else LINKS[1:])
    if feed:
        tile = a["exemplars"]["spans"]["tile:verify"]
        assert tile["counts"].get("quarantine") == 1


def test_xray_off_records_nothing(native_engine, tmp_path, corpus):
    topo, res, d = _port_run(tmp_path, "off", corpus, feed=False,
                             xray=False)
    assert res.xray is None
    assert px.dump_spans() == {}
    assert not os.path.exists(d)
    assert Counter(res.sink_digests) == expected_sink_digests(corpus)
    w = prings.Workspace.join(topo.wksp_path)
    try:
        for r in px.read_queue(w).values():
            assert r["dwell"]["n"] == r["depth_samples"] == \
                r["stall_cnt"] == r["idle_ns"] == 0
    finally:
        w.leave()
    assert res.stage_hist["sink"]["n"] == res.recv_cnt   # flight stays on
