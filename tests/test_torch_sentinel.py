"""The port's fd_sentinel SLO engine (``firedancer_tpu_torch/disco/
sentinel.py``) against the JAX package's (``sentinel.py:1-870``,
``dump_slo_markdown``:1657), on the CPU.

* The table: all 15 SLOs' names, kinds, edges, objectives, budget
  names, targets and fault classes in the JAX order, ``SLO_NAMES``,
  ``SLO_BY_NAME``, ``FAULT_SLO``, the arming minimums, and each budget's
  default equal to the JAX flag's; the markdown's SLO table section
  equals the JAX text; the options map onto the flags (a budget, the
  burn and the windows given as options judge as the JAX sentinel does
  under the same FD_SLO_* environment).
* ``_bad_from_bucket`` over thresholds from 1 ns to 2^62 ns,
  ``evaluate_edges_summary`` (lane variants, non-summary entries) and
  ``evaluate_tenant_summary`` equal the JAX results.
* ``Sentinel`` under injected ``edges_fn``, ``tiles_fn``,
  ``metrics_fn`` and ``clock``, in the scenarios of
  ``tests/test_sentinel.py:72-166`` (a latency burn that fires and
  clears, good traffic, an unspanned slow window, a progress stall,
  progress not armed, a heartbeat stall, booting and halted tiles) and
  the drain-effectiveness, shard-balance, slope and fairness kinds:
  the alert sequence, the summary and the SLO rows equal the JAX
  sentinel's poll for poll; in a workspace the ``flight.slo`` region is
  byte-equal to the JAX one's after the same polls.
* The lifecycle: ``start`` polls on its thread, ``stop`` joins it and is
  idempotent, ``start_for_run`` with the sentinel off gives None.
* Runs on the CPU (the native verifier, ``native_engine``): a clean
  feed run is quiet and its rows reach ``render_prom``; a
  ``credit_starve`` window with a 300 ms stall budget trips exactly
  ``pipeline_progress``, recorded in the HALT dump's sentinel recorder
  (``tests/test_sentinel.py:495-563``).
"""

import json
import os

import numpy as np
import pytest
import torch

from firedancer_tpu import flags as jflags
from firedancer_tpu.disco import flight as jflight
from firedancer_tpu.disco import sentinel as jsentinel
from firedancer_tpu.disco.corpus import mainnet_corpus as jmainnet_corpus
from firedancer_tpu.tango import rings as jrings
from firedancer_tpu_torch.ballet.ed25519 import native as pnative
from firedancer_tpu_torch.disco import engine as pengine
from firedancer_tpu_torch.disco import flight as pflight
from firedancer_tpu_torch.disco import pipeline as ppipe
from firedancer_tpu_torch.disco import sentinel as psentinel
from firedancer_tpu_torch.tango import rings as prings

torch.set_num_threads(1)

PKGS = ((jflight, jsentinel), (pflight, psentinel))


# -- the table ----------------------------------------------------------------


def test_slo_table_equals_jax():
    fields = ("name", "kind", "edge_or_stage", "objective", "budget_flag",
              "target", "fault_classes")
    assert [tuple(getattr(s, f) for f in fields)
            for s in psentinel.SLO_TABLE] == \
        [tuple(getattr(s, f) for f in fields) for s in jsentinel.SLO_TABLE]
    assert len(psentinel.SLO_TABLE) == 15
    assert psentinel.SLO_NAMES == jsentinel.SLO_NAMES
    assert list(psentinel.SLO_BY_NAME) == list(jsentinel.SLO_BY_NAME)
    assert psentinel.FAULT_SLO == jsentinel.FAULT_SLO
    for k in ("MIN_WINDOW_N", "MIN_SHARD_LANES", "MIN_DRAIN_CLAIMS",
              "MIN_SLOPE_SAMPLES", "MIN_TENANT_OFFERED"):
        assert getattr(psentinel, k) == getattr(jsentinel, k), k
    for s in psentinel.SLO_TABLE:
        assert psentinel.SLO_DEFAULTS[s.budget_flag] == \
            jflags.REGISTRY[s.budget_flag].default, s.budget_flag
        assert psentinel._budget_default_ms(s) == \
            jsentinel._budget_default_ms(s)
    o = psentinel.SentinelOptions()
    for name, flag in (("enabled", "FD_SENTINEL"),
                       ("interval_ms", "FD_SENTINEL_INTERVAL_MS"),
                       ("burn", "FD_SLO_BURN"), ("fast_s", "FD_SLO_FAST_S"),
                       ("slow_s", "FD_SLO_SLOW_S")):
        assert getattr(o, name) == jflags.REGISTRY[flag].default, name
    with pytest.raises(KeyError):
        o.budget("FD_SLO_NOPE")


def _slo_section(md: str) -> str:
    start = md.index("## SLO table")
    end = md.find("\n## ", start + 1)
    return md[start:end if end >= 0 else len(md)].rstrip("\n")


def test_slo_markdown_table_equals_jax():
    assert _slo_section(psentinel.dump_slo_markdown()) == \
        _slo_section(jsentinel.dump_slo_markdown())


def test_bad_from_bucket_equals_jax():
    ths = [1, 2, 3, 1000, 1 << 20, (1 << 20) + 1, 2_500_000_000,
           10_000_000, 500_000_000, 1 << 62]
    ths += [int(x) for x in np.random.RandomState(3).randint(1, 1 << 40,
                                                             200)]
    for th in ths:
        assert psentinel._bad_from_bucket(th) == \
            jsentinel._bad_from_bucket(th), th


def test_evaluate_edges_summary_equals_jax():
    rng = np.random.RandomState(5)
    labels = ["sink", "verify_dedup", "verify_dedup.v1", "replay_verify",
              "replay_verify.v2", "verify_drain", "dedup_pack", "pack_sink",
              "quic_ingest", "other"]
    for _ in range(50):
        edges = {}
        for label in labels:
            if rng.rand() < 0.2:
                edges[label] = {"queue": 3}          # not a summary
                continue
            n = int(rng.randint(0, 3))
            edges[label] = {"n": n, "p50_ns_le": 0, "sum_ns": 0,
                            "p99_ns_le": int(1 << rng.randint(0, 36))}
        budgets = (None if rng.rand() < 0.5 else
                   {s.name: int(rng.randint(1, 5000))
                    for s in psentinel.SLO_TABLE})
        assert psentinel.evaluate_edges_summary(edges, budgets) == \
            jsentinel.evaluate_edges_summary(edges, budgets)


def test_evaluate_tenant_summary_equals_jax():
    rng = np.random.RandomState(9)
    for _ in range(50):
        tenants = {}
        for t in range(int(rng.randint(1, 5))):
            offered = int(rng.randint(0, 200))
            shed = int(rng.randint(0, offered + 1))
            admitted = offered - shed + int(rng.rand() < 0.1)
            tenants[f"t{t}"] = {"offered": offered, "admitted": admitted,
                                "shed": shed, "honest": bool(rng.rand() < .7)}
        pct = None if rng.rand() < 0.5 else int(rng.randint(0, 20))
        assert psentinel.evaluate_tenant_summary(tenants, pct) == \
            jsentinel.evaluate_tenant_summary(tenants, pct)


# -- the evaluator ------------------------------------------------------------


def _both(edges=lambda fl: {}, tiles=lambda: {}, metrics=lambda: {}):
    """A JAX and a port Sentinel on the same injected sources (edges
    given each package's EdgeHist rows)."""
    out = []
    for fl, sn in PKGS:
        e = edges(fl)
        out.append(sn.Sentinel(None, None, edges_fn=lambda e=e: e,
                               tiles_fn=tiles, metrics_fn=metrics,
                               clock=lambda: 0.0))
    return out


def _assert_same(js, ps):
    assert ps.alerts == js.alerts
    assert ps.summary() == js.summary()
    for name in psentinel.SLO_NAMES:
        assert np.array_equal(ps._rows[name], js._rows[name]), name


def _drive(pair, steps):
    """steps: [(now, action)]; action(pkg_index) feeds the sources."""
    for now, act in steps:
        for i, snt in enumerate(pair):
            act(i)
            snt.poll(now=now)
        _assert_same(*pair)


def _hists():
    return [fl.EdgeHist("sink") for fl, _ in PKGS]


def _edges_of(hs):
    return lambda fl: {"sink": hs[0 if fl is jflight else 1].row}


def _observe(hs, ns, k):
    def act(i):
        for _ in range(k):
            hs[i].observe(ns)
    return act


def test_latency_burn_fires_and_clears_as_jax():
    hs = _hists()
    pair = _both(edges=_edges_of(hs))
    steps = [(t / 2, _observe(hs, 10_000_000_000, 50)) for t in range(9)]
    steps += [(4.5 + t / 2, lambda i: None) for t in range(4)]
    _drive(pair, steps)
    js, ps = pair
    assert [a["slo"] for a in ps.alerts] == ["e2e_p99"]
    assert not ps._state["e2e_p99"].alerting
    assert ps.summary()["slos"]["e2e_p99"]["alerts"] == 1


def test_latency_good_and_unspanned_windows_quiet_as_jax():
    hs = _hists()
    pair = _both(edges=_edges_of(hs))
    _drive(pair, [(t / 2, _observe(hs, 1_000_000, 50)) for t in range(13)])
    assert pair[1].alerts == []
    hs = _hists()
    pair = _both(edges=_edges_of(hs))
    _drive(pair, [(t / 2, _observe(hs, 10_000_000_000, 100))
                  for t in range(5)])
    assert pair[1].alerts == []


def test_progress_stall_and_unarmed_as_jax():
    hs = _hists()
    pair = _both(edges=_edges_of(hs))
    _drive(pair, [(0.0, _observe(hs, 1000, 1)), (1.0, lambda i: None),
                  (2.5, lambda i: None), (2.6, _observe(hs, 1000, 1))])
    assert [a["slo"] for a in pair[1].alerts] == ["pipeline_progress"]
    assert not pair[1]._state["pipeline_progress"].alerting
    pair = _both(edges=lambda fl: {"sink": np.zeros(fl.EDGE_SLOTS,
                                                    np.uint64)})
    _drive(pair, [(t, lambda i: None) for t in (0.0, 3.0, 6.0, 9.0)])
    assert pair[1].alerts == []


def test_heartbeat_stall_and_ignored_states_as_jax():
    hb = {"verify": (1, 12345)}
    pair = _both(tiles=lambda: dict(hb))

    def beat(i):
        hb["verify"] = (1, 99999)

    _drive(pair, [(0.0, lambda i: None), (1.0, lambda i: None),
                  (1.7, lambda i: None), (1.8, beat)])
    assert [a["slo"] for a in pair[1].alerts] == ["tile_heartbeat"]
    assert pair[1].alerts[0]["tiles"] == ["verify"]
    pair = _both(tiles=lambda: {"boot": (0, 777), "halted": (2, 777)})
    _drive(pair, [(t, lambda i: None) for t in (0.0, 2.0, 4.0)])
    assert pair[1].alerts == []


def test_claims_shards_slopes_and_tenants_as_jax():
    rows = {}
    pair = _both(metrics=lambda: rows)
    seq = [
        {"verify": {"drain_novel": 10, "drain_maybe": 100}},
        {"verify": {"drain_novel": 10, "drain_maybe": 300}},   # < 10 %
        {"verify": {"drain_novel": 200, "drain_maybe": 300}},  # clears
        {"verify.shard0": {"lanes": 100}, "verify.shard1": {"lanes": 10}},
        {"verify.shard0": {"lanes": 100}, "verify.shard1": {"lanes": 90}},
        {"verify.shard0": {"lanes": 100}, "verify.shard1": {"lanes": 0}},
    ]
    slope = {"samples": 9, "heap_kb_min": 100.0, "pool_milli_min": 900.0,
             "compile_per_hr": 1.0}
    tenants = {"a": {"offered": 100, "admitted": 90, "shed": 10,
                     "honest": True},
               "b": {"offered": 100, "admitted": 0, "shed": 100,
                     "honest": False}}
    try:
        for mod in (jsentinel, psentinel):
            mod.set_slope_source(lambda: dict(slope))
            mod.set_tenant_source(lambda: tenants)
        for t, r in enumerate(seq):
            def act(i, r=r):
                rows.clear()
                rows.update(r)
            _drive(pair, [(float(t), act)])
    finally:
        for mod in (jsentinel, psentinel):
            mod.set_slope_source(None)
            mod.set_tenant_source(None)
    got = [a["slo"] for a in pair[1].alerts]
    assert got.count("drain_filter_effectiveness") == 1
    assert got.count("shard_balance") == 2
    assert "pool_occupancy_slope" in got and "tenant_fairness" in got
    assert "heap_slope" not in got


def test_options_judge_as_the_jax_flags(monkeypatch):
    """A budget, the burn and the windows given as options give the
    alerts the JAX sentinel gives under the same FD_SLO_* values."""
    for k, v in (("FD_SLO_E2E_BUDGET_MS", "1"), ("FD_SLO_BURN", "1.5"),
                 ("FD_SLO_FAST_S", "0.5"), ("FD_SLO_SLOW_S", "1.0"),
                 ("FD_SLO_STALL_MS", "700")):
        monkeypatch.setenv(k, v)
    opts = psentinel.SentinelOptions(
        burn=1.5, fast_s=0.5, slow_s=1.0,
        budgets={"FD_SLO_E2E_BUDGET_MS": 1, "FD_SLO_STALL_MS": 700})
    hs = _hists()
    js = jsentinel.Sentinel(None, None, edges_fn=lambda: {"sink": hs[0].row},
                            clock=lambda: 0.0)
    ps = psentinel.Sentinel(None, None, edges_fn=lambda: {"sink": hs[1].row},
                            clock=lambda: 0.0, opts=opts)
    assert ps.budgets_ms == js.budgets_ms
    for t in range(8):
        for h in hs:
            for _ in range(30):
                h.observe(5_000_000)       # 5 ms: over twice 1 ms
        js.poll(now=t / 4)
        ps.poll(now=t / 4)
        _assert_same(js, ps)
    for t in range(8, 14):
        js.poll(now=t / 4)
        ps.poll(now=t / 4)
        _assert_same(js, ps)
    assert [a["slo"] for a in ps.alerts] == ["e2e_p99", "pipeline_progress"]


def test_slo_rows_byte_equal_in_workspaces(tmp_path):
    pw = prings.Workspace.create(str(tmp_path / "p.wksp"), 1 << 22)
    jw = jrings.Workspace.create(str(tmp_path / "j.wksp"), 1 << 22)
    try:
        pflight.create_regions(pw, ["verify"], ["sink"],
                               slo_labels=psentinel.SLO_NAMES)
        jflight.create_regions(jw, ["verify"], ["sink"],
                               slo_labels=jsentinel.SLO_NAMES)
        ph, jh = pflight.edge_hist(pw, "sink"), jflight.edge_hist(jw, "sink")
        ps = psentinel.Sentinel(pw, clock=lambda: 0.0)
        js = jsentinel.Sentinel(jw, clock=lambda: 0.0)
        for t in range(12):
            for h in (ph, jh):
                for _ in range(40):
                    h.observe(10_000_000_000 if t < 9 else 1000)
            ps.poll(now=t / 2)
            js.poll(now=t / 2)
        assert ps.alerts == js.alerts and ps.alerts
        assert bytes(pw.view("flight.slo")) == bytes(jw.view("flight.slo"))
        assert pflight.read_slos(pw) == jflight.read_slos(jw)
    finally:
        pw.leave()
        jw.leave()


def test_lifecycle():
    calls = []
    snt = psentinel.Sentinel(None, None, edges_fn=lambda: calls.append(1)
                             or {}, opts={"interval_ms": 10})
    snt.start()
    for _ in range(200):
        if len(calls) >= 3:
            break
        __import__("time").sleep(0.01)
    summ = snt.stop()
    assert not snt.alive() and summ["evals"] >= 3
    assert snt.stop() == summ                   # idempotent
    assert psentinel.start_for_run(None, opts=False) is None


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


def _corpus(n=200, seed=7):
    return jmainnet_corpus(n=n, seed=seed, dup_rate=0.0, corrupt_rate=0.0,
                           parse_err_rate=0.0, sign_batch_size=64,
                           max_data_sz=120)


def _run(tmp_path, name, corpus, **kw):
    topo = ppipe.build_topology(str(tmp_path / f"{name}.wksp"), depth=512,
                                wksp_sz=1 << 26)
    return topo, ppipe.run_pipeline(topo, corpus.payloads, verify_batch=128,
                                    record_digests=True, device="cpu",
                                    timeout_s=120.0, feed_proc=False, **kw)


def test_clean_run_quiet_sentinel(native_engine, tmp_path):
    topo, res = _run(tmp_path, "clean", _corpus())
    assert res.slo is not None and res.slo["evals"] >= 1
    assert res.slo["alert_cnt"] == 0, res.slo
    assert set(res.slo["slos"]) == set(psentinel.SLO_NAMES)
    assert psentinel.evaluate_edges_summary(res.stage_hist) == []
    w = prings.Workspace.join(topo.wksp_path)
    try:
        slos = pflight.read_slos(w)
        assert slos["e2e_p99"]["evals"] == res.slo["evals"]
        assert 'fd_flight_slo_state{slo="e2e_p99"} 0' in \
            pflight.render_prom(w)
    finally:
        w.leave()


def test_credit_starve_trips_progress_slo(native_engine, tmp_path):
    d = tmp_path / "dumps"
    _, res = _run(tmp_path, "starve", _corpus(n=400, seed=97),
                  chaos=(5, "credit_starve@40:25040"),
                  flight={"dump_dir": str(d)},
                  sentinel={"interval_ms": 50,
                            "budgets": {"FD_SLO_STALL_MS": 300}})
    got = {a["slo"] for a in res.slo["alerts"]}
    assert got == {"pipeline_progress"}, res.slo["alerts"]
    assert "credit_starve" in res.slo["alerts"][0]["fault_classes"]
    (name,) = [n for n in os.listdir(d) if n.endswith("_halt.json")]
    with open(d / name) as f:
        dump = json.load(f)
    events = dump["recorders"]["sentinel"]["events"]
    assert any(e["kind"] == "slo_alert" and e["slo"] == "pipeline_progress"
               for e in events)
    assert dump["slos"]["pipeline_progress"]["alerts"] >= 1
    assert dump["slos"]["tile_heartbeat"]["alerts"] == 0
