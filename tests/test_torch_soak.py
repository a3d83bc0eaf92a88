"""The port's fd_soak harness against the JAX package's, on the CPU.

* The plan: ``build_plan`` over seeds, profiles and a ``max_txns`` that
  caps and one that does not gives the JAX phases, schedule and
  duration; an unknown profile raises in both. The copied tables and
  ``SoakOptions``' defaults equal the JAX ones and its flags'.
  ``chaos_spec`` carries ``chaos_env``'s seed and schedule.
* ``build_payloads`` signs a two-phase plan on ``device="cpu"``: the JAX
  payload bytes, index ranges and ``n_unique_ok``.
* The judgment: ``_lsq_slope``, ``ResourceProbe.source``, ``ring_hwm``
  and ``alerts_between`` on fabricated samples; ``judge`` on
  ``tests/test_soak.py``'s fabricated runs (records equal but for ``ts``;
  the JAX "tpu" backend is the port's "gpu"); ``respawn_budget`` over a
  grid; ``tools/bench_log_check.validate_soak`` on ``SOAK_r01.json`` and
  mutated copies (the JAX script's errors).
* ``hb_stall``: ``ChaosInjector.hb_stalled`` over interleaved tile ids
  gives the JAX booleans and counters; a feed run on ``device="cpu"``
  with ``hb_stall@2:40`` freezes each tile's heartbeat through passes
  2-40, balances the class and delivers the sink exactly.
* A compressed ``run_soak`` and ``tools/fd_soak.main`` on the CPU: judged
  ok, every unique well-formed txn at the sink, the record valid. In
  these runs the engines' verify is the native verifier (as in
  ``tests/test_torch_chaos.py``): the plain PyTorch versions are held to
  the JAX package in ``tests/test_torch_verify.py``; what is tested here
  is the harness around the engine.
"""

import dataclasses
import importlib.util
import json
import os
import time
from collections import Counter, defaultdict
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from firedancer_tpu import flags as jflags
from firedancer_tpu.disco import chaos as jchaos
from firedancer_tpu.disco import sentinel as jsentinel
from firedancer_tpu.disco import siege as jsiege
from firedancer_tpu.disco import soak as jsoak
from firedancer_tpu.disco import supervisor as jsupervisor
from firedancer_tpu.disco.corpus import expected_sink_digests
from firedancer_tpu.disco.corpus import mainnet_corpus as jmainnet_corpus
from firedancer_tpu_torch.ballet.ed25519 import native as pnative
from firedancer_tpu_torch.disco import chaos as pchaos
from firedancer_tpu_torch.disco import engine as pengine
from firedancer_tpu_torch.disco import pipeline as ppipe
from firedancer_tpu_torch.disco import sentinel as psentinel
from firedancer_tpu_torch.disco import siege as psiege
from firedancer_tpu_torch.disco import soak as psoak
from firedancer_tpu_torch.disco import supervisor as psupervisor
from firedancer_tpu_torch.disco import tiles as ptiles

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, *rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, *rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PCHECK = _load("p_bench_log_check", "firedancer_tpu_torch", "tools",
               "bench_log_check.py")
JCHECK = _load("j_bench_log_check", "scripts", "bench_log_check.py")
PTOOL = _load("p_fd_soak", "firedancer_tpu_torch", "tools", "fd_soak.py")

# tests/test_soak.py's compressed-window budgets as sentinel options:
# latency budgets out of the way, the slope budgets scaled but finite.
SENTINEL = {"budgets": {
    "FD_SLO_E2E_BUDGET_MS": 900000, "FD_SLO_SOURCE_BUDGET_MS": 900000,
    "FD_SLO_QUIC_INGEST_MS": 900000, "FD_SLO_HEAP_SLOPE_KB": 131072,
    "FD_SLO_POOL_SLOPE_MILLI": 200000, "FD_SLO_COMPILE_SLOPE": 36000,
    "FD_SLO_STALL_MS": 300000, "FD_SLO_HB_MS": 120000}}


@pytest.fixture
def native_engine(monkeypatch):
    """The engines' verify on the CPU is the native verifier's."""

    def fn(self, msgs, lens, sigs, pubs):
        arrs = [np.ascontiguousarray(torch.as_tensor(a).numpy())
                for a in (msgs, lens, sigs, pubs)]
        self.note_dispatch(len(arrs[0]))
        return torch.from_numpy(pnative.verify_arrays(*arrs, len(arrs[0])))

    monkeypatch.setattr(pengine.EngineEntry, "fn", fn)


# -- the plan -----------------------------------------------------------------


def _plan_dict(plan):
    return dataclasses.asdict(plan)


@pytest.mark.parametrize("max_txns", [200_000, 500])
@pytest.mark.parametrize("profile", ["drift", "crash_storm", "dup_storm"])
@pytest.mark.parametrize("seed", [606, 23, 17, 9])
def test_build_plan_matches_jax(seed, profile, max_txns):
    kw = dict(seed=seed, n_phases=7, phase_s=4.0, rate=37.5,
              profile=profile, max_txns=max_txns)
    got = psoak.build_plan(**kw)
    want = jsoak.build_plan(**kw)
    assert _plan_dict(got) == _plan_dict(want)
    if max_txns == 500:
        assert got.n_txns < sum(max(32, int(p.rate * 4.0))
                                for p in got.phases)


def test_build_plan_defaults_and_unknown_profile():
    assert _plan_dict(psoak.build_plan()) == _plan_dict(jsoak.build_plan())
    for mod in (psoak, jsoak):
        with pytest.raises(ValueError, match="unknown soak profile"):
            mod.build_plan(seed=3, profile="quic_meteor_strike")


def test_tables_and_options_match_jax():
    assert psoak.PROFILE_MIX == jsoak.PROFILE_MIX
    assert psoak._CHAOS_ROTATION == jsoak._CHAOS_ROTATION
    assert psoak._FAULT_COLLATERAL == jsoak._FAULT_COLLATERAL
    assert (psoak.SCHEMA_VERSION, psoak.METRIC) == \
        (jsoak.SCHEMA_VERSION, jsoak.METRIC)
    assert psiege.PROFILES == jsiege.PROFILES
    opts = psoak.SoakOptions()
    reg = jflags.REGISTRY
    assert (opts.seed, opts.phases, opts.phase_s, opts.probe_ms,
            opts.respawn_budget) == tuple(reg[k].default for k in (
                "FD_SOAK_SEED", "FD_SOAK_PHASES", "FD_SOAK_PHASE_S",
                "FD_SOAK_PROBE_MS", "FD_SOAK_RESPAWN_BUDGET"))
    for k in ("FD_SLO_HEAP_SLOPE_KB", "FD_SLO_POOL_SLOPE_MILLI",
              "FD_SLO_COMPILE_SLOPE"):
        assert psentinel.SentinelOptions().budget(k) == reg[k].default
    assert psentinel.MIN_SLOPE_SAMPLES == jsentinel.MIN_SLOPE_SAMPLES


@pytest.mark.parametrize("n_phases", [1, 2, 4])
def test_chaos_spec_carries_chaos_env(n_phases):
    plan = psoak.build_plan(seed=11, n_phases=n_phases, phase_s=2.0,
                            rate=30.0)
    env = jsoak.chaos_env(jsoak.build_plan(seed=11, n_phases=n_phases,
                                           phase_s=2.0, rate=30.0))
    spec = psoak.chaos_spec(plan)
    if not env:
        assert spec is None and plan.chaos_schedule == ""
        return
    assert spec == (int(env["FD_CHAOS_SEED"]), env["FD_CHAOS_SCHEDULE"])
    assert pchaos.injector(spec).schedule == \
        jchaos.parse_schedule(env["FD_CHAOS_SCHEDULE"])


def test_build_payloads_match_jax():
    kw = dict(seed=5, n_phases=2, phase_s=1.0, rate=40.0)
    pplan, jplan = psoak.build_plan(**kw), jsoak.build_plan(**kw)
    got = psoak.build_payloads(pplan, sign_batch_size=256, device="cpu")
    want = jsoak.build_payloads(jplan, sign_batch_size=256)
    assert got == want
    assert _plan_dict(pplan) == _plan_dict(jplan)
    assert pplan.phases[-1].end_idx == len(got)
    for p in pplan.phases:
        assert 0 < p.n_unique_ok <= p.n_txns


# -- the probe and the judgment -----------------------------------------------


@pytest.mark.parametrize("pairs", [
    [(0.0, 1.0), (1.0, 3.0), (2.0, 5.0)],
    [(0.0, 7.0)],
    [(1.0, 7.0), (1.0, 9.0)],
    [(0.1 * i, 3.0 * i * i - 2.0 * i) for i in range(17)],
])
def test_lsq_slope_matches_jax(pairs):
    assert psoak._lsq_slope(pairs) == jsoak._lsq_slope(pairs)


def _probes(samples):
    out = []
    for mod in (psoak, jsoak):
        probe = mod.ResourceProbe(wksp=None, interval_ms=250)
        probe.samples.extend(dict(s) for s in samples)
        out.append(probe)
    return out


_BURST = [{"t": float(i), "heap_kb": 400.0 + 40.0 * min(float(i), 10.0),
           "pool_out": 3, "engines": 2, "alerts": 0} for i in range(40)]
_LEAKY = [{"t": float(i), "heap_kb": 100.0 + 60.0 * i, "pool_out": i % 5,
           "engines": 2 + i // 10, "alerts": i // 7} for i in range(40)]
_SHORT = [{"t": 0.0, "alerts": 0, "pool_out": 1, "inflight": 0,
           "heap_kb": 1.0},
          {"t": 1.0, "alerts": 0, "pool_out": 5, "inflight": 2,
           "heap_kb": 2.0},
          {"t": 2.0, "alerts": 2, "pool_out": 2, "inflight": 7,
           "heap_kb": 2.0},
          {"t": 3.0, "alerts": 3, "pool_out": 0, "inflight": 1,
           "heap_kb": 5.0}]


@pytest.mark.parametrize("samples", [_BURST, _LEAKY, _SHORT, _SHORT[:1], []],
                         ids=["burst", "leaky", "short", "one", "none"])
def test_probe_surfaces_match_jax(samples):
    p, j = _probes(samples)
    assert p.source() == j.source()
    assert p.ring_hwm() == j.ring_hwm()
    for t0, t1 in ((0.0, 3.0), (0.5, 1.5), (1.5, 2.5), (-1.0, 100.0)):
        assert p.alerts_between(t0, t1) == j.alerts_between(t0, t1)
    if samples is _BURST:
        src = p.source()
        assert src["samples"] == sum(1 for r in samples
                                     if r["t"] >= 0.25 * 39)
        assert abs(src["heap_kb_min"]) < 1.0


def _judged(mod, alerts, counters, *, n_unique_ok=50, recv=None, leaked=0,
            restarts=0, elapsed=60.0, reconfigs=(0, 0), t0=None):
    """tests/test_soak.py:181-207's fabricated run, for either package."""
    plan = mod.build_plan(seed=9, n_phases=2, phase_s=1.0, rate=40.0)
    for ph in plan.phases:
        ph.n_unique_ok = n_unique_ok // len(plan.phases)
    expected = sum(ph.n_unique_ok for ph in plan.phases)
    vs = {"chaos": {"counters": counters}, "stager_restarts": restarts,
          "slots_leaked": leaked, "reconfigs": reconfigs[0],
          "reconfig_refused": reconfigs[1]}
    res = SimpleNamespace(
        verify_stats=[vs],
        slo={"alert_cnt": len(alerts), "alerts": [dict(a) for a in alerts],
             "slos": {}},
        recv_cnt=expected if recv is None else recv, supervisor_restarts=0)
    src = SimpleNamespace(
        payloads=[b"x"] * 64, pub_cnt=64,
        phase_log=[{"phase": "p00", "profile": "conn_churn", "t_start": t0,
                    "t_end": t0 + 30.0, "n_txns": 32, "published": 32},
                   {"phase": "p01", "profile": "dup_storm",
                    "t_start": t0 + 30.0, "t_end": t0 + 60.0,
                    "n_txns": 32, "published": 32}])
    probe = mod.ResourceProbe(wksp=None, interval_ms=250)
    probe.samples.extend(
        {"t": t0 + i * 5.0, "heap_kb": 500.0 + 3.0 * i, "pool_out": 1,
         "engines": 1, "alerts": len(alerts) if i >= 6 else 0}
        for i in range(13))
    if mod is psoak:
        return mod.judge(plan, res, src, probe, None, elapsed,
                         backend="gpu")
    return mod.judge(plan, res, src, probe, None, elapsed, backend="tpu")


_HB = {"slo": "tile_heartbeat", "fault_classes": ["hb_stall"],
       "autopsy": "a1.json", "burn_milli": 3000}
_PROGRESS = {"slo": "pipeline_progress", "fault_classes": ["credit_starve"]}
_HEAP = {"slo": "heap_slope", "slo_kind": "slope", "edge_or_stage": "heap"}


@pytest.mark.parametrize("case", [
    dict(alerts=[_HB, _PROGRESS], counters={"hb_stall": {"injected": 2}}),
    dict(alerts=[_HB, _PROGRESS], counters={}),
    dict(alerts=[_HB], counters={"hb_stall": {"injected": 1}}),
    dict(alerts=[_HB], counters={}),
    dict(alerts=[_HEAP], counters={"credit_starve": {"injected": 1}}),
    dict(alerts=[], counters={}, recv=40),
    dict(alerts=[], counters={}, leaked=3),
    dict(alerts=[], counters={}, restarts=3),
    dict(alerts=[], counters={}, restarts=2000, elapsed=60.0),
    dict(alerts=[], counters={"stager_kill": {"injected": 4}},
         reconfigs=(1, 2), elapsed=0.0),
], ids=["explained", "unexplained", "blip-excused", "blip", "heap",
        "dropped", "leaked", "respawn-ok", "respawn-storm", "reconfigs"])
def test_judge_matches_jax(case):
    t0 = time.perf_counter()
    got = _judged(psoak, t0=t0, **case)
    want = _judged(jsoak, t0=t0, **case)
    for rec in (got, want):
        assert "T" in rec.pop("ts")
    assert got.pop("on_device") is want.pop("on_device") is True
    assert (got.pop("backend"), want.pop("backend")) == ("gpu", "tpu")
    assert got == want
    assert PCHECK.validate_soak(dict(got, ts="2026-01-01T00:00:00",
                                     on_device=True, backend="gpu")) == []


@pytest.mark.parametrize("budget", [None, 5, 30])
def test_respawn_budget_matches_jax(budget):
    for restarts in (0, 1, 5, 30, 31, 100, 2000):
        for elapsed in (0.0, 1.0, 60.0, 3600.0, 7200.5):
            assert psupervisor.respawn_budget(restarts, elapsed, budget) \
                == jsupervisor.respawn_budget(restarts, elapsed, budget)


def _mutations():
    return [
        ("dropped", lambda r: r["continuity"].__setitem__("dropped", 5)),
        ("unexplained",
         lambda r: r["slo"].__setitem__("unexplained_alerts", 1)),
        ("digest", lambda r: r["continuity"].__setitem__("digest_match",
                                                         False)),
        ("metric", lambda r: r.__setitem__("metric", "bench")),
        ("schema", lambda r: r.__setitem__("schema_version", 1)),
        ("ts", lambda r: r.pop("ts")),
        ("phases", lambda r: r.__setitem__("phases", [])),
        ("phase-alerts",
         lambda r: r["phases"][0].__setitem__("alerts", True)),
        ("slope", lambda r: r["slopes"].__setitem__("within_budget", False)),
        ("respawn", lambda r: r["respawn"].__setitem__("ok", False)),
        ("leaked", lambda r: r["continuity"].__setitem__("slots_leaked", 2)),
        ("events", lambda r: r["reconfig"].__setitem__("events", None)),
        ("not-ok", lambda r: r.__setitem__("ok", False)),
        ("not-a-dict", lambda r: r.clear()),
    ]


@pytest.mark.parametrize("name,mutate", _mutations(),
                         ids=[m[0] for m in _mutations()])
def test_validate_soak_matches_jax(name, mutate):
    with open(os.path.join(ROOT, "SOAK_r01.json"), encoding="utf-8") as f:
        rec = json.load(f)
    assert PCHECK.validate_soak(rec) == JCHECK.validate_soak(rec) == []
    mutate(rec)
    got = PCHECK.validate_soak(rec)
    assert got == JCHECK.validate_soak(rec)
    assert (got == []) == (name == "not-ok")


def test_bench_log_check_main(tmp_path, capsys):
    good = os.path.join(ROOT, "SOAK_r01.json")
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"metric": "bench"}))
    assert PCHECK.main([good]) == 0
    assert PCHECK.main([good, str(bad)]) == 1
    assert "metric must be soak_run" in capsys.readouterr().out


# -- hb_stall -----------------------------------------------------------------


def test_hb_stalled_matches_jax():
    sched = "hb_stall@3:5,hb_stall@9:9,credit_starve@2:3"
    order = ["a", "b", "a", "c", "a", "b", "a", "a", "c", "b", "a", "b",
             "a", "a", "a", "b", "b", "c", "c", "c", "a", "b", "b", "b",
             "b", "b", "b", "b"]
    out = []
    for mod in (pchaos, jchaos):
        inj = mod.ChaosInjector(seed=3, schedule=sched)
        out.append(([inj.hb_stalled(t) for t in order], inj.snapshot()))
    assert out[0] == out[1]
    assert out[0][1]["counters"]["hb_stall"] == {
        "injected": 5, "detected": 5, "healed": 4}


def test_hb_stall_has_its_site():
    assert "hb_stall" in pchaos.PORTED_CLASSES
    pchaos.ChaosInjector(seed=1, schedule="hb_stall@1:3")


@pytest.mark.parametrize("hi", [40, 10 ** 9])
def test_hb_stall_freezes_each_tiles_heartbeat(native_engine, tmp_path,
                                               monkeypatch, hi):
    """chaos=(1, "hb_stall@2:<hi>") on a feed run: every tile that reached
    its pass 2 kept its pass-1 heartbeat through pass hi (or to its
    halt) and beat again at pass hi + 1; the class books one injected,
    detected and healed a stalled tile (healed at the halt for a window
    still open); the sink is exact."""
    beats = defaultdict(list)
    beat = ptiles.Tile._beat

    def logged(self, now):
        before = self.cnc.heartbeat_query()
        beat(self, now)
        beats[self.cnc_name].append((before, self.cnc.heartbeat_query()))

    monkeypatch.setattr(ptiles.Tile, "_beat", logged)
    corpus = jmainnet_corpus(n=300, seed=13, dup_rate=0.08,
                             corrupt_rate=0.04, parse_err_rate=0.04,
                             sign_batch_size=128, max_data_sz=140)
    topo = ppipe.build_topology(str(tmp_path / "hb.wksp"), depth=512,
                                wksp_sz=1 << 26)
    res = ppipe.run_pipeline(topo, corpus.payloads, verify_batch=32,
                             record_digests=True, device="cpu",
                             timeout_s=120.0, chaos=(1, f"hb_stall@2:{hi}"))
    stalled = [t for t, log in beats.items() if len(log) >= 2]
    assert {"replay.cnc", "verify.cnc", "dedup.cnc", "pack.cnc",
            "sink.cnc"} == set(stalled)
    for t in stalled:
        log = beats[t]
        assert all(b == a == log[0][1] for b, a in log[1:hi]), t
    if hi == 40:
        resumed = [t for t in stalled if len(beats[t]) > 41]
        assert resumed
        for t in resumed:
            assert beats[t][40][1] != beats[t][0][1], t
    c = res.verify_stats[0]["chaos"]["counters"]
    n = len(stalled)
    assert c == {"hb_stall": {"injected": n, "detected": n, "healed": n}}
    assert Counter(res.sink_digests) == expected_sink_digests(corpus)
    assert pchaos.active() is None


def test_hb_stall_halt_closes_an_open_window():
    inj = pchaos.ChaosInjector(seed=1, schedule="hb_stall@2:9")
    assert [inj.hb_stalled("a") for _ in range(3)] == [False, True, True]
    inj.hb_stall_halt("a")
    inj.hb_stall_halt("b")          # never stalled: books nothing
    assert inj.snapshot()["counters"]["hb_stall"] == {
        "injected": 1, "detected": 1, "healed": 1}


# -- the run ------------------------------------------------------------------


def test_run_soak_compressed(native_engine, tmp_path):
    """tests/test_soak.py:391-420 in the port: a seconds-scale run_soak
    on the CPU comes back judged ok, every phase logged, every unique
    well-formed txn at the sink, the slopes armed and within budget,
    and the record valid for both validators."""
    plan = psoak.build_plan(seed=17, n_phases=2, phase_s=1.5, rate=80.0)
    assert plan.phases[0].chaos is None
    rec, res = psoak.run_soak(plan, device="cpu", verify_batch=32,
                              record_digests=True, sentinel=SENTINEL,
                              options=psoak.SoakOptions(probe_ms=100),
                              chaos=psoak.chaos_spec(plan),
                              workdir=str(tmp_path / "soak"))
    assert rec["ok"], (rec["failures"], rec["slo"]["alerts"])
    assert len(rec["phases"]) == 2
    assert rec["continuity"]["dropped"] == 0
    assert rec["continuity"]["slots_leaked"] == 0
    assert rec["continuity"]["received"] == \
        sum(p.n_unique_ok for p in plan.phases) == len(res.sink_digests)
    assert rec["continuity"]["published"] == rec["continuity"]["offered"]
    assert rec["reconfig"] == {"requested": 0, "applied": 0, "refused": 0,
                               "events": []}
    assert rec["slopes"]["samples"] >= psentinel.MIN_SLOPE_SAMPLES
    assert rec["slopes"]["within_budget"]
    assert rec["backend"] == "gpu" and rec["on_device"]
    assert rec["slopes"]["budgets"]["heap_kb_min"] == 131072
    assert PCHECK.validate_soak(rec) == JCHECK.validate_soak(rec) == []
    assert [p["phase"] for p in rec["phases"]] == \
        [p.name for p in plan.phases]
    assert psentinel._SLOPE_SOURCE is None


def test_fd_soak_main_writes_a_valid_record(native_engine, tmp_path,
                                            capsys):
    out = tmp_path / "rec" / "SOAK_r01.json"
    budgets = [f"--budget={k}={v}"
               for k, v in SENTINEL["budgets"].items()]
    rc = PTOOL.main(["--phases", "2", "--phase-s", "1.0", "--rate", "60",
                     "--seed", "23", "--batch", "32", "--probe-ms", "100",
                     "--digests", "--out", str(out), *budgets],
                    device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rec = json.loads(out.read_text())
    assert rc == 0 and line["ok"] and line["artifact"] == str(out)
    assert PCHECK.validate_soak(rec) == []
    assert rec["seed"] == 23 and len(rec["phases"]) == 2
    assert rec["continuity"]["received"] == \
        rec["continuity"]["expected_sink"]
    assert PTOOL.next_artifact_path(str(out.parent)).endswith(
        "SOAK_r02.json")
    with pytest.raises(KeyError, match="unknown SLO budget"):
        PTOOL.main(["--budget", "FD_SLO_NOPE=1"], device="cpu")
