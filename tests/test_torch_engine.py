"""The port's engine ladder against the JAX package's, on the CPU.

Counterparts of ``tests/test_engine.py:176-433``:

* The registry: the prewarm policies (an unknown one raises; "off" and
  "sync" start no thread), the background thread draining its queue to
  idle and starting afresh after ``stop_prewarm``, a failed warm left
  FAILED with its error while the queue goes on, ``entry`` /
  ``warm_entry`` / ``entry_count`` / ``retire`` (a queued warm of a
  retired spec dropped), the per-batch-size MSM pins ``for_tile`` reads,
  ``with_batch`` / ``with_msm`` and ``service_est_ns``.
* ``rung_ladder``: the default, cap and floor, dedup and sort, its
  ValueErrors; the same lists and errors as the JAX ``rung_ladder``
  (which reads FD_ENGINE_LADDER) on the same strings.
* ``RungScheduler``: the constructor's checks, monotone rung-up in
  depth, the slack cap (cost 0 never caps), the saturation bypass,
  covering dispatch, never past the deadline, the starved early-out and
  switch tracking; and ``decide()`` equal to the JAX scheduler's, given
  one cost function, on seeded random sequences.
* ``tiles.tile_rungs``: the default ladder leaves the scheduler off at a
  batch of 8,192 and below.
* ``run_pipeline`` through the feed at B = 128 on a JAX ``mainnet_corpus``:
  ladder ``32,64,128`` with the scheduler on and off, and the default
  ladder (off at that batch), each deliver the JAX package's
  ``expected_sink_digests``; the scheduled run books every batch in
  ``rung_hist`` and warms its rungs.
"""

import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from firedancer_tpu.disco import corpus as jcorpus
from firedancer_tpu.disco import engine as jengine
from firedancer_tpu_torch.disco import engine as pengine
from firedancer_tpu_torch.disco import pipeline as ppipe
from firedancer_tpu_torch.disco import tiles as ptiles
from firedancer_tpu_torch.disco.engine import (
    ENGINE_COLD,
    ENGINE_FAILED,
    ENGINE_WARM,
    EngineRegistry,
    EngineSpec,
    RungScheduler,
)
from firedancer_tpu_torch.disco.feed.policy import (
    FLUSH_DEADLINE,
    FLUSH_FULL,
    FLUSH_STARVED,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture
def fake_warm(monkeypatch):
    """EngineEntry.warm without the zero batch: WARM at once (or raising
    for batch 13), recording the thread each warm ran on."""
    threads = []

    def warm(self, max_msg_len=1232):
        threads.append(threading.current_thread().name)
        if self.spec.batch == 13:
            self.state, self.err = ENGINE_FAILED, "RuntimeError('boom')"
            raise RuntimeError("boom")
        self.state = ENGINE_WARM
        return True

    monkeypatch.setattr(pengine.EngineEntry, "warm", warm)
    return threads


def _wait_idle(reg, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not reg.prewarm_idle():
        assert time.monotonic() < deadline, "prewarm never drained"
        time.sleep(0.01)


# -- registry -------------------------------------------------------------------


def test_registry_prewarm_policy_validates(fake_warm):
    reg = EngineRegistry()
    with pytest.raises(ValueError, match="prewarm policy"):
        reg.prewarm_ladder([EngineSpec("direct", 128)], device="cpu",
                           policy="bogus")
    reg.prewarm_ladder([EngineSpec("direct", 128)], device="cpu",
                       policy="off")
    assert reg.entry_count() == 0 and reg.prewarm_idle()
    reg.prewarm_ladder([EngineSpec("direct", 128)], device="cpu",
                       policy="sync")
    assert fake_warm == [threading.current_thread().name]
    assert reg.warm_entry(EngineSpec("direct", 128), "cpu") is not None
    assert reg.prewarm_idle() and reg._prewarm_thread is None


def test_registry_prewarm_background_drains_and_restarts(fake_warm):
    """The thread drains the queue to idle, stop_prewarm joins it, and a
    later prewarm_ladder starts a fresh one; a failed warm is recorded on
    its entry and the queue goes on."""
    reg = EngineRegistry()
    for round_ in range(2):
        specs = [EngineSpec("direct", 13), EngineSpec("direct", 32 + round_)]
        reg.prewarm_ladder(specs, device="cpu")
        _wait_idle(reg)
        reg.stop_prewarm()
        assert reg.prewarm_idle()
        assert reg.warm_entry(specs[1], "cpu").state == ENGINE_WARM
        bad = reg.entry(specs[0], "cpu")
        assert bad.state == ENGINE_FAILED and "boom" in bad.err
        assert reg.warm_entry(specs[0], "cpu") is None
    assert fake_warm == ["fd_engine.prewarm"] * 4


def test_registry_entry_warm_entry_count_and_retire(fake_warm):
    reg = EngineRegistry()
    spec = EngineSpec("direct", 64)
    e = reg.entry(spec, "cpu")
    assert e.state == ENGINE_COLD and reg.entry(spec, "cpu") is e
    assert reg.warm_entry(spec, "cpu") is None
    assert reg.acquire(spec, device="cpu") == (e, True)
    assert reg.warm_entry(spec, "cpu") is e and e.device == CPU
    other = EngineSpec("rlc", 64)
    reg.entry(other, "cpu")
    assert reg.entry_count() == 2
    # A queued warm of a retired spec is dropped with it: nothing
    # re-creates the entry.
    reg._prewarm_q.append((other, CPU, 1232))
    assert reg.retire([spec, other, EngineSpec("rlc", 8)], "cpu") == 2
    assert reg.entry_count() == 0 and not reg._prewarm_q
    assert reg.snapshot() == []
    with pytest.raises(ValueError, match="verify mode"):
        reg.entry(EngineSpec("cpu", 64), "cpu")


def test_rung_plan_pins_and_for_tile():
    reg = pengine.registry()
    try:
        assert reg.rung_plan(4096) == pengine.DEFAULT_MSM
        reg.set_rung_plan(4096, "s8l3")
        assert EngineSpec.for_tile("gpu", "rlc", 4096).msm == "s8l3"
        assert EngineSpec.for_tile("gpu", "direct", 4096).msm == "u7"
        assert EngineSpec.for_tile("oracle", "direct", 4096).mode == "oracle"
        with pytest.raises(ValueError):
            reg.set_rung_plan(4096, "s8")   # signed without the lazy fill
        assert reg.rung_plan(4096) == "s8l3"
    finally:
        reg.set_rung_plan(4096, "auto")
    assert EngineSpec.for_tile("gpu", "rlc", 4096, "staged") == EngineSpec(
        "rlc", 4096, "u7", "staged")


def test_spec_with_batch_msm_and_service_estimate():
    spec = EngineSpec("rlc", 32768, "u7", "staged")
    assert spec.with_batch(8192).key == "rlc:B8192:festaged:u7"
    assert spec.with_msm("u8").key == "rlc:B32768:festaged:u8"
    e = pengine.EngineEntry(EngineSpec("direct", 32), CPU)
    assert e.service_est_ns() == 0
    e.note_service(800)
    e.note_service(1600)
    assert e.service_ns == e.service_est_ns() == 900


# -- ladder ---------------------------------------------------------------------


@pytest.mark.parametrize("ladder,cap,floor,want", [
    (pengine.DEFAULT_LADDER, None, 0, [8192, 16384, 32768]),
    (pengine.DEFAULT_LADDER, 16384, 0, [8192, 16384]),
    (pengine.DEFAULT_LADDER, 128, 19, []),
    ("64, 32,128,64", None, 0, [32, 64, 128]),
    ([64, "32", 128, 64], None, 0, [32, 64, 128]),
    (" , 4,", None, 19, []),
])
def test_rung_ladder_default_and_filters(ladder, cap, floor, want):
    assert pengine.rung_ladder(ladder, cap=cap, floor=floor) == want


@pytest.mark.parametrize("bad", ["32,abc", "0,32", "-8", "8.5", [32, 0]])
def test_rung_ladder_refuses_malformed(bad):
    with pytest.raises(ValueError):
        pengine.rung_ladder(bad)


@pytest.mark.parametrize("raw", [
    "8192,16384,32768", "64, 32,128,64", "32,64,128", ",,5, 19 ,",
    "32,abc", "0,32", "-8", "8.5", "1,x,2", "19"])
@pytest.mark.parametrize("cap,floor", [(None, 0), (128, 19), (16384, 0)])
def test_rung_ladder_equals_jax(raw, cap, floor, monkeypatch):
    monkeypatch.setenv("FD_ENGINE_LADDER", raw)

    def run(fn):
        try:
            return fn()
        except ValueError:
            return ValueError

    want = run(lambda: jengine.rung_ladder(cap=cap, floor=floor))
    assert run(lambda: pengine.rung_ladder(raw, cap=cap, floor=floor)) \
        == want


@pytest.mark.parametrize("batch,ladder,want", [
    (8192, pengine.DEFAULT_LADDER, []),
    (128, pengine.DEFAULT_LADDER, []),
    (32768, pengine.DEFAULT_LADDER, [8192, 16384, 32768]),
    (16384, pengine.DEFAULT_LADDER, [8192, 16384]),
    (20000, pengine.DEFAULT_LADDER, [8192, 16384, 20000]),
    (128, "32,64,128", [32, 64, 128]),
    (128, "4,64", [64, 128]),
    (128, "4,4096", []),
])
def test_tile_rungs(batch, ladder, want):
    assert ptiles.tile_rungs(ladder, batch) == want


# -- scheduler ------------------------------------------------------------------

LADDER = (8192, 16384, 32768)
DEADLINE = 25_000_000
COST = {8192: 5_000_000, 16384: 10_000_000, 32768: 40_000_000}


@pytest.mark.parametrize("rungs,deadline", [([], DEADLINE),
                                            ([0, 8192], DEADLINE),
                                            (LADDER, 0)])
def test_scheduler_ctor_validates(rungs, deadline):
    with pytest.raises(ValueError):
        RungScheduler(rungs, deadline)


def test_scheduler_monotone_rung_up_in_depth():
    s = RungScheduler(LADDER, DEADLINE, cost_ns=lambda r: COST[r])
    rng = np.random.RandomState(0xE1)
    for slack in (None, DEADLINE, DEADLINE // 4, 0):
        prev = 0
        for depth in sorted(int(rng.randint(0, 200_000))
                            for _ in range(200)):
            rung = s.pick_rung(depth, slack_ns=slack)
            assert rung >= prev, (depth, slack)
            prev = rung
        assert s.pick_rung(0, slack_ns=slack) == LADDER[0]
    assert s.pick_rung(10**9) == LADDER[-1]


def test_scheduler_slack_caps_rung():
    s = RungScheduler(LADDER, DEADLINE, cost_ns=lambda r: COST[r])
    deep = 10**6
    assert s.pick_rung(deep, slack_ns=DEADLINE) == 16384   # 40 ms > 25
    assert s.pick_rung(deep, slack_ns=7_000_000) == 8192
    assert s.pick_rung(deep, slack_ns=None) == 32768
    assert s.pick_rung(deep, slack_ns=0) == 8192
    s0 = RungScheduler(LADDER, DEADLINE, cost_ns=lambda r: 0)
    assert s0.pick_rung(deep, slack_ns=1) == 32768


def test_scheduler_saturation_bypass_lifts_slack_cap():
    s = RungScheduler(LADDER, DEADLINE, cost_ns=lambda r: COST[r])
    assert s.pick(1_000_000, 2000, 500_000, 3000, backlog_full=True) == 32768
    assert s.pick(1_000_000, 2000, 500_000, 3000) == 8192
    # A backlog of a top rung is saturation too.
    assert s.pick(1_000_000, 2000, 500_000, 32768) == 32768


@pytest.mark.parametrize("lanes,want", [(0, 8192), (8192, 8192),
                                        (8193, 16384), (40_000, 32768)])
def test_scheduler_dispatch_rung_covers_lanes(lanes, want):
    assert RungScheduler(LADDER, DEADLINE).dispatch_rung(lanes) == want


def test_scheduler_never_starves_past_deadline():
    rng = np.random.RandomState(0x5EED)
    for trial in range(50):
        deadline = int(rng.randint(1_000, 50_000_000))
        s = RungScheduler(LADDER, deadline)
        first = int(rng.randint(0, 1 << 40))
        lanes = int(rng.randint(1, 32_768))
        for _ in range(int(rng.randint(0, 8))):
            t = first + int(rng.randint(0, deadline))
            s.decide(t, min(lanes, 8191), first,
                     int(rng.randint(0, 100_000)),
                     starved=bool(rng.randint(2)),
                     device_idle=bool(rng.randint(2)),
                     backpressured=bool(rng.randint(2)))
        late = first + deadline + int(rng.randint(0, 1 << 30))
        verdict, rung = s.decide(
            late, lanes, first, int(rng.randint(0, 100_000)),
            starved=bool(rng.randint(2)), device_idle=bool(rng.randint(2)),
            backpressured=bool(rng.randint(2)))
        assert rung in LADDER
        assert verdict in (FLUSH_DEADLINE, FLUSH_FULL), trial
        if verdict == FLUSH_DEADLINE:
            verdict2, _ = s.decide(first + 1, min(lanes, 8191), first, 0)
            assert verdict2 in (FLUSH_DEADLINE, FLUSH_FULL)


def test_scheduler_starved_early_out_and_switch_tracking():
    s = RungScheduler(LADDER, DEADLINE)
    v, rung = s.decide(1_000_000 + s.flush.starve_ns, 100, 1_000_000, 0,
                       starved=True, device_idle=True)
    assert rung == 8192 and v == FLUSH_STARVED
    switches0 = s.switches
    v, rung = s.decide(2_000_000, 100, 1_000_000, 200_000)
    assert rung == 32768 and s.switches == switches0 + 1
    v, rung = s.decide(2_100_000, 100, 1_000_000, 200_000)
    assert rung == 32768 and s.switches == switches0 + 1


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("costs", ["none", "fixed", "zero_top"])
def test_scheduler_decisions_equal_jax(seed, costs):
    """100 decisions a case, 1,200 in all: the same clock, lanes, anchor,
    backlog and flags through the port's and the JAX scheduler, one cost
    function; every (verdict, rung), the switch count and the last
    inputs equal."""
    rng = np.random.RandomState(1000 + seed)
    cost = {"none": None, "fixed": lambda r: COST[r],
            "zero_top": lambda r: 0 if r == 32768 else COST[r]}[costs]
    deadline = int(rng.randint(1_000_000, 60_000_000))
    ps = RungScheduler(LADDER, deadline, cost_ns=cost)
    js = jengine.RungScheduler(LADDER, deadline, cost_ns=cost)
    now = int(rng.randint(0, 1 << 40))
    first, lanes = 0, 0
    for _ in range(100):
        now += int(rng.randint(-200_000, 8_000_000))  # stutters backward too
        if lanes == 0 or rng.randint(6) == 0:
            first, lanes = (now, 0) if rng.randint(2) else (0, 0)
        lanes = min(40_000, lanes + int(rng.randint(0, 9000)))
        backlog = int(rng.choice([0, rng.randint(0, 5000),
                                  rng.randint(0, 70_000)]))
        flags = dict(starved=bool(rng.randint(2)),
                     device_idle=bool(rng.randint(2)),
                     backpressured=bool(rng.randint(2)),
                     backlog_full=bool(rng.randint(4) == 0))
        got = ps.decide(now, lanes, first, backlog, **flags)
        want = js.decide(now, lanes, first, backlog, **flags)
        assert got == want
        assert (ps.switches, ps.cur, ps.last_inputs) == \
            (js.switches, js.cur, js.last_inputs)
    assert ps.decisions == js.decisions == 100


# -- the feed pipeline ----------------------------------------------------------

B = 128


@pytest.fixture(scope="module")
def corpus():
    """tests/test_engine.py's mix: duplicates, corrupt signatures and
    parse errors among 96 unique txns."""
    return jcorpus.mainnet_corpus(n=96, seed=5, dup_rate=0.1,
                                  corrupt_rate=0.06, parse_err_rate=0.04,
                                  sign_batch_size=128, max_data_sz=140)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    d = tmp_path_factory.mktemp("ladder")
    out = {}
    for name, opts in (("sched", {"ladder": "32,64,128"}),
                       ("fixed", {"ladder": "32,64,128", "sched": False}),
                       ("inert", {})):
        topo = ppipe.build_topology(str(d / f"{name}.wksp"), depth=256)
        out[name] = ppipe.run_pipeline(
            topo, corpus.payloads, verify_batch=B, record_digests=True,
            device="cpu", timeout_s=240.0, feed_proc=False,
            verify_opts=opts)
    pengine.registry().stop_prewarm()
    return out


@pytest.mark.parametrize("name", ["sched", "fixed", "inert"])
def test_rung_scheduler_sink_digests_bit_exact(corpus, runs, name):
    """Whatever rungs the scheduler takes, the sink gets exactly the
    fixed batch's content: the JAX expected_sink_digests."""
    res = runs[name]
    assert res.feed
    assert Counter(res.sink_digests) == jcorpus.expected_sink_digests(corpus)
    vs = res.verify_stats[0]
    assert vs["slots_leaked"] == 0 and vs["reconfigs"] == 0
    if name == "sched":
        assert vs["rung_ladder"] == [32, 64, 128]
        assert sum(vs["rung_hist"].values()) == vs["batches"]
        assert set(vs["rung_hist"]) <= {"32", "64", "128"}
        assert vs["rung_cur"] in (32, 64, 128)
        assert vs["rung_switches"] >= 1
    else:
        # The scheduler off (sched=False, or the default ladder at
        # B = 128): the fixed batch, one shape of record.
        assert vs["rung_hist"] == {} and vs["rung_ladder"] == []
        assert vs["rung_switches"] == 0 and vs["rung_cur"] == 0


def test_rung_engines_warmed_and_dispatched(runs):
    """The scheduled run's rung engines were warmed in the background
    and each batch ran on the engine of its rung: the rung entries'
    dispatches cover the histogram's rungs below the batch."""
    hist = runs["sched"].verify_stats[0]["rung_hist"]
    reg = pengine.registry()
    for r in (32, 64, 128):
        e = reg.warm_entry(EngineSpec("direct", r), "cpu")
        assert e is not None and e.warm_s > 0
    for r, n in hist.items():
        e = reg.warm_entry(EngineSpec("direct", int(r)), "cpu")
        assert e.dispatches >= n and e.service_ns > 0
