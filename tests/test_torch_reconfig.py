"""The port's live reconfig against the JAX package's, on the CPU.

Counterparts of ``tests/test_soak.py:296-433``:

* ``soak.ReconfigController``: the request file's mtime fires it (a file
  there at start does not), ``trigger()`` (SIGHUP) fires it, and every
  attempt, a refusal too, is one log entry; ``_read_request`` takes
  only a JSON object.
* ``VerifyTile.request_reconfig`` refuses whole, the running
  configuration untouched: rlc on the "oracle" backend, a tile without
  the feed, a ladder with ``sched=False``, ladders leaving fewer than two
  usable rungs, a decompress flip, unknown keys and values, and a
  second request while one is pending. On a feed run at B = 128
  (``run_feed_pipeline``'s ``tile_hook``): the unusable ladders and the
  race refused, one cold ladder accepted and applied at the inflight
  barrier, the sink the JAX package's ``expected_sink_digests``, no slot
  leaked, and every engine that ran has a service EMA (``note_service``
  on each clean retire).
* Mid-run swaps at B = 32, after the first batch: ``verify_mode`` direct
  to rlc with the drain switched off, and the rlc ``frontend`` fused to
  staged; each run's sink is the JAX ``expected_sink_digests`` on the
  same corpus, batches ran on both sides of the swap, and the old
  primary engine is retired from the registry.
"""

import json
import os
import threading
import time
from collections import Counter

import pytest
import torch

from firedancer_tpu.disco import corpus as jcorpus
from firedancer_tpu_torch.disco import engine as pengine
from firedancer_tpu_torch.disco import pipeline as ppipe
from firedancer_tpu_torch.disco import soak as psoak
from firedancer_tpu_torch.disco import tiles as ptiles
from firedancer_tpu_torch.disco.feed import runtime as pruntime
from firedancer_tpu_torch.tango import rings as prings

torch.set_num_threads(1)

DEPTH = 256


# -- the controller -----------------------------------------------------------


class _FakeTile:
    def __init__(self, accept: bool = True):
        self.accept = accept
        self.requests = []

    def request_reconfig(self, req):
        self.requests.append(req)
        if self.accept:
            return True, "pending (seq 1)"
        return False, "refused (fake)"


def _wait(pred, timeout=5.0):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.02)


def test_reconfig_controller_file_mtime_trigger(tmp_path):
    path = str(tmp_path / "reconfig.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"ladder": [64]}, f)
    tile = _FakeTile()
    ctl = psoak.ReconfigController(path=path, poll_s=0.05)
    ctl.attach(tile)
    ctl.start()
    try:
        time.sleep(0.2)
        assert ctl.log == []  # the file present at start does not fire
        os.utime(path, (time.time() + 5, time.time() + 5))
        _wait(lambda: ctl.log)
    finally:
        ctl.stop()
    assert len(ctl.log) == 1
    assert ctl.log[0]["ok"] and ctl.log[0]["ladder"] == [64]
    assert tile.requests == [{"ladder": [64]}]


def test_reconfig_controller_sighup_trigger_and_refusal_log(tmp_path):
    path = str(tmp_path / "reconfig.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"verify_mode": "rlc", "drain": "off"}, f)
    tile = _FakeTile(accept=False)
    ctl = psoak.ReconfigController(path=path, poll_s=0.05)
    ctl.attach(tile)
    ctl.start()
    try:
        ctl.trigger()  # a SIGHUP handler's whole job
        _wait(lambda: ctl.log)
    finally:
        ctl.stop()
    assert len(ctl.log) == 1
    ent = ctl.log[0]
    assert not ent["ok"] and ent["detail"] == "refused (fake)"
    assert (ent["verify_mode"], ent["drain"]) == ("rlc", "off")
    unattached = psoak.ReconfigController(path=path).apply({"ladder": [8]})
    assert not unattached["ok"] and unattached["detail"] == "no tile attached"


@pytest.mark.parametrize("content,want", [
    (None, {}), ("not json", {}), ("[1, 2]", {}),
    ('{"ladder": [64]}', {"ladder": [64]})])
def test_read_request(tmp_path, content, want):
    path = str(tmp_path / "r.json")
    if content is not None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(content)
    assert psoak._read_request(path) == want
    assert psoak._read_request(None) == {}


# -- refusals on a tile ---------------------------------------------------------


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    """An oracle tile, a feed tile at B = 128 with the scheduler off and
    one with it on (the default ladder: off at this batch); none runs."""
    topo = ppipe.build_topology(
        str(tmp_path_factory.mktemp("refuse") / "r.wksp"), depth=DEPTH)
    w = prings.Workspace.join(topo.wksp_path)

    def tile(**kw):
        return ptiles.VerifyTile(w, "verify.cnc",
                                 ppipe.in_link(w, "replay_verify"),
                                 ppipe.out_link(w, "verify_dedup"),
                                 batch=128, device="cpu", **kw)

    yield {"oracle": tile(backend="oracle"),
           "sched_off": tile(feed=True, sched=False),
           "feed": tile(feed=True)}
    w.leave()


@pytest.mark.parametrize("name,req,reason", [
    ("oracle", {"verify_mode": "rlc"}, "requires backend='gpu'"),
    ("oracle", {"ladder": [64]}, "requires the fd_feed"),
    ("sched_off", {"ladder": [64]}, "sched=False"),
    ("feed", {"ladder": [4096]}, "usable rungs"),
    ("feed", {"ladder": [4]}, "usable rungs"),
    ("feed", {"ladder": "32,abc"}, "unparseable ladder"),
    ("feed", {"decompress": "xla"}, "decompress"),
    ("feed", {"env": {"FD_DRAIN": "off"}}, "unknown reconfig keys"),
    ("feed", {"verify_mode": "fast"}, "unknown verify_mode"),
    ("feed", {"frontend": "xla"}, "unknown frontend"),
    ("feed", {"drain": "on"}, "unknown drain mode"),
])
def test_reconfig_refusals_are_atomic(tiles, name, req, reason):
    v = tiles[name]
    before = (v.verify_mode, v.frontend, v.drain_mode, v.rung_sched,
              v._engine_entry, v.stat_reconfig_refused)
    ok, detail = v.request_reconfig(req)
    assert not ok and reason in detail, detail
    assert v._reconfig_pending is None and v.stat_reconfigs == 0
    assert (v.verify_mode, v.frontend, v.drain_mode, v.rung_sched,
            v._engine_entry) == before[:5]
    assert v.stat_reconfig_refused == before[5] + 1


# -- on a feed run ---------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    """tests/test_soak.py's mix: 72 unique txns with duplicates, corrupt
    signatures and parse errors."""
    return jcorpus.mainnet_corpus(n=72, seed=13, dup_rate=0.08,
                                  corrupt_rate=0.04, parse_err_rate=0.04,
                                  sign_batch_size=128, max_data_sz=140)


def _run(path, corpus, batch, hook, **opts):
    topo = ppipe.build_topology(str(path), depth=DEPTH)
    return pruntime.run_feed_pipeline(
        topo, corpus.payloads, verify_batch=batch, timeout_s=240.0,
        record_digests=True, device="cpu", feed_proc=False,
        verify_opts=opts, tile_hook=hook)


@pytest.fixture(scope="module")
def ladder_run(corpus, tmp_path_factory):
    """B = 128 with the default ladder (the scheduler off): the unusable
    ladders refused, a cold ladder accepted, then the race and a
    decompress flip refused while it is pending."""
    verdicts = {}

    def hook(v):
        verdicts["oversize"] = v.request_reconfig({"ladder": [4096]})
        verdicts["tiny"] = v.request_reconfig({"ladder": [4]})
        verdicts["cold"] = v.request_reconfig({"ladder": [96]})
        verdicts["double"] = v.request_reconfig({"ladder": [64]})
        verdicts["decompress"] = v.request_reconfig({"decompress": "xla"})
        verdicts["tile"] = v

    res = _run(tmp_path_factory.mktemp("ladder") / "l.wksp", corpus, 128,
               hook)
    pengine.registry().stop_prewarm()
    return res, verdicts


def test_reconfig_cold_ladder_unusable_rungs_refused(corpus, ladder_run):
    res, verdicts = ladder_run
    for key in ("oversize", "tiny"):
        ok, detail = verdicts[key]
        assert not ok and "usable rungs" in detail, (key, detail)
    ok, detail = verdicts["cold"]
    assert ok and "pending" in detail
    vs = res.verify_stats[0]
    assert vs["rung_ladder"] == [96, 128]   # the swap in force
    assert vs["slots_leaked"] == 0
    assert len(res.sink_digests) == corpus.n_unique_ok


def test_reconfig_race_refused_and_swap_applied(corpus, ladder_run):
    res, verdicts = ladder_run
    ok, detail = verdicts["double"]
    assert not ok and "already pending" in detail
    ok, detail = verdicts["decompress"]
    assert not ok and "decompress" in detail
    vs = res.verify_stats[0]
    assert vs["reconfigs"] == 1 and vs["reconfig_refused"] == 4
    # Batches dispatched before the barrier ran at the fixed batch.
    assert sum(vs["rung_hist"].values()) <= vs["batches"]
    assert Counter(res.sink_digests) == jcorpus.expected_sink_digests(corpus)


def test_note_service_feeds_the_service_ema(ladder_run):
    """Every engine a batch retired on has a measured service EMA: the
    tile's primary and each rung engine in the histogram."""
    res, verdicts = ladder_run
    v = verdicts["tile"]
    assert v._engine_entry.service_ns > 0
    assert v._engine_entry.service_est_ns() == v._engine_entry.service_ns
    reg = pengine.registry()
    for r in res.verify_stats[0]["rung_hist"]:
        e = reg.warm_entry(pengine.EngineSpec("direct", int(r)), "cpu")
        assert e.dispatches > 0 and e.service_ns > 0, r


@pytest.mark.parametrize("case", ["verify_mode", "frontend"])
def test_reconfig_mid_run_swap_keeps_the_sink(corpus, tmp_path, case):
    """The swap is asked for once the first batch was dispatched; the
    batches before the barrier ran on the old engine, those after on the
    new, and the sink is exact either way."""
    start, req = {
        "verify_mode": ({"verify_mode": "direct"},
                        {"verify_mode": "rlc", "drain": "off"}),
        "frontend": ({"verify_mode": "rlc", "frontend": "fused"},
                     {"frontend": "staged"}),
    }[case]
    got = {}

    def hook(v):
        real = v._apply_reconfig

        def apply_at_barrier():
            got["at"] = (v.stat_batches, v.stat_drain_batches,
                         v._engine_spec)
            real()

        v._apply_reconfig = apply_at_barrier

        def ask():
            deadline = time.time() + 120
            while v.stat_batches < 1 and time.time() < deadline:
                time.sleep(0.002)
            got["verdict"] = v.request_reconfig(req)

        threading.Thread(target=ask, daemon=True).start()
        got["tile"] = v

    res = _run(tmp_path / "m.wksp", corpus, 32, hook, inflight=1, **start)
    pengine.registry().stop_prewarm()
    assert got["verdict"][0], got["verdict"]
    vs, v = res.verify_stats[0], got["tile"]
    assert Counter(res.sink_digests) == jcorpus.expected_sink_digests(corpus)
    assert vs["reconfigs"] == 1 and vs["slots_leaked"] == 0
    batches_at, drained_at, old = got["at"]
    assert 1 <= batches_at < vs["batches"]
    want = {"verify_mode": ("rlc", "fused"),
            "frontend": ("rlc", "staged")}[case]
    assert (vs["mode"], v.frontend) == want
    assert v._engine_spec == pengine.EngineSpec("rlc", 32, "u7", want[1])
    keys = {(s["key"], s["device"]) for s in pengine.registry().snapshot()}
    assert (old.key, "cpu") not in keys      # the old primary retired
    if case == "verify_mode":
        # The drain ran before the swap and not after it.
        assert vs["drain_batches"] == drained_at == batches_at
        assert res.dedup_stats["false_novel"] == 0
    else:
        assert vs["drain_batches"] == vs["batches"]
