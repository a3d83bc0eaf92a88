"""The port's healing lane against the JAX package's, on the CPU.

* ``disco.chaos``: ``parse_schedule`` gives the JAX results and errors
  (``tests/test_chaos.py:34-56``); the injector fires at the same
  ordinals, draws the same ``Rng`` choices (the junk frag, the corrupted
  byte) and heals its window classes on close; a schedule naming a class
  whose site the port lacks (the supervisor's worker_kill) raises; each
  quic_* class fires on a run_quic_pipeline run and books nothing on a
  run without a QUIC tile, as in the JAX package.
* ``feed.policy``: ``CircuitBreaker`` goes through the JAX state sequence
  on the same events (``tests/test_chaos.py:95-157``);
  ``respawn_backoff_s`` equals the JAX one on the same ``Rng`` seed.
* ``ballet.ed25519.native``: the port's binding gives the JAX binding's
  statuses on the 396 Zcash vectors and the RFC 8032 vectors, and the
  oracle's (every RFC vector, every 11th Zcash one: the oracle takes
  about 0.13 s a verify here); a library without the verifier raises
  with its path.
* Pipeline runs on ``device="cpu"`` over ``tests/test_chaos.py``'s
  corpus shapes, each on a fresh workspace: the seven-class schedule
  (its sink, corrupted txn and per-class counters against the JAX feed
  runner's on the same corpus, seed and schedule), the breaker tripping
  and closing under ``device_lost``, two quarantined batches whose
  offenders go out as CTL_ERR frags that the dedup tile filters, and a
  clean run with every healing counter at 0. In these runs the engines'
  verify is the native verifier (``_native_engine``): the plain PyTorch
  versions take about 2 s a 128-lane batch on one core, and they are
  held to the JAX package in ``tests/test_torch_verify.py``; what is
  tested here is the healing around the engine.
* The step loop's quarantine, and the CPU lane's oracle ladder.
"""

import logging
import os
from collections import Counter

import numpy as np
import pytest
import torch

from firedancer_tpu.ballet.ed25519 import native as jnative
from firedancer_tpu.disco import chaos as jchaos
from firedancer_tpu.disco import pipeline as jpipe
from firedancer_tpu.disco.corpus import BAD_SIG, expected_sink_digests
from firedancer_tpu.disco.corpus import mainnet_corpus as jmainnet_corpus
from firedancer_tpu.disco.feed import policy as jpolicy
from firedancer_tpu.utils.rng import Rng as JRng
from firedancer_tpu_torch.ballet.ed25519 import native as pnative
from firedancer_tpu_torch.ballet.ed25519 import oracle as poracle
from firedancer_tpu_torch.disco import chaos as pchaos
from firedancer_tpu_torch.disco import engine as pengine
from firedancer_tpu_torch.disco import pipeline as ppipe
from firedancer_tpu_torch.disco import tiles as ptiles
from firedancer_tpu_torch.disco.feed import policy as ppolicy
from firedancer_tpu_torch.disco.feed import runtime as pruntime
from firedancer_tpu_torch.tango import rings as prings
from firedancer_tpu_torch.utils.rng import Rng as PRng
from tests.test_oracle import RFC8032_VECTORS, _msg_bytes

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# tests/test_chaos.py:272-278, the seven classes' schedule.
SCHEDULE_7 = (
    "ring_ctl_err@5,ring_ctl_err@40,ring_overrun@6,credit_starve@50:80,"
    "stager_kill@4,slot_corrupt@3,backend_raise@2,device_lost@1:3")
CLASSES_7 = ("ring_ctl_err", "ring_overrun", "credit_starve", "stager_kill",
             "slot_corrupt", "backend_raise", "device_lost")
HEALING = ("stager_restarts", "cpu_failover", "quarantined",
           "quarantine_err_txn", "ctl_err_drop", "breaker_trips",
           "breaker_reprobes", "slots_leaked")


# -- schedule and injector ----------------------------------------------------


def _parse(mod, spec):
    try:
        return mod.parse_schedule(spec)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", [
    "ring_ctl_err@5,ring_ctl_err@40,device_lost@3:9, stager_kill@2 ,",
    SCHEDULE_7,
    "hb_stall@2:4,worker_kill@3,quic_slowloris@1:2",
    "nonsense@3",
    "stager_kill",
    "stager_kill@2:5",
    "device_lost@x:y",
    "device_lost@0:4",
    "device_lost@9:3",
])
def test_parse_schedule_matches_jax(spec):
    got = _parse(pchaos, spec)
    assert got == _parse(jchaos, spec)
    if spec.startswith("ring_ctl_err@5,ring_ctl_err@40,device"):
        assert got == {"ring_ctl_err": [(5, 5), (40, 40)],
                       "device_lost": [(3, 9)], "stager_kill": [(2, 2)]}
    assert pchaos.FAULT_CLASSES == jchaos.FAULT_CLASSES


@pytest.mark.parametrize("spec", ["worker_kill@2",
                                  "quic_malformed@1,worker_kill@1"])
def test_unported_classes_raise_at_run_start(spec, tmp_path):
    with pytest.raises(ValueError, match="ROADMAP queue 1 item 9"):
        pchaos.ChaosInjector(seed=1, schedule=spec)
    topo = ppipe.build_topology(str(tmp_path / "u.wksp"), depth=64)
    with pytest.raises(ValueError, match="no hook site in the port"):
        ppipe.run_pipeline(topo, [b"x"], verify_batch=32, device="cpu",
                           chaos=(1, spec))
    assert pchaos.active() is None


@pytest.mark.parametrize("spec,classes", [
    ("quic_conn_churn@1", ("quic_conn_churn",)),
    ("quic_malformed@1", ("quic_malformed",)),
    ("stager_kill@1,quic_slowloris@1:3", ("stager_kill", "quic_slowloris")),
])
def test_quic_classes_fire_on_a_quic_run(native_engine, spec, classes,
                                         tmp_path):
    """The injector takes each quic_* class, and a run_quic_pipeline run
    fires it in the QUIC tile: injected == detected == healed, the sink
    whole."""
    inj = pchaos.ChaosInjector(seed=1, schedule=spec)
    assert set(inj.counters) == set(classes)
    from firedancer_tpu_torch.tango.quic import client as pclient

    corpus = _corpus(n=40, seed=43)
    payloads = list(corpus.payloads)
    topo = ppipe.build_topology(str(tmp_path / "q.wksp"), depth=256,
                                wksp_sz=1 << 25)
    res = ppipe.run_quic_pipeline(
        topo, lambda a: pclient.deliver(a, [payloads], deadline_s=20.0),
        len(payloads), record_digests=True, device="cpu", feed_proc=False,
        timeout_s=60.0, chaos=(1, spec), quic={"hs_timeout_s": 0.3})
    vs = res.verify_stats[0]
    _assert_parity(vs, classes)
    assert Counter(res.sink_digests) == expected_sink_digests(corpus)
    assert pchaos.active() is None


def test_quic_schedule_without_a_quic_tile_books_nothing(native_engine,
                                                         tmp_path,
                                                         monkeypatch):
    """A quic_* schedule on the replay pipeline ticks no site: the class
    books 0 on each counter and the run is clean, as the JAX package's
    run_pipeline does with the same schedule."""
    corpus = _corpus(n=60, seed=47)
    spec = "quic_malformed@1,quic_slowloris@2:4"
    topo = ppipe.build_topology(str(tmp_path / "r.wksp"), depth=256,
                                wksp_sz=1 << 25)
    res = ppipe.run_pipeline(topo, corpus.payloads, record_digests=True,
                             device="cpu", feed_proc=False, timeout_s=60.0,
                             chaos=(1, spec))
    snap = res.verify_stats[0]["chaos"]
    zero = {"injected": 0, "detected": 0, "healed": 0}
    assert snap["counters"] == {"quic_malformed": zero,
                                "quic_slowloris": zero}
    assert Counter(res.sink_digests) == expected_sink_digests(corpus)
    for k, v in (("FD_CHAOS", "1"), ("FD_CHAOS_SEED", "1"),
                 ("FD_CHAOS_SCHEDULE", spec)):
        monkeypatch.setenv(k, v)
    jtopo = jpipe.build_topology(str(tmp_path / "j.wksp"), depth=256)
    jres = jpipe.run_pipeline(jtopo, corpus.payloads, verify_backend="cpu",
                              timeout_s=60.0, record_digests=True,
                              feed=False)
    assert jchaos.active().snapshot()["counters"] == snap["counters"]
    assert Counter(jres.sink_digests) == Counter(res.sink_digests)


def test_injector_counters_only_for_scheduled_classes():
    snaps = []
    for mod in (pchaos, jchaos):
        inj = mod.ChaosInjector(seed=1, schedule="stager_kill@1")
        inj.note("ring_ctl_err", "detected")      # unscheduled: ignored
        inj.note("stager_kill", "detected")
        snaps.append(inj.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["counters"] == {
        "stager_kill": {"injected": 0, "detected": 1, "healed": 0}}


def _hook_trace(mod, schedule, calls):
    """Each call's outcome (the return value or the raised class) and
    the snapshot after them."""
    inj = mod.ChaosInjector(seed=3, schedule=schedule)
    out = []
    for name in calls:
        try:
            out.append(getattr(inj, name)())
        except mod.ChaosFault as e:
            out.append(e.cls)
    return out, inj.snapshot()


@pytest.mark.parametrize("schedule,calls", [
    ("stager_kill@3,backend_raise@2",
     ["stager_round_hook"] * 4 + ["verify_complete_hook"] * 3),
    ("device_lost@2:3", ["verify_dispatch_hook"] * 5),
    ("credit_starve@2:3", ["source_starved"] * 5),
    ("credit_starve@2:3,credit_starve@6:6", ["source_starved"] * 8),
])
def test_injector_hooks_fire_at_the_jax_ordinals(schedule, calls):
    got = _hook_trace(pchaos, schedule, calls)
    assert got == _hook_trace(jchaos, schedule, calls)
    counters = got[1]["counters"]
    for c in counters.values():
        assert c["injected"] >= 1
    if schedule.startswith("credit"):
        # The window heals when it closes.
        assert all(c["injected"] == c["detected"] == c["healed"]
                   for c in counters.values())


class _Link:
    """An out-link that records what the injector publishes."""

    def __init__(self, credits):
        self.credits = credits
        self.frags = []

    def can_publish(self):
        return self.credits > 0

    def publish(self, payload, sig, ctl):
        self.credits -= 1
        self.frags.append((payload, sig, ctl))


def test_source_inject_matches_jax_and_waits_for_a_credit():
    outs = []
    for mod in (pchaos, jchaos):
        inj = mod.ChaosInjector(seed=42, schedule="ring_ctl_err@2,"
                                "ring_ctl_err@4")
        link = _Link(credits=0)
        inj.source_inject(link, 2)          # no credit: deferred
        link.credits = 5
        for ordn in (1, 2, 2, 3, 4):
            inj.source_inject(link, ordn)
        outs.append((link.frags, inj.snapshot()))
    assert outs[0] == outs[1]
    frags = outs[0][0]
    assert len(frags) == 2 and all(ctl == prings.CTL_ERR
                                   for _, _, ctl in frags)


class _Slot:
    """A staged slot's arrays, as feed.slots.Slot holds them."""

    def __init__(self, rng):
        n = 12
        self.msgs = rng.randint(0, 256, (2 * n, 64)).astype(np.uint8)
        self.lens = rng.randint(1, 64, 2 * n).astype(np.int32)
        self.tlanes = np.array([1, 2] * (n // 2), np.uint32)
        self.ha_mask = np.zeros(n, np.bool_)
        self.ha_mask[[1, 4]] = True
        self.psigs = rng.randint(0, 1 << 62, n).astype(np.uint64)
        self.plens = np.full(n, 10, np.uint32)
        self.offs = (np.arange(n) * 10).astype(np.uint32)
        self.pay = rng.randint(0, 256, n * 10).astype(np.uint8)


def test_post_stage_hook_corrupts_the_jax_byte():
    """The Nth non-duplicate staged txn, the same byte and flip in both
    packages, over two rounds; on_sv_drop books it once."""
    slots = []
    for mod in (pchaos, jchaos):
        slot = _Slot(np.random.RandomState(9))
        inj = mod.ChaosInjector(seed=42, schedule="slot_corrupt@3,"
                                "slot_corrupt@7")
        inj.post_stage_hook(slot, 0, 5, lane0=0)
        inj.post_stage_hook(slot, 5, 7, lane0=int(slot.tlanes[:5].sum()))
        inj.on_sv_drop(slot.psigs[[0, 3, 8]])
        slots.append((slot.msgs.copy(), inj.snapshot()))
    assert np.array_equal(slots[0][0], slots[1][0])
    assert slots[0][1] == slots[1][1]
    ref = _Slot(np.random.RandomState(9))
    assert (slots[0][0] != ref.msgs).sum() == 2
    assert len(slots[0][1]["corrupted_sha256"]) == 2


class _InLink:
    def __init__(self, seq, depth):
        self.seq = seq
        self.mcache = type("M", (), {"depth": depth})()


def test_ctl_err_read_again_books_once():
    """A CTL_ERR frag dropped twice (read again after an overrun's
    rewind) books one detection in the port; the JAX injector books
    both, which breaks its own parity (ROADMAP queue 3)."""
    got = {}
    for name, mod in (("port", pchaos), ("jax", jchaos)):
        inj = mod.ChaosInjector(seed=42, schedule="ring_ctl_err@1")
        inj.source_inject(_Link(credits=1), 1)
        inj.on_ctl_err_drop(1)
        inj.on_ctl_err_drop(1)          # the same frag, read again
        got[name] = inj.snapshot()["counters"]["ring_ctl_err"]
    assert got["port"] == {"injected": 1, "detected": 1, "healed": 1}
    assert got["jax"] == {"injected": 1, "detected": 2, "healed": 2}


def test_overrun_rewind_waits_for_stale_lines():
    got = []
    for mod in (pchaos, jchaos):
        inj = mod.ChaosInjector(seed=0, schedule="ring_overrun@2")
        link = _InLink(seq=10, depth=64)
        seqs = []
        for seq in (10, 30, 60, 70, 90):
            link.seq = seq
            inj.overrun_rewind(link)
            seqs.append(link.seq)
        inj.on_overrun_observed()
        inj.on_overrun_observed()   # organic: nothing pending
        got.append((seqs, inj.snapshot()))
    assert got[0] == got[1]
    assert got[0][0] == [10, 30, 60, 70 - 65, 90]
    assert got[0][1]["counters"]["ring_overrun"] == {
        "injected": 1, "detected": 1, "healed": 1}


def test_armed_installs_and_uninstalls_on_a_raise():
    inj = pchaos.ChaosInjector(seed=1, schedule="stager_kill@1")
    with pytest.raises(RuntimeError):
        with pchaos.armed(inj) as got:
            assert got is inj and pchaos.active() is inj
            raise RuntimeError("the run failed")
    assert pchaos.active() is None
    with pchaos.armed((5, "device_lost@1:2")) as fresh:
        assert fresh.seed == 5 and fresh.schedule == {"device_lost": [(1, 2)]}
    with pchaos.armed(None) as none:
        assert none is None


# -- breaker and backoff ------------------------------------------------------


def _breaker_trace(mod, threshold, cooldown, events):
    """The state after each event: ("a", t) allow_device, ("e", t)
    record_error, ("s",) record_success."""
    b = mod.CircuitBreaker(threshold=threshold, cooldown_ns=cooldown)
    out = []
    for ev in events:
        if ev[0] == "a":
            r = b.allow_device(ev[1])
        elif ev[0] == "e":
            r = b.record_error(ev[1])
        else:
            r = b.record_success()
        out.append((r, b.state, b.trips, b.reprobes, b.errors))
    return out


# The JAX tests' sequences (tests/test_chaos.py:95-149).
BREAKER_CASES = {
    "consecutive": (3, 1_000, [("a", 0), ("e", 0), ("e", 0), ("s",),
                               ("e", 0), ("e", 0), ("e", 0), ("a", 0),
                               ("a", 999)]),
    "probe_closes": (1, 1_000, [("e", 0), ("a", 1_000), ("s",)]),
    "decaying": (1, 1_000, [("e", 0), ("a", 1_000), ("e", 1_000),
                            ("a", 2_999), ("a", 3_000), ("e", 3_000),
                            ("a", 6_999), ("a", 7_000), ("s",),
                            ("e", 10_000), ("a", 11_000)]),
    "stragglers": (1, 1_000_000, [("e", 0), ("s",), ("e", 1)]),
}


@pytest.mark.parametrize("case", sorted(BREAKER_CASES))
def test_breaker_state_sequence_matches_jax(case):
    threshold, cooldown, events = BREAKER_CASES[case]
    got = _breaker_trace(ppolicy, threshold, cooldown, events)
    assert got == _breaker_trace(jpolicy, threshold, cooldown, events)
    assert (ppolicy.BREAKER_CLOSED, ppolicy.BREAKER_OPEN,
            ppolicy.BREAKER_HALF_OPEN) == (jpolicy.BREAKER_CLOSED,
                                           jpolicy.BREAKER_OPEN,
                                           jpolicy.BREAKER_HALF_OPEN)


@pytest.mark.parametrize("threshold,cooldown", [(0, 1), (1, 0)])
def test_breaker_rejects_bad_config(threshold, cooldown):
    with pytest.raises(ValueError):
        ppolicy.CircuitBreaker(threshold=threshold, cooldown_ns=cooldown)


@pytest.mark.parametrize("base,cap", [(0.0, 5.0), (0.2, 5.0), (0.01, 2.0)])
def test_respawn_backoff_matches_jax(base, cap):
    prng, jrng = PRng(seq=99), JRng(seq=99)
    got = [ppolicy.respawn_backoff_s(r, base, cap, prng)
           for r in (1, 2, 3, 4, 5, 8, 40)]
    assert got == [jpolicy.respawn_backoff_s(r, base, cap, jrng)
                   for r in (1, 2, 3, 4, 5, 8, 40)]
    for r, d in zip((1, 2, 3, 4, 5), got):
        lo = base * (1 << (r - 1))
        assert min(lo, cap) <= d <= min(lo * 1.25, cap)
    assert got[-1] == (cap if base else 0.0)


# -- the native verifier ------------------------------------------------------


def _zcash():
    out = []
    for name, passes in (("ed25519_malleability_should_pass.bin", True),
                         ("ed25519_malleability_should_fail.bin", False)):
        raw = open(os.path.join(FIXTURES, name), "rb").read()
        out += [((raw[o:o + 64], raw[o + 64:o + 96], b"Zcash"), passes)
                for o in range(0, len(raw), 96)]
    return out


def test_native_matches_jax_and_the_oracle_on_the_zcash_vectors():
    vecs = _zcash()
    assert len(vecs) == 396
    items = [it for it, _ in vecs]
    got = pnative.verify_items(items)
    assert got == jnative.verify_items(items)
    assert [st == 0 for st in got] == [passes for _, passes in vecs]
    for i in range(0, len(items), 11):
        sig, pub, msg = items[i]
        assert got[i] == poracle.verify(msg, sig, pub), i
    # The array entry (the CPU lane's) on the same rows.
    msgs = np.frombuffer(b"Zcash" * len(items), np.uint8).reshape(-1, 5)
    sigs = np.frombuffer(b"".join(s for s, _, _ in items),
                         np.uint8).reshape(-1, 64)
    pubs = np.frombuffer(b"".join(p for _, p, _ in items),
                         np.uint8).reshape(-1, 32)
    lens = np.full(len(items), 5, np.int32)
    assert pnative.verify_arrays(msgs, lens, sigs, pubs,
                                 len(items)).tolist() == got


def test_native_matches_jax_and_the_oracle_on_rfc8032():
    items = [(bytes.fromhex(sig), bytes.fromhex(pub), _msg_bytes(msg))
             for _, pub, msg, sig in RFC8032_VECTORS]
    # A flipped message byte and malformed lengths beside them.
    sig, pub, msg = items[1]
    items += [(sig, pub, bytes([msg[0] ^ 1])), (sig[:63], pub, msg),
              (sig, pub[:31], msg)]
    got = pnative.verify_items(items)
    assert got == jnative.verify_items(items)
    assert got == [poracle.verify(m, s, p) for s, p, m in items]
    assert got[:len(RFC8032_VECTORS)] == [0] * len(RFC8032_VECTORS)
    assert got[-3:] == [-3, -1, -2]
    assert [pnative.verify(m, s, p) for s, p, m in items] == got


def test_native_refuses_malformed_arrays():
    z = np.zeros((4, 8), np.uint8)
    sigs, pubs = np.zeros((4, 64), np.uint8), np.zeros((4, 32), np.uint8)
    lens = np.zeros(4, np.int32)
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        pnative.verify_arrays(z.astype(np.int8), lens, sigs, pubs, 4)
    with pytest.raises(ValueError, match="exceeds the staged rows"):
        pnative.verify_arrays(z, lens, sigs, pubs, 5)
    with pytest.raises(ValueError, match="past the row stride"):
        pnative.verify_arrays(z, np.full(4, 9, np.int32), sigs, pubs, 4)
    assert pnative.verify_arrays(z, lens, sigs, pubs, 0).shape == (0,)


def test_native_without_the_verifier_raises_with_the_path(monkeypatch):
    class Stale:
        pass

    monkeypatch.setattr(pnative, "_LIB", None)
    monkeypatch.setattr(prings, "lib", lambda: Stale())
    with pytest.raises(RuntimeError, match="libfdtango.so lacks "
                       "fd_ed25519_cpu_verify1"):
        pnative.verify_items([(bytes(64), bytes(32), b"")])

    def missing():
        raise OSError("cannot open shared object file")

    monkeypatch.setattr(prings, "lib", missing)
    with pytest.raises(RuntimeError, match="does not build or load"):
        pnative.verify(b"", bytes(64), bytes(32))


# -- pipeline runs ------------------------------------------------------------


def _corpus(n=400, seed=5):
    """tests/test_chaos.py:220-226."""
    return jmainnet_corpus(n=n, seed=seed, dup_rate=0.08, corrupt_rate=0.04,
                           parse_err_rate=0.03, sign_batch_size=128,
                           max_data_sz=140)


@pytest.fixture
def native_engine(monkeypatch):
    """The engines' verify on the CPU is the native verifier's."""

    def fn(self, msgs, lens, sigs, pubs):
        arrs = [np.ascontiguousarray(torch.as_tensor(a).numpy())
                for a in (msgs, lens, sigs, pubs)]
        self.note_dispatch(len(arrs[0]))
        return torch.from_numpy(pnative.verify_arrays(*arrs, len(arrs[0])))

    monkeypatch.setattr(pengine.EngineEntry, "fn", fn)


def _port_chaos_run(path, corpus, schedule, seed=42, verify_batch=128,
                    **kw):
    topo = ppipe.build_topology(str(path), depth=512, wksp_sz=1 << 26)
    res = ppipe.run_pipeline(topo, corpus.payloads,
                             verify_batch=verify_batch,
                             record_digests=True, device="cpu",
                             timeout_s=120.0, chaos=(seed, schedule), **kw)
    assert res.feed and pchaos.active() is None
    return res


def _assert_parity(vs, classes):
    counters = vs["chaos"]["counters"]
    assert set(counters) == set(classes)
    for cls, c in counters.items():
        assert c["injected"] >= 1, (cls, c)
        assert c["injected"] == c["detected"] == c["healed"], (cls, c)


def test_seven_classes_heal_as_in_jax(native_engine, tmp_path, monkeypatch):
    """The seven-class schedule on the same corpus and seed through the
    port's run_pipeline and the JAX feed runner (its CPU backend): the
    same corrupted txn and the same per-class counters; the sink is
    expected_sink_digests less that txn, and the pool is whole."""
    corpus = _corpus(n=500, seed=7)
    res = _port_chaos_run(tmp_path / "p.wksp", corpus, SCHEDULE_7)
    vs = res.verify_stats[0]
    _assert_parity(vs, CLASSES_7)
    corrupted = Counter(bytes.fromhex(h)
                        for h in vs["chaos"]["corrupted_sha256"])
    assert sum(corrupted.values()) == 1
    assert Counter(res.sink_digests) == expected_sink_digests(corpus) \
        - corrupted
    assert vs["slots_leaked"] == 0 and vs["stager_restarts"] == 1
    assert vs["quarantined"] >= 1 and vs["cpu_failover"] >= 1
    assert vs["ctl_err_drop"] >= 2 and vs["breaker_trips"] == 1
    assert res.diag["link.replay_verify"]["ovrnr_cnt"] >= 1
    assert "workers" not in res.proc_cpu_s      # armed: all in process

    for k, v in (("FD_CHAOS", "1"), ("FD_CHAOS_SEED", "42"),
                 ("FD_CHAOS_SCHEDULE", SCHEDULE_7), ("FD_FEED_PROC", "0")):
        monkeypatch.setenv(k, v)
    # The JAX audit books a CTL_ERR frag twice when ring_overrun's rewind
    # reads it again (test_ctl_err_read_again_books_once): a JAX run
    # whose own tri-counters disagree so is run again, twice at most.
    for attempt in range(3):
        topo = jpipe.build_topology(str(tmp_path / f"j{attempt}.wksp"),
                                    depth=512, wksp_sz=1 << 26)
        jres = jpipe.run_pipeline(topo, corpus.payloads,
                                  verify_backend="cpu", timeout_s=120.0,
                                  record_digests=True, feed=True)
        jsnap = jres.verify_stats[0]["chaos"]
        if all(c["injected"] == c["detected"] == c["healed"]
               for c in jsnap["counters"].values()):
            break
    assert vs["chaos"]["counters"] == jsnap["counters"]
    assert vs["chaos"]["corrupted_sha256"] == jsnap["corrupted_sha256"]
    assert Counter(res.sink_digests) == Counter(jres.sink_digests)


def test_device_loss_trips_the_breaker_and_closes(native_engine, tmp_path,
                                                  caplog):
    """device_lost@1:3 with threshold 2 and a 20 ms cooldown: two errors
    trip the breaker, the CPU lane serves, the first probe fails and the
    next closes it (tests/test_chaos.py:349-372)."""
    corpus = _corpus(n=700, seed=31)
    with caplog.at_level(logging.WARNING, pruntime.LOGGER):
        res = _port_chaos_run(tmp_path / "d.wksp", corpus, "device_lost@1:3",
                              verify_opts={"breaker_threshold": 2,
                                           "breaker_cooldown_ms": 20},
                              verify_batch=64)
    vs = res.verify_stats[0]
    assert vs["breaker_trips"] >= 1 and vs["breaker_reprobes"] >= 1
    assert vs["breaker_state"] == ppolicy.BREAKER_CLOSED
    assert vs["cpu_failover"] >= 3 and vs["slots_leaked"] == 0
    _assert_parity(vs, ("device_lost",))
    assert vs["chaos"]["counters"]["device_lost"]["injected"] == 3
    assert Counter(res.sink_digests) == expected_sink_digests(corpus)
    msgs = [r.getMessage() for r in caplog.records]
    assert any("breaker open after ChaosDeviceLost" in m for m in msgs)
    assert sum("served by the CPU lane" in m for m in msgs) \
        == vs["cpu_failover"]


def test_quarantine_publishes_offenders_as_ctl_err(native_engine, tmp_path):
    """Two poisoned completions: both batches are re-verified on the CPU
    lane, the clean txns publish, the bad-signature txns go downstream
    as CTL_ERR frags and the dedup tile filters every one."""
    corpus = _corpus(n=300, seed=37)
    res = _port_chaos_run(tmp_path / "q.wksp", corpus,
                          "backend_raise@1,backend_raise@2")
    vs = res.verify_stats[0]
    assert vs["quarantined"] == 2
    _assert_parity(vs, ("backend_raise",))
    assert Counter(res.sink_digests) == expected_sink_digests(corpus)
    n_bad = int((corpus.expected == BAD_SIG).sum())
    assert 0 < vs["quarantine_err_txn"] <= n_bad
    assert res.diag["link.verify_dedup"]["filt_cnt"] \
        >= vs["quarantine_err_txn"]
    assert vs["breaker_state"] == "closed" and vs["breaker_trips"] == 0


def test_clean_run_reports_zero_healing(native_engine, tmp_path):
    corpus = _corpus(n=200, seed=41)
    topo = ppipe.build_topology(str(tmp_path / "c.wksp"), depth=512,
                                wksp_sz=1 << 26)
    res = ppipe.run_pipeline(topo, corpus.payloads, verify_batch=128,
                             record_digests=True, device="cpu",
                             timeout_s=120.0, feed_proc=False)
    vs = res.verify_stats[0]
    assert "chaos" not in vs
    for key in HEALING:
        assert vs[key] == 0, key
    assert vs["breaker_state"] == ppolicy.BREAKER_CLOSED
    assert Counter(res.sink_digests) == expected_sink_digests(corpus)


# -- the step loop and the CPU lane -------------------------------------------


MAINNET = [open(os.path.join(FIXTURES, f"transaction{i}.bin"), "rb").read()
           for i in (1, 2, 3)]


def _step_tile(tmp_path, **kw):
    topo = ppipe.build_topology(str(tmp_path / "s.wksp"), depth=64)
    w = prings.Workspace.join(topo.wksp_path)
    out = ppipe.out_link(w, "replay_verify")
    verify = ptiles.VerifyTile(w, "verify.cnc",
                               ppipe.in_link(w, "replay_verify"),
                               ppipe.out_link(w, "verify_dedup"),
                               batch=32, device="cpu", **kw)
    return w, out, verify


def test_step_loop_quarantine(native_engine, tmp_path):
    """A poisoned completion in the step loop: the batch's txns are
    re-verified whole on the CPU lane; the valid ones publish, the one
    with a flipped signature goes out as a CTL_ERR frag; the step loop
    has no breaker."""
    w, out, verify = _step_tile(tmp_path)
    bad = bytearray(MAINNET[1])
    bad[10] ^= 1                      # a byte of the first signature
    payloads = [MAINNET[0], bytes(bad), MAINNET[2]]
    for p in payloads:
        out.publish(p, ptiles.meta_sig(p))
    inj = pchaos.ChaosInjector(seed=1, schedule="backend_raise@1")
    with pchaos.armed(inj):
        assert verify.poll_inputs()[0]   # the ring's depth flushes at once
        verify._complete(block=True, drain_all=True)
        vs = pruntime.verify_tile_stats(verify)
    assert vs["quarantined"] == 1 and vs["quarantine_err_txn"] == 1
    assert vs["breaker_state"] == "disabled" and vs["cpu_failover"] == 0
    assert vs["chaos"]["counters"]["backend_raise"] == {
        "injected": 1, "detected": 1, "healed": 1}
    sink_in = ppipe.in_link(w, "verify_dedup")
    frags = [sink_in.mcache.poll(s)[1] for s in range(3)]
    assert [f.ctl & prings.CTL_ERR for f in frags] == [0, prings.CTL_ERR, 0]
    assert [f.sig for f in frags] == [ptiles.meta_sig(p) for p in payloads]
    w.leave()


def test_cpu_lane_falls_back_to_the_oracle(tmp_path, monkeypatch, caplog):
    """The native verifier raising: the slot is verified lane by lane by
    the oracle, with the native verifier's statuses."""
    from firedancer_tpu_torch.disco.feed.slots import Slot

    slot = Slot(0, 32, 1232)
    items = [it for it, _ in _zcash()[195:201]]   # both kinds of vector
    for i, (sig, pub, msg) in enumerate(items):
        slot.msgs[i, :len(msg)] = np.frombuffer(msg, np.uint8)
        slot.lens[i] = len(msg)
        slot.sigs[i] = np.frombuffer(sig, np.uint8)
        slot.pubs[i] = np.frombuffer(pub, np.uint8)
    slot.n_lane = len(items)
    w, _, verify = _step_tile(tmp_path)
    want = pnative.verify_items(items)
    assert verify._verify_slot_cpu(slot).tolist() == want

    def broken(*args):
        raise RuntimeError("native verifier failed")

    monkeypatch.setattr(pnative, "verify_arrays", broken)
    with caplog.at_level(logging.WARNING, pruntime.LOGGER):
        got = verify._verify_slot_cpu(slot)
    assert got[:len(items)].tolist() == want
    assert (got[len(items):] == 1).all()
    assert any("oracle verifies the slot" in r.getMessage()
               for r in caplog.records)
    assert verify.stat_cpu_lanes == 2 * len(items)
    w.leave()


def _chain(tmp_path, corpus, **kw):
    """replay -> verify (the feed) -> sink on a fresh workspace."""
    topo = ppipe.build_topology(str(tmp_path / "ch.wksp"), depth=512)
    w = prings.Workspace.join(topo.wksp_path)
    replay = ptiles.ReplayTile(w, "replay.cnc",
                               ppipe.out_link(w, "replay_verify"),
                               payloads=corpus.payloads)
    verify = ptiles.VerifyTile(w, "verify.cnc",
                               ppipe.in_link(w, "replay_verify"),
                               ppipe.out_link(w, "verify_dedup"),
                               batch=32, device="cpu", feed=True, **kw)
    sink = ptiles.SinkTile(w, "sink.cnc", ppipe.in_link(w, "verify_dedup"),
                           record_digests=True)
    return w, (replay, verify, sink)


def _run_chain(tiles):
    ppipe.run_tiles(list(tiles), lambda: ppipe.chain_quiesced(*tiles),
                    timeout_s=60.0)


def test_stager_past_its_restart_limit_raises(native_engine, tmp_path):
    """stager_restart_max bounds the restarts: the second kill of a
    stager allowed one restart raises out of the feeder, naming the
    limit, and no failover is counted."""
    w, tiles = _chain(tmp_path, _corpus(n=100, seed=3),
                      stager_restart_max=1, stager_backoff_ms=1)
    with pchaos.armed((1, "stager_kill@2,stager_kill@3")):
        with pytest.raises(RuntimeError, match=r"died 2 times \(> 1\)"):
            _run_chain(tiles)
    vs = pruntime.verify_tile_stats(tiles[1])
    assert vs["stager_restarts"] == 2 and vs["cpu_failover"] == 0
    w.leave()


def test_breaker_off_fails_over_batch_by_batch(native_engine, tmp_path):
    """With breaker=False a dispatch that raises still goes to the CPU
    lane, one batch at a time, and nothing trips."""
    corpus = _corpus(n=100, seed=3)
    w, tiles = _chain(tmp_path, corpus, breaker=False)
    with pchaos.armed((1, "device_lost@1:2")):
        _run_chain(tiles)
        vs = pruntime.verify_tile_stats(tiles[1])
    assert vs["breaker_state"] == "disabled" and vs["breaker_trips"] == 0
    assert vs["cpu_failover"] == 2
    assert vs["chaos"]["counters"]["device_lost"] == {
        "injected": 2, "detected": 2, "healed": 2}
    assert Counter(tiles[2].digests) == expected_sink_digests(corpus)
    w.leave()
