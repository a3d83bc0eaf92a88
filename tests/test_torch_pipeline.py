"""The port's dedup and pack tiles and its five-tile runner against the
JAX package's, on the CPU.

* ``TCache.insert_batch`` equals ``insert`` tag by tag and the JAX
  ``insert_batch``, eviction in the middle of a round included.
* ``DedupTile``: the bulk round (``fd_frag_drain``, ``insert_batch``,
  ``fd_frag_publish_bulk_ctl``), the per-frag path and the JAX ``DedupTile``
  forward the same frags and count the same filters, on frags with
  repeated signatures across rounds and CTL_ERR copies, two in-links.
* ``run_pipeline(verify_backend="gpu", device="cpu", verify_batch=32,
  feed=False)`` (the in-process step loop; ``tests/test_torch_feed.py``
  runs the feed) on a port ``mainnet_corpus`` with both pack
  schedulers: the sink gets
  exactly ``expected_sink_digests`` (the port's counterpart of
  ``tests/test_replay_gate.py:80-115``), every filtered txn lands in a
  filter counter, and more than one bank gets work; the JAX
  ``run_pipeline(verify_backend="cpu")`` with ``FD_FEED=0`` on the same
  payloads delivers the same multiset and filter total.
* The pack tile drops a txn over a bank's CU budget into the link's
  filter counter; the diag snapshot, ``latency_percentiles`` and the
  verify stats use the JAX names.
* The gc gate (``PackTile._gate_device_waves``): an inadmissible device
  schedule and a losing one fall back to the greedy waves, a winning
  one publishes, in the port and in the JAX tile alike; the waves the
  port publishes and its block_device / sched_fallback counters agree.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from firedancer_tpu.disco import pipeline as jpipe
from firedancer_tpu.disco import tiles as jtiles
from firedancer_tpu.disco.feed import runtime as jruntime
from firedancer_tpu.tango import rings as jrings
from firedancer_tpu.tango import tcache as jtcache
from firedancer_tpu_torch.disco import corpus as pcorpus
from firedancer_tpu_torch.disco import monitor as pmonitor
from firedancer_tpu_torch.disco import pipeline as ppipe
from firedancer_tpu_torch.disco import sentinel as psentinel
from firedancer_tpu_torch.disco import tiles as ptiles
from firedancer_tpu_torch.disco.feed import runtime as pruntime
from firedancer_tpu_torch.ops import backend
from firedancer_tpu_torch.tango import rings as prings
from firedancer_tpu_torch.tango import tcache as ptcache

torch.set_num_threads(1)

DEPTH = 256


# -- tcache ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_insert_batch_equals_insert(seed):
    """Rounds of up to 70 tags over 48 values through a 16-deep ring:
    repeats inside a round, members evicted mid-round (the loop path)
    and rounds as long as the ring."""
    rng = np.random.RandomState(seed)
    loop, batch, jax = (ptcache.TCache(16), ptcache.TCache(16),
                        jtcache.TCache(16))
    for _ in range(40):
        tags = rng.randint(0, 48, int(rng.randint(0, 71))).astype(np.uint64)
        want = np.array([loop.insert(int(t)) for t in tags], np.bool_)
        got = batch.insert_batch(tags)
        assert got.dtype == np.bool_
        assert np.array_equal(got, want)
        assert np.array_equal(got, jax.insert_batch(tags))
        assert (batch.hit_cnt, batch.miss_cnt) == (loop.hit_cnt,
                                                   loop.miss_cnt)
        assert batch._ring == loop._ring and batch._map == loop._map


# -- dedup -------------------------------------------------------------------


def _frags(n, seed):
    """(payload, sig, ctl, tsorig): sigs drawn from 60 values, so they
    repeat within and across the 64-frag drain rounds; every 7th a
    CTL_ERR copy."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        pay = rng.randint(0, 256, int(rng.randint(1, 300)),
                          dtype=np.uint8).tobytes()
        ctl = 3 | (prings.CTL_ERR if i % 7 == 3 else 0)
        out.append((pay, int(rng.randint(0, 60)), ctl, 1000 + i))
    return out


def _publish(pkg, w, link, frags):
    names = pkg.LinkNames(f"{link}.mcache", f"{link}.dcache",
                          f"{link}.fseq")
    out = pkg.OutLink(w, names, mtu=1232)
    for pay, sig, ctl, ts in frags:
        out.publish(pay, sig, tsorig=ts, ctl=ctl)


def _collect(rmod, w, link, n):
    mc = rmod.MCache(w, f"{link}.mcache")
    dc = rmod.DCache(w, f"{link}.dcache")
    got = []
    for seq in range(mc.seq_next()):
        _, f = mc.poll(seq)
        got.append((dc.read(f.chunk, f.sz), f.sig, f.ctl, f.tsorig))
    return got


def _pump(tile):
    while True:
        progressed, overrun = tile.poll_inputs()
        if not (progressed or overrun):
            return


def _dedup_out(path, pkg, frags, **kw):
    """frags split over the two verify_dedup-style in-links (lane 0 the
    even, lane 1 the odd), one dedup tile with tcache depth 16, its
    output on dedup_pack and the in-links' filter counters."""
    topo = ppipe.build_topology(str(path), depth=DEPTH)
    rmod = prings if pkg is ptiles else jrings
    w = rmod.Workspace.join(topo.wksp_path)
    lanes = ("verify_dedup", "replay_verify")
    for lane, link in enumerate(lanes):
        _publish(pkg, w, link, frags[lane::2])
    names = [pkg.LinkNames(f"{k}.mcache", f"{k}.dcache", f"{k}.fseq")
             for k in (*lanes, "dedup_pack")]
    out = pkg.OutLink(w, names[2], mtu=1232,
                      reliable_fseqs=[rmod.FSeq(w, names[2].fseq)])
    tile = pkg.DedupTile(w, "dedup.cnc",
                         in_links=[pkg.InLink(w, n) for n in names[:2]],
                         out_link=out, tcache_depth=16, **kw)
    _pump(tile)
    got = _collect(rmod, w, "dedup_pack", len(frags))
    filt = [(rmod.FSeq(w, n.fseq).diag(rmod.DIAG_FILT_CNT),
             rmod.FSeq(w, n.fseq).diag(rmod.DIAG_FILT_SZ),
             rmod.FSeq(w, n.fseq).diag(rmod.DIAG_PUB_CNT),
             rmod.FSeq(w, n.fseq).diag(rmod.DIAG_PUB_SZ))
            for n in names[:2]]
    w.leave()
    return got, filt


@pytest.mark.parametrize("seed", [0, 1])
def test_dedup_bulk_equals_per_frag_and_jax(tmp_path, seed):
    frags = _frags(300, seed)
    bulk = _dedup_out(tmp_path / "b.wksp", ptiles, frags)
    per_frag = _dedup_out(tmp_path / "f.wksp", ptiles, frags, bulk=False)
    jax = _dedup_out(tmp_path / "j.wksp", jtiles, frags)
    assert bulk == per_frag == jax
    got, filt = bulk
    assert 0 < len(got) < len(frags)
    assert all(ctl == 3 for _, _, ctl, _ in got)
    assert sum(f[0] for f in filt) + len(got) == len(frags)


# -- the five-tile runner --------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    """Every class of the mainnet mix, small enough for one verify batch
    of 32 lanes (the plain verify on the CPU costs about a second a
    batch)."""
    return pcorpus.mainnet_corpus(n=12, seed=5, dup_rate=0.25,
                                  corrupt_rate=0.25, parse_err_rate=0.17,
                                  device="cpu")


def _filt_total(diag):
    """tests/test_replay_gate.py:106-113's filter accounting."""
    return (diag["tile.verify"]["ha_filt_cnt"]
            + diag["tile.verify"]["sv_filt_cnt"]
            + diag["link.verify_dedup"]["filt_cnt"]
            + diag["link.dedup_pack"]["filt_cnt"])


def _not_ok(c):
    return int((c.expected != pcorpus.OK).sum())


@pytest.fixture(scope="module")
def port_runs(corpus, tmp_path_factory):
    out = {}
    for sched in ("greedy", "gc"):
        topo = ppipe.build_topology(
            str(tmp_path_factory.mktemp(sched) / "p.wksp"), depth=DEPTH)
        backend.reset_counts()
        res = ppipe.run_pipeline(topo, corpus.payloads, verify_batch=32,
                                 record_digests=True, pack_scheduler=sched,
                                 device="cpu", timeout_s=120.0, feed=False)
        out[sched] = (res, dict(backend.plain_calls))
    return out


@pytest.mark.parametrize("sched", ["greedy", "gc"])
def test_port_replay_gate(corpus, port_runs, sched):
    res, plain = port_runs[sched]
    assert not res.feed and res.feed_fallback_reason is None
    assert res.recv_cnt == corpus.n_unique_ok, res.diag
    assert Counter(res.sink_digests) == pcorpus.expected_sink_digests(corpus)
    assert _filt_total(res.diag) == _not_ok(corpus), res.diag
    assert len(res.bank_hist) > 1
    assert res.diag["link.pack_sink"]["tx_seq"] == res.recv_cnt
    assert 0 < res.latency_p50_ns <= res.latency_p99_ns
    ps = res.pack_stats
    assert ps["scheduler"] == sched and ps["cu_drop"] == 0
    if sched == "gc":
        # Every block passed the gate or fell back, and each colored
        # block ran the plain version once (CPU tensors).
        assert ps["blocks"] > 0
        assert ps["block_device"] + ps["sched_fallback"] == ps["blocks"]
        assert plain["pack_schedule"] == ps["blocks"]
    else:
        assert ps["blocks"] == 0 and "pack_schedule" not in plain
    assert set(res.tile_cpu_s) == {"replay", "verify", "dedup", "pack",
                                   "sink"}


def test_jax_runner_gives_the_same_sink(corpus, port_runs, tmp_path,
                                        monkeypatch):
    """The JAX package's in-process runner (FD_FEED=0, greedy pack, its
    CPU verify backend) on the same payloads."""
    monkeypatch.setenv("FD_FEED", "0")
    topo = jpipe.build_topology(str(tmp_path / "j.wksp"), depth=DEPTH)
    jres = jpipe.run_pipeline(topo, corpus.payloads, verify_backend="cpu",
                              verify_batch=32, record_digests=True,
                              timeout_s=120.0)
    assert not jres.feed
    res, _ = port_runs["greedy"]
    assert jres.recv_cnt == res.recv_cnt
    assert Counter(jres.sink_digests) == Counter(res.sink_digests)
    assert _filt_total(jres.diag) == _filt_total(res.diag)
    # The snapshot keeps the JAX names.
    for key, row in res.diag.items():
        assert set(row) <= set(jres.diag[key]), key
    assert set(res.verify_stats[0]) <= set(jres.verify_stats[0])


def test_pack_tile_drops_over_budget(tmp_path, corpus):
    """A txn whose estimate exceeds a bank's CU budget is filtered (and
    counted with its size); a parse error is filtered without its size."""
    topo = ppipe.build_topology(str(tmp_path / "p.wksp"), depth=DEPTH)
    w = prings.Workspace.join(topo.wksp_path)
    ok = [p for p, e in zip(corpus.payloads, corpus.expected)
          if e == pcorpus.OK][:6]
    src = ppipe.out_link(w, "dedup_pack")
    for p in ok + [b"\x00garbage"]:
        src.publish(p, ptiles.meta_sig(p))
    pack = ptiles.PackTile(w, "pack.cnc", ppipe.in_link(w, "dedup_pack"),
                           ppipe.out_link(w, "pack_sink"), bank_cnt=2)
    pack.pack.max_cu_per_bank = 150_000   # below the 200k prior a program
    _pump(pack)
    fs = prings.FSeq(w, "dedup_pack.fseq")
    assert fs.diag(prings.DIAG_FILT_CNT) == len(ok) + 1
    assert fs.diag(prings.DIAG_FILT_SZ) == sum(map(len, ok))
    assert pack.stat_cu_drop == len(ok) and pack.drained()
    assert prings.MCache(w, "pack_sink.mcache").seq_next() == 0
    w.leave()


def test_pack_tile_refuses_unknown_scheduler(tmp_path):
    topo = ppipe.build_topology(str(tmp_path / "p.wksp"), depth=DEPTH)
    w = prings.Workspace.join(topo.wksp_path)
    with pytest.raises(ValueError, match="scheduler"):
        ptiles.PackTile(w, "pack.cnc", ppipe.in_link(w, "dedup_pack"),
                        ppipe.out_link(w, "pack_sink"), scheduler="heap")
    w.leave()


@pytest.mark.parametrize("seed", [0, 1])
def test_latency_percentiles_equal(seed):
    rng = np.random.RandomState(seed)
    for n in (0, 1, 7, 200):
        s = rng.randint(0, 10**9, n).tolist()
        assert (pruntime.latency_percentiles(s)
                == jruntime.latency_percentiles(s))


def test_snapshot_names_every_tile_and_link(tmp_path):
    topo = ppipe.build_topology(str(tmp_path / "s.wksp"), depth=DEPTH)
    w = prings.Workspace.join(topo.wksp_path)
    snap = pmonitor.snapshot(w, ppipe.TILES, ppipe.LINKS)
    w.leave()
    # The flight registry's overlay: its spans, SLO rows and the xray
    # queue rows beside them.
    assert set(snap) == ({f"tile.{t}" for t in ppipe.TILES}
                         | {f"link.{k}" for k in ppipe.LINKS}
                         | {f"span.{e}" for e in ppipe.topology_edges()}
                         | {f"slo.{n}" for n in psentinel.SLO_NAMES}
                         | {f"xq.{e}" for e in ppipe.topology_edges()})
    assert all(v == 0 for row in snap.values() for v in row.values())


# -- the gc gate -------------------------------------------------------------


def _gate_txns(pkg):
    """Six txns: a and b write X (a conflict), e reads X, c, d and f
    are disjoint; scores 9, 8, 1, 7, 6, 5 (rewards / 100 CUs)."""
    mk = pkg.PackTxn
    acct = {k: bytes([k]) * 32 for k in range(1, 8)}
    spec = [(900, {1}, set()), (800, {1}, set()), (100, {2}, set()),
            (700, {3}, set()), (600, {4}, {1}), (500, {5}, set())]
    return [mk(txn_id=i, rewards=r, est_cus=100,
               writable=frozenset(acct[k] for k in w),
               readonly=frozenset(acct[k] for k in ro))
            for i, (r, w, ro) in enumerate(spec)]


def _schedules(t):
    """Device schedules by verdict, as (waves, leftover)."""
    return {
        # a and b write X in one wave.
        "inadmissible": ([[t[0], t[1], t[2]], [t[3], t[4], t[5]]], []),
        # Admissible, but only the lowest score: rewards per CU lose.
        "losing": ([[t[2]]], [t[0], t[1], t[3], t[4], t[5]]),
        # Every txn in other waves than greedy's: rewards per CU equal.
        "winning": ([[t[0], t[2], t[3]], [t[1], t[5]], [t[4]]], []),
    }


class _Counts:
    def __init__(self):
        self.c = Counter()

    def inc(self, name, n=1):
        self.c[name] += n

    def record(self, *a, **kw):
        pass


def _ids(waves):
    return [[t.txn_id for t in w] for w in waves]


@pytest.mark.parametrize("verdict", ["inadmissible", "losing", "winning"])
def test_gc_gate_port_and_jax(tmp_path, monkeypatch, verdict):
    from types import SimpleNamespace

    from firedancer_tpu.ballet import pack as jpack
    from firedancer_tpu_torch.ballet import pack as ppack

    ptx, jtx = _gate_txns(ppack), _gate_txns(jpack)
    pw, pl = _schedules(ptx)[verdict]
    jw, jl = _schedules(jtx)[verdict]
    fake = SimpleNamespace(fl=_Counts(), flightrec=_Counts())
    j_waves, j_left = jtiles.PackTile._gate_device_waves(fake, jtx, jw, jl)

    topo = ppipe.build_topology(str(tmp_path / "g.wksp"), depth=DEPTH)
    w = prings.Workspace.join(topo.wksp_path)
    pack = ptiles.PackTile(w, "pack.cnc", ppipe.in_link(w, "dedup_pack"),
                           ppipe.out_link(w, "pack_sink"), bank_cnt=2,
                           scheduler="gc", device="cpu")
    monkeypatch.setattr(ptiles, "schedule_block",
                        lambda txns, **kw: (pw, pl))
    pack._gc_pending = list(ptx)
    pack._payloads = {t.txn_id: bytes([65 + t.txn_id]) * 40 for t in ptx}
    pack._drain_gc()
    p_waves, p_left = pack._gate_device_waves(ptx, pw, pl)
    mc = prings.MCache(w, "pack_sink.mcache")
    published = [mc.poll(seq)[1].sig & 0xFFFFFFFFFFFF
                 for seq in range(mc.seq_next())]
    w.leave()

    accepted = verdict == "winning"
    assert _ids(p_waves) == _ids(j_waves)
    assert [t.txn_id for t in p_left] == [t.txn_id for t in j_left]
    assert (_ids(p_waves) == _ids(pw)) == accepted
    # The first gate call is the one _drain_gc made; it published the
    # waves the gate chose, wave by wave, and kept the leftover pending.
    assert published == [i for wave in _ids(p_waves) for i in wave]
    assert [t.txn_id for t in pack._gc_pending] == [t.txn_id
                                                    for t in p_left]
    assert (pack.stat_block_device, pack.stat_sched_fallback) == (
        (2, 0) if accepted else (0, 2))
    assert pack.stat_wave_device == (2 * len(pw) if accepted else 0)
    assert (fake.fl.c["pack_block_device"],
            fake.fl.c["pack_sched_fallback"]) == ((1, 0) if accepted
                                                  else (0, 1))
