"""The port's tango layer against the JAX package's, on one workspace.

* The two packages bind one native library, so a ring of one is a ring
  of the other: frags the JAX rings publish, the port's rings poll
  (per frag and by the bulk drain), and the reverse; a lapped consumer
  counts the same overrun in both.
* ``TCache``, ``AdaptiveFlush.due``, the fctl credit updates, ``Rng``
  and the tempo pacing give the JAX versions' results on seeded
  sequences.
"""

import numpy as np
import pytest
import torch

from firedancer_tpu.disco import tiles as jtiles
from firedancer_tpu.disco.feed import policy as jpolicy
from firedancer_tpu.tango import fctl as jfctl
from firedancer_tpu.tango import rings as jrings
from firedancer_tpu.tango import tcache as jtcache
from firedancer_tpu.tango import tempo as jtempo
from firedancer_tpu.utils import rng as jrng
from firedancer_tpu_torch.disco import pipeline as ppipe
from firedancer_tpu_torch.disco import tiles as ptiles
from firedancer_tpu_torch.disco.feed import policy as ppolicy
from firedancer_tpu_torch.tango import fctl as pfctl
from firedancer_tpu_torch.tango import rings as prings
from firedancer_tpu_torch.tango import tcache as ptcache
from firedancer_tpu_torch.tango import tempo as ptempo
from firedancer_tpu_torch.utils import rng as prng

torch.set_num_threads(1)

DEPTH = 64


@pytest.fixture
def wksp_pair(tmp_path):
    """One workspace file, created by the JAX package and joined by the
    port, with two links."""
    path = str(tmp_path / "one.wksp")
    jw = jrings.Workspace.create(path, 1 << 22)
    for link in ("a", "b"):
        jrings.MCache(jw, f"{link}.mcache", depth=DEPTH, create=True)
        jrings.DCache(jw, f"{link}.dcache", data_sz=64 * 20 * (DEPTH + 2),
                      create=True)
        jrings.FSeq(jw, f"{link}.fseq", create=True)
    for tile in ("src", "sink"):
        jrings.Cnc(jw, f"{tile}.cnc", create=True)
    pw = prings.Workspace.join(path)
    yield jw, pw
    pw.leave()
    jw.leave()


def _payloads(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, int(rng.randint(1, 1233)),
                        dtype=np.uint8).tobytes() for _ in range(n)]


def _names(pkg, link):
    return pkg.LinkNames(f"{link}.mcache", f"{link}.dcache", f"{link}.fseq")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_rings_cross_poll(wksp_pair, direction):
    jw, pw = wksp_pair
    prod, cons = ((jtiles, jw), (ptiles, pw))
    if direction == "port_to_jax":
        prod, cons = cons, prod
    out = prod[0].OutLink(prod[1], _names(prod[0], "a"), mtu=1232)
    pays = _payloads(40, 1)
    for i, p in enumerate(pays):
        out.publish(p, sig=1000 + i, tsorig=7 + i)
    rmod = prings if cons[0] is ptiles else jrings
    mc = rmod.MCache(cons[1], "a.mcache")
    dc = rmod.DCache(cons[1], "a.dcache")
    assert mc.seq_next() == len(pays) and mc.depth == DEPTH
    for i, p in enumerate(pays):
        r, f = mc.poll(i)
        assert r == rmod.POLL_FRAG
        assert (f.seq, f.sig, f.sz, f.ctl, f.tsorig) == (
            i, 1000 + i, len(p), 3, 7 + i)
        assert dc.read(f.chunk, f.sz) == p
    assert mc.poll(len(pays))[0] == rmod.POLL_EMPTY
    # Both packages read the same frag metas.
    other = jrings if rmod is prings else prings
    omc = other.MCache(jw if other is jrings else pw, "a.mcache")
    for i in range(len(pays)):
        assert vars(omc.poll(i)[1]) == vars(mc.poll(i)[1])


class _Recorder:
    """on_frag collector mixed into each package's Tile."""

    def on_frag(self, frag, payload):
        self.got.append((frag.seq, frag.sig, frag.ctl, payload))


def _recorder(pkg, wksp, link, cnc):
    cls = type("Rec", (_Recorder, pkg.Tile), {})
    t = cls(wksp, cnc, in_link=pkg.InLink(wksp, _names(pkg, link)))
    t.got = []
    return t


@pytest.mark.parametrize("lapped", [False, True])
def test_bulk_drain_and_overrun_equal(wksp_pair, lapped):
    """JAX publishes the same frags on both links (CTL_ERR on some); the
    port's bulk drain and the JAX package's give the same frags and
    count the same overrun when the producer laps them."""
    jw, pw = wksp_pair
    n = 3 * DEPTH + 5 if lapped else DEPTH // 2
    pays = _payloads(n, 2)
    for link in ("a", "b"):
        out = jtiles.OutLink(jw, _names(jtiles, link), mtu=1232)
        for i, p in enumerate(pays):
            out.publish(p, sig=i, ctl=7 if i % 9 == 4 else 3)
    pt = _recorder(ptiles, pw, "a", "src.cnc")
    jt = _recorder(jtiles, jw, "b", "sink.cnc")
    for t in (pt, jt):
        while True:
            progressed, overrun = t.poll_inputs()
            if not (progressed or overrun):
                break
    assert pt.got == jt.got
    assert len(pt.got) == (DEPTH if lapped else n)
    ovr_p = pt.in_link.fseq.diag(prings.DIAG_OVRNR_CNT)
    ovr_j = jt.in_link.fseq.diag(jrings.DIAG_OVRNR_CNT)
    assert ovr_p == ovr_j == (n - DEPTH if lapped else 0)
    assert pt.in_link.seq == jt.in_link.seq == n
    # The cross reads: the JAX fseq of link a holds the port's diag.
    assert jrings.FSeq(jw, "a.fseq").diag(jrings.DIAG_OVRNR_CNT) == ovr_p


def test_cnc_and_fseq_shared(wksp_pair):
    jw, pw = wksp_pair
    jc, pc = jrings.Cnc(jw, "src.cnc"), prings.Cnc(pw, "src.cnc")
    pc.signal(prings.CNC_HALT)
    assert jc.signal_query() == jrings.CNC_HALT
    jc.diag_add(4, 11)
    pc.diag_add(4, 5)
    assert pc.diag(4) == jc.diag(4) == 16
    pc.heartbeat(123)
    assert jc.heartbeat_query() == 123
    jf, pf = jrings.FSeq(jw, "b.fseq"), prings.FSeq(pw, "b.fseq")
    pf.update(77)
    assert jf.query() == 77
    prings.require_drain()


def test_ring_constants_equal():
    for name in ("POLL_EMPTY", "POLL_FRAG", "POLL_OVERRUN", "CTL_SOM",
                 "CTL_EOM", "CTL_ERR", "CNC_BOOT", "CNC_RUN", "CNC_HALT",
                 "CNC_FAIL", "DIAG_PUB_CNT", "DIAG_PUB_SZ", "DIAG_FILT_CNT",
                 "DIAG_FILT_SZ", "DIAG_OVRNP_CNT", "DIAG_OVRNR_CNT",
                 "DIAG_SLOW_CNT"):
        assert getattr(prings, name) == getattr(jrings, name), name
    for name in ("CNC_DIAG_IN_BACKP", "CNC_DIAG_BACKP_CNT",
                 "CNC_DIAG_HA_FILT_CNT", "CNC_DIAG_HA_FILT_SZ",
                 "CNC_DIAG_SV_FILT_CNT", "CNC_DIAG_SV_FILT_SZ",
                 "CNC_DIAG_UNACKED", "CTL_SOM_EOM", "FD_TPU_MTU"):
        assert getattr(ptiles, name) == getattr(jtiles, name), name
    for p in (b"", b"\x01" + bytes(range(64)), b"\x02abcdefghij"):
        assert ptiles.meta_sig(p) == jtiles.meta_sig(p)


def test_require_drain_names_the_rebuild(monkeypatch):
    class Stale:
        """A library without the current drain entry points."""

    monkeypatch.setattr(prings, "lib", lambda: Stale())
    with pytest.raises(RuntimeError, match="make -C native"):
        prings.require_drain()


def test_mcache_and_dcache_reject_bad_sizes(wksp_pair):
    _, pw = wksp_pair
    with pytest.raises(ValueError, match="power of two"):
        prings.MCache(pw, "x.mcache", depth=48, create=True)
    with pytest.raises(ValueError, match="multiple of 64"):
        prings.DCache(pw, "x.dcache", data_sz=100, create=True)


def test_build_topology_joins_both_packages(tmp_path):
    topo = ppipe.build_topology(str(tmp_path / "t.wksp"), depth=128)
    jw = jrings.Workspace.join(topo.wksp_path)
    for link in ppipe.LINKS:
        assert jrings.MCache(jw, f"{link}.mcache").depth == 128
        jrings.FSeq(jw, f"{link}.fseq")
    for tile in ppipe.TILES:
        jrings.Cnc(jw, f"{tile}.cnc")
    jw.leave()
    assert ppipe.LINKS == ("replay_verify", "verify_dedup", "dedup_pack",
                           "pack_sink")
    with pytest.raises(ValueError, match="holds less"):
        ppipe.build_topology(str(tmp_path / "s.wksp"), depth=32768)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tcache_equal(seed):
    rng = np.random.RandomState(seed)
    tags = rng.randint(0, 40, 600).tolist()
    p, j = ptcache.TCache(16), jtcache.TCache(16)
    assert [p.insert(t) for t in tags] == [j.insert(t) for t in tags]
    assert (p.hit_cnt, p.miss_cnt) == (j.hit_cnt, j.miss_cnt)
    p.reset()
    j.reset()
    assert [p.insert(t) for t in tags[:50]] == [j.insert(t) for t in tags[:50]]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_adaptive_flush_due_equal(seed):
    rng = np.random.RandomState(seed)
    deadline = int(rng.choice([50_000, 1_000_000, 25_000_000]))
    p, j = ppolicy.AdaptiveFlush(deadline), jpolicy.AdaptiveFlush(deadline)
    assert p.starve_ns == j.starve_ns
    now, first = 10**9, 10**9
    for _ in range(400):
        # Forward steps, backward jumps, and new anchors.
        now += int(rng.randint(-deadline // 2, deadline // 2 + 1))
        if rng.rand() < 0.15:
            first = now + int(rng.randint(-1000, 1000))
        args = (now, int(rng.randint(0, 40)), 32, first)
        kw = dict(starved=bool(rng.rand() < 0.5),
                  device_idle=bool(rng.rand() < 0.5),
                  backpressured=bool(rng.rand() < 0.3))
        assert p.due(*args, **kw) == j.due(*args, **kw)
    with pytest.raises(ValueError):
        ppolicy.AdaptiveFlush(0)
    assert (ppolicy.FLUSH_FULL, ppolicy.FLUSH_DEADLINE,
            ppolicy.FLUSH_STARVED) == (jpolicy.FLUSH_FULL,
                                       jpolicy.FLUSH_DEADLINE,
                                       jpolicy.FLUSH_STARVED)


class _Seq:
    """A consumer fseq whose progress follows a seeded walk."""

    def __init__(self):
        self.seq = 0
        self.slow = 0

    def query(self):
        return self.seq

    def diag_add(self, idx, d):
        assert idx == jrings.DIAG_SLOW_CNT
        self.slow += d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fctl_credit_updates_equal(seed):
    rng = np.random.RandomState(seed)
    rx_p, rx_j = [_Seq(), _Seq()], [_Seq(), _Seq()]
    fp = pfctl.make_fctl_for_fseqs(64, rx_p)
    fj = jfctl.make_fctl_for_fseqs(64, rx_j)
    tx, cp, cj = 0, 0, 0
    for _ in range(500):
        tx += int(rng.randint(0, 12))
        for k in range(2):
            adv = int(rng.randint(0, 12))
            for rx in (rx_p[k], rx_j[k]):
                rx.seq = min(tx, rx.seq + adv)
        cp = fp.tx_cr_update(cp, tx)
        cj = fj.tx_cr_update(cj, tx)
        assert (cp, fp.in_backpressure, fp.backp_cnt) == (
            cj, fj.in_backpressure, fj.backp_cnt)
        cp, cj = max(0, cp - 3), max(0, cj - 3)
    assert [r.slow for r in rx_p] == [r.slow for r in rx_j]
    assert fp.backp_cnt > 0


@pytest.mark.parametrize("seed", [0, 7, 2**63 + 5])
def test_rng_and_tempo_equal(seed):
    p, j = prng.Rng(seq=seed), jrng.Rng(seq=seed)
    assert [p.ulong() for _ in range(50)] == [j.ulong() for _ in range(50)]
    assert ([p.roll(n) for n in range(1, 300)]
            == [j.roll(n) for n in range(1, 300)])
    assert [p.float_exp() for _ in range(20)] == [
        j.float_exp() for _ in range(20)]
    assert p.shuffle(range(30)) == j.shuffle(range(30))
    for depth in (1, 128, 32768, 1 << 40):
        lazy = ptempo.lazy_default(depth)
        assert lazy == jtempo.lazy_default(depth)
        assert ptempo.async_min(lazy) == jtempo.async_min(lazy)
        amin = ptempo.async_min(lazy)
        assert (ptempo.async_reload(p, amin)
                == jtempo.async_reload(j, amin))
