"""The port's QUIC tile (``disco.quic_tile``) and ``run_quic_pipeline``
against the JAX package's, on the CPU.

* The tile's step/done/HALT lifecycle on a workspace, its publish log
  (``payloads``, ``pub_ticks``) and the halt-time shed.
* Connection churn: six sequential connections deliver the corpus once.
* The admission ledger: a connection past a small bucket (set through
  ``QuicOptions``) is shed; the sink is the corpus less exactly the
  ledger, each valid payload once.
* The junk peer's quarantine, the tile stepped from the test thread
  until the counters move (no race with a pipeline's end, unlike
  ``tests/test_quic_tile.py:183``); the slowloris reassembly budget the
  same way; the defenses-off options.
* ``injected == detected == healed`` for each ``quic_*`` class on a live
  QUIC run, its sink whole.
* The sink's multiset from ``run_quic_pipeline(device="cpu")`` equals
  the port's ``run_pipeline`` on the same payloads and the JAX
  ``run_quic_pipeline(verify_backend="cpu")`` on a 64-txn corpus.

The runs swap the engines' verify for the native verifier (the plain
PyTorch versions take about 2 s a batch on one core and are held to the
JAX package in ``tests/test_torch_verify.py``), and keep every tile in
process (``feed_proc=False``).
"""

import hashlib
import os
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from firedancer_tpu.disco import pipeline as jpipe
from firedancer_tpu.disco.corpus import expected_sink_digests
from firedancer_tpu.disco.corpus import mainnet_corpus as jmainnet_corpus
from firedancer_tpu.tango.quic.quic import Quic as JQuic
from firedancer_tpu.tango.quic.quic import QuicConfig as JQuicConfig
from firedancer_tpu.tango.udpsock import UdpSock as JUdpSock
from firedancer_tpu_torch.ballet.ed25519 import native as pnative
from firedancer_tpu_torch.disco import engine as pengine
from firedancer_tpu_torch.disco import pipeline as ppipe
from firedancer_tpu_torch.disco import quic_tile as pquic_tile
from firedancer_tpu_torch.tango.quic import client as pclient
from firedancer_tpu_torch.tango.quic.quic import Quic, QuicConfig
from firedancer_tpu_torch.tango.rings import Workspace
from firedancer_tpu_torch.tango.udpsock import UdpSock

torch.set_num_threads(1)


@pytest.fixture
def native_engine(monkeypatch):
    """The engines' verify on the CPU is the native verifier's."""

    def fn(self, msgs, lens, sigs, pubs):
        arrs = [np.ascontiguousarray(torch.as_tensor(a).numpy())
                for a in (msgs, lens, sigs, pubs)]
        self.note_dispatch(len(arrs[0]))
        return torch.from_numpy(pnative.verify_arrays(*arrs, len(arrs[0])))

    monkeypatch.setattr(pengine.EngineEntry, "fn", fn)


def _corpus(n, seed=0, **kw):
    """tests/test_quic_tile.py:30-36: clean unless kw says otherwise."""
    kw.setdefault("dup_rate", 0.0)
    kw.setdefault("corrupt_rate", 0.0)
    kw.setdefault("parse_err_rate", 0.0)
    return jmainnet_corpus(n=n, seed=seed, sign_batch_size=64,
                           max_data_sz=120, **kw)


def _client(listen_addr, txns, n_conns=1, quic_mod=None):
    """tests/test_quic_tile.py:39: deliver txns over n_conns sequential
    connections (the churn shape), each closed once acknowledged."""
    Q, QC, S = quic_mod or (Quic, QuicConfig, UdpSock)
    sock = S()
    tx_aio = sock.aio_tx()
    client = Q(QC(is_server=False, identity_seed=os.urandom(32)),
               tx=lambda addr, d: tx_aio.send_one(addr, d))
    per = -(-len(txns) // n_conns) if txns else 1
    t0 = time.monotonic()
    for ci in range(n_conns):
        chunk = txns[ci * per:(ci + 1) * per]
        if not chunk and ci:
            break
        conn = client.connect(listen_addr, time.monotonic() - t0)
        sent = False
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            now = time.monotonic() - t0
            sock.service_rx(lambda a, d: client.rx(a, d, now))
            client.service(now)
            if conn.closed:
                break
            if conn.established and not sent:
                for t in chunk:
                    conn.send_stream(t)
                sent = True
            if (sent and not conn._send_queue
                    and not any(s.sent for s in conn.spaces)):
                conn.closed = True
                break
            time.sleep(0.001)
    sock.close()


def _run(tmp_path, name, payloads, client_fn=None, n_conns=2, **kw):
    kw.setdefault("timeout_s", 60.0)
    kw.setdefault("quic_idle_timeout", 2.0)
    topo = ppipe.build_topology(str(tmp_path / f"{name}.wksp"), depth=256,
                                wksp_sz=1 << 25)
    if client_fn is None:
        shares = [list(payloads[i::n_conns]) for i in range(n_conns)]

        def client_fn(addr):
            pclient.deliver(addr, shares, deadline_s=20.0)

    return ppipe.run_quic_pipeline(topo, client_fn, len(payloads),
                                   record_digests=True, device="cpu",
                                   feed_proc=False, **kw)


def _sha(payloads):
    return Counter(hashlib.sha256(p).digest() for p in payloads)


def _expected_less_ledger(corpus, ledger):
    """The sink of a run that shed exactly the ledger: the corpus's
    payloads less the ledger's, each valid one once (dedup)."""
    from firedancer_tpu.disco.corpus import OK

    valid = {hashlib.sha256(p).digest()
             for p, e in zip(corpus.payloads, corpus.expected) if e == OK}
    left = _sha(corpus.payloads) - Counter(bytes.fromhex(h) for h in ledger)
    return Counter({d: 1 for d in left if d in valid})


# -- the tile -----------------------------------------------------------------


class _FakeConn:
    peer_addr = ("t", 1)


def _tile(tmp_path, name="lc", **kw):
    topo = ppipe.build_topology(str(tmp_path / f"{name}.wksp"), depth=32)
    wksp = Workspace.join(topo.wksp_path)
    tile = pquic_tile.QuicTile(
        wksp, "quic.cnc", ppipe.out_link(wksp, "replay_verify"),
        identity_seed=b"\x11" * 32, **kw)
    return wksp, tile


def test_tile_step_done_halt_lifecycle(tmp_path):
    """tests/test_quic_tile.py:80: done() once the expected streams were
    seen and the queues drained; the publish log; HALT books what is
    queued as shed and closes the socket."""
    wksp, tile = _tile(tmp_path, stop_after=2)
    assert not tile.done()
    tile._on_stream(_FakeConn(), 2, b"\x01" + b"a" * 80)
    tile._on_stream(_FakeConn(), 6, b"\x01" + b"b" * 80)
    assert tile.streams_seen == 2 and not tile.done()  # queued
    tile.step()
    assert tile.pub_cnt == 2 and tile.done()
    assert tile.payloads == [b"\x01" + b"a" * 80, b"\x01" + b"b" * 80]
    assert len(tile.pub_ticks) == 2 and tile.pub_ticks[0] <= tile.pub_ticks[1]
    st = pquic_tile.quic_tile_stats(tile)
    assert st["admitted"] + st["shed_total"] == st["offered"] == 2
    assert st["t_first_pub"] == tile.pub_ticks[0] / 1e9
    assert st["aes_path"] in ("aes-ni", "bytecode")
    # Oversized and empty streams are dropped at ingest, not offered.
    tile._on_stream(_FakeConn(), 10, b"x" * 1300)
    tile._on_stream(_FakeConn(), 14, b"")
    assert tile.offered == 2 and tile.streams_seen == 4
    tile._on_stream(_FakeConn(), 18, b"\x01" + b"c" * 80)
    tile.on_halt()
    st = pquic_tile.quic_tile_stats(tile)
    assert st["admitted"] + st["shed_total"] == st["offered"] == 3
    assert st["queue_shed"] == 1 and len(tile.shed_sha256) == 1
    assert len(tile.payloads) == 2           # a shed is never logged
    assert tile.sock._sock.fileno() == -1
    wksp.leave()


def test_options_mirror_the_jax_flags():
    from firedancer_tpu import flags

    o = pquic_tile.QuicOptions()
    assert o.defenses == flags.get_bool("FD_QUIC_DEFENSES")
    for field, flag in (("admit_rate", "FD_QUIC_ADMIT_RATE"),
                        ("admit_burst", "FD_QUIC_ADMIT_BURST"),
                        ("shed_depth", "FD_QUIC_SHED_DEPTH"),
                        ("abuse_threshold", "FD_QUIC_ABUSE_THRESHOLD"),
                        ("quarantine_cooldown_ms",
                         "FD_QUIC_QUARANTINE_COOLDOWN_MS"),
                        ("slow_max_buf", "FD_QUIC_SLOW_MAX_BUF")):
        assert getattr(o, field) == flags.get_int(flag), field
    assert o.hs_timeout_s == flags.get_float("FD_QUIC_HS_TIMEOUT_S")
    assert pquic_tile.as_options(False).defenses is False
    assert pquic_tile.as_options({"admit_burst": 8}).admit_burst == 8
    with pytest.raises(TypeError):
        pquic_tile.as_options(3)


def test_txn_priority_equals_jax():
    from firedancer_tpu.ballet.pack import CuEstimator as JCuEstimator
    from firedancer_tpu.disco import quic_tile as jquic_tile
    from firedancer_tpu_torch.ballet.pack import CuEstimator

    corpus = _corpus(24, seed=3, parse_err_rate=0.2)
    pe, je = CuEstimator(), JCuEstimator()
    got = [pquic_tile._txn_priority(p, pe) for p in corpus.payloads]
    assert got == [jquic_tile._txn_priority(p, je) for p in corpus.payloads]
    assert pquic_tile._txn_priority(b"junk", pe) == 0


def test_junk_peer_is_quarantined(tmp_path):
    """A peer spraying junk trips the breaker: the tile, stepped from the
    test thread, quarantines it and drops its next datagrams at the
    socket, and an honest connection still delivers."""
    wksp, tile = _tile(tmp_path, "jk", options={
        "abuse_threshold": 8, "quarantine_cooldown_ms": 30000})
    sent, atk = pclient.junk(tile.listen_addr, 12, seed=3)
    assert sent == 12
    deadline = time.monotonic() + 10.0
    while tile.fl.get("conn_quarantine") < 1 and time.monotonic() < deadline:
        tile.step()
    assert tile.fl.get("conn_quarantine") == 1
    assert tile.quarantined(("127.0.0.1", atk[1]))
    # The eighth junk datagram tripped the breaker; the four behind it
    # and the next one drop at the socket.
    tile.rx(("127.0.0.1", atk[1]), b"\x41" + bytes(40), tile._now())
    assert tile.fl.get("quarantine_drop") == 12 - 8 + 1
    # An honest peer is untouched.
    payloads = list(_corpus(6, seed=13).payloads)
    th = threading.Thread(target=pclient.deliver,
                          args=(tile.listen_addr, [payloads]), daemon=True)
    th.start()
    deadline = time.monotonic() + 20.0
    while tile.pub_cnt < len(payloads) and time.monotonic() < deadline:
        tile.step()
    th.join(timeout=20.0)
    assert tile.payloads == payloads
    st = pquic_tile.quic_tile_stats(tile)
    assert st["conn_quarantine"] == 1 and st["quarantine_drop"] == 5
    assert st["quic_metrics"]["rx_dropped"] == 8
    tile.on_halt()
    wksp.leave()


def test_slowloris_budget_quarantines_the_dribbler(tmp_path):
    """A connection holding incomplete streams past slow_max_buf bytes is
    an abuse event worth the threshold at the housekeeping scan: its
    peer is quarantined and its connection aborted. With the defenses
    off the scan does nothing."""
    for defenses in (True, False):
        wksp, tile = _tile(tmp_path, f"sl{int(defenses)}", options={
            "slow_max_buf": 2048, "abuse_threshold": 8,
            "defenses": defenses})
        sock = UdpSock()
        tx = sock.aio_tx()
        cl = Quic(QuicConfig(is_server=False, identity_seed=os.urandom(32)),
                  tx=lambda a, d: tx.send_one(a, d))
        conn = cl.connect(tile.listen_addr, 0.0)
        t0 = time.monotonic()
        sent = False
        while time.monotonic() - t0 < 10.0:
            now = time.monotonic() - t0
            sock.service_rx(lambda a, d: cl.rx(a, d, now))
            cl.service(now)
            tile.step()
            if conn.established and not sent:
                for _ in range(6):
                    conn.send_stream(b"\x55" * 900, fin=False)
                sent = True
            if sent and not conn._send_queue and not any(
                    s.sent for s in conn.spaces):
                break
        sock.close()
        assert tile.quic.conns[0].reassembly_pressure()[1] > 2048
        tile.on_housekeep()
        assert tile.fl.get("conn_quarantine") == int(defenses)
        assert tile.quic.conns[0].closed == defenses
        assert tile.streams_seen == 0
        tile.on_halt()
        wksp.leave()


# -- runs ---------------------------------------------------------------------


def test_connection_churn(native_engine, tmp_path):
    corpus = _corpus(24, seed=5)
    res = _run(tmp_path, "churn", corpus.payloads,
               client_fn=lambda a: _client(a, corpus.payloads, n_conns=6))
    assert res.recv_cnt == len(corpus.payloads), res.diag
    assert res.quic["quic_metrics"]["conns_created"] >= 6
    assert (res.quic["admitted"] + res.quic["shed_total"]
            == res.quic["offered"] == len(corpus.payloads))
    assert Counter(res.sink_digests) == _sha(corpus.payloads)


def test_admission_ledger(native_engine, tmp_path):
    """One connection past a bucket of 8 refilling 40 a second: shed,
    ledgered, and the sink is the corpus less exactly the ledger."""
    corpus = _corpus(48, seed=11, dup_rate=0.1, corrupt_rate=0.1)
    res = _run(tmp_path, "adm", corpus.payloads, n_conns=1,
               quic={"admit_rate": 40, "admit_burst": 8,
                     "abuse_threshold": 10000})
    q = res.quic
    assert q["admit_shed"] >= 1 and q["queue_shed"] == 0
    assert q["admitted"] + q["shed_total"] == q["offered"] \
        == len(corpus.payloads)
    assert len(q["shed_sha256"]) == q["shed_total"]
    assert Counter(res.sink_digests) == _expected_less_ledger(
        corpus, q["shed_sha256"])
    assert res.flight_tiles["quic"]["admit_shed"] == q["admit_shed"]
    assert res.stage_hist["quic_ingest"]["n"] == q["admitted"]


def test_defenses_off_options(native_engine, tmp_path):
    corpus = _corpus(12, seed=23)
    res = _run(tmp_path, "off", corpus.payloads, n_conns=1,
               quic={"defenses": False, "admit_rate": 1, "admit_burst": 1})
    q = res.quic
    assert q["shed_total"] == 0 and q["conn_quarantine"] == 0
    assert not q["defenses"]
    assert res.recv_cnt == len(corpus.payloads)


def test_quic_chaos_classes_balance(native_engine, tmp_path):
    """tests/test_quic_tile.py:275: the three quic_* classes against live
    traffic, injected == detected == healed each, the sink whole (the
    slowloris window holds, never loses)."""
    corpus = _corpus(16, seed=21)
    res = _run(tmp_path, "qchaos", corpus.payloads, timeout_s=90.0,
               chaos=(3, "quic_malformed@5,quic_malformed@40,"
                         "quic_conn_churn@8,quic_slowloris@20:160"),
               quic={"hs_timeout_s": 0.5})
    counters = res.verify_stats[0]["chaos"]["counters"]
    for cls, want in (("quic_malformed", 2), ("quic_conn_churn", 1),
                      ("quic_slowloris", 1)):
        c = counters[cls]
        assert c["injected"] == c["detected"] == c["healed"] == want, \
            (cls, c)
    assert Counter(res.sink_digests) == _sha(corpus.payloads)


def test_sink_equals_replay_and_jax(native_engine, tmp_path):
    """64 txns with duplicates, bad signatures and parse errors: the QUIC
    run's sink multiset equals the port's replay run's, the JAX
    run_quic_pipeline's (its CPU backend, the step loop) and the
    corpus oracle's; the end-to-end latency matches every receipt."""
    corpus = _corpus(64, seed=9, dup_rate=0.08, corrupt_rate=0.06,
                     parse_err_rate=0.04)
    res = _run(tmp_path, "qp", corpus.payloads, n_conns=4)
    assert res.feed, res.feed_fallback_reason
    assert res.latency_p50_ns > 0 and res.stage_hist["quic_ingest"]["n"] \
        == len(corpus.payloads)
    topo = ppipe.build_topology(str(tmp_path / "rep.wksp"), depth=256,
                                wksp_sz=1 << 25)
    res_r = ppipe.run_pipeline(topo, corpus.payloads, record_digests=True,
                               device="cpu", feed_proc=False, timeout_s=60.0)
    jtopo = jpipe.build_topology(str(tmp_path / "j.wksp"), depth=256)
    jres = jpipe.run_quic_pipeline(
        jtopo, lambda a: _client(a, corpus.payloads, n_conns=2,
                                 quic_mod=(JQuic, JQuicConfig, JUdpSock)),
        n_txns=len(corpus.payloads), verify_backend="cpu", timeout_s=60.0,
        record_digests=True, quic_idle_timeout=2.0)
    got = Counter(res.sink_digests)
    assert got == Counter(res_r.sink_digests) == Counter(jres.sink_digests)
    assert got == expected_sink_digests(corpus)
    assert res.recv_cnt == jres.recv_cnt < len(corpus.payloads)
