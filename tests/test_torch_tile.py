"""The port's verify tile against the JAX package's, replay -> verify ->
sink at B = 32 on the CPU.

* Direct and rlc, native drain on and off (and the oracle backend), on
  a JAX-built mainnet corpus with every traffic class and the mainnet
  fixtures: the sink's digest multiset and the SV and HA filter diag
  counts equal the JAX ``VerifyTile(backend="cpu")`` chain's on the same
  payloads, and the corpus's classes.
* A clean corpus with the fixtures in rlc mode: two batches, the last
  partial, and no fallback.
* JAX ``ReplayTile`` -> port ``VerifyTile`` -> JAX ``SinkTile`` on one
  workspace.
* ``resolve_verify_mode``'s cases (those of
  ``tests/test_frontend_fused.py:399-423`` without the environment
  flags); an engine that raises makes the tile raise with nothing
  published; CTL_ERR frags and garbage are filtered on both ingest
  paths without reaching the engine; the gpu backend refuses a batch or
  a row too narrow for a transaction; a deadline and a starved flush
  are recorded under their verdicts; ``latencies_ns`` reads latencies
  past the 32-bit tsorig's wrap.
"""

import sys
from collections import Counter
from hashlib import sha256
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from firedancer_tpu.disco import corpus as jcorpus
from firedancer_tpu.disco import pipeline as jpipe
from firedancer_tpu.disco import tiles as jtiles
from firedancer_tpu.tango import rings as jrings
from firedancer_tpu_torch.ballet.txn import MAX_SIG_CNT
from firedancer_tpu_torch.disco import engine as pengine
from firedancer_tpu_torch.disco import pipeline as ppipe
from firedancer_tpu_torch.disco import tiles as ptiles
from firedancer_tpu_torch.tango import rings as prings

torch.set_num_threads(1)

B = 32
DEPTH = 256
FIXTURES = Path(__file__).resolve().parent / "fixtures"
MAINNET = [p.read_bytes() for p in sorted(FIXTURES.glob("transaction*.bin"))]
PACK = [(FIXTURES / "txn_pack" / f"{n}.bin").read_bytes()
        for n in ("legacy_12sig", "v0_7sig_luts2", "mtu_v0lut",
                  "legacy_1sig_data1000")]


@pytest.fixture(scope="module")
def dirty():
    """Every class of the mainnet mix, the three mainnet fixtures first."""
    c = jcorpus.mainnet_corpus(n=12, seed=5, dup_rate=0.25,
                               corrupt_rate=0.25, parse_err_rate=0.17)
    return MAINNET + c.payloads, c


@pytest.fixture(scope="module")
def clean():
    c = jcorpus.mainnet_corpus(n=16, seed=9, dup_rate=0.0,
                               corrupt_rate=0.0, parse_err_rate=0.0)
    return MAINNET + PACK + c.payloads, c


def _want(payloads, c):
    """The sink's multiset: the corpus's OK class and every fixture."""
    want = jcorpus.expected_sink_digests(c)
    for p in payloads[:len(payloads) - len(c.payloads)]:
        want[sha256(p).digest()] += 1
    return want


def _result(verify, sink):
    return {"digests": Counter(sink.digests),
            "sv": (verify.cnc.diag(ptiles.CNC_DIAG_SV_FILT_CNT),
                   verify.cnc.diag(ptiles.CNC_DIAG_SV_FILT_SZ)),
            "ha": (verify.cnc.diag(ptiles.CNC_DIAG_HA_FILT_CNT),
                   verify.cnc.diag(ptiles.CNC_DIAG_HA_FILT_SZ)),
            "verify": verify, "sink": sink}


def _jax_link(w, link, out):
    names = jtiles.LinkNames(f"{link}.mcache", f"{link}.dcache",
                             f"{link}.fseq")
    if not out:
        return jtiles.InLink(w, names)
    return jtiles.OutLink(w, names, mtu=1232,
                          reliable_fseqs=[jrings.FSeq(w, names.fseq)])


def _run(tiles, replay, verify, sink):
    ppipe.run_tiles(tiles, lambda: ppipe.chain_quiesced(replay, verify, sink),
                    timeout_s=120.0)


def port_chain(tmp_path, payloads, **verify_kw):
    topo = ppipe.build_topology(str(tmp_path / "port.wksp"), depth=DEPTH)
    w = prings.Workspace.join(topo.wksp_path)
    replay = ptiles.ReplayTile(w, "replay.cnc",
                               ppipe.out_link(w, "replay_verify"),
                               payloads=payloads)
    verify = ptiles.VerifyTile(w, "verify.cnc",
                               ppipe.in_link(w, "replay_verify"),
                               ppipe.out_link(w, "verify_dedup"),
                               batch=B, device="cpu", **verify_kw)
    sink = ptiles.SinkTile(w, "sink.cnc", ppipe.in_link(w, "verify_dedup"),
                           record_digests=True)
    _run([replay, verify, sink], replay, verify, sink)
    return {**_result(verify, sink), "replay": replay}


@pytest.fixture(scope="module")
def jax_dirty(dirty, tmp_path_factory):
    """The JAX package's chain: VerifyTile(backend="cpu"), native drain."""
    topo = jpipe.build_topology(
        str(tmp_path_factory.mktemp("jax") / "jax.wksp"), depth=DEPTH)
    w = jrings.Workspace.join(topo.wksp_path)
    replay = jtiles.ReplayTile(w, "replay.cnc",
                               out_link=_jax_link(w, "replay_verify", True),
                               payloads=dirty[0])
    verify = jtiles.VerifyTile(w, "verify.cnc",
                               _jax_link(w, "replay_verify", False),
                               _jax_link(w, "verify_dedup", True),
                               backend="cpu", batch=B)
    sink = jtiles.SinkTile(w, "sink.cnc", _jax_link(w, "verify_dedup", False),
                           record_digests=True)
    _run([replay, verify, sink], replay, verify, sink)
    return _result(verify, sink)


@pytest.mark.parametrize("backend,mode,native_drain", [
    ("gpu", "direct", True), ("gpu", "direct", False),
    ("gpu", "rlc", True), ("gpu", "rlc", False),
    ("oracle", "auto", False),
])
def test_chain_equals_jax(tmp_path, dirty, jax_dirty, backend, mode,
                          native_drain):
    payloads, c = dirty
    got = port_chain(tmp_path, payloads, backend=backend, verify_mode=mode,
                     native_drain=native_drain)
    n = Counter(int(e) for e in c.expected)
    assert jax_dirty["digests"] == _want(payloads, c)
    assert got["digests"] == jax_dirty["digests"]
    assert got["sv"] == jax_dirty["sv"]
    assert got["ha"] == jax_dirty["ha"]
    assert got["sv"][0] == n[jcorpus.BAD_SIG] + n[jcorpus.BAD_PARSE]
    assert got["ha"][0] == n[jcorpus.DUP]
    v = got["verify"]
    assert v._nd == (backend == "gpu" and native_drain)
    for lanes, verdict in v.batch_log:
        # A full flush leaves no room for the next txn; others are partial.
        assert (lanes > B - MAX_SIG_CNT if verdict == ptiles.FLUSH_FULL
                else lanes < B), (lanes, verdict)
    lat = ptiles.latencies_ns(got["replay"], got["sink"])
    assert len(lat) == got["sink"].recv_cnt and (lat > 0).all()
    if backend == "gpu":
        assert v.stat_batches >= 1
        assert v.stat_lanes <= v.stat_batches * B
    if mode == "rlc":
        # A batch holding a corrupt signature fails the batch equation.
        assert 1 <= v.stat_rlc_fallback <= v.stat_batches
    else:
        assert v.stat_rlc_fallback == 0
    assert v.cnc.diag(ptiles.CNC_DIAG_UNACKED) == 0


def test_chain_under_fast_thread_switching(tmp_path, dirty):
    """The rings, the held-back ack and the quiescence check hold when
    the interpreter switches threads every 10 us (oracle backend, so the
    run stays short)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = port_chain(tmp_path, dirty[0], backend="oracle")
    finally:
        sys.setswitchinterval(old)
    assert got["digests"] == _want(*dirty)
    assert got["sink"].recv_cnt == sum(_want(*dirty).values())


def test_clean_rlc_no_fallback(tmp_path, clean):
    payloads, c = clean
    got = port_chain(tmp_path, payloads, verify_mode="rlc")
    v = got["verify"]
    assert got["digests"] == _want(payloads, c)
    assert v.stat_batches >= 2 and v.stat_lanes < v.stat_batches * B
    assert v.stat_rlc_fallback == 0
    assert got["sv"] == (0, 0) and got["ha"] == (0, 0)


def test_jax_replay_port_verify_jax_sink(tmp_path, clean):
    payloads, c = clean
    topo = jpipe.build_topology(str(tmp_path / "mixed.wksp"), depth=DEPTH)
    jw = jrings.Workspace.join(topo.wksp_path)
    pw = prings.Workspace.join(topo.wksp_path)
    replay = jtiles.ReplayTile(jw, "replay.cnc",
                               out_link=_jax_link(jw, "replay_verify", True),
                               payloads=payloads)
    verify = ptiles.VerifyTile(pw, "verify.cnc",
                               ppipe.in_link(pw, "replay_verify"),
                               ppipe.out_link(pw, "verify_dedup"),
                               batch=B, device="cpu", verify_mode="direct")
    sink = jtiles.SinkTile(jw, "sink.cnc",
                           _jax_link(jw, "verify_dedup", False),
                           record_digests=True)
    _run([replay, verify, sink], replay, verify, sink)
    assert Counter(sink.digests) == _want(payloads, c)
    assert sink.recv_cnt == len(payloads)
    assert verify.stat_batches >= 2
    # The JAX replay's fseq holds the port's verified cursor.
    assert jrings.FSeq(jw, "replay_verify.fseq").query() == len(payloads)


@pytest.mark.parametrize("native_drain", [True, False])
def test_engine_error_propagates(tmp_path, dirty, native_drain):
    topo = ppipe.build_topology(str(tmp_path / "err.wksp"), depth=DEPTH)
    w = prings.Workspace.join(topo.wksp_path)
    replay = ptiles.ReplayTile(w, "replay.cnc",
                               ppipe.out_link(w, "replay_verify"),
                               payloads=dirty[0])
    verify = ptiles.VerifyTile(w, "verify.cnc",
                               ppipe.in_link(w, "replay_verify"),
                               ppipe.out_link(w, "verify_dedup"),
                               batch=B, device="cpu",
                               native_drain=native_drain)
    sink = ptiles.SinkTile(w, "sink.cnc", ppipe.in_link(w, "verify_dedup"))

    def broken(*args):
        raise RuntimeError("engine failed")

    verify._verify_batch_fn = broken
    with pytest.raises(RuntimeError, match="engine failed"):
        _run([replay, verify, sink], replay, verify, sink)
    assert verify.error is not None
    assert verify.out_link.seq == 0 and sink.recv_cnt == 0


def test_resolve_verify_mode():
    rv = pengine.resolve_verify_mode
    assert rv("gpu", "rlc") == "rlc"
    assert rv("gpu", "direct") == "direct"
    assert rv("gpu", "auto") == "direct" == pengine.default_verify_mode()
    assert rv("oracle", "auto") == "direct"
    assert rv("oracle", "direct") == "direct"
    with pytest.raises(ValueError, match="genuinely unsupported"):
        rv("oracle", "rlc")
    with pytest.raises(ValueError, match="unknown verify_mode"):
        rv("gpu", "bogus")
    with pytest.raises(ValueError, match="unknown verify backend"):
        rv("tpu", "direct")


def test_verify_tile_rejects_rlc_on_oracle(tmp_path):
    topo = ppipe.build_topology(str(tmp_path / "o.wksp"), depth=DEPTH)
    w = prings.Workspace.join(topo.wksp_path)
    with pytest.raises(ValueError, match="genuinely unsupported"):
        ptiles.VerifyTile(w, "verify.cnc", ppipe.in_link(w, "replay_verify"),
                          ppipe.out_link(w, "verify_dedup"),
                          backend="oracle", verify_mode="rlc")


def test_engine_spec_for_tile():
    s = pengine.EngineSpec.for_tile("gpu", "rlc", 8192)
    assert s == pengine.EngineSpec("rlc", 8192)
    assert pengine.EngineSpec.for_tile("oracle", "direct", 32).mode == "oracle"


@pytest.mark.parametrize("batch,max_msg_len", [(MAX_SIG_CNT - 1, 1232),
                                               (B, 1231)])
def test_gpu_backend_refuses_narrow_batches(tmp_path, batch, max_msg_len):
    """A txn that parses must fit one batch on the device: the gpu
    backend has no host path to send it to."""
    topo = ppipe.build_topology(str(tmp_path / "n.wksp"), depth=DEPTH)
    w = prings.Workspace.join(topo.wksp_path)
    with pytest.raises(ValueError, match="backend='gpu' needs batch"):
        ptiles.VerifyTile(w, "verify.cnc", ppipe.in_link(w, "replay_verify"),
                          ppipe.out_link(w, "verify_dedup"), batch=batch,
                          max_msg_len=max_msg_len, device="cpu")


@pytest.mark.parametrize("native_drain", [True, False])
def test_flush_verdicts_recorded(tmp_path, native_drain):
    """A partial batch past its deadline flushes as "deadline", one
    starved with the device idle as "starved", and a young one stays."""
    topo = ppipe.build_topology(str(tmp_path / "f.wksp"), depth=DEPTH)
    w = prings.Workspace.join(topo.wksp_path)
    out = ppipe.out_link(w, "replay_verify")
    verify = ptiles.VerifyTile(w, "verify.cnc",
                               ppipe.in_link(w, "replay_verify"),
                               ppipe.out_link(w, "verify_dedup"),
                               batch=B, device="cpu", verify_mode="direct",
                               max_wait_us=80_000_000,
                               native_drain=native_drain)
    lanes = []
    for p, age, starved in ((MAINNET[0], verify.max_wait_ns, False),
                            (MAINNET[1], verify.flush_policy.starve_ns,
                             True)):
        out.publish(p, ptiles.meta_sig(p))
        assert verify.poll_inputs()[0]
        lanes.append(verify._pending_lanes)
        verify._flush_if_due()
        assert verify.stat_batches == len(lanes) - 1  # young: stays staged
        verify._pending_since -= age
        verify._flush_if_due(starved=starved)
        verify._complete(block=True, drain_all=True)
    assert verify.batch_log == [(lanes[0], ptiles.FLUSH_DEADLINE),
                                (lanes[1], ptiles.FLUSH_STARVED)]
    assert verify.stat_flush_timeout == verify.stat_flush_starved == 1
    assert verify.out_link.seq == 2


def test_latencies_ns_past_the_32_bit_wrap():
    """Receipts more than 4.29 s after their publish keep their latency;
    a duplicate payload matches its own publish by tsorig."""
    a, b = MAINNET[0], MAINNET[1]
    t0 = (1 << 40) + 123
    pubs = [t0, t0 + 5_000_000_000, t0 + 6_000_000_000]
    replay = SimpleNamespace(payloads=[a, b, a], pub_ticks=pubs)
    recv = [t0 + 7_000_000_000, pubs[1] + 500, pubs[2] + 90]
    sink = SimpleNamespace(
        digests=[sha256(p).digest() for p in (a, b, a)],
        recv_tsorig=[t & 0xFFFFFFFF for t in pubs], recv_ticks=recv)
    assert list(ptiles.latencies_ns(replay, sink)) == [7_000_000_000, 500, 90]
    sink.recv_tsorig[1] += 1
    with pytest.raises(ValueError, match="matches 0 replay publishes"):
        ptiles.latencies_ns(replay, sink)


def test_device_batch_surface():
    st = torch.tensor([0, -1, 0], dtype=torch.int32)
    out = ptiles._DeviceBatch(st)
    assert out.is_ready()
    assert np.array_equal(np.asarray(out), [0, -1, 0])


@pytest.mark.parametrize("native_drain", [True, False])
def test_ctl_err_and_garbage_filtered(tmp_path, native_drain):
    """Producer-flagged CTL_ERR frags and unparseable payloads count in
    the SV filter slots and reach no engine, on both ingest paths."""
    topo = ppipe.build_topology(str(tmp_path / "ctl.wksp"), depth=DEPTH)
    w = prings.Workspace.join(topo.wksp_path)
    out = ppipe.out_link(w, "replay_verify")
    verify = ptiles.VerifyTile(w, "verify.cnc",
                               ppipe.in_link(w, "replay_verify"),
                               ppipe.out_link(w, "verify_dedup"),
                               batch=B, device="cpu",
                               native_drain=native_drain)
    sink = ptiles.SinkTile(w, "sink.cnc", ppipe.in_link(w, "verify_dedup"))
    err = [MAINNET[0], MAINNET[1]]
    junk = [b"\x00", MAINNET[2][:100]]
    for p in err:
        out.publish(p, ptiles.meta_sig(p), ctl=prings.CTL_ERR | 3)
    for p in junk:
        out.publish(p, ptiles.meta_sig(p))

    def broken(*args):
        raise AssertionError("no batch should reach the engine")

    verify._verify_batch_fn = broken
    replay = ptiles.ReplayTile(w, "replay.cnc", out, payloads=[])
    _run([replay, verify, sink], replay, verify, sink)
    assert verify.stat_ctl_err == 2 and verify.stat_batches == 0
    assert verify.cnc.diag(ptiles.CNC_DIAG_SV_FILT_CNT) == 4
    assert verify.cnc.diag(ptiles.CNC_DIAG_SV_FILT_SZ) == sum(
        len(p) for p in err + junk)
    assert sink.recv_cnt == 0
