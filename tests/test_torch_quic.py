"""The port's QUIC stack (``firedancer_tpu_torch.tango.quic``) against the
JAX package's, on the CPU.

* The wire: varints, long and short headers, every frame type, transport
  parameters, Retry and path frames encode byte-equal to the JAX
  ``wire`` for fixed inputs, and parse to the same frames.
* Packet protection: the Initial keys of a fixed DCID, then sealed
  packets with header protection, byte-equal to the JAX
  ``crypto_suites`` for fixed keys and packet numbers (RFC 9001 A.2's
  client Initial among them), and the next key generation's.
* Interop both ways: the JAX client completes a handshake with the
  port's server and delivers its streams in order, and the port's
  client does the same with the JAX server, over in-memory wires and
  over localhost UDP.
* The JAX cases of ``tests/test_quic.py`` (handshake, streams, loss
  recovery, RTT/PTO, key update, migration, Retry and token binding,
  the amplification limit, stateless reset, PMTUD) and the handshake
  deadline of ``tests/test_quic_wire_adversarial.py``, run on the port.

QUIC draws connection IDs, keys and tokens from ``os.urandom``, so the
two packages are compared at the wire's encodings of fixed inputs, at
decrypted payloads and at delivered streams, never at the ciphertext of
two random handshakes.
"""

import os

import pytest

from firedancer_tpu.tango.quic import conn as jconn
from firedancer_tpu.tango.quic import crypto_suites as jcs
from firedancer_tpu.tango.quic import quic as jquic
from firedancer_tpu.tango.quic import wire as jwire
from firedancer_tpu_torch.tango.quic import conn as pconn
from firedancer_tpu_torch.tango.quic import crypto_suites as pcs
from firedancer_tpu_torch.tango.quic import quic as pquic
from firedancer_tpu_torch.tango.quic import wire
from firedancer_tpu_torch.tango.quic.conn import (
    TP_INITIAL_MAX_DATA,
    TP_INITIAL_SCID,
    encode_transport_params,
    parse_transport_params,
    tp_varint,
)
from firedancer_tpu_torch.tango.quic.quic import Quic, QuicConfig
from firedancer_tpu_torch.tango.udpsock import UdpSock

WIRES = {"jax": (jwire, jconn, jcs), "port": (wire, pconn, pcs)}


# ------------------------------------------------- the wire against JAX ----


def _frames(w):
    """One of every frame type the wire encodes, for fixed inputs."""
    v = w.varint_encode
    return [
        w.encode_crypto(5, b"hello"),
        w.encode_crypto(70000, bytes(range(200))),
        w.encode_stream(2, 0, b"world", fin=True),
        w.encode_stream(6, 1234, b"x" * 300, fin=False),
        w.encode_ack(100, 3, 10),
        w.encode_ack(2**20, 25, 4, [(1, 2), (7, 0), (300, 17)]),
        bytes([w.FRAME_PING]),
        bytes([w.FRAME_PADDING]) * 7,
        bytes([w.FRAME_HANDSHAKE_DONE]),
        w.encode_conn_close(7, 2, b"bye"),
        w.encode_conn_close(0x101, 0, b"app says no", app=True),
        w.encode_path_frame(w.FRAME_PATH_CHALLENGE, b"ABCDEFGH"),
        w.encode_path_frame(w.FRAME_PATH_RESPONSE, b"12345678"),
        w.encode_simple(w.FRAME_RESET_STREAM, 2, 9, 4096),
        w.encode_simple(w.FRAME_STOP_SENDING, 6, 3),
        w.encode_simple(w.FRAME_MAX_DATA, 1 << 20),
        w.encode_simple(w.FRAME_MAX_STREAM_DATA, 2, 65536),
        w.encode_simple(w.FRAME_MAX_STREAMS_BIDI, 100),
        w.encode_simple(w.FRAME_MAX_STREAMS_UNI, 1 << 30),
        w.encode_simple(w.FRAME_DATA_BLOCKED, 77),
        w.encode_simple(w.FRAME_STREAM_DATA_BLOCKED, 10, 88),
        w.encode_simple(w.FRAME_STREAMS_BLOCKED_BIDI, 5),
        w.encode_simple(w.FRAME_STREAMS_BLOCKED_UNI, 6),
        w.encode_simple(w.FRAME_RETIRE_CONNECTION_ID, 3),
        bytes([w.FRAME_NEW_TOKEN]) + v(5) + b"token",
        bytes([w.FRAME_NEW_CONNECTION_ID]) + v(1) + v(0) + bytes([8])
        + b"C" * 8 + b"R" * 16,
    ]


_ENCODINGS = {
    "varints": lambda w, c, s: b"".join(
        w.varint_encode(x) for x in (0, 1, 63, 64, 16383, 16384, 2**30 - 1,
                                     2**30, 2**62 - 1)),
    "long_initial": lambda w, c, s: w.encode_long_header(
        w.PKT_INITIAL, b"D" * 8, b"S" * 8, pn=7, pn_len=2, payload_len=100,
        token=b"tok"),
    "long_handshake": lambda w, c, s: w.encode_long_header(
        w.PKT_HANDSHAKE, b"d" * 20, b"", pn=0x123456, pn_len=4,
        payload_len=1200),
    "short": lambda w, c, s: w.encode_short_header(b"Q" * 8, 0xABCD, 2),
    "short_key_phase": lambda w, c, s: w.encode_short_header(
        b"Q" * 8, 9, 1, key_phase=1),
    "frames": lambda w, c, s: b"".join(_frames(w)),
    "transport_params": lambda w, c, s: c.encode_transport_params({
        c.TP_INITIAL_MAX_DATA: 12345, c.TP_INITIAL_SCID: b"abcdefgh",
        c.TP_MAX_IDLE_TIMEOUT: 10000, c.TP_MAX_UDP_PAYLOAD: 1452,
        c.TP_INITIAL_MAX_STREAMS_UNI: 1 << 20,
        c.TP_INITIAL_MAX_STREAM_DATA_UNI: 1 << 16,
        c.TP_STATELESS_RESET_TOKEN: b"T" * 16,
        c.TP_ORIGINAL_DCID: b"o" * 8, c.TP_RETRY_SCID: b"r" * 8}),
    "retry": lambda w, c, s: w.encode_retry(b"D" * 8, b"S" * 8,
                                            b"retry-token" * 3, b"O" * 8),
}


@pytest.mark.parametrize("name", sorted(_ENCODINGS))
def test_wire_encodings_byte_equal_to_jax(name):
    fn = _ENCODINGS[name]
    got = fn(*WIRES["port"])
    assert got == fn(*WIRES["jax"])
    assert len(got) > 0


def _frame_tuples(frames):
    return [(f.ftype, dict(f.fields), bytes(f.data), list(f.ack_ranges))
            for f in frames]


def test_frames_parse_as_in_jax():
    buf = b"".join(_frames(wire))
    got = _frame_tuples(wire.parse_frames(buf))
    assert got == _frame_tuples(jwire.parse_frames(buf))
    kinds = {f[0] for f in got}
    assert {wire.FRAME_CRYPTO, wire.FRAME_ACK, wire.FRAME_HANDSHAKE_DONE,
            wire.FRAME_NEW_CONNECTION_ID, wire.FRAME_NEW_TOKEN} <= kinds


@pytest.mark.parametrize("buf", [
    b"\x00" * 3, b"\x1a\x01", b"\x06\x41", b"\xff", b"\x02\x05\x00\x80",
])
def test_truncated_frames_rejected_as_in_jax(buf):
    def outcome(w):
        try:
            return _frame_tuples(w.parse_frames(buf))
        except w.QuicWireError as e:
            return type(e).__name__
    assert outcome(wire) == outcome(jwire)


def test_headers_and_params_parse_as_in_jax():
    hdr = wire.encode_long_header(wire.PKT_INITIAL, b"D" * 8, b"S" * 8,
                                  pn=7, pn_len=2, payload_len=100,
                                  token=b"tok") + bytes(120)
    a, b = wire.parse_long_header(hdr), jwire.parse_long_header(hdr)
    assert (a.pkt_type, a.dcid, a.scid, a.token, a.length) == \
        (b.pkt_type, b.dcid, b.scid, b.token, b.length) == \
        (wire.PKT_INITIAL, b"D" * 8, b"S" * 8, b"tok", 102)
    tp = encode_transport_params({TP_INITIAL_MAX_DATA: 12345,
                                  TP_INITIAL_SCID: b"abcdefgh"})
    parsed = parse_transport_params(tp)
    assert parsed == jconn.parse_transport_params(tp)
    assert tp_varint(parsed, TP_INITIAL_MAX_DATA) == 12345
    assert parsed[TP_INITIAL_SCID] == b"abcdefgh"
    for v in (0, 63, 64, 16384, 2**62 - 1):
        assert wire.varint_decode(wire.varint_encode(v), 0) == \
            jwire.varint_decode(jwire.varint_encode(v), 0)
    with pytest.raises(wire.QuicWireError):
        wire.varint_encode(2**62)
    assert wire.pn_decode(0x9B32, 2, 0xA82F30EA) == 0xA82F9B32  # RFC 9000 A.3
    retry = wire.encode_retry(b"D" * 8, b"S" * 8, b"tok", b"O" * 8)
    assert wire.check_retry(retry, b"O" * 8) == jwire.check_retry(retry,
                                                                 b"O" * 8)
    assert wire.check_retry(retry, b"X" * 8) is None


# --------------------------------------------- packet protection vs JAX ----


def _protect(w, cs, dcid, pn, pn_len, payload, space="client", gen=0):
    ckeys, skeys = cs.initial_secrets(dcid)
    keys = ckeys if space == "client" else skeys
    for _ in range(gen):
        keys = keys.next_generation()
    hdr = w.encode_long_header(w.PKT_INITIAL, dcid, b"", pn=pn,
                               pn_len=pn_len,
                               payload_len=len(payload) + 16)
    return cs.protect_packet(keys, hdr, pn, pn_len, payload), keys, hdr


@pytest.mark.parametrize("space,pn,pn_len,gen", [
    ("client", 2, 4, 0), ("server", 1, 2, 0), ("client", 0x1234, 2, 1),
    ("server", 7, 1, 2)])
def test_packet_protection_byte_equal_to_jax(space, pn, pn_len, gen):
    dcid = bytes.fromhex("8394c8f03e515708")
    payload = bytes([0x06, 0x00, 0x40, 0xF1]) + bytes(range(241)) + bytes(900)
    got, keys, hdr = _protect(wire, pcs, dcid, pn, pn_len, payload, space, gen)
    want, jkeys, _ = _protect(jwire, jcs, dcid, pn, pn_len, payload, space,
                              gen)
    assert got == want
    assert (keys.key, keys.iv, keys.hp) == (jkeys.key, jkeys.iv, jkeys.hp)
    # Unprotect and open: the payload back.
    pkt = bytearray(got)
    pn_off = len(hdr) - pn_len
    plen, tpn = pcs.unprotect_header(keys, pkt, pn_off)
    assert (plen, tpn) == (pn_len, pn & ((1 << (8 * pn_len)) - 1))
    assert keys.open(bytes(pkt[:pn_off + plen]), pn,
                     bytes(pkt[pn_off + plen:])) == payload


def test_rfc9001_a2_client_initial_keys():
    """RFC 9001 A.1's client Initial key, iv and hp from the DCID."""
    ckeys, skeys = pcs.initial_secrets(bytes.fromhex("8394c8f03e515708"))
    assert ckeys.key == bytes.fromhex("1f369613dd76d5467730efcbe3b1a22d")
    assert ckeys.iv == bytes.fromhex("fa044b2f42a3fd3b46fb255c")
    assert ckeys.hp == bytes.fromhex("9f50449e04a0e810283a1e9933adedd2")
    assert skeys.key == bytes.fromhex("cf3a5331653c364c88f0f379b6067e37")


# ------------------------------------------------------- interop with JAX ----


def _cross(client_mod, server_mod, received):
    c2s, s2c = [], []
    client = client_mod.Quic(
        client_mod.QuicConfig(is_server=False, identity_seed=os.urandom(32)),
        tx=lambda a, d: c2s.append(d))
    server = server_mod.Quic(
        server_mod.QuicConfig(is_server=True, identity_seed=os.urandom(32)),
        tx=lambda a, d: s2c.append(d),
        on_stream=lambda conn, sid, data: received.append((sid, data)))
    return client, server, c2s, s2c


@pytest.mark.parametrize("client_mod,server_mod", [
    (jquic, pquic), (pquic, jquic)], ids=["jax_client-port_server",
                                          "port_client-jax_server"])
def test_interop_handshake_and_streams_in_order(client_mod, server_mod):
    received = []
    client, server, c2s, s2c = _cross(client_mod, server_mod, received)
    conn = client.connect(("srv", 1), 0.0)
    now = _pump(client, server, conn, c2s, s2c, 0.0, steps=8)
    assert conn.established
    assert len(server.conns) == 1 and server.conns[0].established
    assert server.conns[0].tls.alpn == b"solana-tpu"
    payloads = [os.urandom(40 + 53 * i) for i in range(12)] + [
        os.urandom(5000)]
    for p in payloads:
        conn.send_stream(p)
    client.service(now)
    _pump(client, server, conn, c2s, s2c, now, steps=10)
    assert [d for _, d in received] == payloads
    assert [sid for sid, _ in received] == [2 + 4 * i
                                            for i in range(len(payloads))]


@pytest.mark.parametrize("client_mod,server_mod", [
    (jquic, pquic), (pquic, jquic)], ids=["jax_client-port_server",
                                          "port_client-jax_server"])
def test_interop_over_udp(client_mod, server_mod):
    import time

    received = []
    srv_sock, cli_sock = UdpSock(), UdpSock()
    srv_tx, cli_tx = srv_sock.aio_tx(), cli_sock.aio_tx()
    server = server_mod.Quic(
        server_mod.QuicConfig(is_server=True, identity_seed=os.urandom(32)),
        tx=lambda addr, d: srv_tx.send_one(addr, d),
        on_stream=lambda conn, sid, data: received.append(data))
    client = client_mod.Quic(
        client_mod.QuicConfig(is_server=False, identity_seed=os.urandom(32)),
        tx=lambda addr, d: cli_tx.send_one(addr, d))
    conn = client.connect(srv_sock.local_addr, 0.0)
    payloads = [os.urandom(300 + i) for i in range(16)]
    t0 = time.monotonic()
    sent = False
    try:
        while time.monotonic() - t0 < 10.0:
            now = time.monotonic() - t0
            srv_sock.service_rx(lambda addr, d: server.rx(addr, d, now))
            cli_sock.service_rx(lambda addr, d: client.rx(addr, d, now))
            client.service(now)
            server.service(now)
            if conn.established and not sent:
                for p in payloads:
                    conn.send_stream(p)
                sent = True
            if len(received) == len(payloads):
                break
    finally:
        srv_sock.close()
        cli_sock.close()
    assert received == payloads


# ------------------------------------------------------------ handshake ----

def _pump(client, server, conn, c2s, s2c, now, steps=10, step=0.01):
    for _ in range(steps):
        now += step
        while c2s:
            server.rx(("cli", 1), c2s.pop(0), now)
        while s2c:
            client.rx(("srv", 1), s2c.pop(0), now)
        client.service(now)
        server.service(now)
    return now


def _mk_pair(received, drop=None):
    c2s, s2c = [], []

    def tx_c(a, d):
        if drop is None or not drop(d):
            c2s.append(d)

    client = Quic(
        QuicConfig(is_server=False, identity_seed=os.urandom(32)), tx=tx_c
    )
    server = Quic(
        QuicConfig(is_server=True, identity_seed=os.urandom(32)),
        tx=lambda a, d: s2c.append(d),
        on_stream=lambda conn, sid, data: received.append((sid, data)),
    )
    return client, server, c2s, s2c


def test_handshake_and_streams():
    received = []
    client, server, c2s, s2c = _mk_pair(received)
    conn = client.connect(("srv", 1), 0.0)
    now = _pump(client, server, conn, c2s, s2c, 0.0, steps=8)
    assert conn.established
    assert len(server.conns) == 1 and server.conns[0].established
    assert server.conns[0].tls.alpn == b"solana-tpu"

    payloads = [os.urandom(50 + 37 * i) for i in range(8)]
    for p in payloads:
        conn.send_stream(p)
    client.service(now)
    _pump(client, server, conn, c2s, s2c, now, steps=6)
    got = {d for _, d in received}
    assert got == set(payloads)
    # uni stream ids are client-initiated: id % 4 == 2
    assert all(sid % 4 == 2 for sid, _ in received)


def test_multi_packet_stream():
    received = []
    client, server, c2s, s2c = _mk_pair(received)
    conn = client.connect(("srv", 1), 0.0)
    now = _pump(client, server, conn, c2s, s2c, 0.0, steps=8)
    big = os.urandom(5000)
    conn.send_stream(big)
    client.service(now)
    _pump(client, server, conn, c2s, s2c, now, steps=8)
    assert received and received[-1][1] == big


def test_loss_recovery():
    """Drop every 3rd client datagram after the handshake: PTO retransmit
    must still deliver every stream."""
    received = []
    state = {"n": 0, "arm": False}

    def drop(d):
        if not state["arm"]:
            return False
        state["n"] += 1
        return state["n"] % 3 == 0

    client, server, c2s, s2c = _mk_pair(received, drop=drop)
    conn = client.connect(("srv", 1), 0.0)
    now = _pump(client, server, conn, c2s, s2c, 0.0, steps=8)
    assert conn.established
    state["arm"] = True
    payloads = [os.urandom(200 + i) for i in range(10)]
    for p in payloads:
        conn.send_stream(p)
    client.service(now)
    # pump with time steps > PTO so retransmission fires
    for _ in range(12):
        now += 0.3
        while c2s:
            server.rx(("cli", 1), c2s.pop(0), now)
        while s2c:
            client.rx(("srv", 1), s2c.pop(0), now)
        client.service(now)
        server.service(now)
    assert {d for _, d in received} == set(payloads)


def test_alpn_mismatch_rejected():
    c2s, s2c = [], []
    client = Quic(
        QuicConfig(
            is_server=False, identity_seed=os.urandom(32), alpns=(b"other",)
        ),
        tx=lambda a, d: c2s.append(d),
    )
    server = Quic(
        QuicConfig(is_server=True, identity_seed=os.urandom(32)),
        tx=lambda a, d: s2c.append(d),
    )
    conn = client.connect(("srv", 1), 0.0)
    now = 0.0
    for _ in range(6):
        now += 0.01
        while c2s:
            server.rx(("cli", 1), c2s.pop(0), now)
        while s2c:
            client.rx(("srv", 1), s2c.pop(0), now)
        client.service(now)
        server.service(now)
    assert not conn.established
    assert len(server.conns) == 0  # server refused the conn


def test_idle_timeout():
    received = []
    client, server, c2s, s2c = _mk_pair(received)
    conn = client.connect(("srv", 1), 0.0)
    now = _pump(client, server, conn, c2s, s2c, 0.0, steps=8)
    assert len(server.conns) == 1
    server.service(now + 60.0)
    assert len(server.conns) == 0


def test_garbage_datagrams_ignored():
    received = []
    client, server, c2s, s2c = _mk_pair(received)
    server.rx(("x", 1), b"\x00" * 30, 0.0)
    server.rx(("x", 1), os.urandom(100), 0.0)
    server.rx(("x", 1), b"", 0.0)
    assert len(server.conns) <= 1  # random long-header bytes may create at
    # most a stillborn conn; no crash is the contract here
    conn = client.connect(("srv", 1), 0.0)
    now = _pump(client, server, conn, c2s, s2c, 0.0, steps=8)
    assert conn.established


# ------------------------------------------------------------- UDP sock ----

def test_quic_over_udpsock():
    """Full handshake + txn streams over real localhost UDP sockets."""
    import time

    from firedancer_tpu_torch.tango.udpsock import UdpSock

    received = []
    srv_sock = UdpSock()
    cli_sock = UdpSock()
    server = Quic(
        QuicConfig(is_server=True, identity_seed=os.urandom(32)),
        tx=lambda addr, d: srv_sock.aio_tx().send_one(addr, d),
        on_stream=lambda conn, sid, data: received.append(data),
    )
    client = Quic(
        QuicConfig(is_server=False, identity_seed=os.urandom(32)),
        tx=lambda addr, d: cli_sock.aio_tx().send_one(addr, d),
    )
    conn = client.connect(srv_sock.local_addr, 0.0)
    t0 = time.monotonic()
    payloads = [os.urandom(300) for _ in range(4)]
    sent = False
    while time.monotonic() - t0 < 5.0:
        now = time.monotonic() - t0
        srv_sock.service_rx(lambda addr, d: server.rx(addr, d, now))
        cli_sock.service_rx(lambda addr, d: client.rx(addr, d, now))
        client.service(now)
        server.service(now)
        if conn.established and not sent:
            for p in payloads:
                conn.send_stream(p)
            sent = True
        if len(received) == len(payloads):
            break
    srv_sock.close()
    cli_sock.close()
    assert conn.established
    assert set(received) == set(payloads)


def test_rtt_estimator_rfc9002():
    from firedancer_tpu_torch.tango.quic.conn import RttEstimator

    est = RttEstimator(initial_rtt=0.125)
    # No samples: PTO = 2 * initial_rtt, doubling per probe event.
    assert est.pto() == pytest.approx(0.25)
    est.pto_count = 2
    assert est.pto() == pytest.approx(1.0)
    est.pto_count = 0

    # First sample initializes srtt/rttvar/min_rtt (RFC 9002 section 5.3).
    est.on_sample(0.100)
    assert est.smoothed_rtt == pytest.approx(0.100)
    assert est.rttvar == pytest.approx(0.050)
    assert est.min_rtt == pytest.approx(0.100)

    # Steady samples converge srtt and shrink rttvar.
    for _ in range(50):
        est.on_sample(0.100)
    assert est.smoothed_rtt == pytest.approx(0.100, abs=1e-6)
    assert est.rttvar < 0.001
    # PTO tracks srtt + 4*rttvar + max_ack_delay.
    assert 0.100 < est.pto() < 0.150

    # ack_delay is subtracted only when it keeps the sample >= min_rtt.
    est.on_sample(0.200, ack_delay=0.050)
    assert est.latest_rtt == pytest.approx(0.200)
    assert est.smoothed_rtt < 0.110  # adjusted sample 0.150 pulled in slowly

    # A sample resets the PTO backoff.
    est.pto_count = 3
    est.on_sample(0.100)
    assert est.pto_count == 0


def test_rtt_adapts_pto_to_wire_latency():
    """On a slow virtual wire the estimator must learn the RTT, so the
    PTO ends up latency-proportional instead of the old fixed 0.25 s."""
    received = []
    client, server, c2s, s2c = _mk_pair(received)
    conn = client.connect(("srv", 1), 0.0)
    # Pump with 50 ms one-way latency: deliver datagrams half a step late.
    now = 0.0
    for _ in range(12):
        now += 0.05
        while c2s:
            server.rx(("cli", 1), c2s.pop(0), now)
        while s2c:
            client.rx(("srv", 1), s2c.pop(0), now)
        client.service(now)
        server.service(now)
    assert conn.established
    conn.send_stream(b"ping")
    client.service(now)
    for _ in range(6):
        now += 0.05
        while c2s:
            server.rx(("cli", 1), c2s.pop(0), now)
        while s2c:
            client.rx(("srv", 1), s2c.pop(0), now)
        client.service(now)
        server.service(now)
    assert conn.rtt.smoothed_rtt is not None
    # Observed RTT ~= one pump step (50-100 ms with ack scheduling).
    assert 0.01 < conn.rtt.smoothed_rtt < 0.3
    assert conn.rtt.pto() < 1.0


def test_packet_threshold_fast_retransmit():
    """A packet 3+ below largest_acked is retransmitted immediately on ACK
    receipt (RFC 9002 section 6.1.1), without waiting out a PTO."""
    received = []
    state = {"drop_next": False, "dropped": 0}

    def drop(d):
        if state["drop_next"]:
            state["drop_next"] = False
            state["dropped"] += 1
            return True
        return False

    client, server, c2s, s2c = _mk_pair(received, drop=drop)
    conn = client.connect(("srv", 1), 0.0)
    now = _pump(client, server, conn, c2s, s2c, 0.0, steps=8)
    assert conn.established
    # Lose exactly one stream packet, then send several more so the acks
    # advance largest_acked past the hole.
    state["drop_next"] = True
    lost = os.urandom(64)
    conn.send_stream(lost)
    client.service(now)
    later = [os.urandom(64) for _ in range(5)]
    for p in later:
        conn.send_stream(p)
        client.service(now)
    # Pump with TINY time steps (never reaching a PTO of ~0.25 s): only
    # the packet-threshold path can recover the hole.
    for _ in range(10):
        now += 0.001
        while c2s:
            server.rx(("cli", 1), c2s.pop(0), now)
        while s2c:
            client.rx(("srv", 1), s2c.pop(0), now)
        client.service(now)
        server.service(now)
    assert state["dropped"] == 1
    assert {d for _, d in received} >= set(later) | {lost}


def test_key_update():
    """RFC 9001 §6: initiator rolls send keys + Key Phase bit; the peer
    detects the flip, installs the next generation both ways, and data
    keeps flowing in both directions (and again after a second update).
    Header-protection keys never rotate."""
    received = []
    client, server, c2s, s2c = _mk_pair(received)
    conn = client.connect(("srv", 1), 0.0)
    now = _pump(client, server, conn, c2s, s2c, 0.0, steps=8)
    assert conn.established
    sconn = server.conns[0]

    from firedancer_tpu_torch.tango.quic.conn import LEVEL_APP

    hp_before = conn.spaces[LEVEL_APP].keys_tx.hp
    key_before = conn.spaces[LEVEL_APP].keys_tx.key

    p1 = os.urandom(64)
    conn.send_stream(p1)
    _pump(client, server, conn, c2s, s2c, now, steps=4)
    assert any(d == p1 for _, d in received)

    conn.initiate_key_update()
    assert conn.tx_key_phase == 1
    assert conn.spaces[LEVEL_APP].keys_tx.key != key_before
    assert conn.spaces[LEVEL_APP].keys_tx.hp == hp_before  # hp is stable
    # §6.2: a second update before the peer answers MUST be refused —
    # it would silently desynchronize the key generations.
    import pytest as _pytest

    with _pytest.raises(RuntimeError):
        conn.initiate_key_update()

    p2 = os.urandom(64)
    conn.send_stream(p2)
    now = _pump(client, server, conn, c2s, s2c, now, steps=6)
    assert any(d == p2 for _, d in received)
    # Server detected the flip and answered in the new phase.
    assert sconn.rx_key_phase == 1 and sconn.tx_key_phase == 1
    assert sconn.stat_key_updates >= 1
    # Client keeps receiving the server's new-phase packets (acks flowed),
    # and a second update also survives.
    conn.initiate_key_update()
    p3 = os.urandom(64)
    conn.send_stream(p3)
    now = _pump(client, server, conn, c2s, s2c, now, steps=6)
    assert any(d == p3 for _, d in received)
    assert sconn.rx_key_phase == 0 and conn.tx_key_phase == 0


def test_connection_migration():
    """RFC 9000 §9: when the client's source address changes after the
    handshake, the server probes the new path with PATH_CHALLENGE and
    only adopts it once the response round trip succeeds; data keeps
    flowing throughout. An address change with no valid responder (a
    spoofed source) must NOT redirect the connection."""
    received = []
    c2s, s2c = [], []
    client_addr = ["cli-A"]  # mutable: models a NAT rebind mid-flight

    def tx_c(a, d):
        c2s.append((client_addr[0], d))

    server_tx = []

    def tx_s(a, d):
        server_tx.append((a, d))
        # deliver only what is addressed to the client's CURRENT address
        if a == client_addr[0]:
            s2c.append(d)

    client = Quic(
        QuicConfig(is_server=False, identity_seed=os.urandom(32)), tx=tx_c
    )
    server = Quic(
        QuicConfig(is_server=True, identity_seed=os.urandom(32)),
        tx=tx_s,
        on_stream=lambda conn, sid, data: received.append((sid, data)),
    )

    def pump(now, steps=8, step=0.01):
        for _ in range(steps):
            now += step
            while c2s:
                a, d = c2s.pop(0)
                server.rx(a, d, now)
            while s2c:
                client.rx(("srv", 1), s2c.pop(0), now)
            client.service(now)
            server.service(now)
        return now

    conn = client.connect(("srv", 1), 0.0)
    now = pump(0.0)
    assert conn.established
    sconn = server.conns[0]
    assert sconn.peer_addr == "cli-A"

    # NAT rebind: same connection, new source address.
    client_addr[0] = "cli-B"
    p = os.urandom(40)
    conn.send_stream(p)
    client.service(now)
    now = pump(now, steps=10)
    assert any(d == p for _, d in received)
    # The server probed cli-B and migrated only after validation.
    assert sconn.stat_migrations == 1
    assert sconn.peer_addr == "cli-B"
    assert any(a == "cli-B" for a, _ in server_tx)

    # Spoof attempt: traffic claiming to come from an address that never
    # answers the challenge must not move the connection.
    p2 = os.urandom(40)
    conn.send_stream(p2)
    client.service(now)
    while c2s:
        a, d = c2s.pop(0)
        server.rx("evil", d, now)  # replayed from a spoofed source
    now = pump(now, steps=10)
    assert sconn.peer_addr == "cli-B"  # probe to "evil" never validated


# ------------------------------------------------- DoS hardening (§8) ------

def test_retry_handshake_completes():
    """retry=True: first Initial gets a stateless Retry; the client echoes
    the token and the handshake completes with the address pre-validated."""
    received = []
    c2s, s2c = [], []
    client = Quic(
        QuicConfig(is_server=False, identity_seed=os.urandom(32)),
        tx=lambda a, d: c2s.append(d),
    )
    server = Quic(
        QuicConfig(is_server=True, identity_seed=os.urandom(32), retry=True),
        tx=lambda a, d: s2c.append(d),
        on_stream=lambda conn, sid, data: received.append((sid, data)),
    )
    conn = client.connect(("srv", 1), 0.0)
    now = _pump(client, server, conn, c2s, s2c, 0.0, steps=10)
    assert conn.established
    assert conn.stat_retries == 1
    assert server.metrics["retries_sent"] == 1
    assert server.metrics["tokens_accepted"] == 1
    assert len(server.conns) == 1
    assert server.conns[0].addr_validated
    conn.send_stream(b"post-retry txn")
    client.service(now)
    _pump(client, server, conn, c2s, s2c, now, steps=6)
    assert received and received[0][1] == b"post-retry txn"


def test_retry_flood_allocates_no_state():
    """A spoofed-source Initial flood against a retry server allocates
    ZERO connection state and costs one small Retry datagram each."""
    sent = []
    server = Quic(
        QuicConfig(is_server=True, identity_seed=os.urandom(32), retry=True),
        tx=lambda a, d: sent.append((a, d)),
    )
    # One real client Initial datagram, replayed from many spoofed addrs.
    probe = []
    client = Quic(
        QuicConfig(is_server=False, identity_seed=os.urandom(32)),
        tx=lambda a, d: probe.append(d),
    )
    client.connect(("srv", 1), 0.0)
    initial = probe[0]
    for i in range(100):
        server.rx(("spoofed", i), initial, now=0.001 * i)
    assert len(server.conns) == 0
    assert server.metrics["retries_sent"] == 100
    # Bounded reflection: each response is far below the 1200B trigger.
    assert all(len(d) < 200 for _, d in sent)


def test_retry_token_is_address_bound():
    """A token minted for one address must not validate from another
    (anti-spoofing: the token proves the Retry round trip)."""
    c2s, s2c = [], []
    client = Quic(
        QuicConfig(is_server=False, identity_seed=os.urandom(32)),
        tx=lambda a, d: c2s.append(d),
    )
    server = Quic(
        QuicConfig(is_server=True, identity_seed=os.urandom(32), retry=True),
        tx=lambda a, d: s2c.append(d),
    )
    conn = client.connect(("srv", 1), 0.0)
    # Initial -> Retry
    server.rx(("cli", 1), c2s.pop(0), 0.0)
    client.rx(("srv", 1), s2c.pop(0), 0.01)
    client.service(0.01)
    assert conn.stat_retries == 1
    tokened_initial = c2s.pop(0)
    # Replay the tokened Initial from a different (spoofed) source.
    server.rx(("evil", 666), tokened_initial, 0.02)
    assert server.metrics["tokens_rejected"] == 1
    assert len(server.conns) == 0
    # From the real address it is accepted.
    server.rx(("cli", 1), tokened_initial, 0.02)
    assert server.metrics["tokens_accepted"] == 1
    assert len(server.conns) == 1


def test_retry_token_expires():
    c2s, s2c = [], []
    client = Quic(
        QuicConfig(is_server=False, identity_seed=os.urandom(32)),
        tx=lambda a, d: c2s.append(d),
    )
    server = Quic(
        QuicConfig(is_server=True, identity_seed=os.urandom(32), retry=True,
                   token_lifetime=5.0),
        tx=lambda a, d: s2c.append(d),
    )
    conn = client.connect(("srv", 1), 0.0)
    server.rx(("cli", 1), c2s.pop(0), 0.0)
    client.rx(("srv", 1), s2c.pop(0), 0.01)
    client.service(0.01)
    assert conn.stat_retries == 1
    stale = c2s.pop(0)
    server.rx(("cli", 1), stale, 100.0)  # long past token_lifetime
    assert server.metrics["tokens_rejected"] == 1
    assert len(server.conns) == 0


def test_forged_retry_rejected():
    """A Retry whose integrity tag is not keyed to the client's original
    dcid (off-path forgery) must be ignored."""
    c2s, s2c = [], []
    client = Quic(
        QuicConfig(is_server=False, identity_seed=os.urandom(32)),
        tx=lambda a, d: c2s.append(d),
    )
    conn = client.connect(("srv", 1), 0.0)
    forged = wire.encode_retry(
        dcid=conn.scid, scid=b"EVILCID1", token=b"evil-token",
        odcid=b"WRONGDCID",  # forger does not know the real odcid binding
    )
    client.rx(("srv", 1), forged, 0.01)
    assert conn.stat_retries == 0
    assert conn.dcid != b"EVILCID1"


def test_amplification_limit_pre_validation():
    """Until the client's address is validated, the server sends at most
    3x the bytes it received — even across PTO retransmissions."""
    c2s, s2c = [], []
    srv_bytes = []
    client = Quic(
        QuicConfig(is_server=False, identity_seed=os.urandom(32)),
        tx=lambda a, d: c2s.append(d),
    )
    server = Quic(
        QuicConfig(is_server=True, identity_seed=os.urandom(32)),
        tx=lambda a, d: (s2c.append(d), srv_bytes.append(len(d))),
    )
    conn = client.connect(("srv", 1), 0.0)
    rx_bytes = sum(len(d) for d in c2s)
    while c2s:
        server.rx(("cli", 1), c2s.pop(0), 0.0)
    # Starve the server of further client traffic; let its timers fire
    # (staying inside the idle timeout so the conn survives to finish).
    now = 0.0
    for _ in range(16):
        now += 0.5
        server.service(now)
    assert sum(srv_bytes) <= 3 * rx_bytes
    assert server.conns and server.conns[0].stat_amp_blocked > 0
    assert not server.conns[0].addr_validated
    # The handshake still completes once the client talks again.
    now = _pump(client, server, conn, c2s, s2c, now, steps=10)
    assert conn.established
    assert server.conns[0].addr_validated


def test_stateless_reset_tears_down_connection():
    """A 'rebooted' endpoint (same static reset key, no conn state)
    answers the client's traffic with a Stateless Reset; the client must
    recognize the token from the old server's transport params and close
    instead of retransmitting forever."""
    received = []
    client, server, c2s, s2c = _mk_pair(received)
    conn = client.connect(("srv", 1), 0.0)
    now = _pump(client, server, conn, c2s, s2c, 0.0, steps=8)
    assert conn.established
    assert conn.peer_reset_token is not None
    # Reboot: fresh endpoint, SAME static reset key, zero conn state.
    reborn = Quic(
        QuicConfig(is_server=True, identity_seed=os.urandom(32)),
        tx=lambda a, d: s2c.append(d),
    )
    reborn._reset_key = server._reset_key
    conn.send_stream(b"into the void")
    client.service(now)
    while c2s:
        reborn.rx(("cli", 1), c2s.pop(0), now)
    assert reborn.metrics["resets_sent"] >= 1
    while s2c:
        client.rx(("srv", 1), s2c.pop(0), now)
    assert conn.closed
    assert conn.close_reason == "stateless reset"
    assert conn.stat_stateless_reset == 1


def test_fake_stateless_reset_ignored():
    """An off-path attacker without the reset key cannot kill the conn:
    a garbage 'reset' with the wrong token is just an undecryptable
    datagram."""
    received = []
    client, server, c2s, s2c = _mk_pair(received)
    conn = client.connect(("srv", 1), 0.0)
    now = _pump(client, server, conn, c2s, s2c, 0.0, steps=8)
    assert conn.established
    fake = wire.encode_stateless_reset(os.urandom(16), 48)
    client.rx(("srv", 1), fake, now)
    assert not conn.closed
    assert conn.stat_stateless_reset == 0


def test_time_threshold_loss_detection():
    """One lost packet with too small a flight for the 3-packet
    threshold: the time threshold (9/8 rtt) must retransmit it without
    waiting out a full PTO backoff."""
    received = []
    state = {"arm": False, "dropped": 0}

    def drop(d):
        if state["arm"] and state["dropped"] == 0:
            state["dropped"] += 1
            return True
        return False

    client, server, c2s, s2c = _mk_pair(received, drop=drop)
    conn = client.connect(("srv", 1), 0.0)
    now = _pump(client, server, conn, c2s, s2c, 0.0, steps=8)
    assert conn.established
    state["arm"] = True
    conn.send_stream(b"lost-on-first-tx")
    client.service(now)          # dropped datagram
    state["arm"] = False
    conn.send_stream(b"second")  # separate later packet, acked normally
    client.service(now + 0.002)
    # Pump with steps far below the PTO; only the time threshold can
    # declare the first packet lost (pn gap is 1, not 3).
    pto0 = conn.rtt.pto()
    for _ in range(40):
        now += 0.02
        while c2s:
            server.rx(("cli", 1), c2s.pop(0), now)
        while s2c:
            client.rx(("srv", 1), s2c.pop(0), now)
        client.service(now)
        server.service(now)
        if {d for _, d in received} >= {b"lost-on-first-tx", b"second"}:
            break
    assert {d for _, d in received} >= {b"lost-on-first-tx", b"second"}
    assert conn.rtt.pto_count == 0 or conn.rtt.pto() <= pto0  # no PTO storm


def test_inflight_path_probe_not_clobbered():
    """RFC 9000 §9.3 + round-2 ADVICE: while a PATH_CHALLENGE is in
    flight, packets racing in from other (possibly spoofed) addresses
    must not replace the probe."""
    received = []
    client, server, c2s, s2c = _mk_pair(received)
    conn = client.connect(("srv", 1), 0.0)
    now = _pump(client, server, conn, c2s, s2c, 0.0, steps=8)
    srv_conn = server.conns[0]
    assert srv_conn.established
    # Client migrates: same datagrams, new source address.
    conn.send_stream(b"after-rebind")
    client.service(now)
    dg = c2s.pop(0)
    server.rx(("cli-rebind", 2), dg, now)
    assert srv_conn._probe_addr == ("cli-rebind", 2)
    probe_data = srv_conn._probe_data
    # Attacker races a copy of a later genuine datagram from a spoofed
    # source before the probe completes.
    conn.send_stream(b"second")
    client.service(now + 0.001)
    dg2 = c2s.pop(0)
    server.rx(("spoof", 99), dg2, now + 0.001)
    assert srv_conn._probe_addr == ("cli-rebind", 2)   # unchanged
    assert srv_conn._probe_data == probe_data          # same challenge


def test_pmtud_raises_datagram_budget():
    """DPLPMTUD over lossless in-memory wires: both sides should walk
    the probe ladder to 1452 and raise their datagram budget."""
    received = []
    client, server, c2s, s2c = _mk_pair(received)
    conn = client.connect(("srv", 1), 0.0)
    now = _pump(client, server, conn, c2s, s2c, 0.0, steps=8)
    assert conn.established
    now = _pump(client, server, conn, c2s, s2c, now, steps=12)
    assert conn.max_datagram == 1452
    assert server.conns[0].max_datagram == 1452
    assert conn.stat_pmtu_probes >= 2  # 1350 then 1452


def test_pmtud_blackhole_keeps_conservative_budget():
    """Probes above 1200 are blackholed: the search must END at the
    conservative default (lost probes are answers, not retransmits) and
    normal traffic must keep flowing."""
    received = []

    def drop(d):
        return len(d) > 1200

    client, server, c2s, s2c = _mk_pair(received, drop=drop)
    conn = client.connect(("srv", 1), 0.0)
    now = _pump(client, server, conn, c2s, s2c, 0.0, steps=8)
    assert conn.established
    # Pump past several PTOs so the lost probe is declared.
    for _ in range(10):
        now += 0.4
        while c2s:
            server.rx(("cli", 1), c2s.pop(0), now)
        while s2c:
            client.rx(("srv", 1), s2c.pop(0), now)
        client.service(now)
        server.service(now)
    assert conn.max_datagram == 1200
    assert conn._pmtu_done
    conn.send_stream(b"still-works")
    client.service(now)
    _pump(client, server, conn, c2s, s2c, now, steps=4)
    assert received and received[-1][1] == b"still-works"


# ------------------------------------- the handshake deadline (adversarial) ----

def test_handshake_deadline_reaps_half_open_conns():
    """A garbage Initial allocates a conn that can never complete its
    handshake; the hs_timeout reaper must retire it (the half-open
    flood defense the quic_conn_churn chaos class audits)."""
    server = Quic(QuicConfig(is_server=True, identity_seed=b"\x01" * 32,
                             hs_timeout=0.5),
                  tx=lambda a, d: None)
    hdr = wire.encode_long_header(wire.PKT_INITIAL, b"Z" * 8, b"S" * 8,
                                  pn=0, pn_len=2, payload_len=48)
    server.rx(("atk", 9), hdr + os.urandom(48), now=0.0)
    assert len(server.conns) == 1 and not server.conns[0].established
    server.service(0.2)
    assert len(server.conns) == 1   # inside the deadline: kept
    server.service(0.6)
    assert len(server.conns) == 0   # past it: reaped
    assert server.metrics["conns_closed"] == 1
