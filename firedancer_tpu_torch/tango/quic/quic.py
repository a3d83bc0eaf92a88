"""Top-level QUIC endpoint: connection map, datagram routing, service loop.

Role parity with the reference's src/tango/quic/fd_quic.{h,c}: the object an
aio backend feeds datagrams into (fd_quic_process_packet) and that produces
datagrams out through an aio tx callback, managing server-side connection
creation keyed by destination connection id and driving per-conn timers via
service() (fd_quic_service). Transport is pluggable: anything that can call
`rx()` with (peer_addr, datagram) and accept `tx(peer_addr, datagram)`
callbacks works — UDP sockets (tango/udpsock), in-process paired wires for
tests (the reference's fd_quic_test_helpers virtual pairs), or pcap replay.

The port's copy of ``firedancer_tpu/tango/quic/quic.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import wire
from .conn import CID_LEN, QuicConn


@dataclass
class QuicConfig:
    is_server: bool
    identity_seed: bytes
    alpns: Tuple[bytes, ...] = (b"solana-tpu",)
    idle_timeout: float = 10.0
    max_conns: int = 1024
    initial_max_streams_uni: int = 2048
    # DoS hardening for a public ingest port (RFC 9000 §8):
    # retry=True answers token-less Initials with a stateless Retry —
    # no connection state is allocated until the client echoes a valid
    # address-bound token, so a spoofed-source Initial flood costs the
    # server one small datagram each and zero memory.
    retry: bool = False
    token_lifetime: float = 30.0
    # stateless_reset=True answers short-header datagrams for unknown
    # cids with a Stateless Reset (§10.3), letting peers of a rebooted
    # endpoint tear down dead connections instead of timing out.
    stateless_reset: bool = True
    # Server-side handshake deadline (seconds): a connection that has
    # not completed its handshake within this window is reaped by
    # service() — the half-open-connection flood defense (a spoofed or
    # junk Initial buys an attacker at most hs_timeout of state
    # lifetime, not a full idle_timeout slot). 0 disables.
    hs_timeout: float = 0.0


class Quic:
    """A QUIC endpoint (one server or one client side)."""

    def __init__(
        self,
        cfg: QuicConfig,
        tx: Callable[[object, bytes], None],
        on_stream: Optional[Callable[[QuicConn, int, bytes], None]] = None,
        on_conn_new: Optional[Callable[[QuicConn], None]] = None,
        on_conn_closed: Optional[Callable[[QuicConn], None]] = None,
        on_rx_drop: Optional[Callable[[object], None]] = None,
    ):
        self.cfg = cfg
        self._tx = tx
        self._on_stream = on_stream
        self._on_conn_new = on_conn_new
        self._on_conn_closed = on_conn_closed
        # Peer-attributed drop notification: called with the source
        # address every time an rx datagram is dropped unprocessed
        # (junk, unknown cid, bad token, conn-cap overflow). The quic
        # tile's abuse breaker scores peers on this — the endpoint
        # itself stays policy-free.
        self._on_rx_drop = on_rx_drop
        self._conns_by_cid: Dict[bytes, QuicConn] = {}
        self.conns: List[QuicConn] = []
        # Endpoint-static secrets: the token key binds retry tokens to
        # this endpoint instance; the reset key derives per-cid stateless
        # reset tokens (deterministic, so they survive connection-state
        # loss — the whole point of a stateless reset).
        self._token_key = os.urandom(32)
        self._reset_key = os.urandom(32)
        # Reset handling must stay cheap under junk floods: incoming
        # candidate resets match against an O(1) token index (rebuilt at
        # most once a second — peer tokens arrive asynchronously inside
        # the TLS flight, so the index is a snapshot by design), and
        # outgoing resets are token-bucket limited (RFC 9000 §10.3
        # recommends bounding resets sent).
        self._reset_index: Dict[bytes, QuicConn] = {}
        self._reset_index_at = -1.0
        self._reset_budget = 10.0
        self._reset_budget_at = 0.0
        # metrics (reference: fd_quic_metrics)
        self.metrics = {
            "rx_datagrams": 0,
            "tx_datagrams": 0,
            "conns_created": 0,
            "conns_closed": 0,
            "streams_completed": 0,
            "rx_dropped": 0,
            "retries_sent": 0,
            "tokens_accepted": 0,
            "tokens_rejected": 0,
            "resets_sent": 0,
        }

    # ------------------------------------------------------------- client --

    def connect(self, peer_addr, now: float = 0.0) -> QuicConn:
        if self.cfg.is_server:
            raise ValueError("connect() is a client-endpoint operation")
        conn = QuicConn(
            is_server=False,
            identity_seed=self.cfg.identity_seed,
            peer_addr=peer_addr,
            alpns=self.cfg.alpns,
            idle_timeout=self.cfg.idle_timeout,
            on_stream=None,
            now=now,
        )
        self._register(conn)
        self._flush(conn, now)
        return conn

    # ----------------------------------------------------------------- rx --

    def _drop(self, peer_addr) -> None:
        """Count + attribute one unprocessable rx datagram (every
        rx_dropped increment routes through here so the tile's abuse
        breaker sees the peer address)."""
        self.metrics["rx_dropped"] += 1
        if self._on_rx_drop is not None:
            self._on_rx_drop(peer_addr)

    def rx(self, peer_addr, datagram: bytes, now: float) -> None:
        """Feed one received UDP datagram into the endpoint."""
        self.metrics["rx_datagrams"] += 1
        if not datagram:
            return
        conn = self._route(datagram)
        if conn is None:
            if not wire.is_long_header(datagram[0]):
                # A datagram we cannot associate with any connection:
                # first check whether IT is a stateless reset aimed at
                # one of our conns (RFC 9000 §10.3.1 — a reset carries a
                # random dcid, so it never routes; the endpoint matches
                # the trailing 16 bytes against the token index).
                if len(datagram) >= 21:
                    if now - self._reset_index_at >= 1.0:
                        self._reset_index = {
                            c.peer_reset_token: c for c in self.conns
                            if c.peer_reset_token is not None
                        }
                        self._reset_index_at = now
                    c = self._reset_index.get(datagram[-16:])
                    if c is not None and not c.closed:
                        c.closed = True
                        c.close_reason = "stateless reset"
                        c.stat_stateless_reset += 1
                        self._unregister(c)
                        return
                # Otherwise: short header for a cid we have no state
                # for — answer with a Stateless Reset (§10.3) so the
                # peer can tear down instead of retransmitting into a
                # void. MUST be smaller than what triggered it
                # (§10.3.3, the reset-loop guard), so tiny datagrams
                # get nothing.
                self._maybe_stateless_reset(peer_addr, datagram, now)
                self._drop(peer_addr)
                return
            if not self.cfg.is_server:
                self._drop(peer_addr)
                return
            try:
                hdr = wire.parse_long_header(datagram)
            except wire.QuicWireError:
                self._drop(peer_addr)
                return
            if (
                hdr.pkt_type != wire.PKT_INITIAL
                or hdr.version != wire.QUIC_VERSION_1
                or len(self.conns) >= self.cfg.max_conns
            ):
                self._drop(peer_addr)
                return
            token_odcid = None
            addr_validated = None
            if self.cfg.retry:
                if not hdr.token:
                    # Stateless Retry: bind a token to (address, odcid)
                    # and allocate NOTHING until it comes back.
                    self._tx(peer_addr, wire.encode_retry(
                        dcid=hdr.scid,
                        scid=os.urandom(CID_LEN),
                        token=self._make_token(peer_addr, hdr.dcid, now),
                        odcid=hdr.dcid,
                    ))
                    self.metrics["retries_sent"] += 1
                    self.metrics["tx_datagrams"] += 1
                    return
                token_odcid = self._check_token(hdr.token, peer_addr, now)
                if token_odcid is None:
                    self.metrics["tokens_rejected"] += 1
                    self._drop(peer_addr)
                    return
                self.metrics["tokens_accepted"] += 1
                addr_validated = True
            scid = os.urandom(CID_LEN)
            conn = QuicConn(
                is_server=True,
                identity_seed=self.cfg.identity_seed,
                peer_addr=peer_addr,
                alpns=self.cfg.alpns,
                orig_dcid=hdr.dcid,
                idle_timeout=self.cfg.idle_timeout,
                on_stream=None,
                now=now,
                initial_max_streams_uni=self.cfg.initial_max_streams_uni,
                scid=scid,
                reset_token=(self._reset_token(scid)
                             if self.cfg.stateless_reset else None),
                retry_odcid=token_odcid,
                addr_validated=addr_validated,
            )
            self._register(conn)
            self._conns_by_cid[hdr.dcid] = conn  # route follow-up initials
            if self._on_conn_new is not None:
                self._on_conn_new(conn)
        if not conn.established:
            conn.peer_addr = peer_addr   # pre-handshake address learning
        # Post-handshake address changes are detected INSIDE
        # recv_datagram, after AEAD authentication succeeds and only for
        # the highest-numbered packet (RFC 9000 §9.3) — a spoofed or
        # reordered datagram must not be able to start or clobber a path
        # probe. Traffic keeps flowing to the validated address until
        # the PATH_CHALLENGE round trip completes.
        conn.recv_datagram(datagram, now, from_addr=peer_addr)
        self._flush(conn, now)

    def _route(self, datagram: bytes) -> Optional[QuicConn]:
        if wire.is_long_header(datagram[0]):
            try:
                hdr = wire.parse_long_header(datagram)
            except wire.QuicWireError:
                return None
            return self._conns_by_cid.get(hdr.dcid)
        if 1 + CID_LEN > len(datagram):
            return None
        return self._conns_by_cid.get(datagram[1 : 1 + CID_LEN])

    # ------------------------------------------------------------ service --

    def service(self, now: float) -> None:
        """Drive timers on every connection; reap closed conns — and
        enforce the handshake deadline: a server conn still
        unestablished past cfg.hs_timeout is closed here (half-open
        flood defense; see QuicConfig.hs_timeout)."""
        for conn in list(self.conns):
            if (self.cfg.hs_timeout and self.cfg.is_server
                    and not conn.established and not conn.closed
                    and now - conn.created > self.cfg.hs_timeout):
                conn.closed = True
                conn.close_reason = "handshake timeout"
            for dg in conn.service(now):
                self._tx(conn.peer_addr, dg)
                self.metrics["tx_datagrams"] += 1
            for addr, dg in conn.path_probe_datagrams(now):
                self._tx(addr, dg)
                self.metrics["tx_datagrams"] += 1
            if conn.closed:
                self._unregister(conn)

    # ------------------------------------------------------------ helpers --

    def _reset_token(self, cid: bytes) -> bytes:
        """Deterministic per-cid stateless-reset token (RFC 9000 §10.3.2):
        HMAC of the cid under the endpoint-static reset key, so the token
        can be recomputed with NO per-connection state."""
        import hashlib
        import hmac

        return hmac.new(self._reset_key, b"sr" + cid,
                        hashlib.sha256).digest()[:16]

    def _maybe_stateless_reset(self, peer_addr, datagram: bytes,
                               now: float) -> None:
        if not self.cfg.stateless_reset or len(datagram) < 22:
            return
        # Token bucket (10/s, burst 10): a junk flood must not buy an
        # HMAC + urandom + reflected datagram per packet (§10.3).
        self._reset_budget = min(
            10.0, self._reset_budget + (now - self._reset_budget_at) * 10.0
        )
        self._reset_budget_at = now
        if self._reset_budget < 1.0:
            return
        self._reset_budget -= 1.0
        dcid = datagram[1 : 1 + CID_LEN]
        if len(dcid) < CID_LEN:
            return
        # Strictly smaller than the trigger (reset-loop guard §10.3.3),
        # and bounded so a flood cannot use us as an amplifier.
        size = min(len(datagram) - 1, 64)
        self._tx(peer_addr,
                 wire.encode_stateless_reset(self._reset_token(dcid), size))
        self.metrics["resets_sent"] += 1
        self.metrics["tx_datagrams"] += 1

    def _make_token(self, peer_addr, odcid: bytes, now: float) -> bytes:
        """Retry token: timestamp + odcid, MACed together with the client
        address under the endpoint-static token key (§8.1.3 — address-
        bound, expiring, stateless)."""
        import hashlib
        import hmac
        import struct

        body = struct.pack(">d", now) + bytes([len(odcid)]) + odcid
        mac = hmac.new(self._token_key, repr(peer_addr).encode() + body,
                       hashlib.sha256).digest()[:16]
        return body + mac

    def _check_token(self, token: bytes, peer_addr, now: float):
        """-> the original dcid bound into a valid token, else None."""
        import hashlib
        import hmac
        import struct

        if len(token) < 8 + 1 + 16:
            return None
        body, mac = token[:-16], token[-16:]
        want = hmac.new(self._token_key, repr(peer_addr).encode() + body,
                        hashlib.sha256).digest()[:16]
        if not hmac.compare_digest(mac, want):
            return None
        ts = struct.unpack(">d", body[:8])[0]
        if not (now - self.cfg.token_lifetime <= ts <= now + 1.0):
            return None
        ln = body[8]
        odcid = body[9 : 9 + ln]
        if len(odcid) != ln or len(body) != 9 + ln:
            return None
        return odcid

    def _register(self, conn: QuicConn) -> None:
        self.conns.append(conn)
        self._conns_by_cid[conn.scid] = conn
        self.metrics["conns_created"] += 1
        conn.on_stream = self._make_stream_cb(conn)

    def _make_stream_cb(self, conn: QuicConn):
        def cb(sid: int, data: bytes) -> None:
            self.metrics["streams_completed"] += 1
            if self._on_stream is not None:
                self._on_stream(conn, sid, data)

        return cb

    def _unregister(self, conn: QuicConn) -> None:
        if conn in self.conns:
            self.conns.remove(conn)
            self.metrics["conns_closed"] += 1
            if self._on_conn_closed is not None:
                self._on_conn_closed(conn)
        for cid in [k for k, v in self._conns_by_cid.items() if v is conn]:
            del self._conns_by_cid[cid]

    def _flush(self, conn: QuicConn, now: float) -> None:
        for dg in conn.pending_datagrams(now):
            self._tx(conn.peer_addr, dg)
            self.metrics["tx_datagrams"] += 1
        for addr, dg in conn.path_probe_datagrams(now):
            self._tx(addr, dg)
            self.metrics["tx_datagrams"] += 1
        if conn.closed:
            self._unregister(conn)
