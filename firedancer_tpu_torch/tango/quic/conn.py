"""QUIC connection state machine: packet numbers, ACKs, CRYPTO + streams.

Role parity with the reference's src/tango/quic/fd_quic_conn.{h,c},
fd_quic_stream.*, and the ack/loss tracking of fd_quic_pkt_meta.*: three
packet-number spaces (initial/handshake/app) each with their own keys, ACK
range tracking, CRYPTO-stream reassembly feeding the TLS engine, stream
reassembly delivering completed unidirectional streams (one Solana txn per
stream, the TPU convention), simple PTO-style retransmission, and datagram
assembly with long-header coalescing + client-Initial padding.

The port's copy of ``firedancer_tpu/tango/quic/conn.py``.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import wire
from .crypto_suites import (
    AEAD_OVERHEAD,
    PacketKeys,
    QuicCryptoError,
    initial_secrets,
    protect_packet,
    unprotect_header,
)
from .tls import (
    LEVEL_APP,
    LEVEL_HANDSHAKE,
    LEVEL_INITIAL,
    TlsConfig,
    TlsEndpoint,
    TlsError,
)

MAX_DATAGRAM = 1200  # conservative pre-PMTUD budget (RFC 9000 §14.1)
CID_LEN = 8

# transport parameter ids (RFC 9000 §18.2)
TP_ORIGINAL_DCID = 0x00
TP_MAX_IDLE_TIMEOUT = 0x01
TP_MAX_UDP_PAYLOAD = 0x03
TP_INITIAL_MAX_DATA = 0x04
TP_INITIAL_MAX_STREAM_DATA_BIDI_LOCAL = 0x05
TP_INITIAL_MAX_STREAM_DATA_BIDI_REMOTE = 0x06
TP_INITIAL_MAX_STREAM_DATA_UNI = 0x07
TP_INITIAL_MAX_STREAMS_BIDI = 0x08
TP_INITIAL_MAX_STREAMS_UNI = 0x09
TP_INITIAL_SCID = 0x0F
TP_STATELESS_RESET_TOKEN = 0x02
TP_RETRY_SCID = 0x10

# RFC 9000 §8.1: a server may send at most 3x the bytes received from an
# address it has not yet validated (anti-amplification limit).
AMP_LIMIT = 3

_LEVEL_TO_PKT = {
    LEVEL_INITIAL: wire.PKT_INITIAL,
    LEVEL_HANDSHAKE: wire.PKT_HANDSHAKE,
}


def encode_transport_params(params: Dict[int, object]) -> bytes:
    out = bytearray()
    for tid, val in params.items():
        out += wire.varint_encode(tid)
        if isinstance(val, bytes):
            out += wire.varint_encode(len(val))
            out += val
        else:
            body = wire.varint_encode(int(val))
            out += wire.varint_encode(len(body))
            out += body
    return bytes(out)


def parse_transport_params(buf: bytes) -> Dict[int, bytes]:
    out: Dict[int, bytes] = {}
    off = 0
    while off < len(buf):
        tid, off = wire.varint_decode(buf, off)
        ln, off = wire.varint_decode(buf, off)
        out[tid] = bytes(buf[off : off + ln])
        off += ln
    return out


def tp_varint(params: Dict[int, bytes], tid: int, default: int = 0) -> int:
    v = params.get(tid)
    if v is None:
        return default
    return wire.varint_decode(v, 0)[0]


class RttEstimator:
    """RFC 9002 RTT estimation + PTO computation (§5.3, §6.2).

    Replaces the fixed 0.25 s probe timeout: smoothed_rtt/rttvar are EWMAs
    of ack-derived samples (ack_delay-adjusted once min_rtt is known) and
    the PTO backs off exponentially per probe event. Loss detection (all
    wired in the ACK handler) uses the packet threshold
    (kPacketThreshold=3), the time threshold (kTimeThreshold=9/8 of
    max(srtt, latest_rtt), RFC 9002 §6.1.2), and the PTO.
    Reference behavior: src/tango/quic/fd_quic_pkt_meta.c + RFC defaults.
    """

    K_GRANULARITY = 0.001          # kGranularity, seconds
    MAX_ACK_DELAY = 0.025          # default peer max_ack_delay
    PTO_BACKOFF_CAP = 6            # 64x max backoff

    def __init__(self, initial_rtt: float = 0.125):
        self.initial_rtt = initial_rtt
        self.latest_rtt = 0.0
        self.smoothed_rtt: Optional[float] = None
        self.rttvar = 0.0
        self.min_rtt = 0.0
        self.pto_count = 0

    def on_sample(self, rtt: float, ack_delay: float = 0.0) -> None:
        if rtt <= 0:
            return
        self.latest_rtt = rtt
        if self.smoothed_rtt is None:
            self.smoothed_rtt = rtt
            self.rttvar = rtt / 2
            self.min_rtt = rtt
        else:
            self.min_rtt = min(self.min_rtt, rtt)
            adj = rtt
            if rtt - ack_delay >= self.min_rtt:
                adj = rtt - ack_delay
            self.rttvar = 0.75 * self.rttvar + 0.25 * abs(self.smoothed_rtt - adj)
            self.smoothed_rtt = 0.875 * self.smoothed_rtt + 0.125 * adj
        self.pto_count = 0

    def pto(self) -> float:
        if self.smoothed_rtt is None:
            base = 2 * self.initial_rtt
        else:
            base = (self.smoothed_rtt
                    + max(4 * self.rttvar, self.K_GRANULARITY)
                    + self.MAX_ACK_DELAY)
        return base * (1 << min(self.pto_count, self.PTO_BACKOFF_CAP))

@dataclass
class _SentPacket:
    time: float
    ack_eliciting: bool
    crypto: List[Tuple[int, bytes]] = field(default_factory=list)
    streams: List[Tuple[int, int, bytes, bool]] = field(default_factory=list)
    handshake_done: bool = False
    pmtu_probe: int = 0   # DPLPMTUD probe datagram size (0 = not a probe)


class _PnSpace:
    """One packet-number space: keys, ACK state, CRYPTO buffers, loss."""

    def __init__(self) -> None:
        self.keys_tx: Optional[PacketKeys] = None
        self.keys_rx: Optional[PacketKeys] = None
        self.next_pn = 0
        self.largest_rx = -1
        self.largest_acked = -1
        # received pn ranges as a sorted (desc) list of [lo, hi]
        self.rx_ranges: List[List[int]] = []
        self.ack_needed = False
        # crypto stream tx: queue of (offset, bytes) not yet sent
        self.crypto_tx: List[Tuple[int, bytes]] = []
        self.crypto_tx_off = 0
        # crypto stream rx reassembly
        self.crypto_rx: Dict[int, bytes] = {}
        self.crypto_rx_off = 0
        self.sent: Dict[int, _SentPacket] = {}
        self.dropped = False

    def record_rx(self, pn: int) -> bool:
        """Track a received pn. -> False if duplicate."""
        for r in self.rx_ranges:
            if r[0] <= pn <= r[1]:
                return False
        self.largest_rx = max(self.largest_rx, pn)
        self.rx_ranges.append([pn, pn])
        self.rx_ranges.sort(key=lambda r: -r[1])
        # merge adjacent
        merged: List[List[int]] = []
        for r in self.rx_ranges:
            if merged and r[1] >= merged[-1][0] - 1:
                merged[-1][0] = min(merged[-1][0], r[0])
            else:
                merged.append(r)
        self.rx_ranges = merged[:32]  # bound state like the reference
        return True

    def ack_frame(self) -> Optional[bytes]:
        if not self.rx_ranges:
            return None
        first = self.rx_ranges[0]
        ranges: List[Tuple[int, int]] = []
        prev_lo = first[0]
        for r in self.rx_ranges[1:]:
            gap = prev_lo - r[1] - 2
            ranges.append((gap, r[1] - r[0]))
            prev_lo = r[0]
        return wire.encode_ack(first[1], 0, first[1] - first[0], ranges)

    def queue_crypto(self, data: bytes) -> None:
        self.crypto_tx.append((self.crypto_tx_off, data))
        self.crypto_tx_off += len(data)

    def on_ack(self, f: wire.Frame):
        """Remove acked packets from the sent map; -> [(pn, _SentPacket)]."""
        acked = []
        hi = f.fields["largest"]
        lo = hi - f.fields["first_range"]
        spans = [(lo, hi)]
        for gap, rng in f.ack_ranges:
            hi = lo - gap - 2
            lo = hi - rng
            spans.append((lo, hi))
        for lo, hi in spans:
            for pn in list(self.sent.keys()):
                if lo <= pn <= hi:
                    acked.append((pn, self.sent.pop(pn)))
            self.largest_acked = max(self.largest_acked, hi)
        return acked

    def drop_keys(self) -> None:
        self.keys_tx = None
        self.keys_rx = None
        self.sent.clear()
        self.crypto_tx.clear()
        self.dropped = True


class _RecvStream:
    __slots__ = ("chunks", "fin_size", "delivered")

    def __init__(self) -> None:
        self.chunks: Dict[int, bytes] = {}
        self.fin_size: Optional[int] = None
        self.delivered = False

    def add(self, off: int, data: bytes, fin: bool) -> None:
        if data:
            self.chunks[off] = data
        if fin:
            self.fin_size = off + len(data)

    def complete(self) -> Optional[bytes]:
        if self.fin_size is None or self.delivered:
            return None
        out = bytearray()
        off = 0
        while off < self.fin_size:
            chunk = self.chunks.get(off)
            if chunk is None:
                # tolerate overlapping retransmits: scan for a covering chunk
                found = None
                for o, c in self.chunks.items():
                    if o <= off < o + len(c):
                        found = c[off - o :]
                        break
                if found is None:
                    return None
                chunk = found
            out += chunk
            off += len(chunk)
        self.delivered = True
        return bytes(out[: self.fin_size])


class QuicConn:
    """A single QUIC connection (client or server role)."""

    def __init__(
        self,
        is_server: bool,
        identity_seed: bytes,
        peer_addr,
        alpns: Tuple[bytes, ...] = (b"solana-tpu",),
        orig_dcid: Optional[bytes] = None,
        idle_timeout: float = 10.0,
        on_stream: Optional[Callable[[int, bytes], None]] = None,
        now: float = 0.0,
        initial_max_streams_uni: int = 2048,
        initial_max_data: int = 1 << 24,
        scid: Optional[bytes] = None,
        reset_token: Optional[bytes] = None,
        retry_odcid: Optional[bytes] = None,
        addr_validated: Optional[bool] = None,
    ):
        self.is_server = is_server
        self.peer_addr = peer_addr
        self.scid = scid if scid is not None else os.urandom(CID_LEN)
        self.on_stream = on_stream
        self.established = False
        self.closed = False
        self.close_reason: Optional[str] = None
        self.idle_timeout = idle_timeout
        self._last_activity = now
        self._hs_done_pending = False
        self._hs_done_sent = False
        self._max_streams_uni = initial_max_streams_uni
        self._streams_consumed = 0
        self._max_data = initial_max_data
        self._rx_data_total = 0

        self.rtt = RttEstimator()
        # Key update state (RFC 9001 §6): per-direction phase bits on the
        # 1-RTT keys; old rx keys are retained one generation for packets
        # reordered across the update.
        self.tx_key_phase = 0
        self.rx_key_phase = 0
        self._prev_keys_rx: Optional[PacketKeys] = None
        self._prev_keys_deadline = 0.0   # drop old read keys after ~3 PTO
        self._next_keys_rx: Optional[PacketKeys] = None  # precomputed (§6.3)
        self._rx_phase_start_pn = 0      # first pn of the current rx phase
        # §6.2 MUST NOT initiate again until a packet sent under the
        # current-phase keys has been ACKNOWLEDGED (tx==rx is not enough:
        # a responder flips both at once and could re-roll within the
        # same round trip, desynchronizing generations).
        self._ku_pending = False
        self._ku_min_ack_pn = 0
        self.stat_key_updates = 0
        # Path migration (RFC 9000 §9): a new source address is adopted
        # only after a PATH_CHALLENGE round trip to it succeeds. One
        # probe at a time, and an in-flight probe is never clobbered by
        # a new candidate (§9.3; see on_peer_address_change).
        self._probe_addr = None
        self._probe_data: Optional[bytes] = None
        self._probe_expire = 0.0
        self._probe_next_tx = 0.0
        self._path_frames: List[bytes] = []   # queued PATH_RESPONSEs
        self._last_rx_addr = None
        self._highest_rx_pn = -1   # §9.3: migrate on newest packet only
        self.stat_migrations = 0
        # Anti-amplification (RFC 9000 §8.1; reference fd_quic.h:110 names
        # this mitigation, enforcement fd_quic.c:1198): a server must not
        # send more than AMP_LIMIT x the bytes received from an address
        # until that address is validated — by a token-validated Initial
        # (retry_odcid path) or by the client proving receipt of the
        # server's Initial (a packet decrypted with handshake keys).
        # Clients are born validated (they chose to talk to the server).
        self.addr_validated = (
            addr_validated if addr_validated is not None else not is_server
        )
        self._amp_rx_bytes = 0
        self._amp_tx_bytes = 0
        self.stat_amp_blocked = 0
        # Retry state (RFC 9000 §8.1.2 / 17.2.5): the client echoes the
        # server's token in every subsequent Initial; one Retry max.
        self._retry_token = b""
        self._retry_used = False
        self.stat_retries = 0
        # Stateless reset (RFC 9000 §10.3): the peer's token arrives in
        # its transport parameters; an undecryptable short packet whose
        # tail matches it kills the connection.
        self.peer_reset_token: Optional[bytes] = None
        self.stat_stateless_reset = 0
        self._peer_cid_adopted = False  # client: server scid adopted (§7.2)
        # DPLPMTUD (RFC 8899 / RFC 9000 §14.3): datagram budget starts at
        # the conservative 1200 and is raised only after a padded probe
        # of the candidate size is ACKNOWLEDGED; a lost probe ends the
        # search at the last validated size. One probe in flight at most.
        self.max_datagram = MAX_DATAGRAM
        self._pmtu_rungs = [1350, 1452]
        self._pmtu_inflight = 0     # probe size awaiting ack (0 = none)
        self._pmtu_done = False
        self.stat_pmtu_probes = 0
        self.spaces = [_PnSpace(), _PnSpace(), _PnSpace()]
        # Creation stamp: the server-side handshake-deadline reaper
        # (Quic.service, hs_timeout) measures half-open lifetime from
        # here — a junk Initial buys bounded state, not a 10 s idle slot.
        self.created = now
        if is_server:
            if orig_dcid is None:
                raise ValueError(
                    "server QuicConn requires orig_dcid (the client "
                    "Initial's destination cid derives the Initial keys)"
                )
            self.dcid = b""  # learned from the client's first Initial (scid)
            self.orig_dcid = orig_dcid
            ckeys, skeys = initial_secrets(orig_dcid)
            self.spaces[LEVEL_INITIAL].keys_rx = ckeys
            self.spaces[LEVEL_INITIAL].keys_tx = skeys
        else:
            self.dcid = os.urandom(CID_LEN)
            self.orig_dcid = self.dcid
            ckeys, skeys = initial_secrets(self.dcid)
            self.spaces[LEVEL_INITIAL].keys_tx = ckeys
            self.spaces[LEVEL_INITIAL].keys_rx = skeys

        tp: Dict[int, object] = {
            TP_MAX_IDLE_TIMEOUT: int(idle_timeout * 1000),
            TP_MAX_UDP_PAYLOAD: 1452,
            TP_INITIAL_MAX_DATA: initial_max_data,
            TP_INITIAL_MAX_STREAM_DATA_BIDI_LOCAL: 1 << 20,
            TP_INITIAL_MAX_STREAM_DATA_BIDI_REMOTE: 1 << 20,
            TP_INITIAL_MAX_STREAM_DATA_UNI: 1 << 20,
            TP_INITIAL_MAX_STREAMS_BIDI: 128,
            TP_INITIAL_MAX_STREAMS_UNI: initial_max_streams_uni,
            TP_INITIAL_SCID: self.scid,
        }
        if is_server:
            if retry_odcid is not None:
                # Post-retry handshake (RFC 9000 §18.2): original dcid is
                # the one from the FIRST Initial (recovered from the
                # token); retry_source_connection_id is the cid the Retry
                # chose, which the client now addresses us by.
                tp[TP_ORIGINAL_DCID] = retry_odcid
                tp[TP_RETRY_SCID] = orig_dcid
            else:
                tp[TP_ORIGINAL_DCID] = orig_dcid
            if reset_token is not None:
                tp[TP_STATELESS_RESET_TOKEN] = reset_token
        self.tls = TlsEndpoint(
            TlsConfig(
                is_server=is_server,
                identity_seed=identity_seed,
                alpns=alpns,
                transport_params=encode_transport_params(tp),
            )
        )
        self.peer_tp: Dict[int, bytes] = {}
        # streams
        self._recv_streams: Dict[int, _RecvStream] = {}
        self._next_uni_stream = 2 if not is_server else 3
        self._send_queue: List[Tuple[int, int, bytes, bool]] = []

        if not is_server:
            self.tls.start()
            self._drain_tls()

    # ---------------------------------------------------------------- rx ---

    def recv_datagram(self, data: bytes, now: float, from_addr=None) -> None:
        self._last_activity = now
        if from_addr is not None:
            self._last_rx_addr = from_addr
        if not self.addr_validated and (
            from_addr is None or from_addr == self.peer_addr
        ):
            # Bytes from the handshake address buy 3x send budget (§8.1).
            self._amp_rx_bytes += len(data)
        off = 0
        while off < len(data) and not self.closed:
            first = data[off]
            if wire.is_long_header(first):
                try:
                    hdr = wire.parse_long_header(data, off)
                except wire.QuicWireError:
                    return
                if hdr.pkt_type == wire.PKT_RETRY:
                    self._on_retry(data[off:], hdr, now)
                    return  # a Retry is never coalesced (§12.2)
                pkt_end = hdr.hdr_end + hdr.length
                if hdr.version != wire.QUIC_VERSION_1 or pkt_end > len(data):
                    return
                if hdr.pkt_type == wire.PKT_INITIAL:
                    level = LEVEL_INITIAL
                elif hdr.pkt_type == wire.PKT_HANDSHAKE:
                    level = LEVEL_HANDSHAKE
                else:
                    off = pkt_end  # 0-RTT unsupported: skip
                    continue
                if not self.dcid:
                    self.dcid = hdr.scid  # server: learn the client's cid
                self._decrypt_and_process(
                    data, off, hdr.hdr_end, pkt_end, level, now,
                    peer_scid=hdr.scid,
                )
                off = pkt_end
            else:
                level = LEVEL_APP
                try:
                    hdr_s = wire.parse_short_header(data, CID_LEN, off)
                except wire.QuicWireError:
                    return
                self._decrypt_and_process(
                    data, off, hdr_s.hdr_end, len(data), level, now
                )
                off = len(data)

    def _decrypt_and_process(
        self, data: bytes, pkt_start: int, pn_off: int, pkt_end: int,
        level: int, now: float, peer_scid: Optional[bytes] = None,
    ) -> None:
        space = self.spaces[level]
        if space.keys_rx is None:
            return  # keys not yet available (or dropped); packet is lost
        pkt = bytearray(data[pkt_start:pkt_end])
        rel_pn_off = pn_off - pkt_start
        try:
            pn_len, tpn = unprotect_header(space.keys_rx, pkt, rel_pn_off)
            pn = wire.pn_decode(tpn, pn_len, space.largest_rx)
            header = bytes(pkt[: rel_pn_off + pn_len])
            ciphertext = bytes(pkt[rel_pn_off + pn_len:])
            # Key update (RFC 9001 §6): the Key Phase bit (0x04, header-
            # protected) selects the key generation for short packets.
            phase = (pkt[0] >> 2) & 1
            if level == LEVEL_APP and now > self._prev_keys_deadline:
                self._prev_keys_rx = None  # §6.5: old read keys expire
            if level == LEVEL_APP and phase != self.rx_key_phase:
                # §6.3: pick the candidate generation by packet number —
                # below the current phase's first pn it can only be a
                # reordered pre-update packet (old keys); at or above, a
                # peer-initiated update (precomputed next keys, derived
                # once per generation, not per packet).
                if pn < self._rx_phase_start_pn and self._prev_keys_rx:
                    payload = self._prev_keys_rx.open(header, pn, ciphertext)
                else:
                    if self._next_keys_rx is None:
                        self._next_keys_rx = space.keys_rx.next_generation()
                    payload = self._next_keys_rx.open(header, pn, ciphertext)
                    # Install the new generation; respond in kind on the
                    # tx side unless we already initiated this update.
                    self._prev_keys_rx = space.keys_rx
                    self._prev_keys_deadline = now + 3 * self.rtt.pto()
                    space.keys_rx = self._next_keys_rx
                    self._next_keys_rx = None
                    self._rx_phase_start_pn = pn
                    self.rx_key_phase ^= 1
                    self.stat_key_updates += 1
                    if self.tx_key_phase != self.rx_key_phase:
                        space.keys_tx = space.keys_tx.next_generation()
                        self.tx_key_phase ^= 1
                        self._ku_pending = True
                        self._ku_min_ack_pn = space.next_pn
            else:
                payload = space.keys_rx.open(header, pn, ciphertext)
        except QuicCryptoError:
            # Undecryptable: drop silently (RFC 9001 §9.3) — unless it is
            # a stateless reset: a short-header datagram whose last 16
            # bytes equal the peer's advertised reset token (RFC 9000
            # §10.3.1; checked only AFTER AEAD failure, so a valid packet
            # can never be misread as a reset).
            if (level == LEVEL_APP and self.peer_reset_token is not None
                    and pkt_end - pkt_start >= 21
                    and data[pkt_end - 16:pkt_end] == self.peer_reset_token):
                self.closed = True
                self.close_reason = "stateless reset"
                self.stat_stateless_reset += 1
            return
        if not space.record_rx(pn):
            return  # duplicate
        if self.is_server and level == LEVEL_HANDSHAKE:
            # The client can only have handshake keys if it received our
            # Initial at the address it claims: address validated (§8.1).
            self.addr_validated = True
        if (not self.is_server and peer_scid is not None
                and not self._peer_cid_adopted):
            # RFC 9000 §7.2: the client MUST switch its dcid to the
            # server's chosen scid once a packet from the server is
            # processed — adopted here, after AEAD authentication, so an
            # off-path injector cannot redirect the connection. (The
            # stateless-reset design depends on this: the server's reset
            # token is minted for ITS cid.)
            self.dcid = peer_scid
            self._peer_cid_adopted = True
        if level == LEVEL_APP and pn > self._highest_rx_pn:
            self._highest_rx_pn = pn
            # Authenticated, newest packet from a non-current address:
            # start path validation (RFC 9000 §9.3 — spoofed packets die
            # at the AEAD above; reordered old-path packets have lower
            # pn and must not clobber an in-flight probe).
            if (self.established and self._last_rx_addr is not None
                    and self._last_rx_addr != self.peer_addr):
                self.on_peer_address_change(self._last_rx_addr, now)
        try:
            frames = wire.parse_frames(payload)
        except wire.QuicWireError:
            self.abort(0x0A, "frame encoding error")
            return
        ack_eliciting = False
        for f in frames:
            if f.ftype not in (wire.FRAME_ACK,):
                ack_eliciting = True
            self._on_frame(level, f, now)
        if ack_eliciting:
            space.ack_needed = True

    def _on_frame(self, level: int, f: wire.Frame, now: float) -> None:
        space = self.spaces[level]
        t = f.ftype
        if t == wire.FRAME_ACK:
            acked = space.on_ack(f)
            if (level == LEVEL_APP and self._ku_pending
                    and any(pn >= self._ku_min_ack_pn for pn, _ in acked)):
                self._ku_pending = False  # current phase confirmed (§6.2)
            for _pn, sp in acked:
                if sp.pmtu_probe and sp.pmtu_probe == self._pmtu_inflight:
                    # Probe delivered: the path carries this size (§14.3).
                    self.max_datagram = max(self.max_datagram,
                                            sp.pmtu_probe)
                    self._pmtu_inflight = 0
            # RTT sample ONLY when the frame's largest-acknowledged packet
            # is itself newly acked and ack-eliciting (RFC 9002 §5.1) — a
            # reordered ACK re-listing old ranges must not fold its own
            # delivery delay into srtt. ack_delay is us << exponent(3).
            largest = f.fields["largest"]
            for pn, sp in acked:
                if pn == largest and sp.ack_eliciting:
                    ack_delay = f.fields.get("ack_delay", 0) * 8 / 1e6
                    self.rtt.on_sample(now - sp.time, ack_delay)
                    break
            # Packet-threshold loss (RFC 9002 §6.1.1, kPacketThreshold=3):
            # anything 3+ below the new largest acked is lost NOW - the
            # fast-retransmit path that does not wait out a PTO.
            # Time-threshold loss (§6.1.2, kTimeThreshold = 9/8): a packet
            # older than 9/8 * max(srtt, latest_rtt) relative to `now`
            # that the newest ack skipped is also lost — catches tail and
            # small-flight losses a 3-packet gap can never form for.
            srtt = self.rtt.smoothed_rtt
            base_rtt = (max(srtt, self.rtt.latest_rtt)
                        if srtt is not None else 2 * self.rtt.initial_rtt)
            time_thresh = max(9 * base_rtt / 8, RttEstimator.K_GRANULARITY)
            for pn in list(space.sent.keys()):
                if pn <= space.largest_acked - 3 or (
                    pn < space.largest_acked
                    and space.sent[pn].time <= now - time_thresh
                ):
                    self._retransmit(space, pn)
        elif t == wire.FRAME_CRYPTO:
            self._on_crypto(level, f.fields["offset"], f.data)
        elif wire.FRAME_STREAM_BASE <= t <= wire.FRAME_STREAM_BASE | 7:
            self._on_stream_frame(f)
        elif t == wire.FRAME_HANDSHAKE_DONE:
            if not self.is_server:
                self.established = True
                self.spaces[LEVEL_HANDSHAKE].drop_keys()
        elif t == wire.FRAME_PATH_CHALLENGE:
            # Echo on the active path (RFC 9000 §8.3; single-socket model
            # approximates "same path" by replying to the current peer).
            self._path_frames.append(wire.encode_path_frame(
                wire.FRAME_PATH_RESPONSE,
                f.fields["data8"].to_bytes(8, "big"),
            ))
        elif t == wire.FRAME_PATH_RESPONSE:
            data = f.fields["data8"].to_bytes(8, "big")
            if (self._probe_data is not None and data == self._probe_data
                    and self._last_rx_addr == self._probe_addr):
                # Path validated: adopt the new address (§9.3).
                self.peer_addr = self._probe_addr
                self._probe_addr = self._probe_data = None
                self.stat_migrations += 1
        elif t in (wire.FRAME_CONN_CLOSE_QUIC, wire.FRAME_CONN_CLOSE_APP):
            self.closed = True
            self.close_reason = f.data.decode("utf-8", "replace")
        # MAX_DATA/MAX_STREAMS/NEW_CONNECTION_ID etc: tracked loosely; the
        # TPU role never hits the limits within a connection's lifetime.

    def _on_retry(self, pkt: bytes, hdr: wire.LongHeader, now: float) -> None:
        """Client-side Retry handling (RFC 9000 §17.2.5.2): validate the
        integrity tag against our ORIGINAL dcid, adopt the server's new
        cid (re-deriving Initial keys from it, RFC 9001 §5.2), stash the
        token for all subsequent Initials, and re-queue the ClientHello.
        At most one Retry per connection; ignored after any decrypted
        server packet (the tag alone does not authenticate the server,
        possession of our Initial does — which an on-path observer has,
        exactly the threat model Retry is scoped to)."""
        if self.is_server or self._retry_used or self.established:
            return
        if any(s.largest_rx >= 0 for s in self.spaces):
            return  # §17.2.5.2: discard after any processed packet
        token = wire.check_retry(pkt, self.orig_dcid)
        if token is None:
            return
        self._retry_used = True
        self._retry_token = token
        self.stat_retries += 1
        self.dcid = hdr.scid
        ckeys, skeys = initial_secrets(self.dcid)
        ini = self.spaces[LEVEL_INITIAL]
        ini.keys_tx, ini.keys_rx = ckeys, skeys
        # Re-queue everything in flight (the ClientHello): packet numbers
        # continue, they are not reset after Retry (RFC 9000 §17.2.5.3).
        for pn in list(ini.sent.keys()):
            self._retransmit(ini, pn)

    def _on_crypto(self, level: int, offset: int, data: bytes) -> None:
        space = self.spaces[level]
        if offset + len(data) <= space.crypto_rx_off:
            return  # fully duplicate
        space.crypto_rx[offset] = data
        # feed contiguous bytes to TLS
        progressed = True
        while progressed:
            progressed = False
            for off, chunk in sorted(space.crypto_rx.items()):
                if off <= space.crypto_rx_off < off + len(chunk):
                    take = chunk[space.crypto_rx_off - off :]
                    try:
                        self.tls.consume(level, take)
                    except TlsError as e:
                        self.abort(0x0128, f"tls: {e}")
                        return
                    space.crypto_rx_off = off + len(chunk)
                    del space.crypto_rx[off]
                    progressed = True
                    break
                if off + len(chunk) <= space.crypto_rx_off:
                    del space.crypto_rx[off]
                    progressed = True
                    break
        self._drain_tls()

    def _on_stream_frame(self, f: wire.Frame) -> None:
        sid = f.fields["stream_id"]
        st = self._recv_streams.get(sid)
        if st is None:
            st = self._recv_streams[sid] = _RecvStream()
        if st.delivered:
            return
        st.add(f.fields["offset"], f.data, bool(f.fields["fin"]))
        self._rx_data_total += len(f.data)
        done = st.complete()
        if done is not None:
            self._streams_consumed += 1
            if self.on_stream is not None:
                self.on_stream(sid, done)
            # retire reassembly state; keep the tombstone for dup filtering
            st.chunks.clear()

    # --------------------------------------------------------------- tls ---

    def _drain_tls(self) -> None:
        for level, msg in self.tls.take_output():
            self.spaces[level].queue_crypto(msg)
        if (
            self.tls.hs_secrets is not None
            and self.spaces[LEVEL_HANDSHAKE].keys_tx is None
        ):
            c, s = self.tls.hs_secrets
            ck, sk = PacketKeys.from_secret(c), PacketKeys.from_secret(s)
            hs = self.spaces[LEVEL_HANDSHAKE]
            if self.is_server:
                hs.keys_rx, hs.keys_tx = ck, sk
            else:
                hs.keys_rx, hs.keys_tx = sk, ck
        if (
            self.tls.app_secrets is not None
            and self.spaces[LEVEL_APP].keys_tx is None
        ):
            c, s = self.tls.app_secrets
            ck, sk = PacketKeys.from_secret(c), PacketKeys.from_secret(s)
            ap = self.spaces[LEVEL_APP]
            if self.is_server:
                ap.keys_rx, ap.keys_tx = ck, sk
            else:
                ap.keys_rx, ap.keys_tx = sk, ck
        if self.tls.peer_transport_params is not None and not self.peer_tp:
            self.peer_tp = parse_transport_params(
                self.tls.peer_transport_params
            )
            tok = self.peer_tp.get(TP_STATELESS_RESET_TOKEN)
            if tok is not None and len(tok) == 16:
                self.peer_reset_token = tok
        if self.tls.handshake_complete and self.is_server and not self.established:
            self.established = True
            self._hs_done_pending = True
            self.spaces[LEVEL_INITIAL].drop_keys()
            self.spaces[LEVEL_HANDSHAKE].drop_keys()

    # ---------------------------------------------------------------- tx ---

    def send_stream(self, data: bytes, fin: bool = True) -> int:
        """Open a new unidirectional stream carrying `data` (one txn)."""
        sid = self._next_uni_stream
        self._next_uni_stream += 4
        self._send_queue.append((sid, 0, data, fin))
        return sid

    def pending_datagrams(self, now: float) -> List[bytes]:
        """Assemble everything sendable into coalesced datagrams."""
        out: List[bytes] = []
        if not self.addr_validated and (
            self._amp_tx_bytes + MAX_DATAGRAM
            > AMP_LIMIT * self._amp_rx_bytes
        ):
            # Anti-amplification (§8.1): sending one more full datagram
            # could exceed 3x the bytes this unvalidated address has sent
            # us. Everything stays queued (crypto_tx untouched) until the
            # peer's next datagram buys more budget or validates the
            # address — a spoofed-source Initial flood can at most make
            # us echo 3x its own traffic at the victim.
            self.stat_amp_blocked += 1
            return out
        segments: List[bytes] = []
        pad_initial = False
        for level in (LEVEL_INITIAL, LEVEL_HANDSHAKE, LEVEL_APP):
            space = self.spaces[level]
            if space.keys_tx is None or space.dropped:
                continue
            frames: List[bytes] = []
            sent = _SentPacket(time=now, ack_eliciting=False)
            if space.ack_needed:
                ack = space.ack_frame()
                if ack:
                    frames.append(ack)
                space.ack_needed = False
            budget = self.max_datagram - 96  # header + AEAD margin
            while space.crypto_tx and budget > 24:
                off, data = space.crypto_tx.pop(0)
                room = budget - 12
                if len(data) > room:
                    space.crypto_tx.insert(0, (off + room, data[room:]))
                    data = data[:room]
                frames.append(wire.encode_crypto(off, data))
                sent.crypto.append((off, data))
                sent.ack_eliciting = True
                budget -= 12 + len(data)
            if level == LEVEL_APP:
                if self._hs_done_pending:
                    frames.append(bytes([wire.FRAME_HANDSHAKE_DONE]))
                    sent.handshake_done = True
                    sent.ack_eliciting = True
                    self._hs_done_pending = False
                while self._path_frames and budget > 16:
                    frames.append(self._path_frames.pop(0))
                    sent.ack_eliciting = True
                    budget -= 9
                while self._send_queue and budget > 32:
                    sid, off, data, fin = self._send_queue.pop(0)
                    room = budget - 16
                    if len(data) > room:
                        self._send_queue.insert(
                            0, (sid, off + room, data[room:], fin)
                        )
                        data, fin_now = data[:room], False
                    else:
                        fin_now = fin
                    frames.append(
                        wire.encode_stream(sid, off, data, fin_now)
                    )
                    sent.streams.append((sid, off, data, fin_now))
                    sent.ack_eliciting = True
                    budget -= 16 + len(data)
            if not frames:
                continue
            payload = b"".join(frames)
            # the header-protection sample needs pn_len+payload+tag >= 20
            # bytes past the pn offset: pad tiny payloads (PADDING frames)
            if len(payload) < 8:
                payload += bytes(8 - len(payload))
            pn = space.next_pn
            space.next_pn += 1
            pn_len = 2
            if level == LEVEL_APP:
                header = wire.encode_short_header(
                    self.dcid, pn, pn_len, key_phase=self.tx_key_phase
                )
            else:
                header = wire.encode_long_header(
                    _LEVEL_TO_PKT[level],
                    self.dcid if self.dcid else self.orig_dcid,
                    self.scid,
                    pn,
                    pn_len,
                    len(payload) + AEAD_OVERHEAD,
                    # Initials echo the server's retry token (§8.1.2).
                    token=(self._retry_token
                           if level == LEVEL_INITIAL else b""),
                )
                if level == LEVEL_INITIAL and not self.is_server:
                    pad_initial = True
            if sent.ack_eliciting:
                space.sent[pn] = sent
            segments.append(
                protect_packet(space.keys_tx, header, pn, pn_len, payload)
            )
        if not segments:
            return out
        self._amp_tx_bytes += sum(len(s) for s in segments)
        datagram = b"".join(segments)
        if pad_initial and len(datagram) < 1200:
            # client Initial datagrams must be >=1200B (RFC 9000 §14.1):
            # pre-pad the *first* segment's payload is complex post-AEAD, so
            # append PADDING inside a trailing app/hs segment if one exists;
            # otherwise rebuild with padding. Simplest correct approach:
            # append raw zero bytes is NOT valid post-protection, so instead
            # re-emit padding as a separate Initial packet is overkill —
            # we pad by constructing the datagram again below.
            datagram = self._pad_initial_datagram(segments, now)
        out.append(datagram)
        return out

    def _pad_initial_datagram(self, segments: List[bytes], now: float) -> bytes:
        """Pad a client datagram containing an Initial to 1200B by sending
        an extra PADDING-only Initial packet sized to fill the gap."""
        space = self.spaces[LEVEL_INITIAL]
        if space.keys_tx is None:
            return b"".join(segments)
        gap = 1200 - sum(len(s) for s in segments)
        pn = space.next_pn
        space.next_pn += 1
        pn_len = 2
        # long header for dcid/scid as in normal initial
        overhead = 7 + 1 + len(self.dcid or self.orig_dcid) + 1 + len(self.scid) + 1 + 2 + pn_len + AEAD_OVERHEAD
        pad_len = max(8, gap - overhead)
        payload = bytes(pad_len)  # PADDING frames
        header = wire.encode_long_header(
            wire.PKT_INITIAL,
            self.dcid if self.dcid else self.orig_dcid,
            self.scid,
            pn,
            pn_len,
            len(payload) + AEAD_OVERHEAD,
            token=self._retry_token,
        )
        segments.append(
            protect_packet(space.keys_tx, header, pn, pn_len, payload)
        )
        return b"".join(segments)

    # ------------------------------------------------------------ service --

    def _retransmit(self, space: "_PnSpace", pn: int) -> None:
        """Re-queue a sent packet's retransmittable content."""
        sp = space.sent.pop(pn)
        if sp.pmtu_probe:
            # A lost probe is the DPLPMTUD answer, not data to re-send:
            # the path cannot carry pmtu_probe bytes — stop the search
            # at the last validated size (RFC 8899 SEARCH_COMPLETE).
            if self._pmtu_inflight == sp.pmtu_probe:
                self._pmtu_inflight = 0
                self._pmtu_done = True
            return
        for off, data in sp.crypto:
            space.crypto_tx.insert(0, (off, data))
        for st in sp.streams:
            self._send_queue.insert(0, st)
        if sp.handshake_done:
            self._hs_done_pending = True

    def service(self, now: float) -> List[bytes]:
        """Timers: idle timeout + PTO retransmission (RTT-driven, RFC 9002;
        the estimator's PTO backs off exponentially while no acks arrive).
        -> datagrams to send."""
        if self.closed:
            return []
        if now - self._last_activity > self.idle_timeout:
            self.closed = True
            self.close_reason = "idle timeout"
            return []
        pto = self.rtt.pto()
        fired = False
        for space in self.spaces:
            if space.dropped:
                continue
            for pn in list(space.sent.keys()):
                if now - space.sent[pn].time > pto:
                    probe = space.sent[pn].pmtu_probe != 0
                    self._retransmit(space, pn)
                    if not probe:   # a lost PMTU probe is an answer,
                        fired = True  # not a congestion signal
        if fired:
            self.rtt.pto_count += 1
        out = self.pending_datagrams(now)
        probe = self._pmtu_probe_datagram(now)
        if probe is not None:
            out.append(probe)
        return out

    def _pmtu_probe_datagram(self, now: float) -> Optional[bytes]:
        """DPLPMTUD search step (RFC 8899, RFC 9000 §14.3): one padded
        PING datagram at the next candidate size; adopted on ack, search
        ended on loss. Never carries data, so a blackholed probe costs
        nothing but itself."""
        if (not self.established or self._pmtu_done or self._pmtu_inflight
                or not self.addr_validated
                or self.spaces[LEVEL_APP].keys_tx is None):
            return None
        target = next(
            (r for r in self._pmtu_rungs if r > self.max_datagram), None
        )
        if target is None:
            self._pmtu_done = True
            return None
        space = self.spaces[LEVEL_APP]
        pn = space.next_pn
        space.next_pn += 1
        pn_len = 2
        header = wire.encode_short_header(
            self.dcid, pn, pn_len, key_phase=self.tx_key_phase
        )
        payload = bytes([wire.FRAME_PING])
        payload += bytes(target - len(header) - AEAD_OVERHEAD - len(payload))
        space.sent[pn] = _SentPacket(
            time=now, ack_eliciting=True, pmtu_probe=target
        )
        self._pmtu_inflight = target
        self.stat_pmtu_probes += 1
        return protect_packet(space.keys_tx, header, pn, pn_len, payload)

    def on_peer_address_change(self, addr, now: float) -> None:
        """A post-handshake datagram arrived from an unvalidated address:
        start (or continue) a PATH_CHALLENGE probe of it. The connection
        keeps sending to the validated address until the probe round
        trip completes (RFC 9000 §9.1)."""
        if self._probe_data is not None and now < self._probe_expire:
            # A validation is already in flight: a different candidate
            # address must NOT clobber it (round-2 ADVICE: an off-path
            # attacker racing copies of genuine datagrams from spoofed
            # sources could otherwise overwrite the probe indefinitely
            # and starve a real NAT-rebind migration). The loser will
            # re-trigger once this probe validates or expires.
            return
        self._probe_addr = addr
        self._probe_data = os.urandom(8)
        self._probe_expire = now + 3 * max(self.rtt.pto(), 0.1)
        self._probe_next_tx = now

    def path_probe_datagrams(self, now: float) -> List[tuple]:
        """[(addr, datagram)] of PATH_CHALLENGE probes due now; resent
        once per PTO until the probe validates or expires."""
        if (self.closed or self._probe_data is None
                or self.spaces[LEVEL_APP].keys_tx is None):
            return []
        if now >= self._probe_expire:
            self._probe_addr = self._probe_data = None
            return []
        if now < self._probe_next_tx:
            return []
        self._probe_next_tx = now + max(self.rtt.pto(), 0.05)
        space = self.spaces[LEVEL_APP]
        payload = wire.encode_path_frame(
            wire.FRAME_PATH_CHALLENGE, self._probe_data
        )
        pn = space.next_pn
        space.next_pn += 1
        header = wire.encode_short_header(
            self.dcid, pn, 2, key_phase=self.tx_key_phase
        )
        return [(self._probe_addr,
                 protect_packet(space.keys_tx, header, pn, 2, payload))]

    def initiate_key_update(self) -> None:
        """Roll the 1-RTT send keys one generation (RFC 9001 §6.1); the
        peer detects the flipped Key Phase bit and responds in kind.
        Only valid once the handshake is confirmed, and not before the
        peer has answered the previous update (§6.2 MUST NOT — rolling
        twice within one round trip returns the phase BIT to its old
        value while the keys advance two generations, silently killing
        the connection)."""
        if not self.established:
            raise RuntimeError("key update before handshake confirmation")
        if self.tx_key_phase != self.rx_key_phase or self._ku_pending:
            raise RuntimeError(
                "previous key update not yet acknowledged by the peer"
            )
        space = self.spaces[LEVEL_APP]
        space.keys_tx = space.keys_tx.next_generation()
        self.tx_key_phase ^= 1
        self._ku_pending = True
        self._ku_min_ack_pn = space.next_pn
        self.stat_key_updates += 1

    def reassembly_pressure(self) -> Tuple[int, int]:
        """(incomplete_streams, buffered_bytes) held by streams that
        have NOT completed: the slowloris posture gauge. A peer
        dribbling partial streams grows exactly this — the quic tile's
        FD_QUIC_SLOW_MAX_BUF defense reads it at housekeeping rate and
        quarantines the connection past the budget, so held-open
        streams cannot grow server state unboundedly."""
        n = 0
        nbytes = 0
        for st in self._recv_streams.values():
            if st.delivered:
                continue
            sz = sum(len(c) for c in st.chunks.values())
            if sz:
                n += 1
                nbytes += sz
        return n, nbytes

    def abort(self, error: int, reason: str) -> None:
        self.closed = True
        self.close_reason = reason
