"""QUIC v1 wire codecs: varints, packet headers, frames.

Role parity with the reference's preprocessor-templated codec DSL
(the reference's src/tango/quic/templ/fd_quic_templ.h and
fd_quic_parsers/encoders generated from it): here the same idea is a
declarative Python table (`_FRAME_SPECS`) driving a generic parse/encode
pair, with the two irregular frames (ACK's range groups, STREAM's
flag-dependent fields) handled explicitly.

The port's copy of ``firedancer_tpu/tango/quic/wire.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

QUIC_VERSION_1 = 0x00000001

# long-header packet types (RFC 9000 §17.2)
PKT_INITIAL = 0
PKT_ZERO_RTT = 1
PKT_HANDSHAKE = 2
PKT_RETRY = 3


class QuicWireError(ValueError):
    pass


# --------------------------------------------------------------- varint ----

def varint_decode(buf: bytes, off: int) -> Tuple[int, int]:
    """-> (value, new_off). RFC 9000 §16: 2-bit length prefix, big-endian."""
    if off >= len(buf):
        raise QuicWireError("varint: truncated")
    first = buf[off]
    n = 1 << (first >> 6)
    if off + n > len(buf):
        raise QuicWireError("varint: truncated body")
    v = first & 0x3F
    for i in range(1, n):
        v = (v << 8) | buf[off + i]
    return v, off + n


def varint_encode(v: int) -> bytes:
    if v < 0x40:
        return bytes([v])
    if v < 0x4000:
        return (0x4000 | v).to_bytes(2, "big")
    if v < 0x40000000:
        return (0x80000000 | v).to_bytes(4, "big")
    if v < 0x4000000000000000:
        return (0xC000000000000000 | v).to_bytes(8, "big")
    raise QuicWireError("varint: value too large")


# ------------------------------------------------------- packet headers ----

@dataclass
class LongHeader:
    pkt_type: int
    version: int
    dcid: bytes
    scid: bytes
    token: bytes = b""  # Initial only
    length: int = 0  # pn + payload length (varint field)
    hdr_end: int = 0  # offset where the packet number begins
    first_byte: int = 0


@dataclass
class ShortHeader:
    dcid: bytes
    hdr_end: int = 0
    first_byte: int = 0


def is_long_header(first_byte: int) -> bool:
    return bool(first_byte & 0x80)


def parse_long_header(buf: bytes, off: int = 0) -> LongHeader:
    if off >= len(buf):
        raise QuicWireError("empty datagram")
    first = buf[off]
    if not (first & 0x80):
        raise QuicWireError("not a long header")
    if off + 6 > len(buf):
        raise QuicWireError("long header truncated")
    version = int.from_bytes(buf[off + 1 : off + 5], "big")
    p = off + 5
    dcil = buf[p]
    p += 1
    if dcil > 20 or p + dcil > len(buf):
        raise QuicWireError("bad dcid")
    dcid = bytes(buf[p : p + dcil])
    p += dcil
    if p >= len(buf):
        raise QuicWireError("long header truncated at scid")
    scil = buf[p]
    p += 1
    if scil > 20 or p + scil > len(buf):
        raise QuicWireError("bad scid")
    scid = bytes(buf[p : p + scil])
    p += scil
    pkt_type = (first >> 4) & 0x3
    token = b""
    if pkt_type == PKT_INITIAL:
        tok_len, p = varint_decode(buf, p)
        if p + tok_len > len(buf):
            raise QuicWireError("bad token")
        token = bytes(buf[p : p + tok_len])
        p += tok_len
    length = 0
    if pkt_type != PKT_RETRY:
        length, p = varint_decode(buf, p)
    return LongHeader(
        pkt_type=pkt_type,
        version=version,
        dcid=dcid,
        scid=scid,
        token=token,
        length=length,
        hdr_end=p,
        first_byte=first,
    )


def encode_long_header(
    pkt_type: int,
    dcid: bytes,
    scid: bytes,
    pn: int,
    pn_len: int,
    payload_len: int,
    token: bytes = b"",
    version: int = QUIC_VERSION_1,
) -> bytes:
    """Header bytes up to and including the (unprotected) packet number."""
    first = 0xC0 | (pkt_type << 4) | (pn_len - 1)
    out = bytearray([first])
    out += version.to_bytes(4, "big")
    out.append(len(dcid))
    out += dcid
    out.append(len(scid))
    out += scid
    if pkt_type == PKT_INITIAL:
        out += varint_encode(len(token))
        out += token
    out += varint_encode(pn_len + payload_len)
    out += pn.to_bytes(pn_len, "big")[-pn_len:]
    return bytes(out)


def parse_short_header(buf: bytes, dcid_len: int, off: int = 0) -> ShortHeader:
    if off >= len(buf):
        raise QuicWireError("empty datagram")
    first = buf[off]
    if first & 0x80:
        raise QuicWireError("not a short header")
    p = off + 1
    if p + dcid_len > len(buf):
        raise QuicWireError("short header truncated")
    dcid = bytes(buf[p : p + dcid_len])
    return ShortHeader(dcid=dcid, hdr_end=p + dcid_len, first_byte=first)


def encode_short_header(dcid: bytes, pn: int, pn_len: int,
                        key_phase: int = 0) -> bytes:
    first = 0x40 | ((key_phase & 1) << 2) | (pn_len - 1)
    return bytes([first]) + dcid + pn.to_bytes(pn_len, "big")[-pn_len:]


def pn_decode(truncated: int, pn_len: int, largest_acked: int) -> int:
    """Recover a full packet number from its truncated encoding (§A.3)."""
    expected = largest_acked + 1
    win = 1 << (pn_len * 8)
    half = win // 2
    candidate = (expected & ~(win - 1)) | truncated
    if candidate <= expected - half and candidate + win < (1 << 62):
        return candidate + win
    if candidate > expected + half and candidate >= win:
        return candidate - win
    return candidate


# ---------------------------------------------------------------- frames ---

FRAME_PADDING = 0x00
FRAME_PING = 0x01
FRAME_ACK = 0x02  # 0x03 with ECN
FRAME_RESET_STREAM = 0x04
FRAME_STOP_SENDING = 0x05
FRAME_CRYPTO = 0x06
FRAME_NEW_TOKEN = 0x07
FRAME_STREAM_BASE = 0x08  # 0x08..0x0f, flags OFF=4 LEN=2 FIN=1
FRAME_MAX_DATA = 0x10
FRAME_MAX_STREAM_DATA = 0x11
FRAME_MAX_STREAMS_BIDI = 0x12
FRAME_MAX_STREAMS_UNI = 0x13
FRAME_DATA_BLOCKED = 0x14
FRAME_STREAM_DATA_BLOCKED = 0x15
FRAME_STREAMS_BLOCKED_BIDI = 0x16
FRAME_STREAMS_BLOCKED_UNI = 0x17
FRAME_NEW_CONNECTION_ID = 0x18
FRAME_RETIRE_CONNECTION_ID = 0x19
FRAME_PATH_CHALLENGE = 0x1A
FRAME_PATH_RESPONSE = 0x1B
FRAME_CONN_CLOSE_QUIC = 0x1C
FRAME_CONN_CLOSE_APP = 0x1D
FRAME_HANDSHAKE_DONE = 0x1E


@dataclass
class Frame:
    ftype: int
    fields: Dict[str, int] = field(default_factory=dict)
    data: bytes = b""
    # ACK only: list of (gap, range) pairs after the first range
    ack_ranges: List[Tuple[int, int]] = field(default_factory=list)


# field kinds: v = varint, b8 = 8-byte blob, b16 = 16-byte blob,
# lv = varint-length-prefixed bytes (-> .data), cid = u8-length-prefixed
# bytes (-> .data)
_FRAME_SPECS: Dict[int, List[Tuple[str, str]]] = {
    FRAME_PING: [],
    FRAME_RESET_STREAM: [
        ("stream_id", "v"), ("app_error", "v"), ("final_size", "v")],
    FRAME_STOP_SENDING: [("stream_id", "v"), ("app_error", "v")],
    FRAME_NEW_TOKEN: [("token", "lv")],
    FRAME_MAX_DATA: [("max_data", "v")],
    FRAME_MAX_STREAM_DATA: [("stream_id", "v"), ("max_stream_data", "v")],
    FRAME_MAX_STREAMS_BIDI: [("max_streams", "v")],
    FRAME_MAX_STREAMS_UNI: [("max_streams", "v")],
    FRAME_DATA_BLOCKED: [("limit", "v")],
    FRAME_STREAM_DATA_BLOCKED: [("stream_id", "v"), ("limit", "v")],
    FRAME_STREAMS_BLOCKED_BIDI: [("limit", "v")],
    FRAME_STREAMS_BLOCKED_UNI: [("limit", "v")],
    FRAME_RETIRE_CONNECTION_ID: [("seq", "v")],
    FRAME_PATH_CHALLENGE: [("data8", "b8")],
    FRAME_PATH_RESPONSE: [("data8", "b8")],
    FRAME_HANDSHAKE_DONE: [],
}


def parse_frames(buf: bytes) -> List[Frame]:
    """Parse a decrypted packet payload into frames."""
    frames: List[Frame] = []
    off = 0
    n = len(buf)
    while off < n:
        ftype = buf[off]
        off += 1
        if ftype == FRAME_PADDING:
            continue
        if ftype in (FRAME_ACK, FRAME_ACK | 1):
            f = Frame(ftype=FRAME_ACK)
            f.fields["largest"], off = varint_decode(buf, off)
            f.fields["ack_delay"], off = varint_decode(buf, off)
            cnt, off = varint_decode(buf, off)
            f.fields["first_range"], off = varint_decode(buf, off)
            for _ in range(cnt):
                gap, off = varint_decode(buf, off)
                rng, off = varint_decode(buf, off)
                f.ack_ranges.append((gap, rng))
            if ftype & 1:  # ECN counts, parsed and dropped
                for _ in range(3):
                    _, off = varint_decode(buf, off)
            frames.append(f)
            continue
        if ftype == FRAME_CRYPTO:
            f = Frame(ftype=FRAME_CRYPTO)
            f.fields["offset"], off = varint_decode(buf, off)
            ln, off = varint_decode(buf, off)
            if off + ln > n:
                raise QuicWireError("crypto frame truncated")
            f.data = bytes(buf[off : off + ln])
            off += ln
            frames.append(f)
            continue
        if FRAME_STREAM_BASE <= ftype <= FRAME_STREAM_BASE | 0x07:
            f = Frame(ftype=ftype)
            f.fields["stream_id"], off = varint_decode(buf, off)
            if ftype & 0x04:
                f.fields["offset"], off = varint_decode(buf, off)
            else:
                f.fields["offset"] = 0
            if ftype & 0x02:
                ln, off = varint_decode(buf, off)
            else:
                ln = n - off
            if off + ln > n:
                raise QuicWireError("stream frame truncated")
            f.fields["fin"] = ftype & 0x01
            f.data = bytes(buf[off : off + ln])
            off += ln
            frames.append(f)
            continue
        if ftype == FRAME_NEW_CONNECTION_ID:
            f = Frame(ftype=ftype)
            f.fields["seq"], off = varint_decode(buf, off)
            f.fields["retire_prior_to"], off = varint_decode(buf, off)
            if off >= n:
                # buf[off] past the end would IndexError out of the
                # parser — an UNTYPED escape the conn layer's
                # QuicWireError handler cannot catch (attacker-
                # controlled bytes must only ever produce typed rejects).
                raise QuicWireError("NEW_CONNECTION_ID truncated")
            cil = buf[off]
            off += 1
            if cil == 0 or cil > 20 or off + cil + 16 > n:
                raise QuicWireError("bad NEW_CONNECTION_ID")
            f.data = bytes(buf[off : off + cil])
            off += cil
            f.fields["reset_token"] = int.from_bytes(
                buf[off : off + 16], "big"
            )
            off += 16
            frames.append(f)
            continue
        if ftype in (FRAME_CONN_CLOSE_QUIC, FRAME_CONN_CLOSE_APP):
            f = Frame(ftype=ftype)
            f.fields["error"], off = varint_decode(buf, off)
            if ftype == FRAME_CONN_CLOSE_QUIC:
                f.fields["frame_type"], off = varint_decode(buf, off)
            ln, off = varint_decode(buf, off)
            if off + ln > n:
                raise QuicWireError("close frame truncated")
            f.data = bytes(buf[off : off + ln])
            off += ln
            frames.append(f)
            continue
        spec = _FRAME_SPECS.get(ftype)
        if spec is None:
            raise QuicWireError(f"unknown frame type 0x{ftype:02x}")
        f = Frame(ftype=ftype)
        for name, kind in spec:
            if kind == "v":
                f.fields[name], off = varint_decode(buf, off)
            elif kind == "b8":
                if off + 8 > n:
                    # int.from_bytes over a short slice would silently
                    # accept a truncated PATH_CHALLENGE/RESPONSE as a
                    # smaller integer — a typed reject, never laxity.
                    raise QuicWireError("frame 8-byte field truncated")
                f.fields[name] = int.from_bytes(buf[off : off + 8], "big")
                off += 8
            elif kind == "lv":
                ln, off = varint_decode(buf, off)
                if off + ln > n:
                    raise QuicWireError("frame blob truncated")
                f.data = bytes(buf[off : off + ln])
                off += ln
        frames.append(f)
    return frames


# ------------------------------------------------------ retry / reset ------

# RFC 9001 §5.8: fixed key/nonce protecting Retry packet integrity (v1).
RETRY_INTEGRITY_KEY = bytes.fromhex("be0c690b9f66575a1d766b54e368c84e")
RETRY_INTEGRITY_NONCE = bytes.fromhex("461599d35d632bf2239825bb")


_RETRY_AEAD = None


def _retry_tag(odcid: bytes, retry_sans_tag: bytes) -> bytes:
    """16-byte Retry Integrity Tag: AES-128-GCM over the empty string
    with the retry pseudo-packet (ODCID-prefixed packet) as AAD. The
    key is a fixed RFC 9001 §5.8 constant, so ONE cached cipher serves
    every packet — constructing it per Retry would re-pay key schedule
    + GHASH setup on the flood path this feature exists to cheapen."""
    global _RETRY_AEAD
    if _RETRY_AEAD is None:
        from ...ballet.aes import AesGcm

        _RETRY_AEAD = AesGcm(RETRY_INTEGRITY_KEY)
    pseudo = bytes([len(odcid)]) + odcid + retry_sans_tag
    return _RETRY_AEAD.seal(RETRY_INTEGRITY_NONCE, b"", pseudo)


def encode_retry(dcid: bytes, scid: bytes, token: bytes,
                 odcid: bytes) -> bytes:
    """Server Retry packet (RFC 9000 §17.2.5): no packet number, no
    payload — just the token and the integrity tag binding it to the
    client's original DCID (so an off-path attacker cannot forge one
    without having seen the Initial)."""
    first = 0xC0 | (PKT_RETRY << 4)
    body = bytearray([first])
    body += QUIC_VERSION_1.to_bytes(4, "big")
    body += bytes([len(dcid)]) + dcid
    body += bytes([len(scid)]) + scid
    body += token
    return bytes(body) + _retry_tag(odcid, bytes(body))


def check_retry(datagram: bytes, odcid: bytes) -> Optional[bytes]:
    """Validate a Retry packet's integrity tag against the original DCID
    this client sent. -> the retry token, or None if invalid."""
    if len(datagram) < 23:  # header floor + 16-byte tag
        return None
    try:
        hdr = parse_long_header(datagram)
    except QuicWireError:
        return None
    if hdr.pkt_type != PKT_RETRY or hdr.version != QUIC_VERSION_1:
        return None
    token = datagram[hdr.hdr_end:-16]
    if not token:
        return None  # §17.2.5.1: a Retry MUST carry a non-empty token
    if _retry_tag(odcid, datagram[:-16]) != datagram[-16:]:
        return None
    return bytes(token)


def encode_stateless_reset(token16: bytes, size: int = 41) -> bytes:
    """Stateless Reset (RFC 9000 §10.3): indistinguishable from a short-
    header packet — fixed bit + unpredictable bytes, with the 16-byte
    reset token in the last 16 bytes. Minimum 21 bytes total."""
    import os as _os

    if len(token16) != 16:
        raise QuicWireError(
            f"stateless reset token must be 16 bytes, got {len(token16)}"
        )
    size = max(21, size)
    rand = bytearray(_os.urandom(size - 16))
    rand[0] = 0x40 | (rand[0] & 0x3F)
    return bytes(rand) + token16


def encode_path_frame(ftype: int, data8: bytes) -> bytes:
    """PATH_CHALLENGE / PATH_RESPONSE: type + 8 opaque bytes (RFC 9000
    §19.17-18)."""
    if ftype not in (FRAME_PATH_CHALLENGE, FRAME_PATH_RESPONSE):
        raise QuicWireError(f"not a path frame type: 0x{ftype:02x}")
    if len(data8) != 8:
        raise QuicWireError(
            f"path frame payload must be 8 bytes, got {len(data8)}"
        )
    return bytes([ftype]) + data8


def encode_ack(
    largest: int,
    ack_delay: int,
    first_range: int,
    ranges: List[Tuple[int, int]] = (),
) -> bytes:
    out = bytearray([FRAME_ACK])
    out += varint_encode(largest)
    out += varint_encode(ack_delay)
    out += varint_encode(len(ranges))
    out += varint_encode(first_range)
    for gap, rng in ranges:
        out += varint_encode(gap)
        out += varint_encode(rng)
    return bytes(out)


def encode_crypto(offset: int, data: bytes) -> bytes:
    return (
        bytes([FRAME_CRYPTO])
        + varint_encode(offset)
        + varint_encode(len(data))
        + data
    )


def encode_stream(
    stream_id: int, offset: int, data: bytes, fin: bool
) -> bytes:
    ftype = FRAME_STREAM_BASE | 0x02 | (0x04 if offset else 0) | int(fin)
    out = bytearray([ftype])
    out += varint_encode(stream_id)
    if offset:
        out += varint_encode(offset)
    out += varint_encode(len(data))
    out += data
    return bytes(out)


def encode_simple(ftype: int, *varints: int) -> bytes:
    out = bytearray([ftype])
    for v in varints:
        out += varint_encode(v)
    return bytes(out)


def encode_conn_close(
    error: int, frame_type: int, reason: bytes = b"", app: bool = False
) -> bytes:
    out = bytearray([FRAME_CONN_CLOSE_APP if app else FRAME_CONN_CLOSE_QUIC])
    out += varint_encode(error)
    if not app:
        out += varint_encode(frame_type)
    out += varint_encode(len(reason))
    out += reason
    return bytes(out)
