"""pcapng — next-generation capture file reader/writer, a copy of
``firedancer_tpu/utils/pcapng.py`` (``PcapngWriter``:85,
``PcapngReader``:162, ``read_all``:309), which ``pcap.read_capture``
reads when a capture starts with the pcapng magic.

Role parity with the reference's fd_pcapng (src/util/net/fd_pcapng.h,
fd_pcapng.c): the block types it handles are SHB (section header), IDB
(interface description), SPB (simple packet), EPB (enhanced packet) and
DSB (decryption secrets, TLS keys); unknown block types are skipped.
Parsing is hardened against malicious inputs: every length is
bounds-checked,
option walks cannot run off a block, and malformed files raise
ValueError — never crash or hang.

Differences from the reference, by design:
- both endiannesses are accepted on read (the reference is LE-only;
  the spec allows either — superset, like pcap.py's dual-endian read);
  writing is little-endian.
- frames are returned as plain tuples, not a fixed 16 KiB buffer.

Timestamps: EPB carries a 64-bit timestamp in units of the interface's
if_tsresol option (default 10^-6 s; the writer emits nanosecond
resolution like the reference, FD_PCAPNG_TSRESOL_NS). Frames normalize
to integer nanoseconds.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional

BLOCK_SHB = 0x0A0D0D0A
BLOCK_IDB = 0x00000001
BLOCK_SPB = 0x00000003
BLOCK_EPB = 0x00000006
BLOCK_DSB = 0x0000000A

BYTE_ORDER_MAGIC = 0x1A2B3C4D

# Frame types (mirror FD_PCAPNG_FRAME_*).
FRAME_SIMPLE = 1
FRAME_ENHANCED = 3
FRAME_TLSKEYS = 4

SECRET_TYPE_TLS = 0x544C534B  # "TLSK" — NSS key log payload

OPT_END = 0
OPT_COMMENT = 1
OPT_SHB_HARDWARE = 2
OPT_SHB_OS = 3
OPT_SHB_USERAPPL = 4
OPT_IDB_NAME = 2
OPT_IDB_TSRESOL = 9

LINKTYPE_ETHERNET = 1
LINKTYPE_USER0 = 147

# Hard cap on any single block (spec recommends bounding; the reference
# rejects frames above FD_PCAPNG_FRAME_SZ=16 KiB — we allow packets up
# to 64 KiB plus block overhead).
_MAX_BLOCK = 1 << 20


@dataclass
class PcapngFrame:
    """One parsed frame (packet or metadata)."""

    ts_ns: int          # nanoseconds (0 for SPB: no timestamp on wire)
    type: int           # FRAME_SIMPLE / FRAME_ENHANCED / FRAME_TLSKEYS
    if_idx: int         # interface index (0 for SPB/DSB)
    data: bytes         # packet bytes / key-log text
    orig_sz: int        # original length (>= len(data) if truncated)


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def _opt_bytes(opts: List[tuple], code: int) -> Optional[bytes]:
    for c, v in opts:
        if c == code:
            return v
    return None


class PcapngWriter:
    """Writes one section: SHB + one IDB, then packets/secrets.

    Matches the reference writer's shape (fd_pcapng_shb_write,
    fd_pcapng_idb_write, fd_pcapng_write_pkt, fd_pcapng_write_tls_keys):
    little-endian, nanosecond if_tsresol, options carried on SHB/IDB.
    """

    def __init__(self, path: str, linktype: int = LINKTYPE_USER0,
                 hardware: str = "", os_name: str = "",
                 userappl: str = "firedancer-tpu",
                 if_name: str = "") -> None:
        self._f = open(path, "wb")
        opts = []
        if hardware:
            opts.append((OPT_SHB_HARDWARE, hardware.encode()))
        if os_name:
            opts.append((OPT_SHB_OS, os_name.encode()))
        if userappl:
            opts.append((OPT_SHB_USERAPPL, userappl.encode()))
        body = struct.pack("<IHHq", BYTE_ORDER_MAGIC, 1, 0, -1)
        body += self._encode_opts(opts)
        self._block(BLOCK_SHB, body)
        iopts = []
        if if_name:
            iopts.append((OPT_IDB_NAME, if_name.encode()))
        iopts.append((OPT_IDB_TSRESOL, bytes([9])))  # 10^-9: ns
        body = struct.pack("<HHI", linktype, 0, 0)
        body += self._encode_opts(iopts)
        self._block(BLOCK_IDB, body)

    @staticmethod
    def _encode_opts(opts: List[tuple]) -> bytes:
        if not opts:
            return b""
        out = b""
        for code, val in opts:
            out += struct.pack("<HH", code, len(val))
            out += val + b"\x00" * (_pad4(len(val)) - len(val))
        out += struct.pack("<HH", OPT_END, 0)
        return out

    def _block(self, btype: int, body: bytes) -> None:
        total = 12 + _pad4(len(body))
        self._f.write(struct.pack("<II", btype, total))
        self._f.write(body + b"\x00" * (_pad4(len(body)) - len(body)))
        self._f.write(struct.pack("<I", total))

    def write(self, payload: bytes, ts_ns: int = 0, if_idx: int = 0) -> None:
        """Enhanced Packet Block."""
        body = struct.pack("<IIIII", if_idx, (ts_ns >> 32) & 0xFFFFFFFF,
                           ts_ns & 0xFFFFFFFF, len(payload), len(payload))
        body += payload + b"\x00" * (_pad4(len(payload)) - len(payload))
        self._block(BLOCK_EPB, body)

    def write_simple(self, payload: bytes) -> None:
        """Simple Packet Block (no timestamp/interface)."""
        body = struct.pack("<I", len(payload))
        body += payload + b"\x00" * (_pad4(len(payload)) - len(payload))
        self._block(BLOCK_SPB, body)

    def write_tls_keys(self, keylog: bytes) -> None:
        """Decryption Secrets Block with an NSS key log payload."""
        body = struct.pack("<II", SECRET_TYPE_TLS, len(keylog))
        body += keylog + b"\x00" * (_pad4(len(keylog)) - len(keylog))
        self._block(BLOCK_DSB, body)

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "PcapngWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PcapngReader:
    """Iterates frames across all sections of a pcapng file."""

    def __init__(self, path: str) -> None:
        self._f = open(path, "rb")
        self._end = "<"
        self._linktypes: List[int] = []
        self._tsresol: List[int] = []   # ns per tick, per interface
        self.linktype: Optional[int] = None
        # The file must open with an SHB (spec §4.1); read it eagerly so
        # a non-pcapng file fails in the constructor like PcapReader.
        hdr = self._f.read(8)
        if len(hdr) < 8:
            raise ValueError("truncated pcapng header")
        btype_le = struct.unpack("<I", hdr[:4])[0]
        if btype_le != BLOCK_SHB:
            raise ValueError(f"bad pcapng leading block {btype_le:#x}")
        self._read_shb_after_type(hdr[4:])

    # -- block-level helpers ------------------------------------------

    def _read_shb_after_type(self, len_bytes: bytes) -> None:
        """Parse an SHB given the 4 bytes after block_type; sets section
        endianness and resets interface state."""
        body_probe = self._f.read(4)
        if len(body_probe) < 4:
            raise ValueError("truncated SHB")
        bom = struct.unpack("<I", body_probe)[0]
        if bom == BYTE_ORDER_MAGIC:
            self._end = "<"
        elif bom == struct.unpack("<I", struct.pack(">I", BYTE_ORDER_MAGIC))[0]:
            self._end = ">"
        else:
            raise ValueError(f"bad pcapng byte-order magic {bom:#x}")
        total = struct.unpack(self._end + "I", len_bytes)[0]
        if total < 28 or total > _MAX_BLOCK or total % 4:
            raise ValueError(f"bad SHB length {total}")
        rest = self._f.read(total - 12)
        if len(rest) < total - 12:
            raise ValueError("truncated SHB")
        trail = struct.unpack(self._end + "I", rest[-4:])[0]
        if trail != total:
            raise ValueError("SHB trailing length mismatch")
        # New section: interface table resets.
        self._linktypes = []
        self._tsresol = []

    def _walk_opts(self, buf: bytes) -> List[tuple]:
        """Hardened option walk: returns [(code, value)], stops at
        opt_endofopt or end of buffer; never reads past buf."""
        opts = []
        off = 0
        while off + 4 <= len(buf):
            code, olen = struct.unpack_from(self._end + "HH", buf, off)
            off += 4
            if code == OPT_END:
                break
            if off + olen > len(buf):
                raise ValueError("option overruns block")
            opts.append((code, buf[off:off + olen]))
            off += _pad4(olen)
        return opts

    def _handle_idb(self, body: bytes) -> None:
        if len(body) < 8:
            raise ValueError("short IDB")
        linktype, _, _snap = struct.unpack_from(self._end + "HHI", body, 0)
        self._linktypes.append(linktype)
        if self.linktype is None:
            self.linktype = linktype
        resol_ns = 1000  # default 10^-6 s
        for code, val in self._walk_opts(body[8:]):
            if code == OPT_IDB_TSRESOL and len(val) >= 1:
                r = val[0]
                if r & 0x80:        # power of 2
                    p = r & 0x7F
                    if p > 63:
                        raise ValueError("if_tsresol out of range")
                    resol_ns = max(1, int(round(1e9 / (1 << p))))
                else:               # power of 10
                    if r > 9:
                        raise ValueError("if_tsresol out of range")
                    resol_ns = 10 ** (9 - r)
        self._tsresol.append(resol_ns)

    def __iter__(self) -> Iterator[PcapngFrame]:
        while True:
            hdr = self._f.read(8)
            if len(hdr) < 8:
                return
            btype_raw = struct.unpack("<I", hdr[:4])[0]
            if btype_raw == BLOCK_SHB:
                # next section (SHB is endian-invariant: palindromic)
                self._read_shb_after_type(hdr[4:])
                continue
            btype, total = struct.unpack(self._end + "II", hdr)
            if total < 12 or total > _MAX_BLOCK or total % 4:
                raise ValueError(f"bad block length {total}")
            rest = self._f.read(total - 8)
            if len(rest) < total - 8:
                return  # truncated tail: EOF mid-block
            body, trail = rest[:-4], rest[-4:]
            if struct.unpack(self._end + "I", trail)[0] != total:
                raise ValueError("block trailing length mismatch")
            if btype == BLOCK_EPB:
                if len(body) < 20:
                    raise ValueError("short EPB")
                if_idx, ts_hi, ts_lo, cap, orig = struct.unpack_from(
                    self._end + "IIIII", body, 0)
                if 20 + cap > len(body):
                    raise ValueError("EPB capture length overruns block")
                if if_idx >= max(len(self._linktypes), 1):
                    raise ValueError("EPB references unknown interface")
                resol = (self._tsresol[if_idx]
                         if if_idx < len(self._tsresol) else 1000)
                ts = ((ts_hi << 32) | ts_lo) * resol
                yield PcapngFrame(ts, FRAME_ENHANCED, if_idx,
                                  body[20:20 + cap], orig)
            elif btype == BLOCK_SPB:
                if len(body) < 4:
                    raise ValueError("short SPB")
                orig = struct.unpack_from(self._end + "I", body, 0)[0]
                cap = min(orig, len(body) - 4)
                yield PcapngFrame(0, FRAME_SIMPLE, 0, body[4:4 + cap], orig)
            elif btype == BLOCK_DSB:
                if len(body) < 8:
                    raise ValueError("short DSB")
                stype, slen = struct.unpack_from(self._end + "II", body, 0)
                if 8 + slen > len(body):
                    raise ValueError("DSB secrets overrun block")
                if stype == SECRET_TYPE_TLS:
                    yield PcapngFrame(0, FRAME_TLSKEYS, 0,
                                      body[8:8 + slen], slen)
            elif btype == BLOCK_IDB:
                self._handle_idb(body)
            # unknown block types: skipped

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "PcapngReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_all(path: str) -> List[bytes]:
    """All packet payloads (EPB + SPB frames) in file order."""
    with PcapngReader(path) as r:
        return [f.data for f in r
                if f.type in (FRAME_SIMPLE, FRAME_ENHANCED)]
