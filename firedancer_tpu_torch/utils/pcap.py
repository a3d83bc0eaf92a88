"""pcap — classic libpcap file reader/writer, a copy of
``firedancer_tpu/utils/pcap.py`` (``PcapWriter``:23, ``PcapReader``:46,
``read_all``:88, ``read_capture``:93): the input of ``fdctl run
--source pcap``.

Role parity with the reference's fd_pcap (src/util/net/fd_pcap.h): the
fixture format for the replay tile and deterministic end-to-end tests.
Supports
the classic 24-byte global header (magic 0xA1B2C3D4, usec timestamps; the
nanosecond 0xA1B23C4D magic is also accepted on read), both endiannesses,
and LINKTYPE_USER0 (147) for raw transaction payloads as well as
LINKTYPE_ETHERNET (1).
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple

MAGIC_USEC = 0xA1B2C3D4
MAGIC_NSEC = 0xA1B23C4D
LINKTYPE_ETHERNET = 1
LINKTYPE_USER0 = 147


class PcapWriter:
    def __init__(self, path: str, linktype: int = LINKTYPE_USER0) -> None:
        self._f = open(path, "wb")
        self._f.write(
            struct.pack("<IHHiIII", MAGIC_USEC, 2, 4, 0, 0, 65535, linktype)
        )

    def write(self, payload: bytes, ts_sec: int = 0, ts_usec: int = 0) -> None:
        self._f.write(
            struct.pack("<IIII", ts_sec, ts_usec, len(payload), len(payload))
        )
        self._f.write(payload)

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "PcapWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PcapReader:
    def __init__(self, path: str) -> None:
        self._f = open(path, "rb")
        hdr = self._f.read(24)
        if len(hdr) < 24:
            raise ValueError("truncated pcap header")
        magic = struct.unpack("<I", hdr[:4])[0]
        if magic in (MAGIC_USEC, MAGIC_NSEC):
            self._end = "<"
        elif magic in (
            struct.unpack(">I", struct.pack("<I", MAGIC_USEC))[0],
            struct.unpack(">I", struct.pack("<I", MAGIC_NSEC))[0],
        ):
            self._end = ">"
        else:
            raise ValueError(f"bad pcap magic {magic:#x}")
        (_, _, _, _, _, self.linktype) = struct.unpack(
            self._end + "HHiIII", hdr[4:]
        )

    def __iter__(self) -> Iterator[Tuple[int, int, bytes]]:
        """Yields (ts_sec, ts_frac, payload)."""
        while True:
            rec = self._f.read(16)
            if len(rec) < 16:
                return
            ts_sec, ts_frac, incl, _orig = struct.unpack(self._end + "IIII", rec)
            payload = self._f.read(incl)
            if len(payload) < incl:
                return
            yield ts_sec, ts_frac, payload

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "PcapReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_all(path: str) -> List[bytes]:
    with PcapReader(path) as r:
        return [p for _, _, p in r]


def read_capture(path: str) -> List[bytes]:
    """Auto-detecting reader: classic pcap or pcapng, by leading magic
    (the reference exposes both fd_pcap and fd_pcapng; capture tooling
    emits either). Returns packet payloads in file order."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if len(magic) == 4 and struct.unpack("<I", magic)[0] == 0x0A0D0D0A:
        from . import pcapng

        return pcapng.read_all(path)
    return read_all(path)
