"""udpsock — plain UDP socket aio backend.

Role parity with the reference's src/tango/udpsock/fd_udpsock.{h,c}: the
development stand-in for the XDP kernel-bypass path. A nonblocking UDP
socket drained in bursts into an rx callback, with an Aio-shaped tx side.
(The reference's AF_XDP path, tango/xdp/fd_xsk.*, has no TPU-host
equivalent here: kernel bypass NICs are out of scope for the dev loop; the
architecture keeps the same aio seam so one can be slotted in.)

The port's copy of ``firedancer_tpu/tango/udpsock.py``.
"""

from __future__ import annotations

import os
import socket
from typing import Callable, List, Optional, Tuple

from .aio import Aio, Packet

MTU = 2048
RX_BURST = 64
# The batched backend's library (native/udp_batch.cc), built with the
# ring library by ``make -C native``.
LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "libfdudp.so")


class UdpSock:
    """Nonblocking UDP socket with aio-style burst service."""

    def __init__(self, bind_addr: Tuple[str, int] = ("127.0.0.1", 0)):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setblocking(False)
        self._sock.bind(bind_addr)
        self.local_addr = self._sock.getsockname()
        self.metrics = {"rx_pkts": 0, "tx_pkts": 0, "tx_fails": 0}

    def aio_tx(self) -> Aio:
        def send(batch: List[Packet]) -> int:
            n = 0
            for addr, payload in batch:
                try:
                    self._sock.sendto(payload, addr)
                    self.metrics["tx_pkts"] += 1
                    n += 1
                except (BlockingIOError, OSError):
                    self.metrics["tx_fails"] += 1
            return n

        return Aio(send)

    def service_rx(
        self, on_packet: Callable[[Tuple[str, int], bytes], None]
    ) -> int:
        """Drain up to RX_BURST datagrams into on_packet. -> count."""
        n = 0
        for _ in range(RX_BURST):
            try:
                data, addr = self._sock.recvfrom(MTU)
            except BlockingIOError:
                break
            except OSError:
                break
            self.metrics["rx_pkts"] += 1
            on_packet(addr, data)
            n += 1
        return n

    def close(self) -> None:
        self._sock.close()


class UdpBatchSock:
    """Batched UDP socket: recvmmsg/sendmmsg via the native helper.

    The environment-appropriate analog of the reference's AF_XDP stack
    (tango/xdp/fd_xsk.h:8-60): where fd_xsk amortizes kernel crossings
    with UMEM descriptor rings, this backend amortizes them with
    one-syscall batches (native/udp_batch.cc). Same aio seam as UdpSock,
    so QuicTile/clients swap backends without change. A library that does
    not build raises: the QUIC tile never falls back to UdpSock.
    """

    BATCH = 256

    def __init__(self, bind_addr: Tuple[str, int] = ("127.0.0.1", 0),
                 mtu: int = MTU, rcvbuf: int = 1 << 22):
        import ctypes

        import numpy as np

        from . import rings

        try:
            rings.ensure_native_built(LIB_PATH)
        except Exception as e:  # noqa: BLE001 - re-raised with the path
            raise RuntimeError(f"udpsock: {LIB_PATH} does not build ({e!r}); "
                               f"build it with `{rings.REBUILD}`") from e
        self._lib = ctypes.CDLL(LIB_PATH)
        self._lib.fd_udp_recv_batch.restype = ctypes.c_int
        self._lib.fd_udp_recv_batch.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_void_p]
        self._lib.fd_udp_send_batch.restype = ctypes.c_int
        self._lib.fd_udp_send_batch.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_uint32]

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setblocking(False)
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
        except OSError:
            pass
        self._sock.bind(bind_addr)
        self.local_addr = self._sock.getsockname()
        self.mtu = mtu
        self._np = np
        self._rx_buf = np.zeros((self.BATCH, mtu), np.uint8)
        self._rx_lens = np.zeros(self.BATCH, np.uint32)
        self._rx_addrs = np.zeros(2 * self.BATCH, np.uint32)
        self._tx_buf = np.zeros((self.BATCH, mtu), np.uint8)
        self._tx_lens = np.zeros(self.BATCH, np.uint32)
        self._tx_addrs = np.zeros(2 * self.BATCH, np.uint32)
        self.metrics = {"rx_pkts": 0, "tx_pkts": 0, "tx_fails": 0,
                        "rx_batches": 0}

    def aio_tx(self) -> Aio:
        import socket as _socket
        import struct as _struct

        def send(batch: List[Packet]) -> int:
            sent_total = 0
            for start in range(0, len(batch), self.BATCH):
                chunk = batch[start : start + self.BATCH]
                n = 0
                for addr, payload in chunk:
                    if len(payload) > self.mtu:
                        self.metrics["tx_fails"] += 1
                        continue
                    ip, port = addr
                    try:
                        packed = _struct.unpack(
                            "<I", _socket.inet_aton(ip))[0]
                    except OSError:
                        # An unroutable/synthetic peer address (e.g. a
                        # fault-injection placeholder) must cost one
                        # tx_fail, never kill the sending tile.
                        self.metrics["tx_fails"] += 1
                        continue
                    self._tx_buf[n, : len(payload)] = bytearray(payload)
                    self._tx_lens[n] = len(payload)
                    self._tx_addrs[2 * n] = packed
                    self._tx_addrs[2 * n + 1] = port
                    n += 1
                if not n:
                    continue
                rc = self._lib.fd_udp_send_batch(
                    self._sock.fileno(),
                    self._tx_buf.ctypes.data, self.mtu,
                    self._tx_lens.ctypes.data, self._tx_addrs.ctypes.data,
                    n)
                if rc < 0:
                    self.metrics["tx_fails"] += n
                    continue
                self.metrics["tx_pkts"] += rc
                self.metrics["tx_fails"] += n - rc
                sent_total += rc
            return sent_total

        return Aio(send)

    def service_rx(
        self, on_packet: Callable[[Tuple[str, int], bytes], None]
    ) -> int:
        """Drain one recvmmsg batch into on_packet. -> count."""
        import socket as _socket
        import struct as _struct

        rc = self._lib.fd_udp_recv_batch(
            self._sock.fileno(), self._rx_buf.ctypes.data, self.mtu,
            self.BATCH, self._rx_lens.ctypes.data,
            self._rx_addrs.ctypes.data)
        if rc <= 0:
            return 0
        self.metrics["rx_pkts"] += rc
        self.metrics["rx_batches"] += 1
        for i in range(rc):
            ln = int(self._rx_lens[i])
            ip = _socket.inet_ntoa(
                _struct.pack("<I", int(self._rx_addrs[2 * i])))
            port = int(self._rx_addrs[2 * i + 1])
            on_packet((ip, port), self._rx_buf[i, :ln].tobytes())
        return rc

    def close(self) -> None:
        self._sock.close()
