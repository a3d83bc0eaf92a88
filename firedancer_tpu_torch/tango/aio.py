"""aio — abstract async packet-burst IO.

Role parity with the reference's src/tango/aio/fd_aio.h (fd_aio_send
callback interface decoupling QUIC from XDP/sockets/pcap, aio/fd_aio.h:6-14).
An Aio endpoint is just a send callback taking a burst of (addr, payload)
packets; backends are UDP sockets (tango/udpsock), in-process wire pairs
(tests), or pcap writers.

The port's copy of ``firedancer_tpu/tango/aio.py``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

Packet = Tuple[object, bytes]  # (opaque peer address, datagram payload)


class Aio:
    """A packet sink: send_func receives a burst, returns #consumed."""

    def __init__(self, send_func: Callable[[List[Packet]], int]):
        self._send = send_func

    def send(self, batch: List[Packet]) -> int:
        return self._send(batch)

    def send_one(self, addr, payload: bytes) -> bool:
        return self._send([(addr, payload)]) == 1


class AioWirePair:
    """Two aio endpoints cross-wired through in-memory queues — the test
    fixture the reference builds in tango/quic/tests/fd_quic_test_helpers.c
    (virtual paired wires), with optional deterministic loss injection."""

    def __init__(self, drop_filter: Optional[Callable[[int, bytes], bool]] = None):
        self.a_to_b: List[Packet] = []
        self.b_to_a: List[Packet] = []
        self._n_sent = 0
        self._drop = drop_filter

    def _mk_send(self, queue: List[Packet]):
        def send(batch: List[Packet]) -> int:
            for addr, payload in batch:
                idx = self._n_sent
                self._n_sent += 1
                if self._drop is not None and self._drop(idx, payload):
                    continue  # deterministic loss injection
                queue.append((addr, payload))
            return len(batch)

        return send

    def endpoint_a(self) -> Aio:
        return Aio(self._mk_send(self.a_to_b))

    def endpoint_b(self) -> Aio:
        return Aio(self._mk_send(self.b_to_a))

    def drain_to_b(self) -> List[Packet]:
        out, self.a_to_b = self.a_to_b, []
        return out

    def drain_to_a(self) -> List[Packet]:
        out, self.b_to_a = self.b_to_a, []
        return out
