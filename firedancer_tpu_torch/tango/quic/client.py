"""A QUIC client that delivers transactions, one a unidirectional stream,
over a number of connections from one thread: the sender of
``disco.pipeline.run_quic_pipeline``'s ``client_fn`` in the tests and in
``chip_smoke.py`` (the JAX tests' ``_quic_client``,
``tests/test_quic_pipeline.py:43``, over several connections).

``deliver`` connects every connection at once, sends each its share of
the payloads as its handshake completes, and returns when every stream
was sent and acknowledged (or at its deadline), with the handshakes'
clock. ``junk`` sends datagrams of seeded garbage from one socket, the
abusive peer of the QUIC tile's quarantine.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Sequence, Tuple

from ..udpsock import UdpBatchSock
from .quic import Quic, QuicConfig


def deliver(listen_addr: Tuple[str, int], shares: Sequence[Sequence[bytes]],
            deadline_s: float = 60.0) -> Dict[str, object]:
    """Deliver shares[i] over connection i (one endpoint, one socket) to
    listen_addr over a batched socket (``UdpBatchSock``). Returns
    {"acked": every stream sent and acknowledged before deadline_s,
    "t_connect", "t_established": perf_counter seconds of the connects
    and of the last handshake}."""
    sock = UdpBatchSock()
    tx_aio = sock.aio_tx()
    client = Quic(QuicConfig(is_server=False, identity_seed=os.urandom(32)),
                  tx=lambda addr, d: tx_aio.send_one(addr, d))
    t0 = time.monotonic()
    t_connect = time.perf_counter()
    conns = [client.connect(listen_addr, 0.0) for _ in shares]
    sent = [False] * len(conns)
    t_est = t_connect
    acked = False
    try:
        while time.monotonic() - t0 < deadline_s:
            now = time.monotonic() - t0
            sock.service_rx(lambda addr, d: client.rx(addr, d, now))
            client.service(now)
            for i, conn in enumerate(conns):
                if conn.established and not sent[i]:
                    t_est = time.perf_counter()
                    for p in shares[i]:
                        conn.send_stream(p)
                    sent[i] = True
            if all(sent) and all(not c._send_queue
                                 and not any(s.sent for s in c.spaces)
                                 for c in conns):
                acked = True
                break
            time.sleep(0.0005)
    finally:
        sock.close()
    return {"acked": acked, "t_connect": t_connect, "t_established": t_est}


def junk(listen_addr: Tuple[str, int], n: int,
         seed: int = 0) -> Tuple[int, Tuple[str, int]]:
    """Send n datagrams of 64 seeded garbage bytes from one socket (a
    short header's first byte: the unknown-cid path). Returns
    (datagrams sent, the socket's address)."""
    import random

    rng = random.Random(seed)
    sock = UdpBatchSock()
    addr = sock.local_addr
    tx = sock.aio_tx()
    sent = 0
    try:
        for _ in range(n):
            dg = bytes([0x40 | rng.randrange(0x40)]) + bytes(
                rng.randrange(256) for _ in range(63))
            sent += int(tx.send_one(listen_addr, dg))
    finally:
        sock.close()
    return sent, addr
