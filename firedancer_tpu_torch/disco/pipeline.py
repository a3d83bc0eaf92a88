"""Topology of the tile graph, the counterpart of
``firedancer_tpu/disco/pipeline.py`` (``build_topology``:64, ``LINKS``,
``TILES``, ``Topology``).

``build_topology`` creates the workspace file, the four links
(mcache, dcache and fseq each) and a cnc per tile, under the JAX
package's names, so either package's tiles can join it. Tiles join a
link by its name (``link_names``); the producer of a link takes credits
from the link's own fseq, which its consumer publishes.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..tango.rings import CNC_HALT, Cnc, DCache, FSeq, MCache, Workspace
from .tiles import FD_TPU_MTU, InLink, LinkNames, OutLink

LINKS = ("replay_verify", "verify_dedup", "dedup_pack", "pack_sink")
TILES = ("replay", "verify", "dedup", "pack", "sink", "quic")


@dataclass
class Topology:
    wksp_path: str
    depth: int = 128
    mtu: int = FD_TPU_MTU


def link_names(link: str) -> LinkNames:
    return LinkNames(f"{link}.mcache", f"{link}.dcache", f"{link}.fseq")


def dcache_size(depth: int, mtu: int = FD_TPU_MTU) -> int:
    """Bytes of a link's dcache: room for depth + 2 frags of mtu."""
    return 64 * ((mtu + 63) // 64) * (depth + 2)


def build_topology(wksp_path: str, depth: int = 128, mtu: int = FD_TPU_MTU,
                   wksp_sz: int = 1 << 24) -> Topology:
    """Create the workspace and every link and cnc; the file stays for
    tiles to join (Workspace.join)."""
    need = len(LINKS) * dcache_size(depth, mtu)
    if wksp_sz < need:
        raise ValueError(f"wksp_sz {wksp_sz} holds less than the links' "
                         f"dcaches ({need} bytes at depth {depth})")
    wksp = Workspace.create(wksp_path, wksp_sz)
    try:
        for link in LINKS:
            names = link_names(link)
            MCache(wksp, names.mcache, depth=depth, create=True)
            DCache(wksp, names.dcache, data_sz=dcache_size(depth, mtu),
                   create=True)
            FSeq(wksp, names.fseq, create=True)
        for tile in TILES:
            Cnc(wksp, f"{tile}.cnc", create=True)
    finally:
        wksp.leave()
    return Topology(wksp_path=wksp_path, depth=depth, mtu=mtu)


def in_link(wksp: Workspace, link: str) -> InLink:
    return InLink(wksp, link_names(link))


def out_link(wksp: Workspace, link: str, mtu: int = FD_TPU_MTU) -> OutLink:
    """The producer side of link, with its consumer's fseq as the one
    reliable consumer of the credit flow control."""
    names = link_names(link)
    return OutLink(wksp, names, mtu=mtu,
                   reliable_fseqs=[FSeq(wksp, names.fseq)])


def chain_quiesced(replay, verify, sink) -> bool:
    """replay -> verify -> sink has drained: the source is exhausted,
    verify consumed all of it with nothing staged or in flight, and the
    sink consumed all verify published."""
    return (replay.done()
            and verify.in_link.seq >= replay.out_link.seq
            and not verify._pending and not verify._inflight
            and sink.in_link.seq >= verify.out_link.seq)


def run_tiles(tiles, quiesced, timeout_s: float = 60.0) -> float:
    """Run each tile on a thread until quiesced() (or timeout_s, or a
    tile raising), then signal HALT through every cnc and join. Returns
    the seconds it ran; raises the first tile error, and TimeoutError
    when the tiles never quiesced."""
    errors: list = []

    def target(t):
        try:
            t.run(int((timeout_s + 30.0) * 1e9))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=target, args=(t,), name=t.name,
                                daemon=True) for t in tiles]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    done = False
    while time.perf_counter() - t0 < timeout_s and not errors:
        if quiesced():
            done = True
            break
        time.sleep(0.002)
    for t in tiles:
        t.cnc.signal(CNC_HALT)
    for th in threads:
        th.join(timeout=timeout_s + 35.0)
    elapsed = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if not done:
        raise TimeoutError(f"tiles did not drain within {timeout_s} s")
    return elapsed
