"""ctypes bindings of the native tango rings, the counterpart of
``firedancer_tpu/tango/rings.py`` (``ensure_native_built``:47, ``lib``:221,
``pylib``:250, ``Workspace``:443, ``MCache``, ``DCache``, ``FSeq``,
``Cnc``, ``Frag``; ``require_drain`` stands for ``native_available``:278
and ``verify_drain_abi2``:324; ``fd_frag_publish_bulk_ctl``
(``native/tango.cc:636``) is bound as at :169-184).

Both packages bind the one library ``build/libfdtango.so``, built by
``make`` from ``native/`` (``tango.cc``, ``verify_drain.cc``), so they
share one ring ABI (``native/tango_abi.h``): a workspace created by one
can be joined, published into and polled by the other. The publish and
consume protocols (the seqlock) live in C++; Python calls them through
ctypes. The ring ops of a few nanoseconds go through a GIL-holding
``PyDLL`` handle (``pylib``), always: a ``CDLL`` call releases the GIL,
and with several tile threads in one interpreter each release can cost a
scheduler switch. The bulk drains stay on the ``CDLL`` handle so they
overlap other threads.

The port needs the current drain ABI (``fd_verify_drain`` with the
publish stamp and payload-hash outputs, ``fd_frag_drain`` with the ctl
and stamp outputs, and the bulk publisher ``fd_frag_publish_bulk_ctl``,
which copies a round's surviving frags into a link in one call, each
frag's ctl word from an array: the fd_drain's verdicts travel in it). A
library without them raises (``require_drain``) and names the rebuild;
there is no slower Python poll to fall back to.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LIB_PATH = os.path.join(REPO, "build", "libfdtango.so")
NATIVE_DIR = os.path.join(REPO, "native")

POLL_EMPTY = 0
POLL_FRAG = 1
POLL_OVERRUN = 2

CTL_SOM = 1
CTL_EOM = 2
CTL_ERR = 4

CNC_BOOT = 0
CNC_RUN = 1
CNC_HALT = 2
CNC_FAIL = 3

# fseq diag slots (fd_fseq.h:57-63 ABI analog)
DIAG_PUB_CNT = 0
DIAG_PUB_SZ = 1
DIAG_FILT_CNT = 2
DIAG_FILT_SZ = 3
DIAG_OVRNP_CNT = 4
DIAG_OVRNR_CNT = 5
DIAG_SLOW_CNT = 6

REBUILD = "make -C native"


def ensure_native_built(lib_path: str = LIB_PATH) -> None:
    """Build the ring library with ``make -C native`` when lib_path is
    missing; an flock serializes concurrent builds so none loads a
    half-written .so."""
    if os.path.exists(lib_path):
        return
    import fcntl

    build_dir = os.path.dirname(lib_path)
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".build.lock"), "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        if not os.path.exists(lib_path):
            subprocess.run(["make", "-s", "-C", NATIVE_DIR,
                            os.path.relpath(lib_path, NATIVE_DIR)],
                           check=True)


_u32, _u64, _vp = ctypes.c_uint32, ctypes.c_uint64, ctypes.c_void_p


def load_lib() -> ctypes.CDLL:
    ensure_native_built(LIB_PATH)
    lib = ctypes.CDLL(LIB_PATH)
    proto = {
        "fd_wksp_create": (_vp, [ctypes.c_char_p, _u64]),
        "fd_wksp_join": (_vp, [ctypes.c_char_p]),
        "fd_wksp_leave": (None, [_vp]),
        "fd_wksp_alloc": (_u64, [_vp, ctypes.c_char_p, _u64, _u64]),
        "fd_wksp_query": (_u64, [_vp, ctypes.c_char_p,
                                 ctypes.POINTER(_u64)]),
        "fd_wksp_laddr": (_vp, [_vp, _u64]),
        "fd_wksp_alloc_cnt": (_u32, [_vp]),
        "fd_wksp_stat": (ctypes.c_int, [_vp, _u32, ctypes.c_char_p,
                                        ctypes.POINTER(_u64),
                                        ctypes.POINTER(_u64)]),
        "fd_wksp_usage": (None, [_vp, _vp]),
        "fd_wksp_page_probe": (_u64, []),
        "fd_mcache_footprint": (_u64, [_u64]),
        "fd_mcache_init": (None, [_vp, _u64]),
        "fd_mcache_depth": (_u64, [_vp]),
        "fd_mcache_seq_next": (_u64, [_vp]),
        "fd_mcache_publish": (None, [_vp, _u64, _u64, _u32, ctypes.c_uint16,
                                     ctypes.c_uint16, _u32, _u32]),
        "fd_mcache_poll": (ctypes.c_int, [_vp, _u64,
                                          ctypes.POINTER(_u64 * 4)]),
        "fd_fseq_footprint": (_u64, []),
        "fd_fseq_init": (None, [_vp]),
        "fd_fseq_update": (None, [_vp, _u64]),
        "fd_fseq_query": (_u64, [_vp]),
        "fd_fseq_diag_add": (None, [_vp, _u32, _u64]),
        "fd_fseq_diag_get": (_u64, [_vp, _u32]),
        "fd_cnc_footprint": (_u64, []),
        "fd_cnc_init": (None, [_vp]),
        "fd_cnc_signal": (None, [_vp, _u64]),
        "fd_cnc_signal_query": (_u64, [_vp]),
        "fd_cnc_heartbeat": (None, [_vp, _u64]),
        "fd_cnc_heartbeat_query": (_u64, [_vp]),
        "fd_cnc_diag_add": (None, [_vp, _u32, _u64]),
        "fd_cnc_diag_get": (_u64, [_vp, _u32]),
        "fd_dcache_next_chunk": (_u32, [_u32, _u32, _u32, _u32]),
    }
    for name, (res, args) in proto.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    if hasattr(lib, "fd_verify_drain_abi2"):
        lib.fd_verify_drain.restype = ctypes.c_int
        lib.fd_verify_drain.argtypes = [
            _vp, _vp, ctypes.POINTER(_u64),     # mcache, dcache, seq_io
            _u32, _u32, _u32, _u32,             # txns, room, hard_lanes, mtu
            _vp, _vp, _vp, _vp,                 # msgs, lens, sigs, pubs
            _vp, _u32,                          # payloads, cap
            _vp, _vp, _vp,                      # payload offs, lens, sigs
            _vp, _vp, _vp, _vp,                 # lanes, tsorig, tspub, hash
            _vp,                                # counters
        ]
    if (hasattr(lib, "fd_frag_drain_has_ctl")
            and hasattr(lib, "fd_frag_drain_has_tspub")):
        lib.fd_frag_drain.restype = ctypes.c_int
        lib.fd_frag_drain.argtypes = [
            _vp, _vp, ctypes.POINTER(_u64),     # mcache, dcache, seq_io
            _u32, _u32,                         # max_n, mtu
            _vp, _u32,                          # payloads, cap
            _vp, _vp, _vp, _vp, _vp,            # offs, lens, sigs, ts, seqs
            _vp, _vp,                           # ctls, tspubs
            _vp,                                # counters
        ]
    if hasattr(lib, "fd_frag_publish_bulk_ctl"):
        lib.fd_frag_publish_bulk_ctl.restype = ctypes.c_int
        lib.fd_frag_publish_bulk_ctl.argtypes = [
            _vp, _vp, _u32, _u32,               # mcache, dcache, chunks, mtu
            ctypes.POINTER(_u64),               # seq_io
            ctypes.POINTER(_u32),               # chunk_io
            _vp, _vp, _vp, _vp,                 # payloads, offs, lens, sigs
            _vp, _vp, _vp,                      # tsorigs, ctls, mask
            ctypes.POINTER(_u32),               # txn_io
            _u32, _u32, _u32,                   # n_txn, max_pub, now32
            _vp,                                # bytes_out
        ]
    return lib


_lib = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = load_lib()
    return _lib


# The ring ops whose C bodies take nanoseconds, called per frag.
_HOT_FUNCS = (
    "fd_mcache_depth", "fd_mcache_seq_next", "fd_mcache_publish",
    "fd_mcache_poll", "fd_fseq_update", "fd_fseq_query",
    "fd_fseq_diag_add", "fd_fseq_diag_get", "fd_cnc_signal",
    "fd_cnc_signal_query", "fd_cnc_heartbeat", "fd_cnc_heartbeat_query",
    "fd_cnc_diag_add", "fd_cnc_diag_get", "fd_dcache_next_chunk",
)

_pylib = None


def pylib() -> ctypes.PyDLL:
    """GIL-holding handle for the ring ops of _HOT_FUNCS, with the
    prototypes of the CDLL handle."""
    global _pylib
    if _pylib is None:
        L = lib()
        pl = ctypes.PyDLL(LIB_PATH)
        for name in _HOT_FUNCS:
            src, dst = getattr(L, name), getattr(pl, name)
            dst.restype = src.restype
            dst.argtypes = src.argtypes
        _pylib = pl
    return _pylib


def require_drain() -> None:
    """Raise unless the library builds, loads and has the current drain
    entry points: the tiles run on them and take no slower path."""
    L = lib()
    if not all(hasattr(L, name) for name in (
            "fd_verify_drain_abi2", "fd_frag_drain_has_ctl",
            "fd_frag_drain_has_tspub", "fd_frag_publish_bulk_ctl")):
        raise RuntimeError(
            f"{LIB_PATH} lacks the current drain entry points "
            "(fd_verify_drain_abi2, fd_frag_drain_has_ctl, "
            "fd_frag_drain_has_tspub, fd_frag_publish_bulk_ctl): rebuild "
            f"it with `{REBUILD}`")


@dataclass
class Frag:
    seq: int
    sig: int
    chunk: int
    sz: int
    ctl: int
    tsorig: int
    tspub: int


class Workspace:
    """A shared-memory file of named allocations."""

    def __init__(self, handle: int):
        self._h = handle

    @classmethod
    def create(cls, path: str, size: int) -> "Workspace":
        h = lib().fd_wksp_create(path.encode(), size)
        if not h:
            raise OSError(f"wksp create failed: {path}")
        return cls(h)

    @classmethod
    def join(cls, path: str) -> "Workspace":
        h = lib().fd_wksp_join(path.encode())
        if not h:
            raise OSError(f"wksp join failed: {path}")
        return cls(h)

    def leave(self) -> None:
        lib().fd_wksp_leave(self._h)
        self._h = None

    def alloc(self, name: str, sz: int, align: int = 64) -> int:
        off = lib().fd_wksp_alloc(self._h, name.encode(), sz, align)
        if not off:
            raise MemoryError(f"wksp alloc failed: {name}")
        return off

    def query(self, name: str) -> tuple[int, int]:
        sz = _u64()
        off = lib().fd_wksp_query(self._h, name.encode(), ctypes.byref(sz))
        if not off:
            raise KeyError(name)
        return off, sz.value

    def laddr(self, off: int) -> int:
        return lib().fd_wksp_laddr(self._h, off)

    def alloc_list(self) -> list[tuple[str, int, int]]:
        """[(name, off, sz)] of every named allocation (fd_wksp_ctl list)."""
        name, off, sz = ctypes.create_string_buffer(64), _u64(), _u64()
        out = []
        for i in range(lib().fd_wksp_alloc_cnt(self._h)):
            if lib().fd_wksp_stat(self._h, i, name, ctypes.byref(off),
                                  ctypes.byref(sz)) == 0:
                out.append((name.value.decode(), off.value, sz.value))
        return out

    def usage(self) -> dict:
        """{total_sz, used, alloc_cnt} of the workspace."""
        buf = (_u64 * 3)()
        lib().fd_wksp_usage(self._h, buf)
        return {"total_sz": buf[0], "used": buf[1], "alloc_cnt": buf[2]}


class MCache:
    """Frag metadata ring: depth lines of (seq, sig, chunk, sz, ctl,
    tsorig, tspub) under a seqlock."""

    def __init__(self, wksp: Workspace, name: str, depth: int | None = None,
                 create: bool = False):
        if create:
            if depth is None or depth <= 0 or depth & (depth - 1) != 0:
                # The line index is seq & (depth - 1).
                raise ValueError(f"mcache depth must be a positive power "
                                 f"of two, got {depth!r}")
            off = wksp.alloc(name, lib().fd_mcache_footprint(depth))
            self._mem = wksp.laddr(off)
            lib().fd_mcache_init(self._mem, depth)
        else:
            off, _ = wksp.query(name)
            self._mem = wksp.laddr(off)
        self.depth = pylib().fd_mcache_depth(self._mem)

    def seq_next(self) -> int:
        return pylib().fd_mcache_seq_next(self._mem)

    def publish(self, seq: int, sig: int, chunk: int, sz: int, ctl: int,
                tsorig: int = 0, tspub: int = 0) -> None:
        pylib().fd_mcache_publish(self._mem, seq, sig, chunk, sz, ctl,
                                  tsorig, tspub)

    def poll(self, seq: int) -> tuple[int, Frag | None]:
        out = (_u64 * 4)()
        r = pylib().fd_mcache_poll(self._mem, seq, ctypes.byref(out))
        if r != POLL_FRAG:
            return r, None
        sig, b, ts, s = out
        return r, Frag(seq=s, sig=sig, chunk=(b >> 32) & 0xFFFFFFFF,
                       sz=(b >> 16) & 0xFFFF, ctl=b & 0xFFFF,
                       tsorig=(ts >> 32) & 0xFFFFFFFF, tspub=ts & 0xFFFFFFFF)


class DCache:
    """Payload region, addressed by 64-byte chunk."""

    def __init__(self, wksp: Workspace, name: str, data_sz: int | None = None,
                 create: bool = False):
        if create:
            if data_sz is None or data_sz <= 0 or data_sz % 64 != 0:
                raise ValueError(f"dcache data_sz must be a positive "
                                 f"multiple of 64, got {data_sz!r}")
            off = wksp.alloc(name, data_sz)
        else:
            off, data_sz = wksp.query(name)
        self._buf = (ctypes.c_char * data_sz).from_address(wksp.laddr(off))
        self.data_sz = data_sz
        self.chunk_cnt = data_sz // 64

    def write(self, chunk: int, data: bytes) -> None:
        o = chunk * 64
        self._buf[o:o + len(data)] = data

    def read(self, chunk: int, sz: int) -> bytes:
        o = chunk * 64
        return bytes(self._buf[o:o + sz])

    def next_chunk(self, chunk: int, sz: int, mtu: int) -> int:
        return pylib().fd_dcache_next_chunk(chunk, sz, (mtu + 63) // 64,
                                            self.chunk_cnt)


class FSeq:
    """A consumer's published progress and its diag counters."""

    def __init__(self, wksp: Workspace, name: str, create: bool = False):
        if create:
            off = wksp.alloc(name, lib().fd_fseq_footprint())
            self._mem = wksp.laddr(off)
            lib().fd_fseq_init(self._mem)
        else:
            off, _ = wksp.query(name)
            self._mem = wksp.laddr(off)

    def update(self, seq: int) -> None:
        pylib().fd_fseq_update(self._mem, seq)

    def query(self) -> int:
        return pylib().fd_fseq_query(self._mem)

    def diag_add(self, idx: int, delta: int) -> None:
        pylib().fd_fseq_diag_add(self._mem, idx, delta)

    def diag(self, idx: int) -> int:
        return pylib().fd_fseq_diag_get(self._mem, idx)


class Cnc:
    """A tile's command-and-control word, heartbeat and diag slots."""

    def __init__(self, wksp: Workspace, name: str, create: bool = False):
        if create:
            off = wksp.alloc(name, lib().fd_cnc_footprint())
            self._mem = wksp.laddr(off)
            lib().fd_cnc_init(self._mem)
        else:
            off, _ = wksp.query(name)
            self._mem = wksp.laddr(off)

    def signal(self, sig: int) -> None:
        pylib().fd_cnc_signal(self._mem, sig)

    def signal_query(self) -> int:
        return pylib().fd_cnc_signal_query(self._mem)

    def heartbeat(self, now: int) -> None:
        pylib().fd_cnc_heartbeat(self._mem, now)

    def heartbeat_query(self) -> int:
        return pylib().fd_cnc_heartbeat_query(self._mem)

    def diag_add(self, idx: int, delta: int) -> None:
        pylib().fd_cnc_diag_add(self._mem, idx, delta)

    def diag(self, idx: int) -> int:
        return pylib().fd_cnc_diag_get(self._mem, idx)
