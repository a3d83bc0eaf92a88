"""pod — hierarchical typed key-value store (the runtime config tree), a
copy of ``firedancer_tpu/utils/pod.py`` (``Pod``, ``serialize``:106,
``deserialize``:128): the same inserts serialize to the same bytes, so
either package reads the other's pod file.

Role parity with the reference's fd_pod (src/util/pod/fd_pod.h): a
serializable tree of typed
values addressed by dotted paths ("firedancer.verify.v0.mcache"), used to
publish the shared-memory topology to every tile. Tiles query by path;
the configure stage inserts gaddrs/parameters.

TPU-first design note: the reference serializes the pod into the wksp so
any process can map it; here the canonical form is the same — a flat bytes
blob (tag-length-value, little-endian) that can live in a Workspace
allocation (tango.rings.Workspace.view) or a plain file, with this class
as the in-memory view.

Value types: uint64 (int), bytes, str (utf-8 cstr), and subpod (nested
dict), mirroring fd_pod's val_type space that the topology actually uses.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Optional, Tuple, Union

_T_SUBPOD = 0
_T_ULONG = 1
_T_CSTR = 2
_T_BUF = 3

Value = Union[int, str, bytes, "Pod"]


class Pod:
    """In-memory pod node. Keys are single path segments (no dots)."""

    def __init__(self) -> None:
        self._d: Dict[str, Value] = {}

    # -- insert/query by dotted path ------------------------------------

    def _descend(self, path: str, create: bool) -> Tuple["Pod", str]:
        parts = path.split(".")
        node = self
        for p in parts[:-1]:
            child = node._d.get(p)
            if child is None:
                if not create:
                    raise KeyError(path)
                child = Pod()
                node._d[p] = child
            elif not isinstance(child, Pod):
                raise KeyError(f"{path}: {p} is a leaf")
            node = child
        return node, parts[-1]

    def insert(self, path: str, value: Value) -> "Pod":
        assert isinstance(value, (int, str, bytes, Pod))
        node, key = self._descend(path, create=True)
        node._d[key] = value
        return self

    def insert_ulong(self, path: str, value: int) -> "Pod":
        return self.insert(path, int(value))

    def insert_cstr(self, path: str, value: str) -> "Pod":
        return self.insert(path, str(value))

    def query(self, path: str, default=None):
        try:
            node, key = self._descend(path, create=False)
            return node._d[key]
        except KeyError:
            return default

    def query_ulong(self, path: str, default: int = 0) -> int:
        v = self.query(path)
        return v if isinstance(v, int) else default

    def query_cstr(self, path: str, default: Optional[str] = None):
        v = self.query(path)
        return v if isinstance(v, str) else default

    def subpod(self, path: str) -> "Pod":
        v = self.query(path)
        if not isinstance(v, Pod):
            raise KeyError(path)
        return v

    def remove(self, path: str) -> bool:
        try:
            node, key = self._descend(path, create=False)
            return node._d.pop(key, None) is not None
        except KeyError:
            return False

    def iter_leaves(self, prefix: str = "") -> Iterator[Tuple[str, Value]]:
        """Depth-first (path, value) over non-subpod leaves."""
        for k, v in sorted(self._d.items()):
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, Pod):
                yield from v.iter_leaves(path)
            else:
                yield path, v

    # -- wire form -------------------------------------------------------

    def serialize(self) -> bytes:
        out = bytearray()
        for k, v in sorted(self._d.items()):
            key = k.encode()
            if isinstance(v, Pod):
                body = v.serialize()
                tag = _T_SUBPOD
            elif isinstance(v, int):
                body = struct.pack("<Q", v)
                tag = _T_ULONG
            elif isinstance(v, str):
                body = v.encode()
                tag = _T_CSTR
            else:
                body = v
                tag = _T_BUF
            out += struct.pack("<BHI", tag, len(key), len(body))
            out += key
            out += body
        return bytes(out)

    @classmethod
    def deserialize(cls, blob: bytes) -> "Pod":
        pod = cls()
        off = 0
        while off < len(blob):
            tag, klen, blen = struct.unpack_from("<BHI", blob, off)
            off += 7
            key = blob[off : off + klen].decode()
            off += klen
            body = blob[off : off + blen]
            off += blen
            if tag == _T_SUBPOD:
                pod._d[key] = cls.deserialize(body)
            elif tag == _T_ULONG:
                pod._d[key] = struct.unpack("<Q", body)[0]
            elif tag == _T_CSTR:
                pod._d[key] = body.decode()
            else:
                pod._d[key] = bytes(body)
        return pod

    # -- convenience -----------------------------------------------------

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, Pod) else v)
            for k, v in self._d.items()
        }

    def __contains__(self, path: str) -> bool:
        return self.query(path) is not None

    def __repr__(self) -> str:
        return f"Pod({self.to_dict()!r})"
