"""tcache — recent-tag dedup cache, a copy of ``firedancer_tpu/tango/tcache.py``
(``TCache.insert``; the verify tile's HA dup filter).

O(1) duplicate detection over the most recent ``depth`` unique 64-bit
tags (fd_tcache.h:344-414). The ring evicts the oldest inserted tag, not
the least recently used: a duplicate hit does not refresh its age. The
map tracks membership, the ring tracks age.
"""

from __future__ import annotations


class TCache:
    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError("depth >= 1")
        self.depth = depth
        self._ring: list[int | None] = [None] * depth
        self._next = 0
        self._map: set[int] = set()
        self.hit_cnt = 0
        self.miss_cnt = 0

    def insert(self, tag: int) -> bool:
        """Returns True if tag was a duplicate (already among last depth)."""
        if tag in self._map:
            self.hit_cnt += 1
            return True
        self.miss_cnt += 1
        old = self._ring[self._next]
        if old is not None:
            self._map.discard(old)
        self._ring[self._next] = tag
        self._next = (self._next + 1) % self.depth
        self._map.add(tag)
        return False

    def reset(self) -> None:
        self._ring = [None] * self.depth
        self._next = 0
        self._map.clear()
