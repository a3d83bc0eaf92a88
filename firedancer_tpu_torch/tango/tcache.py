"""tcache — recent-tag dedup cache, a copy of ``firedancer_tpu/tango/tcache.py``
(``TCache.insert``, the verify tile's HA dup filter; ``insert_batch``:40,
the dedup tile's bulk membership test).

O(1) duplicate detection over the most recent ``depth`` unique 64-bit
tags (fd_tcache.h:344-414). The ring evicts the oldest inserted tag, not
the least recently used: a duplicate hit does not refresh its age. The
map tracks membership, the ring tracks age.
"""

from __future__ import annotations

import numpy as np


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

    def insert_batch(self, tags) -> np.ndarray:
        """Insert a drain round's tags: a bool array, True where the tag
        was a duplicate, bit-identical to insert() called tag by tag in
        order.

        One np.unique collapses the round's repeats and membership is
        probed once a distinct tag; the verdicts scatter back through
        the inverse index. The one order effect this cannot express is
        an eviction in the middle of the round changing a later probe
        (a member among the next len(tags) ring slots is evicted by this
        round's inserts, then probed again): when the probe set meets
        those slots, or the round is as long as the ring, the tags go
        through insert() one by one."""
        tags = np.asarray(tags, np.uint64)
        n = len(tags)
        if n == 0:
            return np.zeros(0, np.bool_)
        probe = set(tags.tolist())
        window = {self._ring[(self._next + i) % self.depth]
                  for i in range(min(n, self.depth))} - {None}
        if n >= self.depth or window & probe:
            return np.fromiter((self.insert(t) for t in tags.tolist()),
                               np.bool_, n)
        uniq, first_idx, inverse = np.unique(
            tags, return_index=True, return_inverse=True)
        m = self._map
        hit_u = np.fromiter((t in m for t in uniq.tolist()), np.bool_,
                            len(uniq))
        # A repeat of any tag is a duplicate: its first occurrence either
        # was one or has just inserted it.
        out = hit_u[inverse] | (np.arange(n) != first_idx[inverse])
        # The new tags enter the ring in first-occurrence order, so ring
        # age matches the loop's.
        new = uniq[~hit_u][np.argsort(first_idx[~hit_u], kind="stable")]
        for t in new.tolist():
            old = self._ring[self._next]
            if old is not None:
                m.discard(old)
            self._ring[self._next] = t
            self._next = (self._next + 1) % self.depth
            m.add(t)
        hits = int(out.sum())
        self.hit_cnt += hits
        self.miss_cnt += n - hits
        return out

    def reset(self) -> None:
        self._ring = [None] * self.depth
        self._next = 0
        self._map.clear()
