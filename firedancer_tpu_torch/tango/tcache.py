"""tcache — recent-tag dedup cache, a copy of ``firedancer_tpu/tango/tcache.py``
(``TCache.insert``, the verify tile's HA dup filter; ``insert_batch``:40,
the dedup tile's bulk membership test; ``insert_novel_batch``:121, the
insert of tags the fd_drain pre-filter proved new).

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
        # fd_drain's tripwire: lanes the device pre-filter claimed
        # definitely novel that the map contradicted.
        self.false_novel_cnt = 0

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

    def insert_batch(self, tags, novel=None) -> np.ndarray:
        """Insert a drain round's tags: a bool array, True where the tag
        was a duplicate, bit-identical to insert() called tag by tag in
        order.

        novel (a bool array of the same length, optional) marks the lanes
        the fd_drain pre-filter ruled definitely novel: the caller counts
        them as skipped probes. The map lookup still runs for them, as
        the filter's tripwire and not as the verdict: a claim the map
        contradicts adds one to false_novel_cnt and keeps the exact
        duplicate verdict. So the verdicts are the same with and without
        novel.

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
            out = np.fromiter((self.insert(t) for t in tags.tolist()),
                              np.bool_, n)
            self._count_false_novel(novel, out)
            return out
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
        self._count_false_novel(novel, out)
        return out

    def _count_false_novel(self, novel, dup: np.ndarray) -> None:
        if novel is not None:
            self.false_novel_cnt += int((np.asarray(novel, np.bool_)
                                         & dup).sum())

    def insert_novel_batch(self, tags) -> np.ndarray:
        """Insert tags the pre-filter proved definitely novel: no
        duplicate verdicts are formed, only the ring and map updates in
        order, bit-identical to insert() for new tags. One map check a
        tag stays as the tripwire: the result is True where a "novel" tag
        was already a member (all False while the filter's contract
        holds). Such a tag keeps insert()'s semantics (it stays a member,
        its age unchanged, a hit counted), so the caller can drop the
        frag as a duplicate and the ring is never corrupted."""
        tl = [int(t) for t in
              (tags if isinstance(tags, list) else tags.tolist())]
        breach = np.zeros(len(tl), np.bool_)
        m = self._map
        for i, t in enumerate(tl):
            if t in m:
                breach[i] = True
                self.hit_cnt += 1
                continue
            self.miss_cnt += 1
            old = self._ring[self._next]
            if old is not None:
                m.discard(old)
            self._ring[self._next] = t
            self._next = (self._next + 1) % self.depth
            m.add(t)
        return breach

    def reset(self) -> None:
        self._ring = [None] * self.depth
        self._next = 0
        self._map.clear()
        self.false_novel_cnt = 0
