"""fd_drain, the host side of the post-verify drain: a copy of
``firedancer_tpu/disco/drain.py`` (the ctl word ``CTL_NOVEL`` ...
``CTL_BASE_MASK``:64-69, ``MAX_CTL_COLORS``:71, ``encode_ctl``:74,
``ctl_color``, ``ctl_block``:95-104; ``DrainWindow``:120,
``rot_quota``:166; ``drain_pack_step``:195; ``greedy_waves``:240,
``schedule_value``:275, ``device_beats_greedy``:287). The dedup tile
reads ``CTL_NOVEL`` and strips it itself; the verify tile launches the
filter behind its engine's verify launches, so the JAX ``drain_pair``
has no copy here.

The verify tile of the fd_feed runtime launches the dedup pre-filter
(``ops.dedup_filter``) right behind each batch on the same stream, and,
with ``drain_pack``, the pack coloring (``ops.pack_gc.pack_schedule``)
over the batch too; the verdicts come home with the statuses and travel
downstream in each frag's mcache ctl word (``fd_frag_publish_bulk_ctl``):

    bits 0..2   SOM/EOM/ERR      (tango, unchanged)
    bit  3      CTL_NOVEL        definitely novel: the dedup tile skips
                                 its probe
    bits 4..10  pack color + 1   0 = no device color
    bits 11..15 device block id  (mod 32; the pack groups waves by it)

``DrainWindow`` keeps the filter's two banks as device tensors and the
rotation proof: rotation (B <- A, A <- 0) forgets bank B, and the
filter stays one-sided only if nothing the dedup tile's TCache still
holds loses its bit. Every published frag set its bucket bit in bank A,
and a TCache of depth D evicts a tag after D distinct newer tags, each
of which is a confirmed-novel publish; so after

    quota = tcache_depth + ring_depth + max_batch

confirmed-novel publishes (the ring and a batch cover the frags in
flight between the verify tile's publish and the dedup tile's insert)
every tag whose bit was last set before the previous rotation has been
evicted, and the window rotates only then, and never while a
``disco.chaos`` injector is armed (the verify tile passes ``blocked``),
as in the JAX window: replayed and dropped frags break the proof's
"published => inserted" step.

``greedy_waves`` is the exact-lock CPU wave packer the pack tile
compares a device schedule with, and falls back to;
``device_beats_greedy`` compares two schedules by rewards per compute
unit in integers.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import dedup_filter as df
from ..ops.pack_gc import pack_schedule

# -- the ctl word ------------------------------------------------------------

CTL_NOVEL = 0x8              # bit 3: definitely novel (skip the probe)
CTL_COLOR_SHIFT = 4
CTL_COLOR_MASK = 0x7F        # bits 4..10: pack color + 1 (0 = none)
CTL_BLOCK_SHIFT = 11
CTL_BLOCK_MASK = 0x1F        # bits 11..15: device block id mod 32
CTL_BASE_MASK = 0x7          # SOM | EOM | ERR (the tango bits)

MAX_CTL_COLORS = CTL_COLOR_MASK - 1   # colors 0..125 encodable


def encode_ctl(base: int, novel: np.ndarray,
               colors: np.ndarray | None = None,
               block: int = 0) -> np.ndarray:
    """The ctl words of one publish batch: the tango bits of base, bit 3
    where novel, and with colors (-1 = none) each color + 1 and the block
    id mod 32. A color outside the encodable range becomes "no color":
    the pack then schedules that txn itself, which is always safe."""
    ctl = np.full(novel.shape, base & CTL_BASE_MASK, np.uint16)
    ctl |= novel.astype(np.uint16) << 3
    if colors is not None:
        c = colors.astype(np.int64) + 1
        c = np.where((c < 1) | (c > CTL_COLOR_MASK), 0, c)
        ctl |= (c.astype(np.uint16) & CTL_COLOR_MASK) << CTL_COLOR_SHIFT
        ctl |= np.uint16((block & CTL_BLOCK_MASK) << CTL_BLOCK_SHIFT)
    return ctl


def ctl_color(ctl: int) -> int:
    """The device pack color, or -1 when the frag carries none."""
    return ((ctl >> CTL_COLOR_SHIFT) & CTL_COLOR_MASK) - 1


def ctl_block(ctl: int) -> int:
    """The device block id (mod 32) the color belongs to."""
    return (ctl >> CTL_BLOCK_SHIFT) & CTL_BLOCK_MASK


# -- the filter window (the verify tile's dispatcher thread) ------------------


class DrainWindow:
    """The filter's two banks on device and the rotation accounting that
    keeps it one-sided (the module docstring). One owner thread. Each
    round's bank A is a new tensor (``dedup_filter`` never writes its
    inputs), so the bank that ``bits_b`` holds after a rotation is never
    written again."""

    def __init__(self, h_bits: int, rot_quota: int, device="cpu"):
        self.h_bits = int(h_bits)
        self.n_words = df.filter_words(self.h_bits)
        self.rot_quota = max(1, int(rot_quota))
        self.device = torch.device(device)
        self.bits_a, self.bits_b = df.empty_banks(self.h_bits, self.device)
        self.novel_since_rot = 0
        self.rotations = 0

    def banks(self):
        """(bits_a, bits_b) for the next filter round."""
        return self.bits_a, self.bits_b

    def commit(self, bits_a_new: torch.Tensor) -> None:
        """Adopt the bank a filter round returned. On the card it may
        still be in flight: the next round runs on the same stream, so it
        reads the bank after this round wrote it."""
        self.bits_a = bits_a_new

    def note_published(self, novel_cnt: int) -> None:
        """Count confirmed-novel frags actually published (selected and
        given credits; frags dropped at HALT never count)."""
        self.novel_since_rot += int(novel_cnt)

    def maybe_rotate(self, blocked: bool = False) -> bool:
        """B <- A, A <- a fresh zero bank, once the quota of
        confirmed-novel publishes proves bank B's tags evicted from the
        TCache. blocked defers the rotation."""
        if blocked or self.novel_since_rot < self.rot_quota:
            return False
        self.bits_b = self.bits_a
        self.bits_a = torch.zeros(self.n_words, dtype=torch.int32,
                                  device=self.device)
        self.novel_since_rot = 0
        self.rotations += 1
        return True


def rot_quota(tcache_depth: int, ring_depth: int, max_batch: int) -> int:
    """The rotation quota of the module's proof: the TCache's depth plus
    every frag that can be in flight between publish and insert."""
    return int(tcache_depth) + int(ring_depth) + int(max_batch)


# -- the composed device steps -------------------------------------------------


def drain_pack_step(tags_hi, tags_lo, valid, bits_a, bits_b, w_idx, r_idx,
                    scores, cus, *, n_colors: int = 64, h_bits: int = 4096,
                    cu_cap: int = 12_000_000):
    """The drain_pack step: the filter and the pack coloring of one
    verify batch, (novel, bits_a_new, novel_cnt, colors). Colors are
    hints: the pack tile validates each device block and falls back to
    the greedy waves, so a wrong color costs a fallback, never an
    inadmissible schedule."""
    novel, bits_a_new, novel_cnt = df.dedup_filter(
        tags_hi, tags_lo, valid, bits_a, bits_b)
    colors = pack_schedule(w_idx, r_idx, scores, cus, n_colors=n_colors,
                           h_bits=h_bits, cu_cap=cu_cap)
    return novel, bits_a_new, novel_cnt, colors


# -- the CPU greedy waves (the pack tile's comparison and fallback) ----------


def greedy_waves(txns: Sequence, n_colors: int,
                 cu_cap: int) -> Tuple[List[list], List]:
    """Reference wave packer: score-descending greedy first-fit over at
    most n_colors waves with exact account-lock sets and the per-wave
    CU budget — the host analog of pack_gc's scan, minus the hash
    collisions (exact sets, so it never manufactures false conflicts).
    Returns (waves, leftover) like ops.pack_gc.schedule_block."""
    order = sorted(range(len(txns)),
                   key=lambda i: (-txns[i].score, i))
    waves: List[list] = [[] for _ in range(n_colors)]
    w_locks: List[set] = [set() for _ in range(n_colors)]
    r_locks: List[set] = [set() for _ in range(n_colors)]
    cu_used = [0] * n_colors
    leftover = []
    for i in order:
        t = txns[i]
        placed = False
        for c in range(n_colors):
            if cu_used[c] + t.est_cus > cu_cap:
                continue
            if any(k in w_locks[c] or k in r_locks[c] for k in t.writable):
                continue
            if any(k in w_locks[c] for k in t.readonly):
                continue
            waves[c].append(t)
            w_locks[c] |= t.writable
            r_locks[c] |= t.readonly
            cu_used[c] += t.est_cus
            placed = True
            break
        if not placed:
            leftover.append(t)
    return [w for w in waves if w], leftover


def schedule_value(waves: Sequence[Sequence]) -> Tuple[int, int]:
    """(total rewards, total est CUs) of a wave schedule — the
    rewards/CU comparison numerator/denominator."""
    rewards = 0
    cus = 0
    for w in waves:
        for t in w:
            rewards += t.rewards
            cus += t.est_cus
    return rewards, cus


def device_beats_greedy(dev_waves, dev_left, cpu_waves, cpu_left) -> bool:
    """rewards/CU gate: the device schedule wins when its ratio is at
    least the greedy baseline's (cross-multiplied — no float division,
    exact in ints). An empty device schedule only wins when greedy is
    empty too."""
    dr, dc = schedule_value(dev_waves)
    gr, gc = schedule_value(cpu_waves)
    if gc == 0:
        return True          # nothing schedulable either way
    if dc == 0:
        return dr >= gr      # device scheduled nothing: only ok if 0-0
    return dr * gc >= gr * dc
