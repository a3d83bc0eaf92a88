"""The host side of the pack tile's schedule gate, a copy of
``firedancer_tpu/disco/drain.py`` (``greedy_waves``:240,
``schedule_value``:275, ``device_beats_greedy``:287).

``greedy_waves`` is the exact-lock CPU wave packer the graph-coloring
schedule is compared with, and falls back to; ``device_beats_greedy``
compares two schedules by rewards per compute unit in integers. The
fd_drain ctl-word transport of the JAX module comes with the feed
runtime.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


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
