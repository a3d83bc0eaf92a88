"""Block packing: reward-ordered transaction scheduling with account
locks, a copy of ``firedancer_tpu/ballet/pack.py`` (``compare_worse``:29,
the heap helpers :36-99, ``PackTxn``:101, ``EstTbl``:115,
``CuEstimator``:172, ``Pack``:203, ``validate_schedule``:549), the role
of the reference's fd_pack (fd_pack.c).

``Pack`` keeps a bounded max-heap of pending transactions ordered by
estimated rewards per compute unit and schedules the best one whose
account locks conflict with nothing in flight on any bank (the conflict
rule of fd_pack.c:446-461,520-545: a writer conflicts with any other use
of the account, readers only with writers). Completed transactions
release their locks. ``validate_schedule`` is the admissibility oracle
for the graph-coloring scheduler (``ops.pack_gc``): every schedule the
device emits must pass it.

The compute-unit estimator follows fd_est_tbl.h: a per-program
exponential moving average with a default prior.
"""

from __future__ import annotations

import heapq
import itertools
import math
import random
from dataclasses import dataclass, field


def compare_worse(rewards_a: int, cus_a: int, rewards_b: int, cus_b: int) -> bool:
    """True iff a's rewards/compute is strictly worse than b's, by integer
    cross-multiplication (the reference's COMPARE_WORSE, fd_pack.c:85 —
    exact, no float rounding at the priority boundary)."""
    return rewards_a * cus_b < rewards_b * cus_a


def _sift_down_to_root(heap: list, i: int) -> int:
    """Bubble heap[i] toward the root while it beats its parent; returns
    the final index. (Inlined rather than heapq._siftdown: the
    underscore helpers are CPython-private and absent on alternative
    interpreters.)"""
    item = heap[i]
    while i > 0:
        parent = (i - 1) >> 1
        if item < heap[parent]:
            heap[i] = heap[parent]
            i = parent
        else:
            break
    heap[i] = item
    return i


def _sift_up_to_leaves(heap: list, i: int) -> None:
    """Push heap[i] down toward the leaves until both children are >=."""
    n = len(heap)
    item = heap[i]
    while True:
        child = 2 * i + 1
        if child >= n:
            break
        right = child + 1
        if right < n and heap[right] < heap[child]:
            child = right
        if heap[child] < item:
            heap[i] = heap[child]
            i = child
        else:
            break
    heap[i] = item


def _heap_remove_at(heap: list, i: int) -> None:
    """Remove heap[i] in O(log n): swap in the last element and restore
    the invariant locally instead of a full O(n) heapify."""
    heap[i] = heap[-1]
    heap.pop()
    if i < len(heap):
        if _sift_down_to_root(heap, i) == i:
            _sift_up_to_leaves(heap, i)


def _evict_bottom_half(heap: list, rng: random.Random, txn: PackTxn) -> bool:
    """The reference's overload rule (fd_pack.c:383-399): pick a random
    victim from the bottom half of the heap array (leaf-heavy —
    expected-worst candidates without a full scan) and evict it iff the
    incoming txn is strictly better by integer cross-multiplication.
    Returns True when a slot was freed, False when the incoming txn
    should be dropped."""
    sz = len(heap)
    victim_idx = sz // 2 + rng.randrange(max(sz - sz // 2, 1))
    _, _, victim = heap[victim_idx]
    if not compare_worse(victim.rewards, victim.est_cus,
                         txn.rewards, txn.est_cus):
        return False
    _heap_remove_at(heap, victim_idx)
    return True


@dataclass(frozen=True)
class PackTxn:
    """Scheduling view of a transaction."""

    txn_id: int
    rewards: int                  # lamports (priority fee + base)
    est_cus: int                  # estimated compute units
    writable: frozenset[bytes]    # write-locked account keys
    readonly: frozenset[bytes]    # read-locked account keys

    @property
    def score(self) -> float:
        return self.rewards / max(self.est_cus, 1)


class EstTbl:
    """Sliding-window mean/variance histogram over tagged data — the
    fd_est_tbl analog (reference src/ballet/pack/fd_est_tbl.h).

    Tags hash onto a power-of-two bin array (aliasing is intentional: a
    never-seen tag lands on a bin whose estimate approximates the global
    mean). Each bin keeps EMA numerators for x and x^2 plus paired
    denominators d and d2, so
        mean = x / d,   var = (d*x2 - x^2) / (d^2 - d2)
    with a default mean (variance 0) for empty bins. ema_coeff is
    1 - 1/history, matching the reference's window tuning.
    """

    def __init__(self, bin_cnt: int = 1024, history: int = 512,
                 default_val: float = 200_000.0):
        if bin_cnt <= 0 or bin_cnt & (bin_cnt - 1):
            raise ValueError("bin_cnt must be a power of two")
        if history <= 0:
            raise ValueError("history must be positive")
        self._mask = bin_cnt - 1
        self._coeff = 1.0 - 1.0 / history
        self.default_val = float(default_val)
        # bins: [x, x2, d, d2] per bin
        self._bins = [[0.0, 0.0, 0.0, 0.0] for _ in range(bin_cnt)]

    @staticmethod
    def tag(program_key: bytes, first_instr_byte: int = 0) -> int:
        """Tag = hash of the program id's first 15 bytes + the first
        instruction-data byte (the reference's word1/word2 mix,
        fd_pack.c:305-310, re-expressed over Python ints)."""
        w1 = int.from_bytes(program_key[:8].ljust(8, b"\0"), "little")
        w2 = int.from_bytes(program_key[8:16].ljust(8, b"\0"), "little")
        w2 = (w2 & 0xFFFFFFFFFFFFFF00) ^ (first_instr_byte & 0xFF)
        h = (w1 * 0x9E3779B97F4A7C15) ^ (w2 * 0xC2B2AE3D27D4EB4F)
        h &= (1 << 64) - 1
        return h ^ (h >> 32)

    def estimate(self, tag: int) -> tuple[float, float]:
        """(mean, variance) for this tag's bin; (default_val, 0) when
        the bin has no data."""
        x, x2, d, d2 = self._bins[tag & self._mask]
        if not d > 0.0:
            return self.default_val, 0.0
        mean = x / d
        denom = d * d - d2
        var = (d * x2 - x * x) / denom if denom > 0.0 else 0.0
        return mean, max(var, 0.0)

    def update(self, tag: int, value: float) -> None:
        b = self._bins[tag & self._mask]
        c = self._coeff
        b[0] = value + c * b[0]
        b[1] = value * value + c * b[1]
        b[2] = 1.0 + c * b[2]
        b[3] = 1.0 + c * c * b[3]


class CuEstimator:
    """Per-program CU estimator over an EstTbl histogram (fd_est_tbl
    analog: bounded memory, sliding-window variance, and the reference's
    alias-to-global-mean behavior for unseen programs)."""

    DEFAULT = 200_000

    def __init__(self, bin_cnt: int = 1024, history: int = 512):
        self._tbl = EstTbl(bin_cnt=bin_cnt, history=history,
                           default_val=float(self.DEFAULT))

    def estimate(self, program_keys) -> int:
        mean, _ = self.estimate_with_variance(program_keys)
        return max(int(0.5 + mean), 1)

    def estimate_with_variance(self, program_keys) -> tuple[float, float]:
        """Summed (mean, variance) across instructions' programs —
        variances add under the reference's independence assumption."""
        total = 0.0
        var = 0.0
        for k in program_keys:
            m, v = self._tbl.estimate(EstTbl.tag(k))
            total += m
            var += v
        return total, var

    def observe(self, program_key: bytes, actual_cus: int) -> None:
        self._tbl.update(EstTbl.tag(program_key), float(actual_cus))


class Pack:
    """Bounded pending heap + per-bank in-flight lock tracking."""

    def __init__(self, bank_cnt: int, depth: int = 4096,
                 max_cu_per_bank: int = 12_000_000,
                 rng: random.Random | None = None):
        self.bank_cnt = bank_cnt
        self.depth = depth
        self.max_cu_per_bank = max_cu_per_bank
        self._rng = rng or random.Random(0x5ACC)
        self._heap: list[tuple[float, int, PackTxn]] = []  # (-score, seq, txn)
        self._seq = itertools.count()
        self._inflight: list[dict[int, PackTxn]] = [dict() for _ in range(bank_cnt)]
        self._bank_cu: list[int] = [0] * bank_cnt
        self._write_locks: dict[bytes, int] = {}   # key -> holder txn_id
        self._read_locks: dict[bytes, int] = {}    # key -> reader count
        # Diag counters (cnc-style).
        self.insert_cnt = 0
        self.drop_cnt = 0
        self.schedule_cnt = 0
        self.conflict_skip_cnt = 0

    def pending_cnt(self) -> int:
        return len(self._heap)

    def inflight_cnt(self) -> int:
        return sum(len(b) for b in self._inflight)

    def insert(self, txn: PackTxn) -> bool:
        """Queue a transaction; when the heap is full, pick a random
        victim from the bottom half of the heap array (leaf-heavy —
        expected-worst candidates without a full scan) and replace it
        iff the new txn is strictly better, else drop the new txn.
        This is the reference's overload rule (fd_pack.c:383-399:
        victim_idx in [sz/2, sz), COMPARE_WORSE by integer
        cross-multiplication). Returns False when dropped."""
        self.insert_cnt += 1
        if len(self._heap) >= self.depth:
            if not _evict_bottom_half(self._heap, self._rng, txn):
                self.drop_cnt += 1
                return False
            self.drop_cnt += 1
        heapq.heappush(self._heap, (-txn.score, next(self._seq), txn))
        return True

    def _conflicts(self, txn: PackTxn) -> bool:
        for k in txn.writable:
            if k in self._write_locks or self._read_locks.get(k, 0) > 0:
                return True
        for k in txn.readonly:
            if k in self._write_locks:
                return True
        return False

    def schedule(self, bank_idx: int, scan_limit: int = 64) -> PackTxn | None:
        """Pop the best non-conflicting pending txn onto bank_idx.

        Scans up to scan_limit heap entries (the reference similarly bounds
        its search); skipped entries are re-queued.
        """
        if self._bank_cu[bank_idx] >= self.max_cu_per_bank:
            return None
        skipped = []
        chosen = None
        for _ in range(min(scan_limit, len(self._heap))):
            neg, seq, txn = heapq.heappop(self._heap)
            if self._bank_cu[bank_idx] + txn.est_cus > self.max_cu_per_bank:
                skipped.append((neg, seq, txn))
                continue
            if self._conflicts(txn):
                self.conflict_skip_cnt += 1
                skipped.append((neg, seq, txn))
                continue
            chosen = txn
            break
        for item in skipped:
            heapq.heappush(self._heap, item)
        if chosen is None:
            return None
        for k in chosen.writable:
            self._write_locks[k] = chosen.txn_id
        for k in chosen.readonly:
            self._read_locks[k] = self._read_locks.get(k, 0) + 1
        self._inflight[bank_idx][chosen.txn_id] = chosen
        self._bank_cu[bank_idx] += chosen.est_cus
        self.schedule_cnt += 1
        return chosen

    def complete(self, bank_idx: int, txn_id: int, actual_cus: int | None = None):
        txn = self._inflight[bank_idx].pop(txn_id)
        for k in txn.writable:
            del self._write_locks[k]
        for k in txn.readonly:
            n = self._read_locks[k] - 1
            if n:
                self._read_locks[k] = n
            else:
                del self._read_locks[k]
        if actual_cus is not None:
            self._bank_cu[bank_idx] += actual_cus - txn.est_cus

    def end_block(self):
        """Reset per-block CU budgets (locks persist only via in-flight)."""
        self._bank_cu = [0] * self.bank_cnt


def validate_schedule(batches: list[list[PackTxn]]) -> bool:
    """Admissibility check: within each parallel batch, no lock conflicts.

    Used to validate device-generated (graph-coloring) schedules against the
    reference conflict rule.
    """
    for batch in batches:
        writes: set[bytes] = set()
        reads: set[bytes] = set()
        for t in batch:
            for k in t.writable:
                if k in writes or k in reads:
                    return False
            for k in t.readonly:
                if k in writes:
                    return False
            writes |= t.writable
            reads |= t.readonly
    return True
