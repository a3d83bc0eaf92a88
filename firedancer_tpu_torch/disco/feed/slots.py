"""Staging-slot arenas of the fd_feed runtime, the counterpart of
``firedancer_tpu/disco/feed/slots.py`` (``Slot``:36, ``SlotPool``:102).

A ``Slot`` is one host arena in the layout the native drain
(``fd_verify_drain``) stages and the verify engine reads: row-major
msgs, lens, sigs and pubs, beside the payload sidecar (offsets, lengths,
meta sigs, lane counts, tsorig, tspub, hashes and the HA mask) that the
completion publishes from. Each arena is allocated once; the stager
fills a slot with one C call a drain round.

The four engine arrays are torch tensors with numpy views for the drain
(``msgs``, ``lens``, ``sigs``, ``pubs``; the tensors are ``t_msgs`` and
so on). With ``pin=True`` they are pinned host memory, so the engine's
host-to-device copy runs asynchronously and reads the arena after the
dispatch returns. A slot therefore goes back to the pool only when its
batch has retired: the device finished with it and the completion
published from it. The fd_drain's inputs are pinned arenas of their own
(``t_tag_hi``, ``t_tag_lo``, ``t_valid``: the meta sigs' halves and the
staged-txn mask, with numpy views ``tag_hi`` and so on), written at
dispatch and copied up under the same rule.

The ``SlotPool`` is the handoff between the stager thread (it fills
slots) and the dispatcher thread (it ships READY slots to the device):
FREE -> FILLING -> READY -> (dispatched) -> FREE. When every slot is
FILLING or READY the stager blocks in ``acquire`` (counted in
``slot_stall`` and ``stall_ns``) until the dispatcher releases one, which
happens only as batches retire, so staging never runs ahead of the
device by more than the pool.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np
import torch

FREE = 0
FILLING = 1
READY = 2

_MTU = 1232  # FD_TPU_MTU


def _arena(shape, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, pin_memory=pin)


class Slot:
    """One staging arena and the per-txn bookkeeping the completion
    needs. reset() only rewinds the cursors: the drain overwrites rows
    and zeroes row tails, and the dispatch zeroes the lanes past the
    staged ones, so nothing stale is verified or published."""

    __slots__ = (
        "idx", "state", "t_msgs", "t_lens", "t_sigs", "t_pubs", "msgs",
        "lens", "sigs", "pubs", "t_tag_hi", "t_tag_lo", "t_valid",
        "tag_hi", "tag_lo", "valid", "pay", "offs", "plens", "psigs", "tlanes",
        "tsorigs", "tspubs", "hashes", "ha_mask", "n_txn", "n_lane",
        "pay_fill", "t_first", "drain_end", "flush_verdict",
    )

    def __init__(self, idx: int, batch: int, max_msg_len: int,
                 pin: bool = False):
        self.idx = idx
        self.state = FREE
        self.t_msgs = _arena((batch, max_msg_len), torch.uint8, pin)
        # int32 as the engine takes it; the drain writes the same values
        # as uint32 (a row is at most the MTU).
        self.t_lens = _arena((batch,), torch.int32, pin)
        self.t_sigs = _arena((batch, 64), torch.uint8, pin)
        self.t_pubs = _arena((batch, 32), torch.uint8, pin)
        self.msgs = self.t_msgs.numpy()
        self.lens = self.t_lens.numpy()
        self.sigs = self.t_sigs.numpy()
        self.pubs = self.t_pubs.numpy()
        # The drain's filter inputs, one lane a txn (int32 bit patterns
        # of the meta sig's halves).
        self.t_tag_hi = _arena((batch,), torch.int32, pin)
        self.t_tag_lo = _arena((batch,), torch.int32, pin)
        self.t_valid = _arena((batch,), torch.bool, pin)
        self.tag_hi = self.t_tag_hi.numpy()
        self.tag_lo = self.t_tag_lo.numpy()
        self.valid = self.t_valid.numpy()
        self.pay = np.zeros(batch * _MTU, np.uint8)
        # Per-txn sidecars at txn index, accumulated across drain rounds
        # (offs made absolute into pay as rounds land).
        self.offs = np.zeros(batch, np.uint32)
        self.plens = np.zeros(batch, np.uint32)
        self.psigs = np.zeros(batch, np.uint64)
        self.tlanes = np.zeros(batch, np.uint32)
        self.tsorigs = np.zeros(batch, np.uint32)
        self.tspubs = np.zeros(batch, np.uint32)
        self.hashes = np.zeros(batch, np.uint64)
        # True: an HA duplicate at staging; its lanes verify (they are
        # staged) but it does not publish.
        self.ha_mask = np.zeros(batch, np.bool_)
        self.n_txn = 0
        self.n_lane = 0
        self.pay_fill = 0
        self.t_first = 0       # tick count of the first staged txn
        self.drain_end = 0     # in-ring seq after the last drain round
        self.flush_verdict = "full"

    def reset(self) -> None:
        self.ha_mask[: max(self.n_txn, 1)] = False
        self.n_txn = 0
        self.n_lane = 0
        self.pay_fill = 0
        self.t_first = 0
        self.drain_end = 0
        self.flush_verdict = "full"


class SlotPool:
    """Bounded FREE/FILLING/READY rotation between one stager thread and
    one dispatcher thread. READY order is commit order, so batches
    retire in the order their txns were drained, which the verify
    tile's ack cursor relies on."""

    def __init__(self, n_slots: int, batch: int, max_msg_len: int,
                 pin: bool = False):
        if n_slots < 2:
            # One slot cannot overlap filling with dispatch.
            raise ValueError(f"SlotPool needs >= 2 slots, got {n_slots}")
        self.batch = batch
        self.slots: List[Slot] = [Slot(i, batch, max_msg_len, pin)
                                  for i in range(n_slots)]
        self._free: List[Slot] = list(self.slots)
        self._ready: List[Slot] = []
        self._lock = threading.Lock()
        self._free_cv = threading.Condition(self._lock)
        self.slot_stall = 0          # acquires that had to wait
        self.stall_ns = 0            # the stager's wall time waiting

    # -- stager side -----------------------------------------------------

    def acquire(self, timeout_s: float) -> Optional[Slot]:
        """FREE -> FILLING. Waits up to timeout_s when no slot is free
        (one slot_stall a wait, its wall time in stall_ns), so the
        stager stays responsive to HALT."""
        with self._free_cv:
            if not self._free:
                self.slot_stall += 1
                t0 = time.perf_counter_ns()
                self._free_cv.wait(timeout_s)
                self.stall_ns += time.perf_counter_ns() - t0
            if not self._free:
                return None
            slot = self._free.pop(0)
            slot.state = FILLING
            return slot

    def commit(self, slot: Slot) -> None:
        """FILLING -> READY, in FIFO order."""
        with self._lock:
            if slot.state != FILLING:
                raise ValueError(
                    f"commit of slot {slot.idx} in state {slot.state} "
                    "(want FILLING)")
            slot.state = READY
            self._ready.append(slot)

    # -- dispatcher side -------------------------------------------------

    def pop_ready(self) -> Optional[Slot]:
        with self._lock:
            if not self._ready:
                return None
            return self._ready.pop(0)

    def release(self, slot: Slot) -> None:
        """A retired slot back to FREE."""
        slot.reset()
        with self._free_cv:
            slot.state = FREE
            self._free.append(slot)
            self._free_cv.notify()

    # -- observers -------------------------------------------------------

    def ready_cnt(self) -> int:
        with self._lock:
            return len(self._ready)

    def outstanding(self) -> int:
        """Slots not FREE (FILLING, READY or dispatched); 0 after the
        tile halted, or a slot was lost."""
        with self._lock:
            return len(self.slots) - len(self._free)

    def idle(self) -> bool:
        """No slot holds staged-but-unretired txns: no READY backlog, and
        every slot (the FILLING one, and a popped one until it is
        released) empty. The quiescence check reads this from another
        thread."""
        with self._lock:
            if self._ready:
                return False
            return all(s.n_txn == 0 for s in self.slots)
