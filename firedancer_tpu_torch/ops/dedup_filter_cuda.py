"""The fd_drain dedup pre-filter on the card: the counterpart of
``firedancer_tpu/ops/dedup_filter.py:84`` ``dedup_filter`` (an XLA graph,
not a ``pallas_call``), as ``csrc/dedup_filter.cu``.

``dedup_filter_cuda`` makes one ``torch.empty`` a call, a buffer that
holds the new bank, the count, the grid's scratch and the verdict bytes
(``outputs``), and one call into the library on the current stream. The
launch is ``geometry(n, h_bits)``'s, chosen by the lane count as the card
measured it (``PERF.md`` row 17): up to ``ONE_CTA_LANES`` lanes (the
staged txns of a feed batch), one launch of one CTA whose shared memory
holds the first-occurrence table, the window and each lane's slot, with
nothing cleared from the host; past them, or for a window too wide for
that shared memory, the grid: a memset of the table in the scratch and
the count, then an insert and a mark launch over all SMs. The kernel's
header gives the design. One call counts one ``dedup_filter`` launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import backend, build

_V = ctypes.c_void_p
_I = ctypes.c_int
# Dynamic shared memory a CTA can opt into on Hopper (227 KB).
SMEM_LIMIT = 232_448
THREADS = 1024          # the one block's threads (DF_THREADS)
GRID_THREADS = 256      # a grid block's threads (DF_GRID_THREADS)
# Lanes the one block serves: on the H100 it beats the grid at 2,048
# lanes and loses at 4,096 (chip_smoke.py times both launches at both).
ONE_CTA_LANES = 2048
TABLE_GROWTH = 8        # the table grows to at most 8 times its least size
MAX_LANES = (1 << 29) - 1  # so that the table's slots stay a C int
_MAX_SLOTS = 1 << 30
_EXTRA_WORDS = 4        # the count, the least-invalid word, padding
_OUT_PAD = 16           # bytes of the count's slot in the output buffer


def table_slots(n: int) -> int:
    """Slots of the first-occurrence table: 2^ceil(log2 2n), at least 32,
    so the table is at most half full."""
    return max(32, 1 << max(0, 2 * n - 1).bit_length())


def smem_bytes(n: int, h_bits: int, slots: int | None = None) -> int:
    """Dynamic shared bytes of the one block: its table words
    (table_slots(n) unless given), the window and the new bank (h_bits /
    32 words each), the few words of DF_EXTRA_WORDS, and a slot word for
    each lane of its threads (ceil(n / THREADS) a thread)."""
    slots = table_slots(n) if slots is None else slots
    lanes = -(-n // THREADS) * THREADS
    return 4 * (slots + 2 * (h_bits // 32) + _EXTRA_WORDS + lanes)


@functools.lru_cache(maxsize=256)
def geometry(n: int, h_bits: int) -> tuple[str, int, int, int]:
    """(route, threads a block, dynamic shared bytes, table slots) of the
    launch over n lanes and an h_bits window. "block": one CTA, up to
    ONE_CTA_LANES lanes when its shared memory fits SMEM_LIMIT with the
    least table (table_slots(n)), the table then doubled while it fits, up
    to TABLE_GROWTH times the least. "grid": otherwise, no shared memory,
    the table TABLE_GROWTH times the least (at most 2^30 slots, and never
    below the least). ValueError past MAX_LANES or
    for a window that is not a power of two of at least 32 bits."""
    from .dedup_filter import filter_words

    filter_words(h_bits)
    if n > MAX_LANES:
        raise ValueError(f"dedup_filter: {n} lanes (at most {MAX_LANES})")
    least = table_slots(n)
    if n <= ONE_CTA_LANES and smem_bytes(n, h_bits, least) <= SMEM_LIMIT:
        slots = least
        while (slots < TABLE_GROWTH * least
               and smem_bytes(n, h_bits, 2 * slots) <= SMEM_LIMIT):
            slots *= 2
        return "block", THREADS, smem_bytes(n, h_bits, slots), slots
    return "grid", GRID_THREADS, 0, max(least, min(TABLE_GROWTH * least,
                                                   _MAX_SLOTS))


def scratch_words(n: int, route: str, slots: int) -> int:
    """The grid's scratch: the table, the least invalid lane and each
    lane's slot; none for the one block."""
    return slots + 1 + n if route == "grid" else 0


def outputs(n: int, n_words: int, device, scratch: int = 0):
    """The call's one allocation, as (buffer, novel, bits_out, count,
    scratch): the new bank's n_words int32 at offset 0 (16-byte aligned
    for the kernel's stores), the 0-dim int32 count in the next 16 bytes,
    then scratch int32 words, then the n verdict bytes as bool."""
    s0 = 4 * n_words + _OUT_PAD
    v0 = s0 + 4 * scratch
    buf = torch.empty(v0 + n, dtype=torch.uint8, device=device)
    bits_out = buf[:4 * n_words].view(torch.int32)
    cnt = buf[4 * n_words:4 * n_words + 4].view(torch.int32)[0]
    scr = buf[s0:v0].view(torch.int32)
    novel = buf[v0:].view(torch.bool)
    return buf, novel, bits_out, cnt, scr


def dedup_filter_cuda(tags_hi: torch.Tensor, tags_lo: torch.Tensor,
                      valid: torch.Tensor, bits_a: torch.Tensor,
                      bits_b: torch.Tensor):
    """The kernel: (novel, bits_a_new, novel_cnt) of (n,) int32 tag
    halves, (n,) bool valid and (W,) int32 banks, all contiguous on one
    CUDA device (dedup_filter.dedup_filter_ref's contract). A shape the
    geometry refuses raises ValueError before any check or launch."""
    n = tags_hi.shape[0] if tags_hi.dim() == 1 else -1
    w = bits_a.shape[0] if bits_a.dim() == 1 else -1
    if n >= 0 and w >= 0:
        route, _, smem, slots = geometry(n, 32 * w)
    backend.check_tensor("tags_hi", tags_hi, torch.int32, (None,))
    backend.check_tensor("tags_lo", tags_lo, torch.int32, (n,))
    backend.check_tensor("valid", valid, torch.bool, (n,))
    backend.check_tensor("bits_a", bits_a, torch.int32, (None,))
    backend.check_tensor("bits_b", bits_b, torch.int32, (w,))
    _, novel, bits_out, cnt, scr = outputs(
        n, w, tags_hi.device, scratch_words(n, route, slots))
    stream = torch.cuda.current_stream(tags_hi.device).cuda_stream
    ptrs = (tags_hi.data_ptr(), tags_lo.data_ptr(), valid.data_ptr(),
            bits_a.data_ptr(), bits_b.data_ptr(), novel.data_ptr(),
            bits_out.data_ptr(), cnt.data_ptr())
    if route == "block":
        fn = build.bind("dedup_filter", "fd_dedup_filter_block",
                        [_V] * 8 + [_I] * 4 + [_V])
        rc = fn(*ptrs, n, w, slots, smem, stream)
    else:
        fn = build.bind("dedup_filter", "fd_dedup_filter_grid",
                        [_V] * 9 + [_I] * 3 + [_V])
        rc = fn(*ptrs, scr.data_ptr(), n, w, slots, stream)
    build.check_rc(f"fd_dedup_filter_{route}", rc)
    backend.count_launch("dedup_filter")
    return novel, bits_out, cnt
