"""The fd_drain dedup pre-filter on the card: the counterpart of
``firedancer_tpu/ops/dedup_filter.py:84`` ``dedup_filter`` (an XLA graph,
not a ``pallas_call``), as ``csrc/dedup_filter.cu``.

``dedup_filter_cuda`` allocates the outputs and the scratch (the
first-occurrence hash table of ``table_slots(n)`` words, the least
invalid lane, each lane's slot) and makes one call into the library,
which clears the table and the count and launches the kernel's two
passes on the current stream (the kernel's header gives its design).
One call counts one ``dedup_filter`` launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import backend, build

_V = ctypes.c_void_p
_I = ctypes.c_int


def table_slots(n: int) -> int:
    """Slots of the first-occurrence table: 2^ceil(log2 2n), at least 32,
    so the table is at most half full."""
    return max(32, 1 << max(0, 2 * n - 1).bit_length())


def dedup_filter_cuda(tags_hi: torch.Tensor, tags_lo: torch.Tensor,
                      valid: torch.Tensor, bits_a: torch.Tensor,
                      bits_b: torch.Tensor):
    """The kernel: (novel, bits_a_new, novel_cnt) of (n,) int32 tag
    halves, (n,) bool valid and (W,) int32 banks, all contiguous on one
    CUDA device (dedup_filter.dedup_filter_ref's contract)."""
    from .dedup_filter import filter_words

    n = tags_hi.shape[0] if tags_hi.dim() == 1 else -1
    backend.check_tensor("tags_hi", tags_hi, torch.int32, (None,))
    backend.check_tensor("tags_lo", tags_lo, torch.int32, (n,))
    backend.check_tensor("valid", valid, torch.bool, (n,))
    backend.check_tensor("bits_a", bits_a, torch.int32, (None,))
    w = bits_a.shape[0]
    backend.check_tensor("bits_b", bits_b, torch.int32, (w,))
    filter_words(32 * w)
    if n >= 2 ** 30:
        raise ValueError(f"dedup_filter: {n} lanes (at most 2^30 - 1)")
    dev = tags_hi.device
    novel = torch.empty(n, dtype=torch.bool, device=dev)
    bits_out = torch.empty(w, dtype=torch.int32, device=dev)
    cnt = torch.empty((), dtype=torch.int32, device=dev)
    slots = table_slots(n)
    scratch = torch.empty(slots + 1 + n, dtype=torch.int32, device=dev)
    fn = build.bind("dedup_filter", "fd_dedup_filter",
                    [_V, _V, _V, _V, _V, _V, _V, _V, _V, _I, _I, _I, _V])
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check_rc("fd_dedup_filter", fn(
        tags_hi.data_ptr(), tags_lo.data_ptr(), valid.data_ptr(),
        bits_a.data_ptr(), bits_b.data_ptr(), novel.data_ptr(),
        bits_out.data_ptr(), cnt.data_ptr(), scratch.data_ptr(), n, w,
        slots, stream))
    backend.count_launch("dedup_filter")
    return novel, bits_out, cnt
