"""The fd_drain dedup pre-filter, the counterpart of
``firedancer_tpu/ops/dedup_filter.py`` (``DEFAULT_FILTER_BITS``:48,
``_MIX_A``/``_MIX_B``:52-53, ``filter_words``:56, ``split_tags``:63,
``_bucket``:73, ``dedup_filter``:84, jitted ``dedup_filter_jit``:149,
``empty_banks``:153).

For a batch of 64-bit dedup tags (each staged txn's meta sig) the
filter answers "definitely novel" or "maybe a duplicate" against a
window of recently published tags: two bitset banks on the device. A
tag is novel when its bucket's bit is clear in A | B and it is the first
occurrence of its value in the batch; every valid first occurrence sets
its bucket's bit in bank A, novel or not. The verdict is one-sided: a
tag the dedup tile's TCache holds had its bit set when it was published,
and the rotation (``disco/drain.py``) never drops a bit before the TCache
has evicted the tag, so a clear bit proves the tag is new.

The port's tensors carry the JAX package's uint32 words as int32 bit
patterns: ``tags_hi``, ``tags_lo`` (B,) int32, ``valid`` (B,) bool,
``bits_a``, ``bits_b`` (W,) int32. ``dedup_filter`` returns ``(novel,
bits_a_new, novel_cnt)``: (B,) bool, a new (W,) int32 bank (the inputs
are never written, so a bank that ``bits_b`` aliases stays as it was) and
a 0-dim int32 count. It dispatches on the tensors' device
(``backend.use_kernel``): CUDA tensors launch ``csrc/dedup_filter.cu``
(``dedup_filter_cuda``) or raise; CPU tensors run ``dedup_filter_ref``,
which transcribes the JAX graph: the mix in int64 with explicit masks (CPU
torch has no uint32 product), the first occurrence by a stable sort over
the lane's 64-bit key, invalid lanes keyed by the all-ones sentinel.
"""

from __future__ import annotations

import numpy as np
import torch

from . import backend
from .dedup_filter_cuda import dedup_filter_cuda

#: Window size in bits when the caller names none (the JAX package's
#: FD_DRAIN_FILTER_BITS default): 16 KiB a bank.
DEFAULT_FILTER_BITS = 1 << 17

#: Odd 32-bit mix constants of the bucket hash.
MIX_A = 0x9E3779B1
MIX_B = 0x85EBCA77

_M32 = 0xFFFFFFFF


def filter_words(h_bits: int) -> int:
    """32-bit words a bank of an h_bits-bit window; h_bits must be a
    power of two of at least 32."""
    if h_bits <= 0 or (h_bits & (h_bits - 1)) != 0 or h_bits % 32:
        raise ValueError(f"h_bits must be a power of two >= 32: {h_bits}")
    return h_bits // 32


def split_tags(tags_u64) -> tuple[np.ndarray, np.ndarray]:
    """numpy uint64 tags -> (hi, lo) int32 arrays holding the two 32-bit
    halves' bit patterns."""
    t = np.asarray(tags_u64, dtype=np.uint64)
    lo = (t & np.uint64(_M32)).astype(np.uint32).view(np.int32)
    hi = (t >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return hi, lo


def empty_banks(h_bits: int = DEFAULT_FILTER_BITS, device="cpu"):
    """A fresh (bits_a, bits_b) pair of all-clear banks, two tensors (the
    JAX function returns one array twice; here bank A is replaced, never
    written, but distinct tensors keep that safe if it ever is)."""
    w = filter_words(h_bits)
    return (torch.zeros(w, dtype=torch.int32, device=device),
            torch.zeros(w, dtype=torch.int32, device=device))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32): the product of 16-bit
    halves, so no int64 product overflows."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def bucket(tags_hi: torch.Tensor, tags_lo: torch.Tensor,
           h_bits: int) -> torch.Tensor:
    """Each lane's bucket in [0, h_bits) as int64: the JAX ``_bucket``
    mix of the 64-bit tag."""
    hi = tags_hi.long() & _M32
    lo = tags_lo.long() & _M32
    mix = lo ^ _mul32(hi, MIX_A)
    mix = _mul32(mix ^ (mix >> 15), MIX_B)
    mix = mix ^ (mix >> 13)
    return mix & (h_bits - 1)


def dedup_filter_ref(tags_hi: torch.Tensor, tags_lo: torch.Tensor,
                     valid: torch.Tensor, bits_a: torch.Tensor,
                     bits_b: torch.Tensor):
    """Plain version, on any device: the JAX graph step by step."""
    backend.count_plain("dedup_filter")
    n = tags_hi.shape[0]
    n_words = bits_a.shape[0]
    h_bits = n_words * 32
    dev = tags_hi.device
    b = bucket(tags_hi, tags_lo, h_bits)
    word, bit = b >> 5, b & 31
    window = (bits_a.long() | bits_b.long()) & _M32
    hit = ((window[word] >> bit) & 1) != 0
    # The stable 3-key sort of the JAX graph: (hi, lo) as one 64-bit key
    # (a bijection, so equal keys group), invalid lanes on the all-ones
    # sentinel, ties in lane order.
    key = ((tags_hi.long() & _M32) << 32) | (tags_lo.long() & _M32)
    key = torch.where(valid, key, torch.full_like(key, -1))
    s_key, s_idx = torch.sort(key, stable=True)
    rep = torch.zeros(n, dtype=torch.bool, device=dev)
    rep[1:] = s_key[1:] == s_key[:-1]
    first = torch.zeros(n, dtype=torch.bool, device=dev)
    first[s_idx] = ~rep
    first &= valid
    novel = first & ~hit
    occ = torch.zeros(h_bits, dtype=torch.bool, device=dev)
    occ[b[first]] = True
    # The 32 columns are distinct powers of two: their sum is their OR.
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    packed = (occ.view(n_words, 32).long() << shifts).sum(dim=1)
    new = (bits_a.long() & _M32) | packed
    bits_a_new = (new - ((new >> 31) << 32)).to(torch.int32)
    novel_cnt = novel.sum(dtype=torch.int32)
    return novel, bits_a_new, novel_cnt


def dedup_filter(tags_hi: torch.Tensor, tags_lo: torch.Tensor,
                 valid: torch.Tensor, bits_a: torch.Tensor,
                 bits_b: torch.Tensor):
    """One filter round: the kernel for CUDA tensors, the plain version
    for CPU tensors (same contract as dedup_filter_ref)."""
    if backend.use_kernel(tags_hi, tags_lo, valid, bits_a, bits_b):
        return dedup_filter_cuda(tags_hi.contiguous(), tags_lo.contiguous(),
                                 valid.contiguous(), bits_a.contiguous(),
                                 bits_b.contiguous())
    return dedup_filter_ref(tags_hi, tags_lo, valid, bits_a, bits_b)
