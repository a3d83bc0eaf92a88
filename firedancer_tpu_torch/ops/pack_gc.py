"""Account-conflict transaction scheduling as batched graph coloring, the
counterpart of ``firedancer_tpu/ops/pack_gc.py`` (``pack_schedule``:64,
``hash_account``:131, ``PackTxnPad``:143, ``build_arrays``:157,
``schedule_block``:186), the device analog of ``ballet.pack``
(fd_pack.c:446-461,520-545).

A block of pending transactions with account read/write locks is split
into parallel waves ("colors") such that no two transactions of a wave
conflict (a writer conflicts with any other use of the account, readers
only with writers), higher rewards per CU land in earlier waves, and each
wave keeps to a CU budget. Account keys hash (FNV-1a) into H buckets; a
collision makes only a false conflict, so a schedule stays admissible.
Transactions go in descending score order, each to the least color whose
sets it does not conflict with and whose CU total stays within the cap,
or to -1 (left pending) when none is free.

``pack_schedule`` dispatches on its tensors' device (``backend.use_kernel``):
CUDA tensors launch ``pack_gc_cuda.pack_schedule_cuda`` (one launch a
block) or raise; CPU tensors run ``pack_schedule_ref``, a line-by-line
transcription of the JAX scan (dense masks, the first free color by
argmax).
"""

from __future__ import annotations

import numpy as np
import torch

from . import backend
from .pack_gc_cuda import pack_schedule_cuda

H_BITS_DEFAULT = 4096           # lock-bucket space; 128 32-bit words
MAX_COLORS_DEFAULT = 64         # parallel waves a scheduling round
CU_CAP_DEFAULT = 12_000_000


def _masks_from_idx(idx: torch.Tensor, n_words: int) -> torch.Tensor:
    """(N, A) int32 bucket indices (-1 pad) -> (N, n_words) 32-bit masks
    (int32 words): bit b & 31 of word b >> 5 for each valid b; a bucket
    past the last word sets nothing."""
    lanes = torch.arange(n_words, dtype=torch.int32, device=idx.device)
    out = torch.zeros(idx.shape[0], n_words, dtype=torch.int32,
                      device=idx.device)
    for j in range(idx.shape[1]):
        col = idx[:, j:j + 1]
        hit = (lanes[None, :] == (col >> 5)) & (col >= 0)
        out |= torch.where(hit, torch.ones_like(col) << (col & 31),
                           torch.zeros_like(col))
    return out


def pack_schedule_ref(w_idx: torch.Tensor, r_idx: torch.Tensor,
                      scores: torch.Tensor, cus: torch.Tensor, *,
                      n_colors: int = MAX_COLORS_DEFAULT,
                      h_bits: int = H_BITS_DEFAULT,
                      cu_cap: int = CU_CAP_DEFAULT) -> torch.Tensor:
    """Plain version: the JAX scan step by step on dense masks. (N, AW),
    (N, AR) int32 buckets (-1 pad), (N,) float32 scores, (N,) int32 CUs ->
    (N,) int32 colors in input order, -1 where every color conflicts."""
    backend.count_plain("pack_schedule")
    n = w_idx.shape[0]
    dev = w_idx.device
    n_words = h_bits // 32
    order = torch.sort(-scores, stable=True).indices   # heap-pop order
    w_mask = _masks_from_idx(w_idx[order], n_words)
    r_mask = _masks_from_idx(r_idx[order], n_words)
    cu_sorted = cus[order]
    used_w = torch.zeros(n_colors, n_words, dtype=torch.int32, device=dev)
    used_r = torch.zeros_like(used_w)
    cu_used = torch.zeros(n_colors, dtype=torch.int32, device=dev)
    color_ids = torch.arange(n_colors, device=dev)
    colors_sorted = torch.empty(n, dtype=torch.int32, device=dev)
    for i in range(n):
        wm, rm, cu = w_mask[i], r_mask[i], cu_sorted[i]
        # fd_pack.c:446-461: my writes against their anything, my reads
        # against their writes; and the wave's CU budget.
        conflict = (((used_w & (wm | rm)) != 0).any(dim=1)
                    | ((used_r & wm) != 0).any(dim=1)
                    | (cu_used + cu > cu_cap))
        free = ~conflict
        color = torch.where(free.any(), free.to(torch.int32).argmax(),
                            -1).to(torch.int32)
        sel = color_ids == color
        used_w = torch.where(sel[:, None], used_w | wm, used_w)
        used_r = torch.where(sel[:, None], used_r | rm, used_r)
        cu_used = torch.where(sel, cu_used + cu, cu_used)
        colors_sorted[i] = color
    colors = torch.zeros(n, dtype=torch.int32, device=dev)
    colors[order] = colors_sorted
    return colors


def pack_schedule(w_idx: torch.Tensor, r_idx: torch.Tensor,
                  scores: torch.Tensor, cus: torch.Tensor, *,
                  n_colors: int = MAX_COLORS_DEFAULT,
                  h_bits: int = H_BITS_DEFAULT,
                  cu_cap: int = CU_CAP_DEFAULT) -> torch.Tensor:
    """Color a block: the kernel for CUDA tensors, the plain version for
    CPU tensors (same contract as pack_schedule_ref)."""
    kw = {"n_colors": n_colors, "h_bits": h_bits, "cu_cap": cu_cap}
    if backend.use_kernel(w_idx, r_idx, scores, cus):
        return pack_schedule_cuda(w_idx.contiguous(), r_idx.contiguous(),
                                  scores.contiguous(), cus.contiguous(), **kw)
    return pack_schedule_ref(w_idx, r_idx, scores, cus, **kw)


_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def hash_account(key: bytes, h_bits: int = H_BITS_DEFAULT) -> int:
    """Stable account key -> bucket: FNV-1a over the 32-byte key."""
    h = _FNV_OFFSET
    for b in key:
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h % h_bits


def hash_accounts(keys: list, h_bits: int = H_BITS_DEFAULT) -> np.ndarray:
    """hash_account of each key of a list, vectorised over keys of one
    length: numpy's uint64 product wraps mod 2^64 as the masked one does."""
    if len({len(k) for k in keys}) != 1:
        return np.array([hash_account(k, h_bits) for k in keys], np.int64)
    raw = np.frombuffer(b"".join(keys), np.uint8).reshape(len(keys), -1)
    h = np.full(len(keys), _FNV_OFFSET, np.uint64)
    prime = np.uint64(_FNV_PRIME)
    with np.errstate(over="ignore"):
        for j in range(raw.shape[1]):
            h = (h ^ raw[:, j].astype(np.uint64)) * prime
    return (h % np.uint64(h_bits)).astype(np.int64)


class _PadTxn:
    """Shape-padding placeholder: no locks, zero priority, 1 CU."""

    txn_id = -1
    rewards = 0
    est_cus = 1
    writable = frozenset()
    readonly = frozenset()
    score = 0.0


PackTxnPad = _PadTxn()


def build_arrays(txns, h_bits: int = H_BITS_DEFAULT,
                 max_w: int | None = None, max_r: int | None = None):
    """PackTxn list -> (w_idx, r_idx, scores, cus) numpy arrays, each
    transaction's sorted keys hashed. Distinct accounts may share a
    bucket (a false conflict, safe); one account always maps to one
    bucket, so every true conflict is kept. Scores are rounded to float32
    here, on the host."""
    n = len(txns)
    max_w = max_w or max((len(t.writable) for t in txns), default=1) or 1
    max_r = max_r or max((len(t.readonly) for t in txns), default=1) or 1
    w_idx = np.full((n, max_w), -1, np.int32)
    r_idx = np.full((n, max_r), -1, np.int32)
    scores = np.zeros((n,), np.float32)
    cus = np.zeros((n,), np.int32)
    for idx, attr in ((w_idx, "writable"), (r_idx, "readonly")):
        keys, rows, cols = [], [], []
        for i, t in enumerate(txns):
            ks = sorted(getattr(t, attr))
            keys += ks
            rows += [i] * len(ks)
            cols += range(len(ks))
        if keys:
            idx[rows, cols] = hash_accounts(keys, h_bits)
    for i, t in enumerate(txns):
        scores[i] = t.score
        cus[i] = t.est_cus
    return w_idx, r_idx, scores, cus


def schedule_block(txns, n_colors: int = MAX_COLORS_DEFAULT,
                   h_bits: int = H_BITS_DEFAULT,
                   cu_cap: int = CU_CAP_DEFAULT, pad_to: int | None = None,
                   max_w: int | None = None, max_r: int | None = None,
                   device=None):
    """PackTxn list -> (waves, leftover) on device (the card unless the
    caller passes device="cpu"): waves[k] are the transactions of the
    k-th non-empty color, leftover those left unscheduled. pad_to rounds
    the block up to a multiple with pad transactions (no accounts, zero
    score: they color freely and are cut from the result); max_w and
    max_r fix the bucket arrays' widths."""
    if not txns:
        return [], []
    dev = backend.resolve_device(device)
    n_real = len(txns)
    if pad_to:
        pad = (-n_real) % pad_to
        if pad:
            txns = list(txns) + [PackTxnPad] * pad
    arrays = build_arrays(txns, h_bits, max_w=max_w, max_r=max_r)
    w_idx, r_idx, scores, cus = (torch.from_numpy(a).to(dev) for a in arrays)
    colors = pack_schedule(w_idx, r_idx, scores, cus, n_colors=n_colors,
                           h_bits=h_bits, cu_cap=cu_cap).cpu().numpy()
    waves = [[] for _ in range(n_colors)]
    leftover = []
    for t, c in zip(txns[:n_real], colors[:n_real].tolist()):
        if c < 0:
            leftover.append(t)
        else:
            waves[c].append(t)
    return [w for w in waves if w], leftover
