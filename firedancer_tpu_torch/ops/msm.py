"""Batched multi-scalar multiplication (Pippenger), the counterpart of
``firedancer_tpu/ops/msm.py``'s kernel path (``msm_fast_partial``:690,
``msm_fast_combine``:762, ``subgroup_fast_partial``:825,
``subgroup_fast_combine``:869).

Computes sum_i c_i * P_i for a batch of scalars and Z = 1 points with one
doubling chain shared by the whole batch:

1. Staging (plain PyTorch on any device, as the JAX package does it in
   XLA): w-bit window digits, for signed plans the balanced recode, then
   a slot table idx[t, b, r] = the lane of the r-th point in bucket
   (t, b), or -1, from a stable sort and searchsorted. The fill runs a
   STATIC number of rounds (msm_plan.default_rounds); ``ok`` is False iff
   some live bucket holds more points, and the caller then takes the
   exact per-lane path. Bucket 0 is never counted: digit 0 adds nothing.
2. Bucket fill, aggregation, window Horner and the [L] ladder: the four
   kernels of ``msm_cuda`` (CUDA on the card, their plain versions on the
   CPU).

Points cross as canonical int64 (n, 4, 5) radix-2^51 limbs (X, Y, Z, T),
and the fill reads their niels forms, (n, 3, 5) limbs: the RLC pass hands
over the ones its decompress kernel wrote (``niels=``), other callers get
them formed here in plain PyTorch. The halves keep the JAX package's
return contracts: a partial is a (nw, 4, 5) point per window (or per
trial) plus its fill verdict, so a multi-card combine can gather partials
before the tails.
"""

from __future__ import annotations

import torch

from .. import msm_plan
from ..msm_plan import BASELINE_PLAN, MsmPlan
from . import curve25519 as ge
from . import msm_cuda
from .msm_recode import recode_signed

W_BITS = msm_plan.W_BITS
N_BUCKETS = msm_plan.N_BUCKETS
WINDOWS_Z = msm_plan.WINDOWS_Z       # RLC z weights: uniform < 2^126
WINDOWS_253 = msm_plan.WINDOWS_253   # scalars mod L
# Scalar widths behind the baseline window counts; other plans re-derive
# their own window count from these (msm_plan.plan_windows).
SCALAR_BITS = {WINDOWS_Z: 126, WINDOWS_253: 253}


def _digits(scalars_bytes: torch.Tensor, n_windows: int,
            w_bits: int = W_BITS) -> torch.Tensor:
    """(B, 32) uint8 -> (n_windows, B) int64 w_bits-wide windows, LSB
    first. A window spans at most two bytes (sh + w_bits <= 15), read as
    one 16-bit word (bytes past the scalar are zero)."""
    dev = scalars_bytes.device
    b = torch.nn.functional.pad(scalars_bytes.to(torch.int64).T,
                                (0, 0, 0, 2))          # (34, B)
    bit = torch.arange(n_windows, device=dev) * w_bits
    i = (bit >> 3).clamp(max=32)
    word = b[i] + (b[i + 1] << 8)                       # (nw, B)
    return (word >> (bit & 7)[:, None]) & ((1 << w_bits) - 1)


def _staging_from_digits(d: torch.Tensor, bsz: int, max_rounds: int,
                         n_buckets: int = N_BUCKETS):
    """Slot table from (nw, B) digits in [0, n_buckets): (idx, ok), idx
    (nw, n_buckets, max_rounds) int32 lane indices or -1, ok a 0-dim bool
    tensor, False iff a live bucket (b > 0) overflowed max_rounds."""
    nw = d.shape[0]
    dev = d.device
    d = d.to(torch.int64)
    sorted_d, order = torch.sort(d, dim=1, stable=True)
    buckets = torch.arange(n_buckets, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(
        sorted_d.contiguous(), buckets.expand(nw, n_buckets).contiguous())
    ends = torch.cat([starts[:, 1:],
                      torch.full((nw, 1), bsz, dtype=starts.dtype,
                                 device=dev)], dim=1)
    counts = ends - starts
    ok = torch.where(buckets > 0, counts, 0).max() <= max_rounds
    r = torch.arange(max_rounds, dtype=torch.int64, device=dev)
    pos = starts[:, :, None] + r                          # (nw, nb, R)
    valid = (r < counts[:, :, None]) & (buckets[None, :, None] > 0)
    pos = pos.reshape(nw, -1).clamp(0, max(bsz - 1, 0))
    idx = torch.gather(order, 1, pos).reshape(nw, n_buckets, max_rounds)
    return torch.where(valid, idx, -1).to(torch.int32), ok


def _staging_indices(scalars_bytes: torch.Tensor, n_windows: int, bsz: int,
                     max_rounds: int):
    """Baseline-plan slot table of (B, 32) uint8 scalars."""
    return _staging_from_digits(_digits(scalars_bytes, n_windows), bsz,
                                max_rounds)


def _plan_dims(n_windows: int, bsz: int, plan: MsmPlan):
    """(nw, n_buckets, default max_rounds) of a non-baseline plan, from
    the scalar width behind the caller's baseline window count."""
    scalar_bits = SCALAR_BITS.get(n_windows, W_BITS * n_windows)
    nw = msm_plan.plan_windows(scalar_bits, plan.w, plan.signed)
    nb = msm_plan.plan_buckets(plan)
    live = (1 << (plan.w - 1)) if plan.signed else nb
    return nw, nb, msm_plan.default_rounds(bsz, live, signed=plan.signed)


def _top_tree_planes(n_windows: int, nw: int, plan: MsmPlan) -> int:
    """Bit planes of the plan's top window when it covers r < w scalar
    bits (its digits then crowd a few buckets and would overflow the
    round bound, so _top_window_sum sums it exactly), else 0."""
    scalar_bits = SCALAR_BITS.get(n_windows, W_BITS * n_windows)
    r = scalar_bits - plan.w * (nw - 1)
    if r < 0 or r >= plan.w:
        return 0
    return r + 1 if plan.signed else r


def _neg_table(neg_flags: torch.Tensor, idx: torch.Tensor,
               bsz: int) -> torch.Tensor:
    """neg[t, b, r]: slot (t, b, r) holds a lane whose signed digit was
    negative (empty slots are False)."""
    nw, nb, rounds = idx.shape
    safe = idx.reshape(nw, -1).to(torch.int64).clamp(0, max(bsz - 1, 0))
    neg = torch.gather(neg_flags, 1, safe).reshape(nw, nb, rounds)
    return neg & (idx >= 0)


def _plan_staging(scalars_bytes, bsz: int, max_rounds: int, nw: int,
                  n_buckets: int, plan: MsmPlan, tree_planes: int = 0):
    """Digits, the signed recode on signed plans, and magnitude bucketing:
    (idx, neg, ok, top), neg None on unsigned plans; with tree_planes the
    top window's digit row is split off as top."""
    d = _digits(scalars_bytes, nw, plan.w)
    s = recode_signed(d, plan.w) if plan.signed else d
    top = None
    if tree_planes:
        top, s = s[nw - 1], s[:nw - 1]
    if not plan.signed:
        idx, ok = _staging_from_digits(s, bsz, max_rounds, n_buckets)
        return idx, None, ok, top
    idx, ok = _staging_from_digits(s.abs(), bsz, max_rounds, n_buckets)
    return idx, _neg_table(s < 0, idx, bsz), ok, top


def _reduce_pairs(pt, n: int):
    """Tree-reduce the lane axis (dim -2 of each fe) by pairwise
    point_add; an odd width splits off its leading element into a carry
    folded back at the end (msm.py:96)."""
    carry = None
    while n > 1:
        if n % 2:
            head = tuple(c[..., :1, :] for c in pt)
            carry = head if carry is None else ge.point_add(carry, head)
            pt = tuple(c[..., 1:, :] for c in pt)
            n -= 1
        pt = ge.point_add(tuple(c[..., 0::2, :] for c in pt),
                          tuple(c[..., 1::2, :] for c in pt))
        n //= 2
    return pt if carry is None else ge.point_add(pt, carry)


def _top_window_sum(top_digits: torch.Tensor, points: torch.Tensor,
                    planes: int) -> torch.Tensor:
    """W_top = sum_i top_i * P_i by MSB-first bit-plane masked tree sums
    over the lanes (msm.py:181): exact for any digit, no round bound.
    Plain PyTorch on every device, as the JAX package keeps it in XLA on
    both engines. Returns (1, 4, 5) limbs."""
    dev = points.device
    bsz = points.shape[0]
    pts = ge.from_limbs51(points)
    ident_b = ge.identity((bsz,), dev)
    acc = ge.identity((1,), dev)
    for k in range(planes - 1, -1, -1):
        m = ((top_digits >> k) & 1) == 1
        t_k = _reduce_pairs(ge.point_select(m, pts, ident_b), bsz)
        acc = ge.point_add(ge.point_double(acc), t_k)
    return ge.to_limbs51(acc)


def msm_fast_partial(scalars_bytes: torch.Tensor, points: torch.Tensor,
                     n_windows: int, max_rounds: int | None = None,
                     plan: MsmPlan = BASELINE_PLAN,
                     niels: torch.Tensor | None = None):
    """Local half of the MSM: staging, the bucket fill and the per-window
    aggregation. scalars_bytes (B, 32) uint8 (windows past n_windows
    zero); points (B, 4, 5) limbs with Z = 1 (the niels mixed add needs
    it); niels their (B, 3, 5) niels forms (None: formed from points).
    Returns (w_res, ok): w_res (nw, 4, 5), W_t = sum_b b * S_{t,b} (nw is
    the plan's window count), ok the fill verdict (0-dim bool)."""
    bsz = points.shape[0]
    if plan == BASELINE_PLAN:
        if max_rounds is None:
            max_rounds = msm_plan.default_rounds(bsz)
        nw, nb = n_windows, N_BUCKETS
        idx, ok = _staging_indices(scalars_bytes, nw, bsz, max_rounds)
        neg, top, planes = None, None, 0
    else:
        nw, nb, rounds = _plan_dims(n_windows, bsz, plan)
        if max_rounds is None:
            max_rounds = rounds
        planes = _top_tree_planes(n_windows, nw, plan)
        idx, neg, ok, top = _plan_staging(scalars_bytes, bsz, max_rounds,
                                          nw, nb, plan, tree_planes=planes)
    nw_grid = nw - 1 if planes else nw
    if niels is None:
        niels = ge.niels_limbs(points)
    buckets = msm_cuda.fill_buckets(niels, idx, neg)
    w_res = msm_cuda.aggregate_buckets(buckets.reshape(nw_grid, nb, 4, 5))
    if planes:
        w_res = torch.cat([w_res, _top_window_sum(top, points, planes)])
    return w_res, ok


def msm_fast_combine(w_res: torch.Tensor, ok: torch.Tensor,
                     plan: MsmPlan = BASELINE_PLAN):
    """Tail half: the cross-window Horner chain (plan.w doublings per
    window). Returns ((1, 4, 5) point, ok)."""
    return msm_cuda.window_horner(w_res, plan.w), ok


def subgroup_fast_partial(niels: torch.Tensor, u_digits: torch.Tensor,
                          bucket_bits: int = msm_plan.TORSION_BUCKET_BITS,
                          max_rounds: int | None = None):
    """Local half of the torsion certification: K random weightings of
    the (B, 3, 5) niels forms' points (trial j's digits u[j] masked to
    bucket_bits), filled and aggregated as K windows. Returns (agg (K, 4,
    5), ok_fill). Masked digits keep the catch probability, which rests
    on the digits mod 8 (msm.py:805-812)."""
    bsz = niels.shape[0]
    n_buckets = 1 << bucket_bits
    if max_rounds is None:
        max_rounds = msm_plan.default_rounds(bsz, n_buckets)
    d = u_digits.to(torch.int64) & (n_buckets - 1)
    k = d.shape[0]
    idx, ok_fill = _staging_from_digits(d, bsz, max_rounds, n_buckets)
    buckets = msm_cuda.fill_buckets(niels, idx, None)
    return (msm_cuda.aggregate_buckets(buckets.reshape(k, n_buckets, 4, 5)),
            ok_fill)


def subgroup_fast_combine(agg: torch.Tensor, ok_fill: torch.Tensor):
    """Tail half: [L] * Agg_j for every trial and the identity test.
    Returns (every trial is the identity, ok_fill), 0-dim bools."""
    la = msm_cuda.mul_by_group_order(agg)
    return ge.is_identity_limbs(la).all(), ok_fill
