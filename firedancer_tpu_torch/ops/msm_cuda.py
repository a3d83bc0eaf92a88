"""The Pippenger MSM's four kernels, the counterpart of
``firedancer_tpu/ops/msm_pallas.py``:

* ``fill_buckets`` (``fill_buckets_pallas``:93): per (window, bucket)
  lane, the sum of the points its slot table names, by unified mixed adds
  from the identity, reading the points' niels forms; ``csrc/msm_fill.cu``.
* ``aggregate_buckets`` (``aggregate_buckets_pallas``:305): sum_b b * S_b
  per window by two running sums, bucket 0 never read;
  ``csrc/msm_aggregate.cu``.
* ``window_horner`` (``window_horner_pallas``:248): sum_t 2^(w t) W_t,
  most significant window first; ``csrc/msm_horner.cu``.
* ``mul_by_group_order`` (``mul_by_group_order_pallas``:164): [L] P per
  trial point; ``csrc/msm_order.cu``.

Each op launches its kernel for CUDA tensors and runs its plain version
(``*_ref``) for CPU tensors. Both use the reference's formulas in the
reference's order (``_madd_niels``:52, ``_point_add_ext``:69,
``_point_double_ext``:230), so they give the same projective point as the
JAX kernels, and their canonical coordinates compare exactly. Points are
canonical int64 (n, 4, 5) radix-2^51 limbs (X, Y, Z, T); inputs may carry
limbs up to 2^52 (negated points from ``curve25519.point_neg_limbs``).
Niels forms are canonical (n, 3, 5) limbs (y + x, y - x, 2d t), as
``curve_cuda.decompress_niels`` writes them.
"""

from __future__ import annotations

import ctypes

import torch

from . import backend, build
from . import curve25519 as ge
from . import fe25519 as fe
from .sc25519 import L

_V = ctypes.c_void_p
_LL = ctypes.c_longlong


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _points(t: torch.Tensor):
    return ge.from_limbs51(t, 4)


# --------------------------------------------------------------- fill


def fill_buckets_ref(niels: torch.Tensor, idx: torch.Tensor,
                     neg: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version. niels (N, 3, 5) limbs of Z = 1 points; idx (nw, nb,
    R) int32 slot table (-1 = empty); neg (nw, nb, R) bool or None, True
    where the slot's point enters negated. Returns the (nw * nb, 4, 5)
    bucket points, lane t * nb + b."""
    backend.count_plain("msm_fill")
    nw, nb, rounds = idx.shape
    dev = niels.device
    # A lane whose slots are all empty adds the identity niels every
    # round, (0, y, y, 0) -> (0, 4y^2, 4y^2, 0): from the identity it ends
    # at y = 4^(2^R - 1). Only the lanes with a point run the rounds.
    y_empty = pow(4, (1 << rounds) - 1, fe.P)
    out = ge.to_limbs51(tuple(fe.fe_const(v, (nw * nb,), dev)
                              for v in (0, y_empty, y_empty, 0)))
    active = torch.nonzero(idx[:, :, 0].reshape(-1) >= 0).flatten()
    lanes = active.numel()
    yp, ym, t2d = ge.from_limbs51(niels, 3)
    one, zero = fe.fe_one((lanes,), dev), fe.fe_zero((lanes,), dev)
    sel_r = idx.reshape(nw * nb, rounds)[active].T.to(torch.int64)
    neg_r = None if neg is None else neg.reshape(nw * nb, rounds)[active].T
    acc = ge.identity((lanes,), dev)
    for r in range(rounds):
        m = sel_r[r] >= 0
        safe = sel_r[r].clamp(0, niels.shape[0] - 1)
        gyp = fe.fe_select(m, yp[safe], one)
        gym = fe.fe_select(m, ym[safe], one)
        gtd = fe.fe_select(m, t2d[safe], zero)
        if neg_r is not None:
            ng = neg_r[r]
            gyp, gym = fe.fe_select(ng, gym, gyp), fe.fe_select(ng, gyp, gym)
            gtd = fe.fe_select(ng, fe.fe_neg(gtd), gtd)
        acc = ge.madd_niels(acc, (gyp, gym, gtd))
    out[active] = ge.to_limbs51(acc)
    return out


def fill_buckets_cuda(niels: torch.Tensor, idx_r: torch.Tensor,
                      neg_r: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel. idx_r (R, lanes) int32 and neg_r (R, lanes) uint8 (or
    None) are the slot table and sign bits round-major, so that the
    lanes of a warp read neighbouring words. Returns (lanes, 4, 5)."""
    backend.check_tensor("niels", niels, torch.int64, (None, 3, 5))
    backend.check_tensor("idx_r", idx_r, torch.int32, (None, None))
    rounds, lanes = idx_r.shape
    if neg_r is not None:
        backend.check_tensor("neg_r", neg_r, torch.uint8, (rounds, lanes))
    out = torch.empty(lanes, 4, 5, dtype=torch.int64, device=niels.device)
    if lanes == 0:
        return out
    fn = build.bind("msm_fill", "fd_msm_fill",
                    [_V, _V, _V, _V, _LL, ctypes.c_int, _V])
    build.check_rc("fd_msm_fill", fn(
        niels.data_ptr(), idx_r.data_ptr(),
        None if neg_r is None else neg_r.data_ptr(), out.data_ptr(),
        lanes, rounds, _stream(niels)))
    backend.count_launch("msm_fill")
    return out


def fill_buckets(niels: torch.Tensor, idx: torch.Tensor,
                 neg: torch.Tensor | None = None) -> torch.Tensor:
    """Bucket fill of (N, 3, 5) niels forms over the (nw, nb, R) slot
    table -> (nw * nb, 4, 5)."""
    if backend.use_kernel(niels, idx):
        nw, nb, rounds = idx.shape
        idx_r = idx.permute(2, 0, 1).reshape(rounds, nw * nb).contiguous()
        neg_r = (None if neg is None else neg.permute(2, 0, 1).reshape(
            rounds, nw * nb).to(torch.uint8).contiguous())
        return fill_buckets_cuda(niels.contiguous(), idx_r, neg_r)
    return fill_buckets_ref(niels, idx, neg)


# ---------------------------------------------------------- aggregate


def aggregate_buckets_ref(buckets: torch.Tensor) -> torch.Tensor:
    """Plain version. buckets (ncols, nb, 4, 5) -> (ncols, 4, 5): per
    column S = T = bucket nb-1, then for b = nb-2 .. 1, S += bucket b and
    T += S; T = sum_b b * S_b. Bucket 0 is never read."""
    backend.count_plain("msm_aggregate")
    nb = buckets.shape[1]
    coords = tuple(fe.fe_from_limbs51(buckets[:, :, c]) for c in range(4))
    s = tuple(c[:, nb - 1] for c in coords)
    t = s
    for b in range(nb - 2, 0, -1):
        s = ge.point_add(s, tuple(c[:, b] for c in coords))
        t = ge.point_add(t, s)
    return ge.to_limbs51(t)


def aggregate_buckets_cuda(buckets: torch.Tensor) -> torch.Tensor:
    """The kernel: same contract as aggregate_buckets_ref."""
    backend.check_tensor("buckets", buckets, torch.int64, (None, None, 4, 5))
    ncols, nb = buckets.shape[:2]
    if nb < 2:
        raise ValueError(f"aggregation needs >= 2 buckets, got {nb}")
    out = torch.empty(ncols, 4, 5, dtype=torch.int64, device=buckets.device)
    if ncols == 0:
        return out
    fn = build.bind("msm_aggregate", "fd_msm_aggregate",
                    [_V, _V, ctypes.c_int, ctypes.c_int, _V])
    build.check_rc("fd_msm_aggregate", fn(
        buckets.data_ptr(), out.data_ptr(), ncols, nb, _stream(buckets)))
    backend.count_launch("msm_aggregate")
    return out


def aggregate_buckets(buckets: torch.Tensor) -> torch.Tensor:
    """sum_b b * S_b per column of (ncols, nb, 4, 5) bucket points."""
    if backend.use_kernel(buckets):
        return aggregate_buckets_cuda(buckets.contiguous())
    return aggregate_buckets_ref(buckets)


# ------------------------------------------------------------- horner


def window_horner_ref(w_res: torch.Tensor, w_bits: int) -> torch.Tensor:
    """Plain version. w_res (nw, 4, 5), window t in row t -> (1, 4, 5)
    sum_t 2^(w_bits t) W_t: from the top window down, w_bits doublings
    and one add per window."""
    backend.count_plain("msm_horner")
    nw = w_res.shape[0]
    cols = _points(w_res)
    r = tuple(c[nw - 1:nw] for c in cols)
    for i in range(nw - 1):
        for _ in range(w_bits):
            r = ge.point_double(r)
        r = ge.point_add(r, tuple(c[nw - 2 - i:nw - 1 - i] for c in cols))
    return ge.to_limbs51(r)


def window_horner_cuda(w_res: torch.Tensor, w_bits: int) -> torch.Tensor:
    """The kernel: same contract as window_horner_ref."""
    backend.check_tensor("w_res", w_res, torch.int64, (None, 4, 5))
    nw = w_res.shape[0]
    if nw < 1:
        raise ValueError("window_horner needs >= 1 window")
    out = torch.empty(1, 4, 5, dtype=torch.int64, device=w_res.device)
    fn = build.bind("msm_horner", "fd_msm_horner",
                    [_V, _V, ctypes.c_int, ctypes.c_int, _V])
    build.check_rc("fd_msm_horner", fn(
        w_res.data_ptr(), out.data_ptr(), nw, w_bits, _stream(w_res)))
    backend.count_launch("msm_horner")
    return out


def window_horner(w_res: torch.Tensor, w_bits: int) -> torch.Tensor:
    """Cross-window Horner of (nw, 4, 5) window sums -> (1, 4, 5)."""
    if backend.use_kernel(w_res):
        return window_horner_cuda(w_res.contiguous(), w_bits)
    return window_horner_ref(w_res, w_bits)


# ------------------------------------------------------------ [L] * P


def mul_by_group_order_ref(pt: torch.Tensor) -> torch.Tensor:
    """Plain version. pt (K, 4, 5) -> (K, 4, 5) [L] P: from the leading 1
    of L, per remaining bit a doubling and, where the bit is set, an add
    of P."""
    backend.count_plain("msm_order")
    base = _points(pt)
    r = base
    for bit in bin(L)[3:]:
        r = ge.point_double(r)
        if bit == "1":
            r = ge.point_add(r, base)
    return ge.to_limbs51(r)


def mul_by_group_order_cuda(pt: torch.Tensor) -> torch.Tensor:
    """The kernel: same contract as mul_by_group_order_ref."""
    backend.check_tensor("pt", pt, torch.int64, (None, 4, 5))
    k = pt.shape[0]
    out = torch.empty(k, 4, 5, dtype=torch.int64, device=pt.device)
    if k == 0:
        return out
    fn = build.bind("msm_order", "fd_msm_mul_by_order",
                    [_V, _V, _LL, _V])
    build.check_rc("fd_msm_mul_by_order", fn(
        pt.data_ptr(), out.data_ptr(), k, _stream(pt)))
    backend.count_launch("msm_order")
    return out


def mul_by_group_order(pt: torch.Tensor) -> torch.Tensor:
    """[L] P for each of the (K, 4, 5) points."""
    if backend.use_kernel(pt):
        return mul_by_group_order_cuda(pt.contiguous())
    return mul_by_group_order_ref(pt)
