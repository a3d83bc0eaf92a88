"""The Pippenger MSM's four kernels, the counterpart of
``firedancer_tpu/ops/msm_pallas.py``:

* ``fill_buckets`` (``fill_buckets_pallas``:93): per (window, bucket)
  lane, the sum of the points its slot table names, reading the points'
  niels forms; ``csrc/msm_fill.cu``.
* ``aggregate_buckets`` (``aggregate_buckets_pallas``:305): sum_b b * S_b
  per window, bucket 0 never read; ``csrc/msm_aggregate.cu``.
* ``window_horner`` (``window_horner_pallas``:248): sum_t 2^(w t) W_t,
  most significant window first; ``csrc/msm_horner.cu``.
* ``mul_by_group_order`` (``mul_by_group_order_pallas``:164): [L] P per
  trial point; ``csrc/msm_order.cu``.
* ``msm_tails``: the RLC pass's two Horners and its ladders in one
  launch of ``csrc/msm_tails.cu``, whose roles are the two above (a quad
  of threads a chain, ``csrc/ge_quad.cuh``); ``window_horner`` and
  ``mul_by_group_order`` launch it with one role.

Each op launches its kernel for CUDA tensors and runs its plain version
(``*_ref``) for CPU tensors. The plain versions use the reference's
formulas in the reference's order (``_madd_niels``:52,
``_point_add_ext``:69, ``_point_double_ext``:230), so they give the same
projective point as the JAX kernels, and their canonical coordinates
compare exactly. The fill and aggregation kernels split a lane's slots
and a column's buckets over the threads of a warp, which adds in another
order: the same group element, other projective coordinates. Their
mirrors ``fill_buckets_split_ref`` and ``aggregate_buckets_split_ref``
run the kernels' order in plain PyTorch (chip_smoke.py holds the kernels
to them limb for limb, and to the JAX-order versions affinely); the a =
-1 unified add with non-square d is complete on all of E(F_p), so any
order gives the same element, small-order points included. Points are
canonical int64 (n, 4, 5) radix-2^51 limbs (X, Y, Z, T); inputs may
carry limbs up to 2^52 (negated points from
``curve25519.point_neg_limbs``). Niels forms are canonical (n, 3, 5)
limbs (y + x, y - x, 2d t), as ``curve_cuda.decompress_niels`` writes
them.
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


# Launch geometry of the fill and aggregation kernels (csrc/msm_fill.cu,
# csrc/msm_aggregate.cu): a lane's fill threads and a column's
# aggregation threads share one warp.
WARP = 32
# One wave of the fill's blocks on an H100 SXM: at 130 registers one
# 256-thread block fits an SM (csrc/msm_fill.cu), on each of 132 SMs.
FILL_WAVE_THREADS = 132 * 256


def fill_chunks(rounds: int, lanes: int) -> int:
    """C, the fill kernel's threads per lane: the largest power of two
    <= 32 and <= rounds with lanes * C <= FILL_WAVE_THREADS (at least 1).
    Each of a lane's threads runs all log2 C tree adds, so past one wave
    a larger C only adds work (chip_smoke.py phase 3 times C = 4-32). At
    B = 8192: 16 for the torsion grid (2048 lanes), 8 for the z grid
    (2304), 4 for the 253-bit grid (4736)."""
    c = 1
    while (c < WARP and 2 * c <= rounds
           and lanes * 2 * c <= FILL_WAVE_THREADS):
        c *= 2
    return c


def aggregate_segment(nb: int) -> int:
    """s, the aggregation kernel's buckets per thread: the least power of
    two with 32 s >= nb - 1 (1 for nb <= 33, 4 for 128 and 129)."""
    s = 1
    while WARP * s < nb - 1:
        s *= 2
    return s


def _warp_tree(pt, width: int):
    """Sum over dim 1 (width a power of two) in the kernels' butterfly
    order (msm.cuh ge_warp_tree): at offset o = width/2, ..., 1, element
    i < o adds element i + o. Returns the element-0 sums."""
    o = width // 2
    while o:
        pt = ge.point_add(tuple(c[:, :o] for c in pt),
                          tuple(c[:, o:2 * o] for c in pt))
        o //= 2
    return tuple(c[:, 0] for c in pt)


# --------------------------------------------------------------- fill


def fill_buckets_ref(niels: torch.Tensor, idx: torch.Tensor,
                     neg: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version in the JAX kernel's order. niels (N, 3, 5) limbs of
    Z = 1 points; idx (nw, nb, R) int32 slot table (-1 = empty); neg
    (nw, nb, R) bool or None, True where the slot's point enters negated.
    Returns the (nw * nb, 4, 5) bucket points, lane t * nb + b: per lane
    R mixed adds from the identity, an empty slot adding the identity
    niels (1, 1, 0)."""
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


def fill_buckets_split_ref(niels: torch.Tensor, idx: torch.Tensor,
                           neg: torch.Tensor | None = None,
                           chunks: int | None = None) -> torch.Tensor:
    """Plain version in the kernel's order, same contract as
    fill_buckets_ref. Lane l's C = chunks threads (fill_chunks by
    default): thread c sums slots c, c + C, ... by mixed adds from the
    identity up to its first empty slot, then the C partials meet in
    _warp_tree."""
    backend.count_plain("msm_fill")
    nw, nb, rounds = idx.shape
    lanes = nw * nb
    c = fill_chunks(rounds, lanes) if chunks is None else chunks
    dev = niels.device
    k = -(-rounds // c)

    def dealt(t, empty):
        # (lanes, R) -> (lanes * C, k): row l * C + j holds slots j + C i.
        t = torch.nn.functional.pad(t.reshape(lanes, rounds),
                                    (0, k * c - rounds), value=empty)
        return t.reshape(lanes, k, c).transpose(1, 2).reshape(lanes * c, k)

    sel = dealt(idx.to(torch.int64), -1)
    ng = None if neg is None else dealt(neg, False)
    live = torch.cumprod((sel >= 0).to(torch.int64), dim=1) == 1
    yp, ym, t2d = ge.from_limbs51(niels, 3)
    acc = ge.identity((lanes * c,), dev)
    for i in range(k):
        rows = torch.nonzero(live[:, i]).flatten()
        if rows.numel() == 0:
            break
        s = sel[rows, i]
        q = (yp[s], ym[s], t2d[s])
        if ng is not None:
            m = ng[rows, i]
            q = (fe.fe_select(m, q[1], q[0]), fe.fe_select(m, q[0], q[1]),
                 fe.fe_select(m, fe.fe_neg(q[2]), q[2]))
        part = ge.madd_niels(tuple(a[rows] for a in acc), q)
        acc = tuple(a.index_copy(0, rows, p) for a, p in zip(acc, part))
    acc = tuple(a.reshape(lanes, c, -1) for a in acc)
    return ge.to_limbs51(_warp_tree(acc, c))


def fill_buckets_cuda(niels: torch.Tensor, idx_l: torch.Tensor,
                      neg_l: torch.Tensor | None = None,
                      chunks: int | None = None) -> torch.Tensor:
    """The kernel. idx_l (lanes, R) int32 and neg_l (lanes, R) uint8 (or
    None) are the slot table and sign bits lane-major, each lane's live
    slots a prefix; chunks the threads per lane (fill_chunks by default;
    chip_smoke.py times the others). Returns (lanes, 4, 5), equal to
    fill_buckets_split_ref."""
    backend.check_tensor("niels", niels, torch.int64, (None, 3, 5))
    backend.check_tensor("idx_l", idx_l, torch.int32, (None, None))
    lanes, rounds = idx_l.shape
    if neg_l is not None:
        backend.check_tensor("neg_l", neg_l, torch.uint8, (lanes, rounds))
    c = fill_chunks(rounds, lanes) if chunks is None else chunks
    if c < 1 or c > WARP or c & (c - 1):
        raise ValueError(f"chunks must be a power of two <= {WARP}, got {c}")
    out = torch.empty(lanes, 4, 5, dtype=torch.int64, device=niels.device)
    if lanes == 0:
        return out
    fn = build.bind("msm_fill", "fd_msm_fill",
                    [_V, _V, _V, _V, _LL, ctypes.c_int, ctypes.c_int, _V])
    build.check_rc("fd_msm_fill", fn(
        niels.data_ptr(), idx_l.data_ptr(),
        None if neg_l is None else neg_l.data_ptr(), out.data_ptr(),
        lanes, rounds, c, _stream(niels)))
    backend.count_launch("msm_fill")
    return out


def fill_buckets(niels: torch.Tensor, idx: torch.Tensor,
                 neg: torch.Tensor | None = None) -> torch.Tensor:
    """Bucket fill of (N, 3, 5) niels forms over the (nw, nb, R) slot
    table -> (nw * nb, 4, 5)."""
    if backend.use_kernel(niels, idx):
        nw, nb, rounds = idx.shape
        idx_l = idx.reshape(nw * nb, rounds).contiguous()
        neg_l = (None if neg is None else
                 neg.reshape(nw * nb, rounds).to(torch.uint8).contiguous())
        return fill_buckets_cuda(niels.contiguous(), idx_l, neg_l)
    return fill_buckets_ref(niels, idx, neg)


# ---------------------------------------------------------- aggregate


def aggregate_buckets_ref(buckets: torch.Tensor) -> torch.Tensor:
    """Plain version in the JAX kernel's order. buckets (ncols, nb, 4, 5)
    -> (ncols, 4, 5): per column S = T = bucket nb-1, then for b = nb-2
    .. 1, S += bucket b and T += S; T = sum_b b * S_b. Bucket 0 is never
    read."""
    backend.count_plain("msm_aggregate")
    nb = buckets.shape[1]
    coords = tuple(fe.fe_from_limbs51(buckets[:, :, c]) for c in range(4))
    s = tuple(c[:, nb - 1] for c in coords)
    t = s
    for b in range(nb - 2, 0, -1):
        s = ge.point_add(s, tuple(c[:, b] for c in coords))
        t = ge.point_add(t, s)
    return ge.to_limbs51(t)


def aggregate_buckets_split_ref(buckets: torch.Tensor) -> torch.Tensor:
    """Plain version in the kernel's order, same contract as
    aggregate_buckets_ref. Per column, thread j of 32 runs the two
    running sums from the top of its segment lo_j = 1 + j s .. min(lo_j
    + s - 1, nb - 1), s = aggregate_segment(nb): S_j = sum S_b, T_j = sum
    (b - lo_j + 1) S_b; then the suffix sums U_j = sum_{i >= j} S_i by a
    5-level scan, U_0 := identity, s U_j by log2 s doublings, T_j + s U_j,
    and _warp_tree: sum_j T_j + s sum_j j S_j = sum_b b S_b."""
    backend.count_plain("msm_aggregate")
    ncols, nb = buckets.shape[:2]
    seg = aggregate_segment(nb)
    dev = buckets.device
    coords = tuple(fe.fe_from_limbs51(buckets[:, :, c]) for c in range(4))
    lo = 1 + seg * torch.arange(WARP, device=dev)
    hi = (lo + seg - 1).clamp(max=nb - 1)
    ident = ge.identity((ncols, WARP), dev)

    def at(b):
        return tuple(c[:, b.clamp(0, nb - 1)] for c in coords)

    s = ge.point_select(lo <= hi, at(hi), ident)
    t = s
    for i in range(1, seg):
        m = hi - i >= lo
        s = ge.point_select(m, ge.point_add(s, at(hi - i)), s)
        t = ge.point_select(m, ge.point_add(t, s), t)
    u, o = s, 1
    while o < WARP:
        head = ge.point_add(tuple(c[:, :WARP - o] for c in u),
                            tuple(c[:, o:] for c in u))
        u = tuple(torch.cat([h, c[:, WARP - o:]], dim=1)
                  for h, c in zip(head, u))
        o *= 2
    u = ge.point_select(torch.arange(WARP, device=dev) > 0, u, ident)
    for _ in range(seg.bit_length() - 1):
        u = ge.point_double(u)
    return ge.to_limbs51(_warp_tree(ge.point_add(t, u), WARP))


def aggregate_buckets_cuda(buckets: torch.Tensor) -> torch.Tensor:
    """The kernel: same contract as aggregate_buckets_ref, equal to
    aggregate_buckets_split_ref."""
    backend.check_tensor("buckets", buckets, torch.int64, (None, None, 4, 5))
    ncols, nb = buckets.shape[:2]
    if nb < 2:
        raise ValueError(f"aggregation needs >= 2 buckets, got {nb}")
    out = torch.empty(ncols, 4, 5, dtype=torch.int64, device=buckets.device)
    if ncols == 0:
        return out
    fn = build.bind("msm_aggregate", "fd_msm_aggregate",
                    [_V, _V, ctypes.c_int, ctypes.c_int, ctypes.c_int, _V])
    build.check_rc("fd_msm_aggregate", fn(
        buckets.data_ptr(), out.data_ptr(), ncols, nb, aggregate_segment(nb),
        _stream(buckets)))
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
    """The kernel (msm_tails.cu with the Horner role alone): same
    contract as window_horner_ref."""
    _check_horner("w_res", w_res)
    out = torch.empty(1, 4, 5, dtype=torch.int64, device=w_res.device)
    fn = build.bind("msm_tails", "fd_msm_horner",
                    [_V, _V, ctypes.c_int, ctypes.c_int, _V])
    build.check_rc("fd_msm_horner", fn(
        w_res.data_ptr(), out.data_ptr(), w_res.shape[0], w_bits,
        _stream(w_res)))
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
    """The kernel (msm_tails.cu with the ladder role alone): same
    contract as mul_by_group_order_ref."""
    backend.check_tensor("pt", pt, torch.int64, (None, 4, 5))
    k = pt.shape[0]
    out = torch.empty(k, 4, 5, dtype=torch.int64, device=pt.device)
    if k == 0:
        return out
    fn = build.bind("msm_tails", "fd_msm_mul_by_order", [_V, _V, _LL, _V])
    build.check_rc("fd_msm_mul_by_order", fn(
        pt.data_ptr(), out.data_ptr(), k, _stream(pt)))
    backend.count_launch("msm_order")
    return out


def mul_by_group_order(pt: torch.Tensor) -> torch.Tensor:
    """[L] P for each of the (K, 4, 5) points."""
    if backend.use_kernel(pt):
        return mul_by_group_order_cuda(pt.contiguous())
    return mul_by_group_order_ref(pt)


# -------------------------------------------------------------- tails


def _check_horner(name: str, w_res: torch.Tensor) -> None:
    backend.check_tensor(name, w_res, torch.int64, (None, 4, 5))
    if w_res.shape[0] < 1:
        raise ValueError(f"{name}: the Horner needs >= 1 window")


def msm_tails_ref(w_r: torch.Tensor, w_m: torch.Tensor, pt: torch.Tensor,
                  w_bits: int):
    """Plain version: (window_horner_ref(w_r), window_horner_ref(w_m),
    mul_by_group_order_ref(pt))."""
    return (window_horner_ref(w_r, w_bits), window_horner_ref(w_m, w_bits),
            mul_by_group_order_ref(pt))


def msm_tails_cuda(w_r: torch.Tensor, w_m: torch.Tensor, pt: torch.Tensor,
                   w_bits: int):
    """The kernel: both Horners and the K ladders in one launch
    (csrc/msm_tails.cu, a warp a chain or eight trials). Same contract as
    msm_tails_ref, equal to it limb for limb."""
    _check_horner("w_r", w_r)
    _check_horner("w_m", w_m)
    backend.check_tensor("pt", pt, torch.int64, (None, 4, 5))
    dev = w_r.device
    t1 = torch.empty(1, 4, 5, dtype=torch.int64, device=dev)
    t2 = torch.empty(1, 4, 5, dtype=torch.int64, device=dev)
    la = torch.empty(pt.shape[0], 4, 5, dtype=torch.int64, device=dev)
    fn = build.bind("msm_tails", "fd_msm_tails",
                    [_V, ctypes.c_int, _V, ctypes.c_int, ctypes.c_int, _V,
                     _LL, _V, _V, _V, _V])
    build.check_rc("fd_msm_tails", fn(
        w_r.data_ptr(), w_r.shape[0], w_m.data_ptr(), w_m.shape[0], w_bits,
        pt.data_ptr(), pt.shape[0], t1.data_ptr(), t2.data_ptr(),
        la.data_ptr(), _stream(w_r)))
    backend.count_launch("msm_tails")
    return t1, t2, la


def msm_tails(w_r: torch.Tensor, w_m: torch.Tensor, pt: torch.Tensor,
              w_bits: int):
    """The tails of an RLC pass: the two MSMs' Horners of (nw, 4, 5)
    window sums -> (1, 4, 5) each, and [L] P of the (K, 4, 5) trial
    aggregates."""
    if backend.use_kernel(w_r, w_m, pt):
        return msm_tails_cuda(w_r.contiguous(), w_m.contiguous(),
                              pt.contiguous(), w_bits)
    return msm_tails_ref(w_r, w_m, pt, w_bits)


def tails_kernel_info() -> dict[str, int]:
    """msm_tails_kernel's resources on the current device (the CUDA
    runtime's function attributes): registers and stack bytes a thread,
    static shared bytes a block, threads a block."""
    fn = build.bind("msm_tails", "fd_msm_tails_kernel_info", [_V])
    info = (ctypes.c_int * 4)()
    build.check_rc("fd_msm_tails_kernel_info", fn(ctypes.addressof(info)))
    return dict(zip(("registers", "stack_bytes", "static_shared_bytes",
                     "threads"), info))
