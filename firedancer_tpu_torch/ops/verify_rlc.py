"""Batch Ed25519 verification by random linear combination (RLC), the
counterpart of ``firedancer_tpu/ops/verify_rlc.py``.

One pass verifies a whole batch with one multi-scalar multiplication and
one shared doubling chain instead of B double-scalar multiplications:

    T = (sum_i z_i s_i mod L) B + sum_i z_i (-R_i) + sum_i (z_i h_i mod L) (-A_i)
    batch valid  <=>  T == identity  AND  every live R_i, A_i torsion-free

with z_i fresh random 126-bit weights drawn after the signatures are
known. The equation alone is sound only against prime-order defects; a
lane whose defect lies in the 8-torsion can cancel with others, so K
random trial aggregates of the live A and R are each multiplied by the
group order and must give the identity (soundness per accepted batch:
2^-126 for prime-order defects plus 2^-K for torsion; the argument is
``verify_rlc.py:18-33``). A failed equation, a failed certification or
an overflowing bucket fill only routes the batch to the exact per-lane
path (``ops.verify.verify_batch``).

The front half decompresses A || R once with the Montgomery-batched
kernel (``curve_cuda.decompress_niels``), which also writes the small-order
mask and the niels forms the three bucket fills read, and computes the
scalars h = SHA-512(r || A || msg) mod L, m = z h mod L and zs = z s mod
L in one of the JAX package's two accelerator configurations
(``frontend``): "fused", one ``frontend_rlc`` launch, or "staged",
``sha512_batch`` with the reduction and products in PyTorch. u = sum zs
mod L, and u B rides the 253-bit MSM as one extra lane. The three MSMs
run on ``msm``'s kernel path: the bucket fill, aggregation, window
Horner and [L] ladder kernels.

Semantics are the reference's default 2-point verify, as the direct
path: s >= L is ERR_SIG; A or R failing to decode, or a small-order A,
is ERR_PUBKEY; a small-order R is ERR_SIG. Those lanes are definite and
weigh zero (z = 0, u = 0). A non-canonical but decodable R stays live.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..msm_plan import BASELINE_PLAN, MsmPlan
from . import curve25519 as ge
from . import curve_cuda, frontend_cuda
from .frontend_cuda import DEFAULT_FRONTEND
from . import msm as msm_mod
from . import sc25519 as sc
from .verify import (FD_ED25519_ERR_PUBKEY, FD_ED25519_ERR_SIG,
                     FD_ED25519_SUCCESS, _check_inputs)

TORSION_K = 64       # trials of the torsion certification


def fresh_z(batch: int, rng: np.random.Generator | None = None) -> np.ndarray:
    """(B, 32) uint8 uniform random 126-bit weights (top 16 bytes zero),
    so all 18 7-bit windows are uniform. Entropy is os.urandom: soundness
    rests on z being unpredictable to whoever made the signatures. The
    numpy Generator is for deterministic tests only."""
    z = np.zeros((batch, 32), np.uint8)
    if rng is None:
        z[:, :16] = np.frombuffer(os.urandom(batch * 16),
                                  np.uint8).reshape(batch, 16)
    else:
        z[:, :16] = rng.integers(0, 256, (batch, 16), dtype=np.uint8)
    z[:, 15] &= 0x3F
    return z


def _fresh_u8(k: int, batch: int,
              rng: np.random.Generator | None = None) -> np.ndarray:
    """fresh_u's digits as uint8 (a quarter of the bytes to make, copy
    and send to the card)."""
    if rng is None:
        raw = np.frombuffer(os.urandom(k * batch), np.uint8)
    else:
        raw = rng.integers(0, 256, k * batch, dtype=np.uint8)
    return (raw & 0x7F).reshape(k, batch)


def fresh_u(k: int, batch: int,
            rng: np.random.Generator | None = None) -> np.ndarray:
    """(K, batch) int32 digits uniform in [0, 128): the torsion trials'
    weights (columns 0..B-1 weigh the A points, B..2B-1 the R points).
    Same entropy rule as fresh_z."""
    return _fresh_u8(k, batch, rng).astype(np.int32)


def draw_weights(bsz: int, device, torsion_k: int = TORSION_K,
                 rng: np.random.Generator | None = None):
    """One pass's weights on the device: z (B, 32) uint8 (fresh_z) and u
    (torsion_k, 2B) uint8 digits (fresh_u's values), drawn on the host
    and copied over."""
    z = torch.from_numpy(fresh_z(bsz, rng)).to(device, non_blocking=True)
    u = torch.from_numpy(_fresh_u8(torsion_k, 2 * bsz, rng)).to(
        device, non_blocking=True)
    return z, u


def rlc_front(msgs, msg_lengths, sigs, pubkeys, z_bytes, u_digits,
              frontend: str = DEFAULT_FRONTEND):
    """The front half of one RLC pass: the s-range check, the stacked
    A || R decompress, the status ladder, the scalars and the MSM inputs.
    Returns (status, definite, msm_in): status (B,) int32, final where
    definite is True and provisionally SUCCESS elsewhere; msm_in the
    three MSMs' (scalars, points, niels forms) --
    "r":   (z_live, -R)           the z weights of the live lanes,
    "m":   (m || u, -A || B)      m = z h mod L, u = sum z s mod L,
    "sub": (u_live, A || R)       the trial weights of the live lanes."""
    _check_inputs(msgs, msg_lengths, sigs, pubkeys)
    bsz = pubkeys.shape[0]
    r_bytes = sigs[:, :32]
    s_bytes = sigs[:, 32:].contiguous()
    s_ok = sc.sc_check_range(s_bytes)

    both, both_ok, both_so, niels, niels_neg = curve_cuda.decompress_niels(
        torch.cat([pubkeys, r_bytes], dim=0))
    a_point, r_point = both[:bsz], both[bsz:]
    pub_ok, r_dec_ok = both_ok[:bsz], both_ok[bsz:]
    a_small, r_small = both_so[:bsz], both_so[bsz:]

    status = torch.where(r_small, FD_ED25519_ERR_SIG,
                         FD_ED25519_SUCCESS).to(torch.int32)
    status = torch.where(~pub_ok | ~r_dec_ok | a_small,
                         FD_ED25519_ERR_PUBKEY, status)
    status = torch.where(~s_ok, FD_ED25519_ERR_SIG, status)
    definite = ~(s_ok & pub_ok & r_dec_ok & ~a_small & ~r_small)
    live = ~definite
    z_live = torch.where(live[:, None], z_bytes, 0).to(torch.uint8)

    _, m_bytes, zs = frontend_cuda.rlc_scalars(
        frontend, torch.cat([r_bytes, pubkeys, msgs], dim=1),
        msg_lengths.to(torch.int32) + 64, z_live, s_bytes)
    u_bytes = sc.sc_sum(zs)

    # u B rides the 253-bit MSM as one extra lane (point B, scalar u).
    dev = both.device
    m_in = (torch.cat([m_bytes, u_bytes], dim=0),
            torch.cat([ge.point_neg_limbs(a_point), ge.base_point_limbs(dev)]),
            torch.cat([niels_neg[:bsz], ge.base_niels_limbs(dev)]))
    # Torsion trials weigh the live lanes' A and R; dead lanes weigh 0.
    u_live = torch.where(torch.cat([live, live])[None, :],
                         u_digits.to(torch.int64), 0)
    msm_in = {"r": (z_live, ge.point_neg_limbs(r_point), niels_neg[bsz:]),
              "m": m_in, "sub": (u_live, both, niels)}
    return status, definite, msm_in


def verify_rlc_local(msgs, msg_lengths, sigs, pubkeys, z_bytes, u_digits,
                     plan: MsmPlan = BASELINE_PLAN,
                     frontend: str = DEFAULT_FRONTEND):
    """The local half of one RLC pass: rlc_front (in the configuration
    ``frontend``) and the three bucket fills with their aggregations.
    Returns (status, definite, parts), parts the partials
    verify_rlc_combine takes --
    w_r / ok_r  window sums and fill verdict of the z (-R) MSM,
    w_m / ok_m  the same for the [m (-A), u B] 253-bit MSM,
    sub / sub_ok  the K trial aggregates and their fill verdict."""
    status, definite, msm_in = rlc_front(msgs, msg_lengths, sigs, pubkeys,
                                         z_bytes, u_digits, frontend)
    return status, definite, msm_partials(msm_in, plan)


def msm_partials(msm_in, plan: MsmPlan = BASELINE_PLAN):
    """The three bucket fills with their aggregations over rlc_front's
    msm_in: the parts dict of verify_rlc_local."""
    z, neg_r, niels_r = msm_in["r"]
    w_r, ok_r = msm_mod.msm_fast_partial(z, neg_r, msm_mod.WINDOWS_Z,
                                         plan=plan, niels=niels_r)
    m, pts_m, niels_m = msm_in["m"]
    w_m, ok_m = msm_mod.msm_fast_partial(m, pts_m, msm_mod.WINDOWS_253,
                                         plan=plan, niels=niels_m)
    u_live, _, niels = msm_in["sub"]
    sub, sub_ok = msm_mod.subgroup_fast_partial(niels, u_live)
    return {"w_r": w_r, "ok_r": ok_r, "w_m": w_m, "ok_m": ok_m,
            "sub": sub, "sub_ok": sub_ok}


def combine_points(parts, plan: MsmPlan = BASELINE_PLAN):
    """The tails of one RLC pass: (t1, t2, cert, verdicts) with t1, t2
    the two MSMs' Horner outputs (1, 4, 5), cert True iff every trial
    aggregate times L is the identity, verdicts the AND of the three fill
    verdicts."""
    t1, ok1 = msm_mod.msm_fast_combine(parts["w_r"], parts["ok_r"], plan)
    t2, ok2 = msm_mod.msm_fast_combine(parts["w_m"], parts["ok_m"], plan)
    cert, sub_fill_ok = msm_mod.subgroup_fast_combine(parts["sub"],
                                                      parts["sub_ok"])
    return t1, t2, cert, ok1 & ok2 & sub_fill_ok


def batch_verdict(t1, t2, cert, fills_ok) -> torch.Tensor:
    """combine_points' outputs -> the batch verdict, a 0-dim bool: T =
    t1 + t2 is the identity (verify_rlc.py:468-471, tested as t1 ==
    -t2), every trial certifies, and no fill overflowed."""
    t_is_identity = ge.sum_is_identity(ge.from_limbs51(t1, 3),
                                       ge.from_limbs51(t2, 3))[0]
    return t_is_identity & cert & fills_ok


def verify_rlc_combine(parts, plan: MsmPlan = BASELINE_PLAN) -> torch.Tensor:
    """The tail half of one RLC pass: the two Horner chains, the [L]
    ladder, and the batch verdict (batch_verdict)."""
    return batch_verdict(*combine_points(parts, plan))


def verify_batch_rlc(msgs, msg_lengths, sigs, pubkeys, z_bytes, u_digits,
                     plan: MsmPlan = BASELINE_PLAN,
                     frontend: str = DEFAULT_FRONTEND):
    """One RLC pass: (status, definite, batch_ok). z_bytes (B, 32) uint8
    from fresh_z, u_digits (K, 2B) from fresh_u, on the inputs' device;
    frontend "fused" or "staged" (frontend_cuda.FRONTENDS). batch_ok True
    means every non-definite lane is SUCCESS; on False the caller runs
    the per-lane path."""
    status, definite, parts = verify_rlc_local(
        msgs, msg_lengths, sigs, pubkeys, z_bytes, u_digits, plan=plan,
        frontend=frontend)
    return status, definite, verify_rlc_combine(parts, plan=plan)


def _event_after(t: torch.Tensor):
    """A CUDA event recorded after the work that produces t (None on the
    CPU, where every result is ready when it is returned)."""
    if t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


class RlcAsyncResult:
    """An RLC pass with its per-lane fallback, resolved lazily:
    ``is_ready()`` polls without blocking and ``np.asarray(result)`` gives
    the final statuses. The fallback is launched only once ``batch_ok`` is
    known to be False, so a clean batch costs one pass and a dirty one
    two."""

    def __init__(self, rlc_out, fallback_fn, args):
        self._status, self._definite, self._ok = rlc_out
        self._ok_event = _event_after(self._ok)
        self._fallback_fn = fallback_fn
        self._args = args
        self._fb = None
        self._fb_event = None
        self._resolved = None
        self.used_fallback = False

    def _start_fallback(self) -> None:
        self._fb = self._fallback_fn(*self._args)
        self._fb_event = _event_after(self._fb)
        self._args = None
        self.used_fallback = True

    def is_ready(self) -> bool:
        if self._resolved is not None:
            return True
        if self._fb is not None:
            return self._fb_event is None or self._fb_event.query()
        if self._ok_event is not None and not self._ok_event.query():
            return False
        if bool(self._ok):
            self._resolved = self._status.cpu().numpy()
            return True
        self._start_fallback()
        return self._fb_event is None or self._fb_event.query()

    def __array__(self, dtype=None, copy=None):
        if self._resolved is None:
            if self._fb is None:
                if bool(self._ok):          # waits for the RLC pass
                    self._resolved = self._status.cpu().numpy()
                else:
                    self._start_fallback()
            if self._resolved is None:
                self._resolved = self._fb.cpu().numpy()
        out = self._resolved
        return out.astype(dtype) if dtype is not None else out


def make_async_verifier(fallback_fn, rng: np.random.Generator | None = None,
                        rlc_fn=None, torsion_k: int = TORSION_K,
                        plan: MsmPlan = BASELINE_PLAN,
                        frontend: str = DEFAULT_FRONTEND):
    """fn(msgs, lens, sigs, pubs) -> RlcAsyncResult, with fresh z and u
    weights per call (os.urandom unless a test passes rng), made on the
    host and copied to the inputs' device. fallback_fn is the per-lane
    verifier run when the batch equation fails; rlc_fn the RLC pass
    (verify_batch_rlc at plan and frontend by default)."""
    if rlc_fn is not None:
        rlc = rlc_fn
    else:
        def rlc(*args):
            return verify_batch_rlc(*args, plan=plan, frontend=frontend)

    def fn(msgs, lens, sigs, pubs):
        z, u = draw_weights(msgs.shape[0], msgs.device, torsion_k, rng)
        out = rlc(msgs, lens, sigs, pubs, z, u)
        return RlcAsyncResult(out, fallback_fn, (msgs, lens, sigs, pubs))

    return fn
