"""Planning math of the Pippenger MSM: the port's own copy of the
stdlib-only ``firedancer_tpu/msm_plan.py`` (the port imports nothing of
the JAX package).

Kept: ``MsmPlan``, ``BASELINE_PLAN``, ``plan_token``, ``parse_plan``,
``plan_windows``, ``plan_buckets``, ``default_rounds`` and ``all_plans``.
There is no flag registry here: an engine's plan is the ``msm`` token of
its ``EngineSpec`` (``"u7"``, the baseline, by default).

``default_rounds`` is the static fill round count
R(lam) = lam + 7 sqrt(lam) + 8 (+1), lam = points per live bucket: the
Poisson tail bound that puts per-batch overflow below ~1e-7. It must stay
bit-identical to the JAX package's (a test pins it), because the fill
verdict ``ok`` depends on it: a port fill must never accept a batch the
reference's fill rejects.
"""

from __future__ import annotations

from typing import NamedTuple

W_BITS = 7
N_BUCKETS = 1 << W_BITS          # 7-bit MSM windows
WINDOWS_Z = 18                   # RLC z weights: uniform < 2^126
WINDOWS_253 = 37                 # scalars mod L
TORSION_BUCKET_BITS = 5          # masked torsion-trial digits


class MsmPlan(NamedTuple):
    """One MSM schedule: window width ``w`` (bits), balanced signed-digit
    recoding (``signed``: digits in [-(2^(w-1)-1), 2^(w-1)], negation
    folded into the gather) and the lazy niels fill flag (``lazy``; the
    kernel path always fills with niels mixed adds, so it reads only
    ``w`` and ``signed``). Signed plans exist only with ``lazy``."""

    w: int = W_BITS
    signed: bool = False
    lazy: bool = False


BASELINE_PLAN = MsmPlan()
PLAN_WIDTHS = (6, 7, 8)


def plan_token(plan: MsmPlan) -> str:
    """Canonical token: 'u7', 'u8l3', 's8l3', ... ('s' = signed digits,
    'l3' = the lazy niels fill)."""
    return (("s" if plan.signed else "u") + str(plan.w)
            + ("l3" if plan.lazy else ""))


def parse_plan(token: str) -> MsmPlan:
    """Inverse of plan_token; raises ValueError on junk, on widths outside
    PLAN_WIDTHS and on a signed plan without the lazy fill."""
    tok = str(token).strip()
    sign_ch, rest = tok[:1], tok[1:]
    if sign_ch not in ("u", "s") or not rest:
        raise ValueError(f"unknown msm plan token {token!r}")
    lazy = rest.endswith("l3")
    if lazy:
        rest = rest[:-2]
    if not rest.isdigit():
        raise ValueError(f"unknown msm plan token {token!r}")
    w = int(rest)
    if w not in PLAN_WIDTHS:
        raise ValueError(
            f"msm plan width {w} outside {PLAN_WIDTHS} ({token!r})")
    signed = sign_ch == "s"
    if signed and not lazy:
        raise ValueError(
            f"signed msm plan {token!r} requires the lazy fill "
            "(signed recoding only exists on the niels-madd path)")
    return MsmPlan(w=w, signed=signed, lazy=lazy)


def plan_windows(scalar_bits: int, w: int = W_BITS,
                 signed: bool = False) -> int:
    """Window count for scalar_bits-wide scalars at width w. Signed
    recoding borrows upward, so when w divides scalar_bits one extra
    all-carry window absorbs the final borrow."""
    nw = -(-scalar_bits // w)
    if signed and scalar_bits % w == 0:
        nw += 1
    return nw


def plan_buckets(plan: MsmPlan) -> int:
    """Bucket-grid height per window: 2^w unsigned (bucket 0 dead),
    2^(w-1)+1 signed (magnitudes 1..2^(w-1); bucket 0 dead)."""
    if plan.signed:
        return (1 << (plan.w - 1)) + 1
    return 1 << plan.w


def default_rounds(bsz: int, n_buckets: int = N_BUCKETS,
                   signed: bool = False) -> int:
    """Static fill rounds for bsz points over n_buckets buckets. Unsigned
    grids have n_buckets-1 live buckets at lam = bsz/(n_buckets-1);
    signed grids pass n_buckets = 2^(w-1) LIVE buckets at
    lam = bsz/n_buckets."""
    lam = bsz / n_buckets if signed else bsz / (n_buckets - 1)
    return min(int(lam + 7.0 * lam ** 0.5 + 8.0) + 1, bsz)


def all_plans() -> list:
    """Every spellable plan (parse_plan-valid), baseline first."""
    plans = [MsmPlan(w=w, signed=False, lazy=False) for w in PLAN_WIDTHS]
    plans += [MsmPlan(w=w, signed=False, lazy=True) for w in PLAN_WIDTHS]
    plans += [MsmPlan(w=w, signed=True, lazy=True) for w in PLAN_WIDTHS]
    plans.sort(key=lambda p: (p != BASELINE_PLAN,))
    return plans
