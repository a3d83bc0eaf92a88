"""Balanced signed-window recode for the signed MSM plans: the
counterpart of ``firedancer_tpu/ops/msm_recode.py`` (``_recode_step``:75,
``recode_signed``:84).

Unsigned w-bit window digits d_t (LSB first along axis 0) become signed
digits in [-(2^(w-1)-1), 2^(w-1)] with sum(digit_t * 2^(w*t)) equal to
the original scalar, provided the window count follows
``msm_plan.plan_windows``. Plain PyTorch on any device.
"""

from __future__ import annotations

import torch


def _recode_step(v: torch.Tensor, w_bits: int):
    """One borrow step: v = d_t + c_in in [0, 2^w] maps to
    (digit, c_out) with digit = v - c_out * 2^w, c_out = (v > 2^(w-1))."""
    borrow = (v > (1 << (w_bits - 1))).to(v.dtype)
    return v - (borrow << w_bits), borrow


def recode_signed(d: torch.Tensor, w_bits: int) -> torch.Tensor:
    """(n_windows, ...) digits, each masked to [0, 2^w - 1] on entry ->
    int64 signed digits of the same shape."""
    d = d.to(torch.int64) & ((1 << w_bits) - 1)
    c = torch.zeros_like(d[0])
    outs = []
    for t in range(d.shape[0]):
        digit, c = _recode_step(d[t] + c, w_bits)
        outs.append(digit)
    return torch.stack(outs, dim=0)
