"""Batched Ed25519 verification, the counterpart of
``firedancer_tpu/ops/verify.py:47-119`` ``verify_batch``.

The reference's default 2-point semantics: the s-range check, A and R
decompressed in one stacked 2B pass, small-order A rejected with
ERR_PUBKEY and small-order R with ERR_SIG, then h*(-A) + s*B compared
with the decoded R as group elements, where h = SHA-512(r || A || msg)
mod L. On CUDA tensors ``verify_batch`` runs the four kernels
(sha512_mod_l, decompress_so, double_scalarmult, point_eq) and glue
PyTorch ops (concatenation, the s-range compare, the status ladder);
``verify_batch_ref`` is the same composition over the plain versions,
on any device.
"""

from __future__ import annotations

import torch

from . import curve_cuda, dsm_cuda, frontend_cuda
from . import sc25519 as sc

FD_ED25519_SUCCESS = 0
FD_ED25519_ERR_SIG = -1
FD_ED25519_ERR_PUBKEY = -2
FD_ED25519_ERR_MSG = -3


def _check_inputs(msgs, msg_lengths, sigs, pubkeys) -> None:
    bsz = msgs.shape[0]
    if (msgs.dim() != 2 or msgs.dtype != torch.uint8
            or tuple(msg_lengths.shape) != (bsz,)
            or tuple(sigs.shape) != (bsz, 64) or sigs.dtype != torch.uint8
            or tuple(pubkeys.shape) != (bsz, 32)
            or pubkeys.dtype != torch.uint8):
        raise ValueError(
            "want msgs (B, max_len) uint8, msg_lengths (B,), sigs (B, 64) "
            f"uint8, pubkeys (B, 32) uint8; got {tuple(msgs.shape)} "
            f"{msgs.dtype}, {tuple(msg_lengths.shape)}, "
            f"{tuple(sigs.shape)} {sigs.dtype}, {tuple(pubkeys.shape)} "
            f"{pubkeys.dtype}")


def _verify(msgs, msg_lengths, sigs, pubkeys, frontend, dsm, point_eq):
    _check_inputs(msgs, msg_lengths, sigs, pubkeys)
    bsz = msgs.shape[0]
    r_bytes = sigs[:, :32]
    s_bytes = sigs[:, 32:].contiguous()
    s_ok = sc.sc_check_range(s_bytes)

    ar = torch.cat([pubkeys, r_bytes], dim=0)                # (2B, 32)
    hash_in = torch.cat([r_bytes, pubkeys, msgs], dim=1)
    h_bytes, ar_pt, ar_ok, ar_so = frontend(
        hash_in, msg_lengths.to(torch.int32) + 64, ar)
    a_point, rd_point = ar_pt[:bsz], ar_pt[bsz:]
    pub_ok, r_dec_ok = ar_ok[:bsz], ar_ok[bsz:]
    a_small, r_small = ar_so[:bsz], ar_so[bsz:]

    r_prime = dsm(h_bytes, a_point, s_bytes)           # h*(-A) + s*B
    # Rd is affine (decompress emits Z = 1): projective cross-compare.
    r_match = point_eq(rd_point, r_prime)

    # Priority ladder of the reference, lowest rung first, each later
    # rung overriding: the group-element compare (MSG), small-order R
    # (SIG), A/R decompress failure or small-order A (PUBKEY), s-range
    # (SIG). Python-int codes: no host-to-device copy on the hot path.
    status = torch.where(r_match, FD_ED25519_SUCCESS,
                         FD_ED25519_ERR_MSG).to(torch.int32)
    status = torch.where(r_small, FD_ED25519_ERR_SIG, status)
    status = torch.where(~pub_ok | ~r_dec_ok | a_small,
                         FD_ED25519_ERR_PUBKEY, status)
    return torch.where(~s_ok, FD_ED25519_ERR_SIG, status)


def verify_batch(msgs: torch.Tensor, msg_lengths: torch.Tensor,
                 sigs: torch.Tensor, pubkeys: torch.Tensor) -> torch.Tensor:
    """Verify a batch of Ed25519 signatures.

    Args:
      msgs: (B, max_len) uint8, row b valid in [0, msg_lengths[b]).
      msg_lengths: (B,) integer lengths.
      sigs: (B, 64) uint8 (r || s).
      pubkeys: (B, 32) uint8.

    Returns (B,) int32 statuses (SUCCESS / ERR_SIG / ERR_PUBKEY /
    ERR_MSG), on the inputs' device: the kernels on CUDA, the plain
    versions on the CPU.
    """
    return _verify(msgs, msg_lengths, sigs, pubkeys,
                   frontend_cuda.frontend_direct,
                   dsm_cuda.double_scalarmult, curve_cuda.point_eq_affine)


def verify_batch_ref(msgs: torch.Tensor, msg_lengths: torch.Tensor,
                     sigs: torch.Tensor, pubkeys: torch.Tensor) -> torch.Tensor:
    """verify_batch through the plain versions, on any device (the
    card's reference in chip_smoke.py)."""
    return _verify(msgs, msg_lengths, sigs, pubkeys,
                   frontend_cuda.frontend_direct_ref,
                   dsm_cuda.double_scalarmult_ref,
                   curve_cuda.point_eq_affine_ref)
