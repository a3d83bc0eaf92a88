"""Batched Ed25519 key generation and signing (RFC 8032): the
counterpart of ``firedancer_tpu/ops/sign.py`` (``keygen_batch``:83,
``sign_batch``:95), the device side of ``fd_ed25519_sign``.

The composition and the byte layout are the JAX package's. Every step is
an op of the port that dispatches on its tensors' device (kernels on
CUDA, plain versions on the CPU); the clamp and the concatenations are
PyTorch glue. One ``sign_batch`` call launches sha512_batch 3 times,
sc_reduce64 2, double_scalarmult 2, compress 2 and sc_muladd once.
``sign_batch_ref`` is the same composition over the plain versions, on
any device. RFC 8032 signing is deterministic, so both give the oracle's
bytes.
"""

from __future__ import annotations

import functools

import torch

from . import curve25519 as ge
from . import curve_cuda, dsm_cuda, frontend_cuda, sc_cuda


@functools.lru_cache(maxsize=4)
def _b_rows(device: torch.device, n: int) -> torch.Tensor:
    """The base point (curve25519.base_point_limbs) as n contiguous
    (4, 5) rows, the A operand of scalarmult_base; made once per device
    and batch, callers must not write to it."""
    return ge.base_point_limbs(device).expand(n, 4, 5).contiguous()


@functools.lru_cache(maxsize=None)
def _clamp_consts(device: torch.device):
    """The clamp's AND and OR masks, made once per device."""
    mask = torch.full((32,), 0xFF, dtype=torch.uint8, device=device)
    mask[0], mask[31] = 248, 63
    top = torch.zeros(32, dtype=torch.uint8, device=device)
    top[31] = 64
    return mask, top


def _clamp(a_bytes: torch.Tensor) -> torch.Tensor:
    """RFC 8032 secret-scalar clamp on (B, 32) uint8 (sign.py:55): the
    low three bits cleared, bit 255 cleared and bit 254 set."""
    mask, top = _clamp_consts(a_bytes.device)
    return (a_bytes & mask) | top


# The ops a signing call runs: (sha512_batch, sc_reduce64, dsm, compress,
# sc_muladd), dispatching by device or the plain versions.
_OPS = (frontend_cuda.sha512_batch, sc_cuda.sc_reduce64,
        dsm_cuda.double_scalarmult, curve_cuda.compress, sc_cuda.sc_muladd)
_OPS_REF = (frontend_cuda.sha512_batch_ref, sc_cuda.sc_reduce64_ref,
            dsm_cuda.double_scalarmult_ref, curve_cuda.compress_ref,
            sc_cuda.sc_muladd_ref)


def _scalarmult_base(s_bytes: torch.Tensor, ops) -> torch.Tensor:
    """s B for (B, 32) uint8 scalars of any 256 bits (sign.py:39): the
    double-scalar multiply with h = 0, so the A term adds only the
    identity; -> (B, 3, 5) canonical X, Y, Z limbs."""
    n = s_bytes.shape[0]
    return ops[2](torch.zeros_like(s_bytes), _b_rows(s_bytes.device, n),
                  s_bytes)


def _keygen(seeds: torch.Tensor, ops):
    sha, _, _, compress, _ = ops
    az = sha(seeds, torch.full((seeds.shape[0],), 32, dtype=torch.int32,
                               device=seeds.device))
    a = _clamp(az[:, :32])
    return a, az[:, 32:].contiguous(), compress(_scalarmult_base(a, ops))


def keygen_batch(seeds: torch.Tensor):
    """(B, 32) uint8 seeds -> (a_clamped, prefix, pub), each (B, 32)
    uint8; pub is the encoding of A = a B."""
    return _keygen(seeds, _OPS)


def _sign(msgs: torch.Tensor, lens: torch.Tensor, seeds: torch.Tensor, ops):
    sha, reduce64, _, compress, muladd = ops
    lens = lens.to(device=msgs.device, dtype=torch.int32)
    a, prefix, pub = _keygen(seeds, ops)
    # r = SHA-512(prefix || msg) mod L; R = r B.
    r = reduce64(sha(torch.cat([prefix, msgs], dim=1), lens + 32))
    r_enc = compress(_scalarmult_base(r, ops))
    # h = SHA-512(R || pub || msg) mod L, the layout verify hashes.
    h = reduce64(sha(torch.cat([r_enc, pub, msgs], dim=1), lens + 64))
    return torch.cat([r_enc, muladd(h, a, r)], dim=1), pub


def sign_batch(msgs: torch.Tensor, lens: torch.Tensor,
               seeds: torch.Tensor):
    """Sign a batch: msgs (B, max_len) uint8, lens (B,) integer lengths,
    seeds (B, 32) uint8 -> (sigs (B, 64) uint8 R || s, pubs (B, 32)
    uint8), on the inputs' device."""
    return _sign(msgs, lens, seeds, _OPS)


def sign_batch_ref(msgs: torch.Tensor, lens: torch.Tensor,
                   seeds: torch.Tensor):
    """sign_batch through the plain versions, on any device (the card's
    reference in chip_smoke.py)."""
    return _sign(msgs, lens, seeds, _OPS_REF)
