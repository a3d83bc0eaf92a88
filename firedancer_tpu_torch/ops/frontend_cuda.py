"""The direct-verify front half: h = SHA-512(r || A || msg) mod L, and the
stacked (A, R) decompress with its small-order mask.

Counterpart of ``firedancer_tpu/ops/frontend_pallas.py`` (the fused
``sha512_mod_l_pallas``:277 and ``frontend_direct_auto``:403) and of
``sha512_pallas.py``. ``sha512_mod_l`` launches the CUDA kernel
``csrc/sha512_mod_l.cu`` for CUDA tensors and runs the plain version
``sha512_mod_l_ref`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import backend, build
from . import curve_cuda
from .sc25519 import sc_reduce64
from .sha512 import sha512_batch

_V = ctypes.c_void_p


def sha512_mod_l_ref(msgs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Plain version: sc_reduce64(sha512_batch(msgs, lens))."""
    backend.count_plain("sha512_mod_l")
    return sc_reduce64(sha512_batch(msgs, lens))


def sha512_mod_l_cuda(msgs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The kernel: (B, max_len) uint8 rows and (B,) int32 lengths
    (clamped to [0, max_len]) -> (B, 32) uint8 canonical scalars."""
    backend.check_tensor("msgs", msgs, torch.uint8, (None, None))
    bsz, max_len = msgs.shape
    backend.check_tensor("lens", lens, torch.int32, (bsz,))
    out = torch.empty(bsz, 32, dtype=torch.uint8, device=msgs.device)
    if bsz == 0:
        return out
    fn = build.bind("sha512_mod_l", "fd_sha512_mod_l",
                    [_V, ctypes.c_longlong, _V, _V, ctypes.c_longlong, _V])
    stream = torch.cuda.current_stream(msgs.device).cuda_stream
    build.check_rc("fd_sha512_mod_l",
                   fn(msgs.data_ptr(), max_len, lens.data_ptr(),
                      out.data_ptr(), bsz, stream))
    backend.count_launch("sha512_mod_l")
    return out


def sha512_mod_l(msgs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """h = SHA-512(row[:len]) mod L per lane, as (B, 32) uint8."""
    if backend.use_kernel(msgs, lens):
        return sha512_mod_l_cuda(msgs.contiguous(),
                                 lens.to(torch.int32).contiguous())
    return sha512_mod_l_ref(msgs, lens)


def frontend_direct(msgs: torch.Tensor, lens: torch.Tensor,
                    ar_bytes: torch.Tensor):
    """The whole direct-verify front half: (h, ar_point, ar_ok,
    ar_small_order) for the hash rows and the stacked (2B, 32) A || R
    encodings."""
    h = sha512_mod_l(msgs, lens)
    pt, ok, so = curve_cuda.decompress_so(ar_bytes)
    return h, pt, ok, so


def frontend_direct_ref(msgs: torch.Tensor, lens: torch.Tensor,
                        ar_bytes: torch.Tensor):
    """frontend_direct through the plain versions, on any device."""
    h = sha512_mod_l_ref(msgs, lens)
    pt, ok, so = curve_cuda.decompress_so_ref(ar_bytes)
    return h, pt, ok, so
