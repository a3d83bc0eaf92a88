"""The GF(2^255 - 19) power chains on the card: the counterpart of
``firedancer_tpu/ops/pow_pallas.py`` (``fe_invert_pallas``:160 and
``fe_pow22523_pallas``:164, body ``_pow_kernel``:113).

``fe_invert`` (z^(p - 2); 0 for z = 0) and ``fe_pow22523``
(z^((p - 5)/8); 0 for z = 0) take (B, 5) int64 radix-2^51 limbs, each in
[0, 2^52), the kernels' layout, and return canonical limbs. Both run
``csrc/fe_pow.cu`` for CUDA tensors (the chains ``lg_invert`` and
``lg_pow22523`` of ``csrc/decompress_core.cuh`` on its group of GROUP
threads a lane, thread j holding limb j) and their plain versions (the
chains of ``fe25519``, through ``fe_from_limbs51``/``fe_to_limbs51``)
for CPU tensors. Nothing on the port's paths calls them: the kernels that
need a chain run it inside themselves (``decompress_so``,
``decompress_niels``, ``compress``).
"""

from __future__ import annotations

import ctypes

import torch

from . import backend, build
from . import fe25519 as fe

_V = ctypes.c_void_p


def _pow_ref(z: torch.Tensor, invert: bool) -> torch.Tensor:
    backend.count_plain("fe_pow")
    chain = fe.fe_invert if invert else fe.fe_pow22523
    return fe.fe_to_limbs51(chain(fe.fe_from_limbs51(z)))


def _pow_cuda(z: torch.Tensor, invert: bool) -> torch.Tensor:
    backend.check_tensor("z", z, torch.int64, (None, 5))
    n = z.shape[0]
    out = torch.empty_like(z)
    if n == 0:
        return out
    fn = build.bind("fe_pow", "fd_fe_pow",
                    [ctypes.c_int, _V, _V, ctypes.c_longlong, _V])
    stream = torch.cuda.current_stream(z.device).cuda_stream
    build.check_rc("fd_fe_pow", fn(int(invert), z.data_ptr(), out.data_ptr(),
                                   n, stream))
    backend.count_launch("fe_pow")
    return out


def _pow(z: torch.Tensor, invert: bool) -> torch.Tensor:
    if backend.use_kernel(z):
        return _pow_cuda(z.contiguous(), invert)
    return _pow_ref(z, invert)


def fe_invert_ref(z: torch.Tensor) -> torch.Tensor:
    """Plain version: z^(p - 2) of (B, 5) limbs -> canonical limbs."""
    return _pow_ref(z, True)


def fe_invert_cuda(z: torch.Tensor) -> torch.Tensor:
    """The kernel: same contract as fe_invert_ref, limbs in [0, 2^52)."""
    return _pow_cuda(z, True)


def fe_invert(z: torch.Tensor) -> torch.Tensor:
    """z^(p - 2), the inverse of nonzero z, as canonical (B, 5) limbs."""
    return _pow(z, True)


def fe_pow22523_ref(z: torch.Tensor) -> torch.Tensor:
    """Plain version: z^((p - 5)/8) of (B, 5) limbs -> canonical limbs."""
    return _pow_ref(z, False)


def fe_pow22523_cuda(z: torch.Tensor) -> torch.Tensor:
    """The kernel: same contract as fe_pow22523_ref, limbs in [0, 2^52)."""
    return _pow_cuda(z, False)


def fe_pow22523(z: torch.Tensor) -> torch.Tensor:
    """z^((p - 5)/8), the square-root chain, as canonical (B, 5) limbs."""
    return _pow(z, False)
