"""R' = h*(-A) + s*B, the verify equation's left side: the counterpart
of ``firedancer_tpu/ops/dsm_pallas.py`` (``double_scalarmult_pallas``:222,
which verify calls on the negated point).

``double_scalarmult`` launches ``csrc/double_scalarmult.cu`` for CUDA
tensors and runs ``double_scalarmult_ref`` (the plain
``curve25519.double_scalarmult`` on -A) for CPU tensors. Both build the
A table and walk the windows the same way, so they return the same
canonical projective X, Y, Z.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import backend, build
from . import curve25519 as ge
from . import fe25519 as fe

_V = ctypes.c_void_p
_tables_set: set[int] = set()


def double_scalarmult_ref(h_bytes: torch.Tensor, a_pt: torch.Tensor,
                          s_bytes: torch.Tensor) -> torch.Tensor:
    """Plain version: h, s (B, 32) uint8 scalars, a_pt (B, >=4, 5) limbs
    of A (X, Y, Z, T) -> (B, 3, 5) canonical limbs of X, Y, Z of
    h*(-A) + s*B."""
    backend.count_plain("double_scalarmult")
    neg_a = ge.point_neg(ge.from_limbs51(a_pt, 4))
    x, y, z, _ = ge.double_scalarmult(h_bytes, neg_a, s_bytes)
    return ge.to_limbs51((x, y, z))


def base_table_niels() -> np.ndarray:
    """(16, 3, 5) uint64: [0..15]*B as (y+x, y-x, 2d*x*y) radix-2^51
    limbs, the kernel's __constant__ table."""
    out = np.zeros((16, 3, 5), np.uint64)
    for t, (x, y) in enumerate(ge.base_multiples()):
        for c, v in enumerate(((y + x) % fe.P, (y - x) % fe.P,
                               fe.D2_INT * x * y % fe.P)):
            out[t, c] = [(v >> (51 * i)) & fe.M51 for i in range(5)]
    return out


def _set_base_table(device: torch.device) -> None:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx in _tables_set:
        return
    fn = build.bind("double_scalarmult", "fd_dsm_set_base_table", [_V])
    tab = np.ascontiguousarray(base_table_niels())
    with torch.cuda.device(idx):
        build.check_rc("fd_dsm_set_base_table", fn(tab.ctypes.data))
    _tables_set.add(idx)


def double_scalarmult_cuda(h_bytes: torch.Tensor, a_pt: torch.Tensor,
                           s_bytes: torch.Tensor) -> torch.Tensor:
    """The kernel: same contract as double_scalarmult_ref."""
    backend.check_tensor("h_bytes", h_bytes, torch.uint8, (None, 32))
    n = h_bytes.shape[0]
    backend.check_tensor("a_pt", a_pt, torch.int64, (n, None, 5))
    backend.check_tensor("s_bytes", s_bytes, torch.uint8, (n, 32))
    if a_pt.shape[1] < 4:
        raise ValueError("a_pt needs X, Y, Z, T")
    dev = h_bytes.device
    out = torch.empty(n, 3, 5, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    _set_base_table(dev)
    fn = build.bind("double_scalarmult", "fd_double_scalarmult",
                    [_V, _V, ctypes.c_int, _V, _V, ctypes.c_longlong, _V])
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check_rc("fd_double_scalarmult",
                   fn(h_bytes.data_ptr(), a_pt.data_ptr(), a_pt.shape[1],
                      s_bytes.data_ptr(), out.data_ptr(), n, stream))
    backend.count_launch("double_scalarmult")
    return out


def double_scalarmult(h_bytes: torch.Tensor, a_pt: torch.Tensor,
                      s_bytes: torch.Tensor) -> torch.Tensor:
    """R' = h*(-A) + s*B as canonical (B, 3, 5) projective limbs."""
    if backend.use_kernel(h_bytes, a_pt, s_bytes):
        return double_scalarmult_cuda(h_bytes.contiguous(),
                                      a_pt.contiguous(),
                                      s_bytes.contiguous())
    return double_scalarmult_ref(h_bytes, a_pt, s_bytes)
