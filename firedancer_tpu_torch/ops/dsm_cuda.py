"""R' = h*(-A) + s*B, the verify equation's left side: the counterpart
of ``firedancer_tpu/ops/dsm_pallas.py`` (``double_scalarmult_pallas``:222,
which verify calls on the negated point).

``double_scalarmult`` launches ``csrc/double_scalarmult.cu`` for CUDA
tensors and runs ``double_scalarmult_ref`` (the plain
``curve25519.double_scalarmult`` on -A) for CPU tensors. Both build the
A table by the same 14 adds and walk the same unsigned 4-bit windows in
the same add order, so they return the same canonical projective X, Y, Z.

The kernel runs a quad of four threads a lane, thread q holding
coordinate q of the accumulator (X, Y, Z, T): every formula's four
independent products run side by side and meet through width-4
shuffles, so a window's dependent chain is ~12 field operations, not
~43. Each thread keeps its coordinate of the lane's A table in shared
memory (80 KB a block of 32 lanes, two blocks an SM); the B table is a
device tensor (``base_table``, made once per device from
``base_table_niels``) that each block copies into shared memory. The
source's header gives the bound and the mapping; ``kernel_info`` reports
registers, stack, shared memory and the blocks an SM holds.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import backend, build
from . import curve25519 as ge
from . import fe25519 as fe

_V = ctypes.c_void_p
_btabs: dict[torch.device, torch.Tensor] = {}


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
    limbs, the kernel's B table."""
    out = np.zeros((16, 3, 5), np.uint64)
    for t, (x, y) in enumerate(ge.base_multiples()):
        for c, v in enumerate(((y + x) % fe.P, (y - x) % fe.P,
                               fe.D2_INT * x * y % fe.P)):
            out[t, c] = [(v >> (51 * i)) & fe.M51 for i in range(5)]
    return out


def base_table(device) -> torch.Tensor:
    """base_table_niels() as a (16, 3, 5) int64 tensor on device, made
    once per device; the kernel reads it by pointer. Callers must not
    write to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    tab = _btabs.get(dev)
    if tab is None:
        tab = torch.from_numpy(base_table_niels().astype(np.int64)).to(dev)
        _btabs[dev] = tab
    return tab


def kernel_info() -> dict[str, int]:
    """The kernel's resources on the current device (the CUDA runtime's
    function attributes and occupancy API): registers and stack bytes a
    thread, static and dynamic shared bytes a block, threads a block and
    resident blocks an SM."""
    fn = build.bind("double_scalarmult", "fd_dsm_kernel_info", [_V])
    info = (ctypes.c_int * 6)()
    build.check_rc("fd_dsm_kernel_info", fn(ctypes.addressof(info)))
    return dict(zip(("registers", "stack_bytes", "static_shared_bytes",
                     "dynamic_shared_bytes", "threads", "blocks_per_sm"),
                    info))


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
    btab = base_table(dev)
    fn = build.bind("double_scalarmult", "fd_double_scalarmult",
                    [_V, _V, ctypes.c_int, _V, _V, _V, ctypes.c_longlong, _V])
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check_rc("fd_double_scalarmult",
                   fn(h_bytes.data_ptr(), a_pt.data_ptr(), a_pt.shape[1],
                      s_bytes.data_ptr(), btab.data_ptr(), out.data_ptr(), n,
                      stream))
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
