"""Scalar arithmetic mod L on the card: the counterpart of
``firedancer_tpu/ops/sc_pallas.py`` (``sc_reduce64_pallas``:124, body
``_sc_reduce_kernel``:72; ``sc_mul_pallas``:90, body ``_sc_mul_kernel``:76)
and of ``ops/sign.py:63`` ``_sc_muladd``.

* ``sc_reduce64``: x mod L of (B, 64) uint8 little-endian values.
* ``sc_muladd``: (a b + c) mod L of (B, 32) uint8 scalars; c = None is
  a b mod L (``sc_mul_pallas``). a, b and c need not be reduced.

Both run ``csrc/sc_reduce.cu`` for CUDA tensors and their plain versions
(``*_ref``, ``sc25519.sc_reduce64`` and ``sc25519.sc_muladd``) for CPU
tensors; both give canonical (B, 32) uint8 scalars.
"""

from __future__ import annotations

import ctypes

import torch

from . import backend, build
from . import sc25519 as sc

_V = ctypes.c_void_p
_LL = ctypes.c_longlong


def _launch(symbol: str, name: str, tensors, n: int, like: torch.Tensor):
    """Run one scalar kernel over n lanes -> (n, 32) uint8 on like's
    device (None in tensors passes a null pointer)."""
    out = torch.empty(n, 32, dtype=torch.uint8, device=like.device)
    if n == 0:
        return out
    fn = build.bind("sc_reduce", symbol, [_V] * (len(tensors) + 1) + [_LL, _V])
    stream = torch.cuda.current_stream(like.device).cuda_stream
    build.check_rc(symbol, fn(*(None if t is None else t.data_ptr()
                                for t in tensors), out.data_ptr(), n, stream))
    backend.count_launch(name)
    return out


def sc_reduce64_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, 64) uint8 -> canonical (B, 32) uint8 mod L."""
    backend.count_plain("sc_reduce64")
    return sc.sc_reduce64(x)


def sc_reduce64_cuda(x: torch.Tensor) -> torch.Tensor:
    """The kernel: same contract as sc_reduce64_ref."""
    backend.check_tensor("x", x, torch.uint8, (None, 64))
    return _launch("fd_sc_reduce64", "sc_reduce64", (x,), x.shape[0], x)


def sc_reduce64(x: torch.Tensor) -> torch.Tensor:
    """x mod L of 64-byte little-endian values, as (B, 32) uint8."""
    if backend.use_kernel(x):
        return sc_reduce64_cuda(x.contiguous())
    return sc_reduce64_ref(x)


def sc_muladd_ref(a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: (a b + c) mod L of (B, 32) uint8 scalars, c = None
    read as 0 -> canonical (B, 32) uint8."""
    backend.count_plain("sc_muladd")
    return sc.sc_muladd(a, b, torch.zeros_like(a) if c is None else c)


def sc_muladd_cuda(a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel: same contract as sc_muladd_ref."""
    backend.check_tensor("a", a, torch.uint8, (None, 32))
    n = a.shape[0]
    backend.check_tensor("b", b, torch.uint8, (n, 32))
    if c is not None:
        backend.check_tensor("c", c, torch.uint8, (n, 32))
    return _launch("fd_sc_muladd", "sc_muladd", (a, b, c), n, a)


def sc_muladd(a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor | None = None) -> torch.Tensor:
    """(a b + c) mod L per lane, as (B, 32) uint8; c = None is a b mod L."""
    tensors = (a, b) if c is None else (a, b, c)
    if backend.use_kernel(*tensors):
        return sc_muladd_cuda(a.contiguous(), b.contiguous(),
                              None if c is None else c.contiguous())
    return sc_muladd_ref(a, b, c)
