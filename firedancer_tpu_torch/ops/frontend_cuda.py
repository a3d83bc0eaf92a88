"""The verify front halves' hashes and scalars: the counterpart of
``firedancer_tpu/ops/frontend_pallas.py`` and ``sha512_pallas.py``.

* ``sha512_mod_l`` (``sha512_mod_l_pallas``:277): h = SHA-512(r || A ||
  msg) mod L, the direct path's hash; ``csrc/sha512_mod_l.cu``.
* ``frontend_rlc`` (``frontend_rlc_pallas``:300): (h, m = z h mod L,
  zs = z s mod L) in one launch, the RLC pass's fused scalar front half;
  ``csrc/frontend_rlc.cu``.
* ``sha512_batch`` (``sha512_pallas.sha512_batch_pallas``:201): plain
  64-byte digests, the staged front half's hash; ``csrc/sha512_batch.cu``.

Each launches its CUDA kernel for CUDA tensors and runs its plain version
(``*_ref``) for CPU tensors. ``frontend_direct`` is the direct path's
whole front half (``frontend_direct_auto``:403); ``rlc_scalars`` selects
the RLC pass's scalar front half by ``frontend`` (``frontend_rlc_auto``:375
with ``staged_coeff_muls``:349, whose reduction and products run the
scalar kernels of ``sc_cuda``, as JAX's ``FD_SC_IMPL=pallas`` does).
"""

from __future__ import annotations

import ctypes

import torch

from . import backend, build
from . import curve_cuda, sc_cuda
from . import sha512 as sha
from .sc25519 import sc_muladd, sc_reduce64

_V = ctypes.c_void_p
_LL = ctypes.c_longlong
# The RLC pass's front halves (the JAX package's accelerator
# configurations): "fused" is FD_FRONTEND_IMPL=auto, one frontend_rlc
# launch; "staged" is FD_FRONTEND_IMPL=xla with FD_SC_IMPL=pallas,
# sha512_batch, then sc_reduce64, then one sc_muladd on the stacked
# products.
FRONTENDS = ("fused", "staged")
DEFAULT_FRONTEND = "fused"


def _hash_rows(msgs: torch.Tensor, lens: torch.Tensor):
    """A hash kernel's row contract: (B, max_len) uint8 rows, (B,) int32
    lengths (clamped to [0, max_len] in the kernel)."""
    backend.check_tensor("msgs", msgs, torch.uint8, (None, None))
    backend.check_tensor("lens", lens, torch.int32, (msgs.shape[0],))
    return msgs.shape


def sha512_mod_l_ref(msgs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Plain version: sc_reduce64(sha512_batch(msgs, lens))."""
    backend.count_plain("sha512_mod_l")
    return sc_reduce64(sha.sha512_batch(msgs, lens))


def sha512_mod_l_cuda(msgs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The kernel: (B, max_len) uint8 rows and (B,) int32 lengths
    (clamped to [0, max_len]) -> (B, 32) uint8 canonical scalars."""
    bsz, max_len = _hash_rows(msgs, lens)
    out = torch.empty(bsz, 32, dtype=torch.uint8, device=msgs.device)
    if bsz == 0:
        return out
    fn = build.bind("sha512_mod_l", "fd_sha512_mod_l",
                    [_V, _LL, _V, _V, _LL, _V])
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


def sha512_batch_ref(msgs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Plain version: the port's plain SHA-512, (B, 64) uint8 digests."""
    backend.count_plain("sha512_batch")
    return sha.sha512_batch(msgs, lens)


def sha512_batch_cuda(msgs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The kernel: same row contract as sha512_mod_l_cuda -> (B, 64)
    uint8 digests."""
    bsz, max_len = _hash_rows(msgs, lens)
    out = torch.empty(bsz, 64, dtype=torch.uint8, device=msgs.device)
    if bsz == 0:
        return out
    fn = build.bind("sha512_batch", "fd_sha512_batch",
                    [_V, _LL, _V, _V, _LL, _V])
    stream = torch.cuda.current_stream(msgs.device).cuda_stream
    build.check_rc("fd_sha512_batch",
                   fn(msgs.data_ptr(), max_len, lens.data_ptr(),
                      out.data_ptr(), bsz, stream))
    backend.count_launch("sha512_batch")
    return out


def sha512_batch(msgs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """SHA-512(row[:len]) per lane, as (B, 64) uint8 digests."""
    if backend.use_kernel(msgs, lens):
        return sha512_batch_cuda(msgs.contiguous(),
                                 lens.to(torch.int32).contiguous())
    return sha512_batch_ref(msgs, lens)


def staged_coeff_muls(z: torch.Tensor, h: torch.Tensor, s: torch.Tensor):
    """(m, zs) = (z h mod L, z s mod L) as one sc_muladd on the stacked
    (z || z, h || s), c = 0: the staged path's coefficient products,
    frontend_pallas.py:362-370 (one stacked sc_mul_pallas launch)."""
    out = sc_cuda.sc_muladd(torch.cat([z, z]), torch.cat([h, s]))
    return out[:z.shape[0]], out[z.shape[0]:]


def frontend_rlc_ref(msgs: torch.Tensor, lens: torch.Tensor,
                     z: torch.Tensor, s: torch.Tensor):
    """Plain version: h = sc_reduce64(sha512(msgs)), m = z h mod L and
    zs = z s mod L, the plain staged composition -> (h, m, zs), each
    (B, 32) uint8."""
    backend.count_plain("frontend_rlc")
    h = sc_reduce64(sha.sha512_batch(msgs, lens))
    zero = torch.zeros_like(h)
    return h, sc_muladd(z, h, zero), sc_muladd(z, s, zero)


def frontend_rlc_cuda(msgs: torch.Tensor, lens: torch.Tensor,
                      z: torch.Tensor, s: torch.Tensor):
    """The kernel: the row contract of sha512_mod_l_cuda, z and s (B, 32)
    uint8 -> (h, m, zs), each (B, 32) uint8."""
    bsz, max_len = _hash_rows(msgs, lens)
    backend.check_tensor("z", z, torch.uint8, (bsz, 32))
    backend.check_tensor("s", s, torch.uint8, (bsz, 32))
    h, m, zs = (torch.empty(bsz, 32, dtype=torch.uint8, device=msgs.device)
                for _ in range(3))
    if bsz == 0:
        return h, m, zs
    fn = build.bind("frontend_rlc", "fd_frontend_rlc",
                    [_V, _LL, _V, _V, _V, _V, _V, _V, _LL, _V])
    stream = torch.cuda.current_stream(msgs.device).cuda_stream
    build.check_rc("fd_frontend_rlc",
                   fn(msgs.data_ptr(), max_len, lens.data_ptr(),
                      z.data_ptr(), s.data_ptr(), h.data_ptr(),
                      m.data_ptr(), zs.data_ptr(), bsz, stream))
    backend.count_launch("frontend_rlc")
    return h, m, zs


def frontend_rlc(msgs: torch.Tensor, lens: torch.Tensor, z: torch.Tensor,
                 s: torch.Tensor):
    """(h, m, zs) = (SHA-512(row[:len]) mod L, z h mod L, z s mod L)."""
    if backend.use_kernel(msgs, lens, z, s):
        return frontend_rlc_cuda(msgs.contiguous(),
                                 lens.to(torch.int32).contiguous(),
                                 z.contiguous(), s.contiguous())
    return frontend_rlc_ref(msgs, lens, z, s)


def rlc_scalars(frontend: str, msgs: torch.Tensor, lens: torch.Tensor,
                z: torch.Tensor, s: torch.Tensor):
    """The RLC pass's scalar front half, (h, m, zs), by configuration:
    "fused" launches frontend_rlc; "staged" launches sha512_batch,
    sc_reduce64 and one stacked sc_muladd. Both give the same bytes."""
    if frontend == "fused":
        return frontend_rlc(msgs, lens, z, s)
    if frontend == "staged":
        h = sc_cuda.sc_reduce64(sha512_batch(msgs, lens))
        return (h,) + staged_coeff_muls(z, h, s)
    raise ValueError(f"unknown frontend {frontend!r} (want "
                     f"{'|'.join(FRONTENDS)})")


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
