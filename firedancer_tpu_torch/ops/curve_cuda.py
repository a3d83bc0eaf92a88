"""Point decompression with the small-order mask, the RLC pass's
batched decompress with niels forms, the affine point compare and point
compression: the counterpart of ``firedancer_tpu/ops/curve_pallas.py``
(``decompress_pallas(want_small_order=True)`` and
``decompress_pallas(want_niels=True)``:180, ``point_eq_affine_pallas``:275,
``compress_pallas``:318).

Points cross as canonical int64 ``(B, k, 5)`` radix-2^51 limbs (X, Y,
Z, T), niels forms as ``(B, 3, 5)``. Each op launches its CUDA kernel
(``csrc/decompress_so.cu``, ``csrc/decompress_niels.cu``,
``csrc/point_eq.cu``, ``csrc/compress.cu``) for CUDA tensors and runs its
plain version for CPU tensors. All four run one core
(``csrc/decompress_core.cuh``): a lane's field ops on GROUP threads,
thread j holding limb j of every field element, LANES_PER_WARP lanes a
warp; donna's inversion-free square root for decompress, the inversion
z^(p - 2) for compress, two multiplies and two zero tests for the point
compare.
"""

from __future__ import annotations

import ctypes

import torch

from . import backend, build
from . import curve25519 as ge
from . import decompress as dec
from . import fe25519 as fe

_V = ctypes.c_void_p
GROUP = 5                       # threads a lane (decompress_core.cuh DC_GROUP)
LANES_PER_WARP = 32 // GROUP    # threads 30-31 of a warp decode no lane


def decompress_so_ref(enc: torch.Tensor):
    """Plain version: (B, 32) uint8 -> (point (B, 4, 5), ok, small_order).
    Failed lanes carry the identity, so they read small_order True."""
    backend.count_plain("decompress_so")
    pt, ok = ge.decompress(enc)
    return ge.to_limbs51(pt), ok, ge.small_order_mask(pt)


def decompress_so_cuda(enc: torch.Tensor):
    """The kernel: same contract as decompress_so_ref."""
    backend.check_tensor("enc", enc, torch.uint8, (None, 32))
    n = enc.shape[0]
    dev = enc.device
    pt = torch.empty(n, 4, 5, dtype=torch.int64, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    so = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return pt, ok, so
    fn = build.bind("decompress_so", "fd_decompress_so",
                    [_V, _V, _V, _V, ctypes.c_longlong, _V])
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check_rc("fd_decompress_so",
                   fn(enc.data_ptr(), pt.data_ptr(), ok.data_ptr(),
                      so.data_ptr(), n, stream))
    backend.count_launch("decompress_so")
    return pt, ok, so


def decompress_so(enc: torch.Tensor):
    """Donna decompress of (B, 32) encodings -> (point, ok, small_order)."""
    if backend.use_kernel(enc):
        return decompress_so_cuda(enc.contiguous())
    return decompress_so_ref(enc)


def decompress_niels_ref(enc: torch.Tensor):
    """Plain version: (B, 32) uint8 -> (point (B, 4, 5), ok, small_order,
    niels (B, 3, 5), niels_neg (B, 3, 5)). niels is (y + x, y - x, 2d t),
    niels_neg the form of -P, (y - x, y + x, -2d t). Failed lanes carry
    the identity, whose forms are (1, 1, 0), and read small_order True."""
    backend.count_plain("decompress_niels")
    pt, ok, so = dec.decompress_batched(enc)
    x, y, _, t = ge.from_limbs51(pt)
    yp, ym, t2d = ge.niels((x, y, None, t))
    return (pt, ok, so, ge.to_limbs51((yp, ym, t2d)),
            ge.to_limbs51((ym, yp, fe.fe_neg(t2d))))


def decompress_niels_cuda(enc: torch.Tensor):
    """The kernel: same contract as decompress_niels_ref."""
    backend.check_tensor("enc", enc, torch.uint8, (None, 32))
    n = enc.shape[0]
    dev = enc.device
    pt = torch.empty(n, 4, 5, dtype=torch.int64, device=dev)
    niels = torch.empty(n, 3, 5, dtype=torch.int64, device=dev)
    neg = torch.empty(n, 3, 5, dtype=torch.int64, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    so = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return pt, ok, so, niels, neg
    fn = build.bind("decompress_niels", "fd_decompress_niels",
                    [_V, _V, _V, _V, _V, _V, ctypes.c_longlong, _V])
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check_rc("fd_decompress_niels",
                   fn(enc.data_ptr(), pt.data_ptr(), niels.data_ptr(),
                      neg.data_ptr(), ok.data_ptr(), so.data_ptr(), n,
                      stream))
    backend.count_launch("decompress_niels")
    return pt, ok, so, niels, neg


def decompress_niels(enc: torch.Tensor):
    """Decompress of (B, 32) encodings -> (point, ok, small_order, niels,
    niels_neg): the RLC pass's front half. The kernel runs K2's per-lane
    chain; the plain version shares one inversion among decompress.GROUP
    lanes, as the JAX kernel does. The outputs are the same."""
    if backend.use_kernel(enc):
        return decompress_niels_cuda(enc.contiguous())
    return decompress_niels_ref(enc)


def point_eq_affine_ref(aff: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Plain version: aff (B, >=2, 5) holds (ax, ay), proj (B, >=3, 5)
    holds (X, Y, Z); -> (B,) bool ax*Z == X and ay*Z == Y."""
    backend.count_plain("point_eq")
    return ge.point_eq_affine(ge.from_limbs51(aff, 2),
                              ge.from_limbs51(proj, 3))


def point_eq_affine_cuda(aff: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """The kernel: same contract as point_eq_affine_ref, every limb of
    ax, ay, X, Y and Z in [0, 2^52) (the group's multiply takes 26-bit
    halves; the direct path passes canonical limbs)."""
    backend.check_tensor("aff", aff, torch.int64, (None, None, 5))
    n = aff.shape[0]
    backend.check_tensor("proj", proj, torch.int64, (n, None, 5))
    if aff.shape[1] < 2 or proj.shape[1] < 3:
        raise ValueError("aff needs >= 2 coordinates, proj >= 3")
    out = torch.empty(n, dtype=torch.bool, device=aff.device)
    if n == 0:
        return out
    fn = build.bind("point_eq", "fd_point_eq_affine",
                    [_V, ctypes.c_int, _V, ctypes.c_int, _V,
                     ctypes.c_longlong, _V])
    stream = torch.cuda.current_stream(aff.device).cuda_stream
    build.check_rc("fd_point_eq_affine",
                   fn(aff.data_ptr(), aff.shape[1], proj.data_ptr(),
                      proj.shape[1], out.data_ptr(), n, stream))
    backend.count_launch("point_eq")
    return out


def point_eq_affine(aff: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Lane mask: the affine point equals the projective one."""
    if backend.use_kernel(aff, proj):
        return point_eq_affine_cuda(aff.contiguous(), proj.contiguous())
    return point_eq_affine_ref(aff, proj)


def compress_ref(pt: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, >= 3, 5) limbs of X, Y, Z -> (B, 32) uint8
    canonical encodings (curve25519.compress)."""
    backend.count_plain("compress")
    return ge.compress(pt)


def compress_cuda(pt: torch.Tensor) -> torch.Tensor:
    """The kernel: same contract as compress_ref."""
    backend.check_tensor("pt", pt, torch.int64, (None, None, 5))
    if pt.shape[1] < 3:
        raise ValueError("pt needs X, Y, Z")
    n = pt.shape[0]
    out = torch.empty(n, 32, dtype=torch.uint8, device=pt.device)
    if n == 0:
        return out
    fn = build.bind("compress", "fd_compress",
                    [_V, ctypes.c_int, _V, ctypes.c_longlong, _V])
    stream = torch.cuda.current_stream(pt.device).cuda_stream
    build.check_rc("fd_compress", fn(pt.data_ptr(), pt.shape[1],
                                     out.data_ptr(), n, stream))
    backend.count_launch("compress")
    return out


def compress(pt: torch.Tensor) -> torch.Tensor:
    """Canonical 32-byte encodings of projective points (B, >= 3, 5)."""
    if backend.use_kernel(pt):
        return compress_cuda(pt.contiguous())
    return compress_ref(pt)
