"""State carried across from the JAX package, and canonical forms for
comparing the two.

The system has no weights; what crosses is device state in the JAX
package's layouts, as numpy arrays: field elements as (32, B) int32
radix-2^8 limbs (lazy, signed) and points as tuples of them. These
helpers build the port's canonical int64 (B, k, 5) radix-2^51 limbs from
them, and normalise either side to bytes for comparison: raw limbs and
projective coordinates are never compared across the packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import fe25519 as fe

P = fe.P


def _jax_limbs_to_ints(limbs) -> list[int]:
    arr = np.asarray(limbs).astype(object).reshape(32, -1)
    return [sum(int(arr[i, b]) << (8 * i) for i in range(32)) % P
            for b in range(arr.shape[1])]


def _port_limbs_to_ints(t: torch.Tensor) -> list[int]:
    rows = t.detach().cpu().reshape(-1, 5).tolist()
    return [sum(int(v) << (51 * i) for i, v in enumerate(r)) % P
            for r in rows]


def _ints_to_limbs51(values, device) -> torch.Tensor:
    return torch.tensor([[(v >> (51 * i)) & fe.M51 for i in range(5)]
                         for v in values], dtype=torch.int64,
                        device=device).reshape(len(values), 5)


def _to_ints(x) -> list[int]:
    """Field elements of either layout -> canonical Python ints."""
    if isinstance(x, torch.Tensor):
        return _port_limbs_to_ints(x)
    return _jax_limbs_to_ints(x)


def fe_from_jax_limbs(limbs, device="cpu") -> torch.Tensor:
    """(32, B) int32 JAX limbs -> canonical (B, 5) int64 port limbs."""
    return _ints_to_limbs51(_jax_limbs_to_ints(limbs), device)


def point_from_jax(point, device="cpu") -> torch.Tensor:
    """JAX point (X, Y, Z, T) of (32, B) limbs -> (B, 4, 5) port limbs.
    A missing T (None) is computed as XY/Z."""
    x, y, z = (_jax_limbs_to_ints(c) for c in point[:3])
    t = point[3] if len(point) > 3 else None
    if t is None:
        t = [xi * yi * pow(zi, P - 2, P) % P for xi, yi, zi in zip(x, y, z)]
    else:
        t = _jax_limbs_to_ints(t)
    return torch.stack([_ints_to_limbs51(c, device) for c in (x, y, z, t)],
                       dim=1)


def niels_from_jax(niels, device="cpu") -> torch.Tensor:
    """JAX niels forms (yp, ym, t2d[, t2dn]) of (32, B) limbs, as the
    decompress kernel writes them -> canonical (B, 3, 5) port limbs of
    (y + x, y - x, 2d t), what the port's bucket fill reads."""
    return torch.stack([_ints_to_limbs51(_jax_limbs_to_ints(c), device)
                        for c in niels[:3]], dim=1)


def niels_to_canonical_bytes(niels) -> np.ndarray:
    """Niels forms -> (B, 3, 32) uint8 canonical little-endian (y + x,
    y - x, 2d t). Takes a port tensor (B, 3, 5) or a JAX tuple of (32, B)
    limb arrays."""
    cols = _coords(niels, 3)
    return np.array([[list(v.to_bytes(32, "little")) for v in lane]
                     for lane in zip(*cols)], np.uint8).reshape(-1, 3, 32)


def fe_to_canonical_bytes(x) -> np.ndarray:
    """Field elements -> (B, 32) uint8 canonical little-endian. Takes a
    port tensor (B, 5) or a JAX (32, B) limb array."""
    return np.array([list(v.to_bytes(32, "little")) for v in _to_ints(x)],
                    np.uint8).reshape(-1, 32)


def _coords(point, n: int) -> list[list[int]]:
    """The first n coordinates of a port tensor (B, k, 5) or a JAX tuple
    of (32, B) limb arrays, as canonical Python ints."""
    if isinstance(point, torch.Tensor):
        return [_port_limbs_to_ints(point[:, c]) for c in range(n)]
    return [_jax_limbs_to_ints(c) for c in point[:n]]


def point_to_projective_bytes(point) -> np.ndarray:
    """Points -> (B, 4, 32) uint8: canonical little-endian X, Y, Z, T.
    Two computations that ran the same formulas in the same order agree
    here, not only as group elements."""
    cols = _coords(point, 4)
    return np.array([[list(v.to_bytes(32, "little")) for v in lane]
                     for lane in zip(*cols)], np.uint8).reshape(-1, 4, 32)


def point_digest(point) -> np.ndarray:
    """(B, 8) uint8: the first 8 bytes of SHA-256 over each point's
    canonical projective bytes (a compact exact fingerprint)."""
    import hashlib

    proj = point_to_projective_bytes(point)
    return np.array([list(hashlib.sha256(p.tobytes()).digest()[:8])
                     for p in proj], np.uint8).reshape(-1, 8)


def point_to_affine_bytes(point) -> np.ndarray:
    """Points -> (B, 32) uint8 compressed encodings (canonical y, bit 255
    the parity of x). Takes a port tensor (B, k >= 3, 5) or a JAX tuple
    (X, Y, Z[, T]) of (32, B) limb arrays."""
    x, y, z = _coords(point, 3)
    out = []
    for xi, yi, zi in zip(x, y, z):
        zinv = pow(zi, P - 2, P)
        ax, ay = xi * zinv % P, yi * zinv % P
        out.append(list((ay | ((ax & 1) << 255)).to_bytes(32, "little")))
    return np.array(out, np.uint8).reshape(-1, 32)
