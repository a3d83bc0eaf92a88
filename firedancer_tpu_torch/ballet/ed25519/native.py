"""ctypes binding of the native Ed25519 CPU verifier, the counterpart of
``firedancer_tpu/ballet/ed25519/native.py`` (``verify``:74,
``verify_arrays``:169, ``verify_items``:222).

``native/ed25519_cpu.cc`` (radix-2^51 field arithmetic, a vartime
double-scalar multiplication, and an AVX-512 IFMA batch path where the
host has it) is built into the ring library ``build/libfdtango.so`` by
``make -C native``, beside the rings the tiles already bind
(``tango.rings``). Its statuses are the oracle's: 0, -1 ERR_SIG,
-2 ERR_PUBKEY, -3 ERR_MSG.

It is the verify tile's CPU lane: the failover target when the card's
dispatch fails and the re-verify of a quarantined batch
(``disco.tiles.VerifyTile._verify_slot_cpu``). It is never a fallback
for a kernel: the engines run their kernels or raise. Where the JAX
binding returns None for a library that is missing or predates the
verifier, this one raises, naming the library's path.

``sign`` and ``public_key`` (the JAX :90-125, over
``fd_ed25519_cpu_sign`` and ``fd_ed25519_cpu_keypair``) are the QUIC
handshake's signer: the TLS CertificateVerify and the self-signed
certificate (``ballet.x509``). Where the JAX ones fall back to the oracle
(about 180 ms a signature), these raise. Batches of signatures are
signed on the card (``ops.sign``).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from ...tango import rings

_ENTRIES = ("fd_ed25519_cpu_verify1", "fd_ed25519_cpu_verify_batch")
_SIGN_ENTRIES = ("fd_ed25519_cpu_sign", "fd_ed25519_cpu_keypair")
_LIB = None
_SIGN_LIB = None


def lib() -> ctypes.CDLL:
    """The ring library with the verifier's prototypes; RuntimeError,
    naming its path and the rebuild, when it cannot be built or loaded
    or lacks the verifier."""
    global _LIB
    if _LIB is not None:
        return _LIB
    try:
        L = rings.lib()
    except Exception as e:  # noqa: BLE001 - re-raised with the path
        raise RuntimeError(f"native ed25519 verifier: {rings.LIB_PATH} "
                           f"does not build or load ({e!r}); build it "
                           f"with `{rings.REBUILD}`") from e
    missing = [name for name in _ENTRIES if not hasattr(L, name)]
    if missing:
        raise RuntimeError(f"native ed25519 verifier: {rings.LIB_PATH} "
                           f"lacks {', '.join(missing)}: rebuild it with "
                           f"`{rings.REBUILD}`")
    vp = ctypes.c_void_p
    L.fd_ed25519_cpu_verify1.restype = ctypes.c_int
    L.fd_ed25519_cpu_verify1.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_char_p]
    L.fd_ed25519_cpu_verify_batch.restype = None
    L.fd_ed25519_cpu_verify_batch.argtypes = [
        vp, ctypes.c_uint32, vp, vp, vp, vp, ctypes.c_uint32]
    _LIB = L
    return L


def sign_lib() -> ctypes.CDLL:
    """The ring library with the signer's prototypes; RuntimeError,
    naming its path and the rebuild, when it lacks them."""
    global _SIGN_LIB
    if _SIGN_LIB is not None:
        return _SIGN_LIB
    L = lib()
    missing = [name for name in _SIGN_ENTRIES if not hasattr(L, name)]
    if missing:
        raise RuntimeError(f"native ed25519 signer: {rings.LIB_PATH} lacks "
                           f"{', '.join(missing)}: rebuild it with "
                           f"`{rings.REBUILD}`")
    L.fd_ed25519_cpu_sign.restype = None
    L.fd_ed25519_cpu_sign.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_char_p]
    L.fd_ed25519_cpu_keypair.restype = None
    L.fd_ed25519_cpu_keypair.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    _SIGN_LIB = L
    return L


def sign(msg: bytes, seed: bytes) -> bytes:
    """RFC 8032 signature of msg by the key of a 32-byte seed (vartime:
    a test and handshake signer), bit-equal to ``oracle.sign``."""
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")  # oracle.sign's contract
    out = ctypes.create_string_buffer(64)
    sign_lib().fd_ed25519_cpu_sign(msg, len(msg), seed, out)
    return out.raw


def public_key(seed: bytes) -> bytes:
    """The 32-byte public key of a seed (``oracle.keypair_from_seed``'s
    third item)."""
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    out = ctypes.create_string_buffer(32)
    sign_lib().fd_ed25519_cpu_keypair(seed, out)
    return out.raw


def verify(msg: bytes, sig: bytes, pub: bytes) -> int:
    """One verify. The lengths are checked here, as the oracle checks
    them: the C side reads exactly 64 and 32 bytes."""
    L = lib()
    if len(sig) != 64:
        return -1  # FD_ED25519_ERR_SIG
    if len(pub) != 32:
        return -2  # FD_ED25519_ERR_PUBKEY
    return L.fd_ed25519_cpu_verify1(msg, len(msg), sig, pub)


def _batch(msgs: np.ndarray, lens: np.ndarray, sigs: np.ndarray,
           pubs: np.ndarray, n: int) -> np.ndarray:
    """fd_ed25519_cpu_verify_batch over rows [0, n) (one C call, the
    interpreter lock released)."""
    status = np.zeros(n, np.int32)
    lib().fd_ed25519_cpu_verify_batch(
        msgs.ctypes.data, msgs.shape[1], lens.ctypes.data, sigs.ctypes.data,
        pubs.ctypes.data, status.ctypes.data, n)
    return status


def verify_arrays(msgs, lens, sigs, pubs, n: int) -> np.ndarray:
    """Verify rows [0, n) of arrays in the layout fd_verify_drain stages
    (msgs (B, stride) uint8, lens, sigs (B, 64) and pubs (B, 32) uint8,
    C-contiguous): an (n,) int32 status array from one C call. Malformed
    arrays raise ValueError before the call."""
    lib()
    if n == 0:
        return np.zeros(0, np.int32)
    for name, arr in (("msgs", msgs), ("sigs", sigs), ("pubs", pubs)):
        if arr.dtype != np.uint8 or not arr.flags.c_contiguous:
            raise ValueError(f"verify_arrays: {name} must be C-contiguous "
                             f"uint8 (got dtype={arr.dtype}, c_contiguous="
                             f"{arr.flags.c_contiguous})")
    if msgs.ndim != 2 or sigs.shape[1:] != (64,) or pubs.shape[1:] != (32,):
        raise ValueError("verify_arrays: expected msgs (B, stride), sigs "
                         f"(B, 64), pubs (B, 32); got {msgs.shape}, "
                         f"{sigs.shape}, {pubs.shape}")
    if not (msgs.shape[0] >= n and sigs.shape[0] >= n and pubs.shape[0] >= n
            and len(lens) >= n):
        raise ValueError(f"verify_arrays: n={n} exceeds the staged rows "
                         f"({msgs.shape[0]}, {sigs.shape[0]}, "
                         f"{pubs.shape[0]}, {len(lens)})")
    lens32 = np.ascontiguousarray(lens[:n], np.uint32)
    if int(lens32.max()) > msgs.shape[1]:
        raise ValueError(f"verify_arrays: a length past the row stride "
                         f"{msgs.shape[1]}")
    return _batch(msgs, lens32, sigs, pubs, n)


def verify_items(items: Sequence[tuple]) -> list:
    """Verify [(sig, pub, msg), ...] in one C call: a status list. A
    signature that is not 64 bytes gives ERR_SIG and a key that is not 32
    bytes ERR_PUBKEY, as in the oracle."""
    lib()
    n = len(items)
    if n == 0:
        return []
    stride = max(max(len(m) for _, _, m in items), 1)
    msgs = np.zeros((n, stride), np.uint8)
    lens = np.zeros(n, np.uint32)
    sigs = np.zeros((n, 64), np.uint8)
    pubs = np.zeros((n, 32), np.uint8)
    bad = {}
    for i, (sig, pub, msg) in enumerate(items):
        msgs[i, :len(msg)] = np.frombuffer(msg, np.uint8)
        lens[i] = len(msg)
        if len(sig) != 64:
            bad[i] = -1  # FD_ED25519_ERR_SIG
        elif len(pub) != 32:
            bad[i] = -2  # FD_ED25519_ERR_PUBKEY
        else:
            sigs[i] = np.frombuffer(sig, np.uint8)
            pubs[i] = np.frombuffer(pub, np.uint8)
    out = _batch(msgs, lens, sigs, pubs, n).tolist()
    for i, code in bad.items():
        out[i] = code
    return out
