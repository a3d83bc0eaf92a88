"""AES-128/256 (encrypt direction) + AES-GCM AEAD, from scratch.

Role parity with the reference's QUIC packet protection
(the reference's src/tango/quic/crypto/fd_quic_crypto_suites.{h,c}), which
delegates AES-GCM to OpenSSL EVP; here the cipher is reimplemented standalone
in the ballet spirit (caller-provided state, no IO). Only the *encrypt*
direction of the block cipher is needed: CTR mode and GCM use forward AES for
both sealing and opening, and QUIC header protection (RFC 9001 §5.4.3) is a
single forward ECB block on the packet-number sample.

GHASH uses a per-key 16x256 byte-slice table built by linearity from 128
shift-reduce steps — the software analog of Shoup's 8-bit tables — so the
per-block cost is 16 table lookups instead of 128 shift/xor rounds.

The port's copy of ``firedancer_tpu/ballet/aes.py``. AES-128 ciphers take
the AES-NI/PCLMULQDQ path of ``native/aes_gcm.cc`` (``fd_aes128_*`` in
``build/libfdtango.so``, built on first use) where ``fd_aes128_has_ni()``
says the host has it, the bytecode path here otherwise; the choice is
made once, when the cipher is built (``native=`` forces it), and never
changes after an error. A library that does not build raises.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple


# ---------------------------------------------------------------- S-box ----

def _build_sbox() -> bytes:
    """Generate the AES S-box from GF(2^8) inverses + affine transform."""
    sbox = [0] * 256
    p = q = 1
    first = True
    while first or p != 1:
        first = False
        # p *= 3 in GF(2^8)
        p = (p ^ ((p << 1) & 0xFF) ^ (0x1B if p & 0x80 else 0)) & 0xFF
        # q /= 3 (multiply by the inverse of 3, 0xF6)
        q ^= (q << 1) & 0xFF
        q ^= (q << 2) & 0xFF
        q ^= (q << 4) & 0xFF
        if q & 0x80:
            q ^= 0x09
        rot = lambda v, n: ((v << n) | (v >> (8 - n))) & 0xFF
        sbox[p] = q ^ rot(q, 1) ^ rot(q, 2) ^ rot(q, 3) ^ rot(q, 4) ^ 0x63
    sbox[0] = 0x63
    return bytes(sbox)


_SBOX = _build_sbox()
_XTIME = bytes(((a << 1) ^ (0x1B if a & 0x80 else 0)) & 0xFF for a in range(256))

# T-tables: column transform for [s0,s1,s2,s3] -> MixColumns(SubBytes(...)).
# Tn[b] packs the 4 output bytes contributed by input byte b at row n.
_TE0 = [0] * 256
_TE1 = [0] * 256
_TE2 = [0] * 256
_TE3 = [0] * 256
for _b in range(256):
    _s = _SBOX[_b]
    _s2 = _XTIME[_s]
    _s3 = _s2 ^ _s
    _TE0[_b] = (_s2 << 24) | (_s << 16) | (_s << 8) | _s3
    _TE1[_b] = (_s3 << 24) | (_s2 << 16) | (_s << 8) | _s
    _TE2[_b] = (_s << 24) | (_s3 << 16) | (_s2 << 8) | _s
    _TE3[_b] = (_s << 24) | (_s << 16) | (_s3 << 8) | _s2

_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


def _expand_key(key: bytes) -> List[int]:
    """Key schedule -> list of 4*(Nr+1) 32-bit round-key words."""
    nk = len(key) // 4
    if nk not in (4, 8):
        raise ValueError("AES key must be 16 or 32 bytes")
    nr = nk + 6
    w = list(struct.unpack(">%dI" % nk, key))
    for i in range(nk, 4 * (nr + 1)):
        t = w[i - 1]
        if i % nk == 0:
            t = ((t << 8) | (t >> 24)) & 0xFFFFFFFF  # RotWord
            t = (
                (_SBOX[(t >> 24) & 0xFF] << 24)
                | (_SBOX[(t >> 16) & 0xFF] << 16)
                | (_SBOX[(t >> 8) & 0xFF] << 8)
                | _SBOX[t & 0xFF]
            )
            t ^= _RCON[i // nk - 1] << 24
        elif nk == 8 and i % nk == 4:
            t = (
                (_SBOX[(t >> 24) & 0xFF] << 24)
                | (_SBOX[(t >> 16) & 0xFF] << 16)
                | (_SBOX[(t >> 8) & 0xFF] << 8)
                | _SBOX[t & 0xFF]
            )
        w.append(w[i - nk] ^ t)
    return w


class Aes:
    """Encrypt-only AES block cipher (the only direction GCM/CTR/HP need).

    AES-128 single blocks (the QUIC header-protection mask — one per
    packet) take the AES-NI path where the host has it (``_pick``)."""

    def __init__(self, key: bytes, native: Optional[bool] = None):
        self._rk_lazy = None  # key schedule built on first Python-path use
        self._nr = len(key) // 4 + 6
        self._key = key
        self._nat = _pick(key, native)

    @property
    def _rk(self):
        if self._rk_lazy is None:
            self._rk_lazy = _expand_key(self._key)
        return self._rk_lazy

    def encrypt_block(self, block: bytes) -> bytes:
        if self._nat is not None:
            import ctypes

            out = ctypes.create_string_buffer(16)
            self._nat.fd_aes128_encrypt_block(self._key, block, out)
            return out.raw
        rk = self._rk
        s0, s1, s2, s3 = struct.unpack(">4I", block)
        s0 ^= rk[0]
        s1 ^= rk[1]
        s2 ^= rk[2]
        s3 ^= rk[3]
        k = 4
        for _ in range(self._nr - 1):
            t0 = (
                _TE0[(s0 >> 24) & 0xFF]
                ^ _TE1[(s1 >> 16) & 0xFF]
                ^ _TE2[(s2 >> 8) & 0xFF]
                ^ _TE3[s3 & 0xFF]
                ^ rk[k]
            )
            t1 = (
                _TE0[(s1 >> 24) & 0xFF]
                ^ _TE1[(s2 >> 16) & 0xFF]
                ^ _TE2[(s3 >> 8) & 0xFF]
                ^ _TE3[s0 & 0xFF]
                ^ rk[k + 1]
            )
            t2 = (
                _TE0[(s2 >> 24) & 0xFF]
                ^ _TE1[(s3 >> 16) & 0xFF]
                ^ _TE2[(s0 >> 8) & 0xFF]
                ^ _TE3[s1 & 0xFF]
                ^ rk[k + 2]
            )
            t3 = (
                _TE0[(s3 >> 24) & 0xFF]
                ^ _TE1[(s0 >> 16) & 0xFF]
                ^ _TE2[(s1 >> 8) & 0xFF]
                ^ _TE3[s2 & 0xFF]
                ^ rk[k + 3]
            )
            s0, s1, s2, s3 = t0, t1, t2, t3
            k += 4
        # final round: SubBytes + ShiftRows + AddRoundKey (no MixColumns)
        o0 = (
            (_SBOX[(s0 >> 24) & 0xFF] << 24)
            | (_SBOX[(s1 >> 16) & 0xFF] << 16)
            | (_SBOX[(s2 >> 8) & 0xFF] << 8)
            | _SBOX[s3 & 0xFF]
        ) ^ rk[k]
        o1 = (
            (_SBOX[(s1 >> 24) & 0xFF] << 24)
            | (_SBOX[(s2 >> 16) & 0xFF] << 16)
            | (_SBOX[(s3 >> 8) & 0xFF] << 8)
            | _SBOX[s0 & 0xFF]
        ) ^ rk[k + 1]
        o2 = (
            (_SBOX[(s2 >> 24) & 0xFF] << 24)
            | (_SBOX[(s3 >> 16) & 0xFF] << 16)
            | (_SBOX[(s0 >> 8) & 0xFF] << 8)
            | _SBOX[s1 & 0xFF]
        ) ^ rk[k + 2]
        o3 = (
            (_SBOX[(s3 >> 24) & 0xFF] << 24)
            | (_SBOX[(s0 >> 16) & 0xFF] << 16)
            | (_SBOX[(s1 >> 8) & 0xFF] << 8)
            | _SBOX[s2 & 0xFF]
        ) ^ rk[k + 3]
        return struct.pack(">4I", o0, o1, o2, o3)

    def ctr_xor(self, counter_block: bytes, data: bytes) -> bytes:
        """XOR data with the AES-CTR keystream starting at counter_block.

        The 32-bit big-endian counter in the last 4 bytes increments per
        block (GCM convention, NIST SP 800-38D).
        """
        prefix = counter_block[:12]
        ctr = struct.unpack(">I", counter_block[12:])[0]
        out = bytearray(len(data))
        for off in range(0, len(data), 16):
            ks = self.encrypt_block(prefix + struct.pack(">I", ctr))
            ctr = (ctr + 1) & 0xFFFFFFFF
            chunk = data[off : off + 16]
            out[off : off + len(chunk)] = bytes(
                a ^ b for a, b in zip(chunk, ks)
            )
        return bytes(out)


# ---------------------------------------------------------------- GHASH ----

_GCM_R = 0xE1000000000000000000000000000000


class _Ghash:
    """GHASH with a per-key 16x256 byte-slice table (Shoup-style)."""

    def __init__(self, h: bytes):
        hv = int.from_bytes(h, "big")
        # V[k] = H * x^k in the reflected GCM field representation.
        v = hv
        vs = []
        for _ in range(128):
            vs.append(v)
            v = (v >> 1) ^ _GCM_R if v & 1 else v >> 1
        # table[j][b] = (byte b at big-endian byte position j) * H
        table = []
        for j in range(16):
            row = [0] * 256
            base = 8 * j
            for bit in range(8):
                vk = vs[base + bit]
                step = 1 << (7 - bit)
                for b in range(step, 256, 2 * step):
                    for bb in range(b, min(b + step, 256)):
                        row[bb] ^= vk
            table.append(row)
        self._table = table

    def mult(self, x: int) -> int:
        t = self._table
        xb = x.to_bytes(16, "big")
        z = 0
        for j in range(16):
            z ^= t[j][xb[j]]
        return z

    def digest(self, aad: bytes, ct: bytes) -> bytes:
        y = 0
        for blob in (aad, ct):
            for off in range(0, len(blob), 16):
                blk = blob[off : off + 16]
                if len(blk) < 16:
                    blk = blk + bytes(16 - len(blk))
                y = self.mult(y ^ int.from_bytes(blk, "big"))
        lens = struct.pack(">QQ", len(aad) * 8, len(ct) * 8)
        y = self.mult(y ^ int.from_bytes(lens, "big"))
        return y.to_bytes(16, "big")


def native_lib():
    """The ring library (``build/libfdtango.so``, ``native/aes_gcm.cc``)
    with the AES-128 prototypes, built by ``make -C native`` on first use
    as the rings are. RuntimeError, naming the library and the rebuild,
    when it does not build or load or lacks the AES entry points: a
    missing library is never read as a host without AES-NI."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    import ctypes

    from ..tango import rings

    try:
        rings.ensure_native_built(rings.LIB_PATH)
        lib = ctypes.CDLL(rings.LIB_PATH)
    except Exception as e:  # noqa: BLE001 - re-raised with the path
        raise RuntimeError(f"aes: {rings.LIB_PATH} does not build or load "
                           f"({e!r}); build it with `{rings.REBUILD}`") from e
    missing = [n for n in _NATIVE_ENTRIES if not hasattr(lib, n)]
    if missing:
        raise RuntimeError(f"aes: {rings.LIB_PATH} lacks "
                           f"{', '.join(missing)}: rebuild it with "
                           f"`{rings.REBUILD}`")
    lib.fd_aes128_has_ni.restype = ctypes.c_int
    lib.fd_aes128_gcm_seal.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p]
    lib.fd_aes128_gcm_open.restype = ctypes.c_int
    lib.fd_aes128_gcm_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_void_p]
    lib.fd_aes128_encrypt_block.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p]
    _NATIVE = lib
    return lib


def aes_path() -> str:
    """The path an AES-128 cipher built now takes: "aes-ni" where
    fd_aes128_has_ni() says the host has AES-NI and PCLMULQDQ, else
    "bytecode" (the QUIC tile reports it in quic_tile_stats)."""
    return "aes-ni" if native_lib().fd_aes128_has_ni() else "bytecode"


def _pick(key: bytes, native: Optional[bool]):
    """The library for a cipher of key, or None for the bytecode path:
    chosen once, at construction. native None takes AES-NI for AES-128
    keys where fd_aes128_has_ni(); False takes the bytecode path."""
    if native is False or len(key) != 16:
        return None
    lib = native_lib()
    return lib if lib.fd_aes128_has_ni() else None


_NATIVE_ENTRIES = ("fd_aes128_has_ni", "fd_aes128_gcm_seal",
                   "fd_aes128_gcm_open", "fd_aes128_encrypt_block")
_NATIVE = None


class AesGcm:
    """AES-GCM AEAD with a 16-byte tag (the TLS 1.3 / QUIC suite shape).

    AES-128 keys ride the AES-NI native path where the host has it
    (bit-exact against the JAX cipher, tests/test_torch_quic_crypto.py);
    other key sizes and hosts without AES-NI use the bytecode path."""

    TAG_SZ = 16

    def __init__(self, key: bytes, native: Optional[bool] = None):
        self._aes = Aes(key, native)
        self._ghash_lazy = None  # table built only on the Python path
        self._key = key
        self._nat = self._aes._nat

    @property
    def _ghash(self):
        if self._ghash_lazy is None:
            self._ghash_lazy = _Ghash(self._aes.encrypt_block(bytes(16)))
        return self._ghash_lazy

    def _j0(self, iv: bytes) -> bytes:
        if len(iv) == 12:
            return iv + b"\x00\x00\x00\x01"
        return self._ghash.digest(b"", iv)

    def seal(self, iv: bytes, plaintext: bytes, aad: bytes) -> bytes:
        if self._nat is not None and len(iv) == 12:
            import ctypes

            ct = ctypes.create_string_buffer(max(len(plaintext), 1))
            tag = ctypes.create_string_buffer(16)
            self._nat.fd_aes128_gcm_seal(
                self._key, iv, aad, len(aad), plaintext, len(plaintext),
                ct, tag)
            return ct.raw[: len(plaintext)] + tag.raw
        j0 = self._j0(iv)
        ctr1 = j0[:12] + struct.pack(">I", struct.unpack(">I", j0[12:])[0] + 1)
        ct = self._aes.ctr_xor(ctr1, plaintext)
        s = self._ghash.digest(aad, ct)
        tag = bytes(a ^ b for a, b in zip(self._aes.encrypt_block(j0), s))
        return ct + tag

    def open(self, iv: bytes, sealed: bytes, aad: bytes) -> bytes:
        """Returns plaintext; raises ValueError on tag mismatch."""
        if len(sealed) < self.TAG_SZ:
            raise ValueError("gcm: ciphertext shorter than tag")
        ct, tag = sealed[: -self.TAG_SZ], sealed[-self.TAG_SZ :]
        if self._nat is not None and len(iv) == 12:
            import ctypes

            pt = ctypes.create_string_buffer(max(len(ct), 1))
            rc = self._nat.fd_aes128_gcm_open(
                self._key, iv, aad, len(aad), ct, len(ct), tag, pt)
            if rc != 0:
                raise ValueError("gcm: authentication tag mismatch")
            return pt.raw[: len(ct)]
        j0 = self._j0(iv)
        s = self._ghash.digest(aad, ct)
        expect = bytes(a ^ b for a, b in zip(self._aes.encrypt_block(j0), s))
        # verify tag (constant-time comparison is irrelevant for a receiver
        # of public network data, but cheap)
        diff = 0
        for a, b in zip(expect, tag):
            diff |= a ^ b
        if diff:
            raise ValueError("gcm: authentication tag mismatch")
        ctr1 = j0[:12] + struct.pack(">I", struct.unpack(">I", j0[12:])[0] + 1)
        return self._aes.ctr_xor(ctr1, ct)
