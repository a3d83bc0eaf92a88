"""QUIC packet protection (RFC 9001): key derivation, AEAD, header protection.

Role parity with the reference's src/tango/quic/crypto/
fd_quic_crypto_suites.{h,c} (suite TLS_AES_128_GCM_SHA256, fd_quic_gen_keys,
fd_quic_crypto_encrypt/decrypt, header-protection masking), built on the
ballet AES/HKDF primitives instead of OpenSSL EVP.

The port's copy of ``firedancer_tpu/tango/quic/crypto_suites.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

from ...ballet.aes import Aes, AesGcm
from ...ballet.hkdf import hkdf_expand_label, hkdf_extract

# RFC 9001 §5.2 initial salt for QUIC v1
INITIAL_SALT_V1 = bytes.fromhex("38762cf7f55934b34d179ae6a4c80cadccbb7f0a")

AEAD_OVERHEAD = 16  # GCM tag


class QuicCryptoError(ValueError):
    pass


@dataclass
class PacketKeys:
    """One direction's packet-protection keys for one encryption level."""

    secret: bytes
    key: bytes
    iv: bytes
    hp: bytes

    @classmethod
    def from_secret(cls, secret: bytes) -> "PacketKeys":
        return cls(
            secret=secret,
            key=hkdf_expand_label(secret, b"quic key", b"", 16),
            iv=hkdf_expand_label(secret, b"quic iv", b"", 12),
            hp=hkdf_expand_label(secret, b"quic hp", b"", 16),
        )

    def next_generation(self) -> "PacketKeys":
        """Key update (RFC 9001 §6): new secret via "quic ku".

        The header-protection key is NOT updated (§6.1: "The header
        protection key is not updated") — only the packet protection
        key and IV rotate.
        """
        nxt = hkdf_expand_label(self.secret, b"quic ku", b"", 32)
        return PacketKeys(
            secret=nxt,
            key=hkdf_expand_label(nxt, b"quic key", b"", 16),
            iv=hkdf_expand_label(nxt, b"quic iv", b"", 12),
            hp=self.hp,
        )

    def _nonce(self, pn: int) -> bytes:
        pad = bytes(len(self.iv) - 8) + struct.pack(">Q", pn)
        return bytes(a ^ b for a, b in zip(self.iv, pad))

    # The AEAD/HP cipher objects are cached PER KEY, not built per
    # packet: constructing an AesGcm costs a key schedule + GHASH table
    # (milliseconds in the Python fallback), and keys live for millions
    # of packets — per-packet construction capped the whole QUIC tile
    # at ~10^2 datagrams/s.
    def _gcm(self) -> AesGcm:
        g = self.__dict__.get("_gcm_obj")
        if g is None:
            g = self.__dict__["_gcm_obj"] = AesGcm(self.key)
        return g

    def _hp_aes(self) -> Aes:
        a = self.__dict__.get("_hp_obj")
        if a is None:
            a = self.__dict__["_hp_obj"] = Aes(self.hp)
        return a

    def seal(self, header: bytes, pn: int, payload: bytes) -> bytes:
        return self._gcm().seal(self._nonce(pn), payload, header)

    def open(self, header: bytes, pn: int, sealed: bytes) -> bytes:
        try:
            return self._gcm().open(self._nonce(pn), sealed, header)
        except ValueError as e:
            raise QuicCryptoError(str(e)) from e

    def hp_mask(self, sample: bytes) -> bytes:
        return self._hp_aes().encrypt_block(sample)[:5]


def initial_secrets(dcid: bytes) -> tuple:
    """-> (client PacketKeys, server PacketKeys) for the Initial space."""
    initial = hkdf_extract(INITIAL_SALT_V1, dcid)
    client = hkdf_expand_label(initial, b"client in", b"", 32)
    server = hkdf_expand_label(initial, b"server in", b"", 32)
    return PacketKeys.from_secret(client), PacketKeys.from_secret(server)


def protect_packet(
    keys: PacketKeys, header: bytes, pn: int, pn_len: int, payload: bytes
) -> bytes:
    """AEAD-seal payload and apply header protection. `header` includes the
    unprotected packet-number bytes at its tail."""
    sealed = keys.seal(header, pn, payload)
    pkt = bytearray(header + sealed)
    pn_off = len(header) - pn_len
    sample = bytes(pkt[pn_off + 4 : pn_off + 20])
    mask = keys.hp_mask(sample)
    if pkt[0] & 0x80:
        pkt[0] ^= mask[0] & 0x0F
    else:
        pkt[0] ^= mask[0] & 0x1F
    for i in range(pn_len):
        pkt[pn_off + i] ^= mask[1 + i]
    return bytes(pkt)


def unprotect_header(
    keys: PacketKeys, pkt: bytearray, pn_off: int
) -> tuple:
    """Remove header protection in place. -> (pn_len, truncated_pn)."""
    if pn_off + 20 > len(pkt):
        raise QuicCryptoError("packet too short for hp sample")
    sample = bytes(pkt[pn_off + 4 : pn_off + 20])
    mask = keys.hp_mask(sample)
    if pkt[0] & 0x80:
        pkt[0] ^= mask[0] & 0x0F
    else:
        pkt[0] ^= mask[0] & 0x1F
    pn_len = (pkt[0] & 0x03) + 1
    tpn = 0
    for i in range(pn_len):
        pkt[pn_off + i] ^= mask[1 + i]
        tpn = (tpn << 8) | pkt[pn_off + i]
    return pn_len, tpn
