"""TLS 1.3 handshake engine over QUIC CRYPTO streams (RFC 8446 + RFC 9001).

The port's copy of ``firedancer_tpu/tango/quic/tls.py``, its Ed25519
signer and verifier the native ones, which raise without their library.

Role parity with the reference's src/tango/quic/tls/fd_quic_tls.{h,c}: the
reference wraps a quictls/OpenSSL QUIC-TLS integration (fd_quic_tls.h:14-17);
here the handshake is implemented from scratch on ballet primitives
(x25519 key exchange, HKDF key schedule, Ed25519 CertificateVerify over the
ballet x509 self-signed cert). Scope: TLS_AES_128_GCM_SHA256, x25519,
Ed25519 certs, ALPN, quic_transport_parameters — exactly the profile the
Solana TPU uses. No session resumption / 0-RTT / HelloRetryRequest.

The QUIC layer talks to this through three hooks, mirroring the reference's
callback struct (fd_quic_tls.h client_hello/alert/secret/handshake_complete):
`take_output()` drains (level, bytes) to send as CRYPTO frames, `consume()`
feeds reassembled peer CRYPTO bytes, and key events appear as attributes
(hs_secrets, app_secrets) the conn promotes into PacketKeys.
"""

from __future__ import annotations

import hashlib
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ...ballet.ed25519.x25519 import x25519, x25519_public
from ...ballet.hkdf import hkdf_expand_label, hkdf_extract
from ...ballet.hmac import hmac_sha256
from ...ballet import x509


def _ed_verify(msg: bytes, sig: bytes, pub: bytes) -> int:
    """Ed25519 verify through the native verifier (bit-exact against the
    oracle, tests/test_torch_chaos.py), which raises when its library
    does not build: the CertificateVerify check is on every handshake,
    and the oracle's ~130 ms a verify would hide a missing library as a
    slow handshake."""
    from ...ballet.ed25519 import native

    return native.verify(msg, sig, pub)


# encryption levels (== reference's fd_quic_crypto enc levels)
LEVEL_INITIAL = 0
LEVEL_HANDSHAKE = 1
LEVEL_APP = 2

# handshake message types
HS_CLIENT_HELLO = 1
HS_SERVER_HELLO = 2
HS_NEW_SESSION_TICKET = 4
HS_ENCRYPTED_EXTENSIONS = 8
HS_CERTIFICATE = 11
HS_CERTIFICATE_VERIFY = 15
HS_FINISHED = 20

# extensions
EXT_SERVER_NAME = 0
EXT_SUPPORTED_GROUPS = 10
EXT_SIGNATURE_ALGORITHMS = 13
EXT_ALPN = 16
EXT_SUPPORTED_VERSIONS = 43
EXT_KEY_SHARE = 51
EXT_QUIC_TRANSPORT_PARAMS = 0x39

CIPHER_AES128_GCM_SHA256 = 0x1301
GROUP_X25519 = 0x001D
SIGALG_ED25519 = 0x0807
TLS13 = 0x0304


class TlsError(ValueError):
    pass


def _u16(v: int) -> bytes:
    return struct.pack(">H", v)


def _u24(v: int) -> bytes:
    return v.to_bytes(3, "big")


def _hs_msg(mtype: int, body: bytes) -> bytes:
    return bytes([mtype]) + _u24(len(body)) + body


def _ext(etype: int, body: bytes) -> bytes:
    return _u16(etype) + _u16(len(body)) + body


def _derive_secret(secret: bytes, label: bytes, transcript_hash: bytes) -> bytes:
    return hkdf_expand_label(secret, label, transcript_hash, 32)


_CV_SERVER_CTX = b" " * 64 + b"TLS 1.3, server CertificateVerify" + b"\x00"
_CV_CLIENT_CTX = b" " * 64 + b"TLS 1.3, client CertificateVerify" + b"\x00"


@dataclass
class TlsConfig:
    is_server: bool
    identity_seed: bytes  # Ed25519 seed; cert is generated from it
    alpns: Tuple[bytes, ...] = (b"solana-tpu",)
    transport_params: bytes = b""
    server_name: Optional[str] = None
    cert_der: Optional[bytes] = None  # override the generated cert


class TlsEndpoint:
    """One endpoint of a TLS 1.3 handshake carried over CRYPTO frames."""

    def __init__(self, cfg: TlsConfig):
        self.cfg = cfg
        self.is_server = cfg.is_server
        self._out: List[Tuple[int, bytes]] = []
        self._rx_buf: Dict[int, bytearray] = {
            LEVEL_INITIAL: bytearray(),
            LEVEL_HANDSHAKE: bytearray(),
            LEVEL_APP: bytearray(),
        }
        self._transcript = hashlib.sha256()
        self._ecdh_priv = os.urandom(32)
        self._cert = cfg.cert_der or x509.generate_self_signed(
            cfg.identity_seed, cn="firedancer-tpu"
        )
        # outputs / events
        self.alpn: Optional[bytes] = None
        self.peer_transport_params: Optional[bytes] = None
        self.peer_pubkey: Optional[bytes] = None
        self.hs_secrets: Optional[Tuple[bytes, bytes]] = None  # (client, server)
        self.app_secrets: Optional[Tuple[bytes, bytes]] = None
        self.handshake_complete = False
        self.alert: Optional[str] = None
        # internals
        self._hs_secret: Optional[bytes] = None
        self._master: Optional[bytes] = None
        self._client_hs: Optional[bytes] = None
        self._server_hs: Optional[bytes] = None
        self._th_to_cert: Optional[bytes] = None
        self._th_to_cv: Optional[bytes] = None
        self._th_to_server_fin: Optional[bytes] = None
        self._state = "start"
        self._client_random = os.urandom(32)

    # ------------------------------------------------------------- output --

    def take_output(self) -> List[Tuple[int, bytes]]:
        out, self._out = self._out, []
        return out

    def _send(self, level: int, msg: bytes) -> None:
        self._transcript.update(msg)
        self._out.append((level, msg))

    # -------------------------------------------------------------- start --

    def start(self) -> None:
        """Client: emit the ClientHello."""
        if self.is_server:
            return
        exts = b"".join(
            [
                _ext(
                    EXT_SUPPORTED_VERSIONS, bytes([2]) + _u16(TLS13)
                ),
                _ext(
                    EXT_SUPPORTED_GROUPS, _u16(2) + _u16(GROUP_X25519)
                ),
                _ext(
                    EXT_SIGNATURE_ALGORITHMS, _u16(2) + _u16(SIGALG_ED25519)
                ),
                _ext(
                    EXT_KEY_SHARE,
                    _u16(2 + 2 + 32)
                    + _u16(GROUP_X25519)
                    + _u16(32)
                    + x25519_public(self._ecdh_priv),
                ),
                _ext(
                    EXT_ALPN,
                    _u16(sum(1 + len(a) for a in self.cfg.alpns))
                    + b"".join(
                        bytes([len(a)]) + a for a in self.cfg.alpns
                    ),
                ),
                _ext(EXT_QUIC_TRANSPORT_PARAMS, self.cfg.transport_params),
            ]
        )
        if self.cfg.server_name:
            sn = self.cfg.server_name.encode()
            exts += _ext(
                EXT_SERVER_NAME,
                _u16(len(sn) + 3) + b"\x00" + _u16(len(sn)) + sn,
            )
        body = (
            _u16(0x0303)
            + self._client_random
            + b"\x00"  # empty legacy session id (QUIC)
            + _u16(2)
            + _u16(CIPHER_AES128_GCM_SHA256)
            + b"\x01\x00"  # null compression
            + _u16(len(exts))
            + exts
        )
        self._send(LEVEL_INITIAL, _hs_msg(HS_CLIENT_HELLO, body))
        self._state = "wait_sh"

    # -------------------------------------------------------------- input --

    def consume(self, level: int, data: bytes) -> None:
        """Feed reassembled CRYPTO-stream bytes received at `level`."""
        buf = self._rx_buf[level]
        buf += data
        while len(buf) >= 4:
            mlen = int.from_bytes(buf[1:4], "big")
            if len(buf) < 4 + mlen:
                break
            msg = bytes(buf[: 4 + mlen])
            del buf[: 4 + mlen]
            self._on_message(level, msg[0], msg)

    def _on_message(self, level: int, mtype: int, msg: bytes) -> None:
        if self.is_server:
            if mtype == HS_CLIENT_HELLO and self._state == "start":
                self._server_on_client_hello(msg)
            elif mtype == HS_FINISHED and self._state == "wait_client_fin":
                self._on_peer_finished(msg, self._client_hs)
                self.handshake_complete = True
                self._state = "done"
            else:
                raise TlsError(
                    f"server: unexpected msg {mtype} in {self._state}"
                )
        else:
            if mtype == HS_SERVER_HELLO and self._state == "wait_sh":
                self._client_on_server_hello(msg)
            elif mtype == HS_ENCRYPTED_EXTENSIONS and self._state == "wait_ee":
                self._parse_enc_exts(msg)
                self._transcript.update(msg)
                self._state = "wait_cert"
            elif mtype == HS_CERTIFICATE and self._state == "wait_cert":
                self._th_to_cert = self._pre_update_hash(msg)
                self._parse_certificate(msg)
                self._state = "wait_cv"
            elif mtype == HS_CERTIFICATE_VERIFY and self._state == "wait_cv":
                self._verify_cert_verify(msg)
                self._state = "wait_fin"
            elif mtype == HS_FINISHED and self._state == "wait_fin":
                self._on_peer_finished(msg, self._server_hs)
                self._client_finish()
            elif mtype == HS_NEW_SESSION_TICKET:
                pass  # resumption not supported; ignore
            else:
                raise TlsError(
                    f"client: unexpected msg {mtype} in {self._state}"
                )

    def _pre_update_hash(self, msg: bytes) -> bytes:
        """Transcript hash *before* absorbing msg, then absorb it."""
        th = self._transcript.digest()
        self._transcript.update(msg)
        return th

    # ------------------------------------------------------------- server --

    def _server_on_client_hello(self, msg: bytes) -> None:
        self._transcript.update(msg)
        body = msg[4:]
        off = 2 + 32  # legacy_version + random
        sid_len = body[off]
        self._session_id = body[off + 1 : off + 1 + sid_len]
        off += 1 + sid_len
        cs_len = struct.unpack(">H", body[off : off + 2])[0]
        suites = body[off + 2 : off + 2 + cs_len]
        off += 2 + cs_len
        comp_len = body[off]
        off += 1 + comp_len
        if len(body) < off + 2:
            raise TlsError("CH: no extensions")
        ext_len = struct.unpack(">H", body[off : off + 2])[0]
        exts = self._parse_exts(body[off + 2 : off + 2 + ext_len])
        if not any(
            struct.unpack(">H", suites[i : i + 2])[0]
            == CIPHER_AES128_GCM_SHA256
            for i in range(0, len(suites), 2)
        ):
            raise TlsError("CH: no common cipher suite")
        sv = exts.get(EXT_SUPPORTED_VERSIONS)
        if sv is None or TLS13.to_bytes(2, "big") not in bytes(sv):
            raise TlsError("CH: TLS 1.3 not offered")
        ks = exts.get(EXT_KEY_SHARE)
        peer_share = self._find_key_share_ch(ks)
        if peer_share is None:
            raise TlsError("CH: no x25519 key share")
        alpn_ext = exts.get(EXT_ALPN)
        if alpn_ext is not None:
            offered = self._parse_alpn(alpn_ext)
            for a in self.cfg.alpns:
                if a in offered:
                    self.alpn = a
                    break
            if self.alpn is None:
                raise TlsError("CH: no common ALPN")
        tp = exts.get(EXT_QUIC_TRANSPORT_PARAMS)
        if tp is None:
            raise TlsError("CH: missing quic transport params")
        self.peer_transport_params = bytes(tp)

        shared = x25519(self._ecdh_priv, peer_share)
        sh_exts = _ext(
            EXT_SUPPORTED_VERSIONS, _u16(TLS13)
        ) + _ext(
            EXT_KEY_SHARE,
            _u16(GROUP_X25519) + _u16(32) + x25519_public(self._ecdh_priv),
        )
        sh_body = (
            _u16(0x0303)
            + os.urandom(32)
            + bytes([len(self._session_id)])
            + bytes(self._session_id)
            + _u16(CIPHER_AES128_GCM_SHA256)
            + b"\x00"
            + _u16(len(sh_exts))
            + sh_exts
        )
        self._send(LEVEL_INITIAL, _hs_msg(HS_SERVER_HELLO, sh_body))
        self._compute_hs_secrets(shared)

        # EncryptedExtensions
        ee = _ext(EXT_QUIC_TRANSPORT_PARAMS, self.cfg.transport_params)
        if self.alpn is not None:
            ee += _ext(
                EXT_ALPN,
                _u16(1 + len(self.alpn))
                + bytes([len(self.alpn)])
                + self.alpn,
            )
        self._send(
            LEVEL_HANDSHAKE, _hs_msg(HS_ENCRYPTED_EXTENSIONS, _u16(len(ee)) + ee)
        )
        # Certificate
        entry = _u24(len(self._cert)) + self._cert + _u16(0)
        cert_body = b"\x00" + _u24(len(entry)) + entry
        self._send(LEVEL_HANDSHAKE, _hs_msg(HS_CERTIFICATE, cert_body))
        # CertificateVerify over transcript-to-here, signed by the
        # native signer (ballet/x509._ed_sign; it raises without its
        # library, where the oracle's ~180 ms would set the handshake
        # rate).
        th = self._transcript.digest()
        sig = x509._ed_sign(_CV_SERVER_CTX + th, self.cfg.identity_seed)
        cv_body = _u16(SIGALG_ED25519) + _u16(len(sig)) + sig
        self._send(LEVEL_HANDSHAKE, _hs_msg(HS_CERTIFICATE_VERIFY, cv_body))
        # Finished
        fin_key = hkdf_expand_label(self._server_hs, b"finished", b"", 32)
        verify = hmac_sha256(fin_key, self._transcript.digest())
        self._send(LEVEL_HANDSHAKE, _hs_msg(HS_FINISHED, verify))
        # app secrets from transcript through server Finished
        self._th_to_server_fin = self._transcript.digest()
        self._compute_app_secrets()
        self._state = "wait_client_fin"

    # ------------------------------------------------------------- client --

    def _client_on_server_hello(self, msg: bytes) -> None:
        self._transcript.update(msg)
        body = msg[4:]
        off = 2 + 32
        sid_len = body[off]
        off += 1 + sid_len
        cipher = struct.unpack(">H", body[off : off + 2])[0]
        if cipher != CIPHER_AES128_GCM_SHA256:
            raise TlsError("SH: unexpected cipher")
        off += 3  # cipher + null compression
        ext_len = struct.unpack(">H", body[off : off + 2])[0]
        exts = self._parse_exts(body[off + 2 : off + 2 + ext_len])
        ks = exts.get(EXT_KEY_SHARE)
        if ks is None:
            raise TlsError("SH: no key share")
        group = struct.unpack(">H", ks[:2])[0]
        klen = struct.unpack(">H", ks[2:4])[0]
        if group != GROUP_X25519 or klen != 32:
            raise TlsError("SH: unsupported group")
        shared = x25519(self._ecdh_priv, bytes(ks[4:36]))
        self._compute_hs_secrets(shared)
        self._state = "wait_ee"

    def _parse_enc_exts(self, msg: bytes) -> None:
        body = msg[4:]
        ext_len = struct.unpack(">H", body[:2])[0]
        exts = self._parse_exts(body[2 : 2 + ext_len])
        tp = exts.get(EXT_QUIC_TRANSPORT_PARAMS)
        if tp is None:
            raise TlsError("EE: missing quic transport params")
        self.peer_transport_params = bytes(tp)
        alpn_ext = exts.get(EXT_ALPN)
        if alpn_ext is not None:
            chosen = self._parse_alpn(alpn_ext)
            if len(chosen) != 1 or chosen[0] not in self.cfg.alpns:
                raise TlsError("EE: bad ALPN selection")
            self.alpn = chosen[0]

    def _parse_certificate(self, msg: bytes) -> None:
        body = msg[4:]
        ctx_len = body[0]
        off = 1 + ctx_len
        list_len = int.from_bytes(body[off : off + 3], "big")
        off += 3
        if list_len == 0:
            raise TlsError("cert: empty certificate list")
        cert_len = int.from_bytes(body[off : off + 3], "big")
        off += 3
        cert = bytes(body[off : off + cert_len])
        self.peer_pubkey = x509.extract_ed25519_pubkey(cert)

    def _verify_cert_verify(self, msg: bytes) -> None:
        th = self._pre_update_hash(msg)
        body = msg[4:]
        alg = struct.unpack(">H", body[:2])[0]
        if alg != SIGALG_ED25519:
            raise TlsError("CV: unsupported sig alg")
        slen = struct.unpack(">H", body[2:4])[0]
        sig = bytes(body[4 : 4 + slen])
        ctx = _CV_CLIENT_CTX if self.is_server else _CV_SERVER_CTX
        if _ed_verify(ctx + th, sig, self.peer_pubkey) != 0:
            raise TlsError("CV: signature verification failed")

    def _client_finish(self) -> None:
        self._th_to_server_fin = self._transcript.digest()
        self._compute_app_secrets()
        fin_key = hkdf_expand_label(self._client_hs, b"finished", b"", 32)
        verify = hmac_sha256(fin_key, self._th_to_server_fin)
        self._send(LEVEL_HANDSHAKE, _hs_msg(HS_FINISHED, verify))
        self.handshake_complete = True
        self._state = "done"

    # -------------------------------------------------------------- common --

    def _on_peer_finished(self, msg: bytes, peer_hs_secret: bytes) -> None:
        th = self._pre_update_hash(msg)
        fin_key = hkdf_expand_label(peer_hs_secret, b"finished", b"", 32)
        expect = hmac_sha256(fin_key, th)
        if expect != msg[4:]:
            raise TlsError("finished: verify_data mismatch")

    def _compute_hs_secrets(self, ecdh_shared: bytes) -> None:
        empty_hash = hashlib.sha256(b"").digest()
        early = hkdf_extract(bytes(32), bytes(32))
        derived = _derive_secret(early, b"derived", empty_hash)
        self._hs_secret = hkdf_extract(derived, ecdh_shared)
        th = self._transcript.digest()  # through ServerHello
        self._client_hs = _derive_secret(self._hs_secret, b"c hs traffic", th)
        self._server_hs = _derive_secret(self._hs_secret, b"s hs traffic", th)
        self.hs_secrets = (self._client_hs, self._server_hs)

    def _compute_app_secrets(self) -> None:
        empty_hash = hashlib.sha256(b"").digest()
        derived = _derive_secret(self._hs_secret, b"derived", empty_hash)
        self._master = hkdf_extract(derived, bytes(32))
        th = self._th_to_server_fin
        c_ap = _derive_secret(self._master, b"c ap traffic", th)
        s_ap = _derive_secret(self._master, b"s ap traffic", th)
        self.app_secrets = (c_ap, s_ap)

    # ------------------------------------------------------------- helpers --

    @staticmethod
    def _parse_exts(buf: bytes) -> Dict[int, bytes]:
        exts: Dict[int, bytes] = {}
        off = 0
        while off + 4 <= len(buf):
            etype, elen = struct.unpack(">HH", buf[off : off + 4])
            exts[etype] = buf[off + 4 : off + 4 + elen]
            off += 4 + elen
        return exts

    @staticmethod
    def _find_key_share_ch(ks: Optional[bytes]) -> Optional[bytes]:
        if ks is None or len(ks) < 2:
            return None
        total = struct.unpack(">H", ks[:2])[0]
        off = 2
        end = min(2 + total, len(ks))
        while off + 4 <= end:
            group, klen = struct.unpack(">HH", ks[off : off + 4])
            if group == GROUP_X25519 and klen == 32:
                return bytes(ks[off + 4 : off + 36])
            off += 4 + klen
        return None

    @staticmethod
    def _parse_alpn(ext: bytes) -> List[bytes]:
        if len(ext) < 2:
            return []
        total = struct.unpack(">H", ext[:2])[0]
        out = []
        off = 2
        end = min(2 + total, len(ext))
        while off < end:
            ln = ext[off]
            out.append(bytes(ext[off + 1 : off + 1 + ln]))
            off += 1 + ln
        return out
