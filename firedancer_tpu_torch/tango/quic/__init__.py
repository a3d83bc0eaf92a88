"""QUIC v1 (RFC 9000/9001), the port's copy of
``firedancer_tpu/tango/quic`` (the reference's src/tango/quic/): wire codecs, packet
protection, a from-scratch TLS 1.3 handshake over CRYPTO frames, connection
state machine, and stream reassembly, speaking the Solana TPU ALPN.

The reference's split is mirrored by module:
  wire.py          <- templ/fd_quic_templ.h + fd_quic_proto.{h,c} (codecs)
  crypto_suites.py <- crypto/fd_quic_crypto_suites.{h,c} (AEAD + HP + keys)
  tls.py           <- tls/fd_quic_tls.{h,c} (handshake engine; here built
                      from scratch on ballet aes/hkdf/x25519/x509 instead of
                      delegating to a TLS library)
  conn.py          <- fd_quic_conn.{h,c} + fd_quic_stream.* (per-conn state)
  quic.py          <- fd_quic.{h,c} (top object: conn map, aio, service loop)

Host Python over the ballet primitives (the packet AEAD on AES-NI,
``ballet.aes``; the CertificateVerify signer and verifier native,
``ballet.ed25519.native``); nothing here touches the card.
"""

def __getattr__(name):
    if name in ("Quic", "QuicConfig"):
        from . import quic as _q

        return getattr(_q, name)
    raise AttributeError(name)
