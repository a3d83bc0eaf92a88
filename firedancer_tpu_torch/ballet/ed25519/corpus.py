"""Seeded parity traffic for the port: oracle-signed batches and the
decompress edge corpus (torsion encodings, y = +-1 with both sign bits,
non-canonical y >= p, encodings with no square root). The tests and
``chip_smoke.py`` draw their inputs from here, from numpy seeds.
"""

from __future__ import annotations

import numpy as np

from . import oracle

P, L = oracle.P, oracle.L


def _enc(y: int, sign: int) -> bytes:
    return (y | (sign << 255)).to_bytes(32, "little")


def _order8_point():
    """A point of order exactly 8: L*Q for a point Q whose torsion
    component has order 8."""
    y = 2
    while True:
        q = oracle.point_decompress(_enc(y, 0))
        if q is not None:
            t = oracle.scalarmult(L, q)
            if oracle.scalarmult(4, t) != (0, 1):
                return t
        y += 1


def torsion_encodings() -> list[bytes]:
    """Every 32-byte string that decodes (donna semantics) to a point of
    small order: the eight torsion points, with y and y + p where that
    stays below 2^255, and both sign bits."""
    t8 = _order8_point()
    pts = [oracle.scalarmult(k, t8) for k in range(8)]
    out = []
    for x, y in pts:
        for yy in (y, y + P):
            if yy >= 1 << 255:
                continue
            for sign in (0, 1):
                e = _enc(yy, sign)
                pt = oracle.point_decompress(e)
                if (pt is not None and oracle.is_small_order(pt)
                        and e not in out):
                    out.append(e)
    return out


def undecodable_encodings(n: int, rng: np.random.RandomState) -> list[bytes]:
    """n random encodings whose y has no square root (decompress fails)."""
    out = []
    while len(out) < n:
        e = rng.randint(0, 256, 32, dtype=np.uint8).tobytes()
        if oracle.point_decompress(e) is None:
            out.append(e)
    return out


def edge_encodings(rng: np.random.RandomState) -> list[bytes]:
    """The decompress edge corpus: torsion encodings (y = +-1 among them,
    both sign bits), every non-canonical y in [p, 2^255) with both sign
    bits, and eight undecodable encodings."""
    out = torsion_encodings()
    for y in range(P, 1 << 255):
        out += [_enc(y, 0), _enc(y, 1)]
    return out + undecodable_encodings(8, rng)


def signed_items(n: int, msg_lens, rng: np.random.RandomState):
    """n oracle-signed (msg, sig, pub) triples; message i has length
    msg_lens[i % len(msg_lens)], keys and bytes from rng."""
    items = []
    for i in range(n):
        seed = rng.randint(0, 256, 32, dtype=np.uint8).tobytes()
        _, _, pub = oracle.keypair_from_seed(seed)
        m = rng.randint(0, 256, msg_lens[i % len(msg_lens)],
                        dtype=np.uint8).tobytes()
        items.append((m, oracle.sign(m, seed), pub))
    return items


def to_arrays(items, max_len: int | None = None):
    """(msg, sig, pub) triples -> (msgs (B, max_len) uint8, lens (B,)
    int32, sigs (B, 64) uint8, pubs (B, 32) uint8)."""
    if max_len is None:
        max_len = max([len(m) for m, _, _ in items] + [1])
    bsz = len(items)
    msgs = np.zeros((bsz, max_len), np.uint8)
    lens = np.zeros(bsz, np.int32)
    sigs = np.zeros((bsz, 64), np.uint8)
    pubs = np.zeros((bsz, 32), np.uint8)
    for b, (m, sig, pub) in enumerate(items):
        msgs[b, :len(m)] = np.frombuffer(m, np.uint8)
        lens[b] = len(m)
        sigs[b] = np.frombuffer(sig, np.uint8)
        pubs[b] = np.frombuffer(pub, np.uint8)
    return msgs, lens, sigs, pubs
