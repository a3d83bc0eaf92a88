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


# -- RLC adversarial constructions ---------------------------------------
# The RLC batch equation is sound only against prime-order defects; these
# lanes carry defects that live in the 8-torsion, or weights that overload
# one bucket, so each must force the per-lane fallback.

ORDER2 = (0, P - 1)
# The canonical order-8 torsion encoding of the small-order list.
ORDER8_ENC = bytes.fromhex(
    "26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05")


def rlc_items(n: int = 16, max_len: int = 64, seed: int = 5):
    """n oracle-signed triples with keys from seeds bytes([i + 1]) * 32
    and messages of random length in [1, max_len) (numpy RandomState)."""
    rng = np.random.RandomState(seed)
    items = []
    for i in range(n):
        key = bytes([i + 1]) * 32
        _, _, pub = oracle.keypair_from_seed(key)
        m = rng.randint(0, 256, rng.randint(1, max_len), dtype=np.uint8)
        items.append((m.tobytes(), oracle.sign(m.tobytes(), key), pub))
    return items


def torsion_offset(items, t_point, lanes):
    """Replace each lane's signature by R = r*B + T, s = r + h*a with T a
    torsion point: the per-lane defect s*B - h*A - R is exactly -T, so the
    lane fails per-lane verify while its defect is invisible to the bare
    RLC equation whenever the weighted torsion sum cancels."""
    out = list(items)
    for i in lanes:
        a, _, pub = oracle.keypair_from_seed(bytes([i + 1]) * 32)
        m = out[i][0]
        r = 987_654_321 + i
        r_bytes = oracle.point_compress(
            oracle.point_add(oracle.scalarmult(r, oracle.B), t_point))
        h = oracle._sha512_mod_l(r_bytes, pub, m)
        sig = r_bytes + ((r + h * a) % L).to_bytes(32, "little")
        assert oracle.verify(m, sig, pub) != 0
        out[i] = (m, sig, pub)
    return out


def rlc_corpus(n: int = 16, max_len: int = 64) -> dict:
    """The RLC parity corpus: name -> (msg, sig, pub) triples. 'overflow'
    is the clean batch; its overload comes from equal z weights."""
    base = rlc_items(n, max_len)
    out = {"clean": base, "overflow": base}
    salted = list(base)                       # a decodable but wrong R
    m, sig, pub = salted[7]
    salted[7] = (m, sig[:2] + bytes([sig[2] ^ 0x40]) + sig[3:], pub)
    out["salted"] = salted
    definite = list(base)
    m, sig, pub = definite[1]
    definite[1] = (m, sig[:32] + b"\xff" * 32, pub)            # s >= L
    bad_pub = next(e for e in (bytes([c]) + bytes(31) for c in range(2, 200))
                   if oracle.point_decompress(e) is None)
    definite[2] = definite[2][:2] + (bad_pub,)
    out["definite"] = definite
    noncanon = list(base)                     # y = 2^255 - 1 >= p
    m, sig, pub = noncanon[3]
    noncanon[3] = (m, b"\xff" * 31 + b"\x7f" + sig[32:], pub)
    out["noncanon_r"] = noncanon
    out["order2"] = torsion_offset(base, ORDER2, (4, 5))
    out["order8"] = torsion_offset(base, oracle.point_decompress(ORDER8_ENC),
                                   (4, 5, 6, 7))
    small = list(base)
    small[2] = small[2][:2] + (oracle.point_compress(ORDER2),)
    m, sig, pub = small[9]
    small[9] = (m, ORDER8_ENC + sig[32:], pub)
    out["small_order"] = small
    return out


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
