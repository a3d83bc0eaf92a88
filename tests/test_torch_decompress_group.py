"""The decompress core of the port's CUDA kernels (csrc/decompress_core.cuh:
five threads a lane, thread j holding radix-2^51 limb j of every field
element, six lanes a warp; run by decompress_so.cu, decompress_niels.cu,
compress.cu, fe_pow.cu and point_eq.cu) transcribed thread by thread in
Python integers, with its shuffles.

No compiler runs here, so the transcription is the CPU's check of the
kernels' arithmetic and thread map: every warp is a list of 32 thread
values, a shuffle hands a thread another thread's value, and every range
the CUDA code relies on is asserted at every step (26-bit halves and
32-bit factored halves into 64-bit partial sums, 64-bit carries, limbs
back under 2^52). It is held against
the port's plain field ops (ops/fe25519.py), against Python integers,
and, kernel grid and all, against the plain decompress and compress
versions, whose outputs the kernels must equal limb for limb and byte
for byte (chip_smoke.py holds the kernels to them on the card). The
power chains' and the point compare's grids are also held to the JAX
package's fe_invert, fe_pow22523 and point_eq_affine_xla.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import curve25519 as jge
from firedancer_tpu.ops import fe25519 as jfe
from firedancer_tpu_torch import convert
from firedancer_tpu_torch.ballet.ed25519 import corpus, oracle
from firedancer_tpu_torch.ops import curve_cuda, pow_cuda
from firedancer_tpu_torch.ops import fe25519 as fe

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CORE = ROOT / "firedancer_tpu_torch" / "ops" / "csrc" / "decompress_core.cuh"
P = fe.P
M51 = (1 << 51) - 1
M64 = (1 << 64) - 1
M26, M25 = (1 << 26) - 1, (1 << 25) - 1
GROUP, LANES = curve_cuda.GROUP, curve_cuda.LANES_PER_WARP
WARPS = int(re.search(r"#define DC_WARPS (\d+)", CORE.read_text()).group(1))
FOUR_P = ((1 << 53) - 76, (1 << 53) - 4)   # limb 0, limbs 1-4
SENTINEL = -7
SENTINEL_BYTE = 0xA5


def _limbs(v: int):
    return [(v >> (51 * i)) & M51 for i in range(5)]


def _halves(v: int):
    """A limb below 2^52 as its 26-bit halves (lo, hi)."""
    assert 0 <= v < 1 << 52
    return [v & M26, v >> 26]


def _acc(t, x, y):
    """lg_acc: t (s0, s1, s2) += x y, x as 26-bit halves, y as halves
    times a factor; every partial product a 32 x 32 -> 64-bit one."""
    assert max(x) < 1 << 26 and max(y) < 1 << 32
    t[0] += x[0] * y[0]
    t[1] += x[0] * y[1] + x[1] * y[0]
    t[2] += x[1] * y[1]
    assert max(t) < 1 << 64


def _const(v: int):
    return _limbs(v % P)


class _Thread:
    """lg_make for one thread of warp `warp` (blockIdx * DC_WARPS + warp
    index) at warp lane `lane`, in a batch of n lanes."""

    def __init__(self, warp: int, lane: int, n: int):
        spare = lane >= GROUP * LANES
        grp = LANES - 1 if spare else lane // GROUP
        self.j = lane - GROUP * LANES if spare else lane - GROUP * grp
        self.base = GROUP * grp
        self.lane = warp * LANES + grp
        self.live = not spare and self.lane < n
        self.prev = self.base + (self.j + 4) % 5
        s0 = 3 * self.j % 5
        self.sq_src = [self.base + (s0 + k) % 5 for k in range(5)]
        self.mul_src = [self.base + (self.j + 5 - k) % 5 for k in range(5)]
        self.wrap = 19 if self.j == 0 else 1
        self.sq_f = (19 if 2 * s0 >= 5 else 1,
                     38 if (s0 + 1) % 5 + (s0 + 4) % 5 >= 5 else 2,
                     38 if (s0 + 2) % 5 + (s0 + 3) % 5 >= 5 else 2)


class _Warp:
    """One warp of the kernel: a field element is the list of the 32
    threads' limbs."""

    def __init__(self, warp: int, n: int):
        self.t = [_Thread(warp, lane, n) for lane in range(32)]
        self.columns = None       # the last product's column sums

    def reduce(self, cols):
        """lg_reduce: cols are the threads' (s0, s1, s2)."""
        c, m = [], []
        for s0, s1, s2 in cols:
            assert max(s0, s1, s2) < 1 << 64
            mm = s0 + ((s1 & M25) << 26)
            cc = (mm >> 51) + (s1 >> 25) + (s2 << 1)
            assert mm < 1 << 64 and cc < 1 << 64
            assert cc == (s0 + (s1 << 26) + (s2 << 52)) >> 51
            m.append(mm)
            c.append(cc)
        self.columns = [s0 + (s1 << 26) + (s2 << 52) for s0, s1, s2 in cols]
        assert max(self.columns) < 1 << 128
        s = [(v & M51) + c[th.prev] * th.wrap for v, th in zip(m, self.t)]
        assert max(s) < 1 << 64
        c2 = [v >> 51 for v in s]
        assert max(c2) < 1 << 32
        out = [(v & M51) + c2[th.prev] * th.wrap for v, th in zip(s, self.t)]
        assert max(out) < 1 << 52
        return out

    def carry(self, s):
        assert all(0 <= v < 1 << 54 for v in s)
        c = [v >> 51 for v in s]
        out = [(v & M51) + c[th.prev] * th.wrap for v, th in zip(s, self.t)]
        assert max(out) < 1 << 52
        return out

    def add(self, a, b):
        return self.carry([x + y for x, y in zip(a, b)])

    def sub(self, a, b):
        assert max(b) < FOUR_P[0]
        return self.carry([x + FOUR_P[th.j > 0] - y
                           for x, y, th in zip(a, b, self.t)])

    def neg(self, a):
        return self.sub([0] * 32, a)

    def sq(self, a):
        cols = []
        for th in self.t:
            r = [_halves(a[s]) for s in th.sq_src]
            t = [0, 0, 0]
            for x, y, f in ((0, 0, 0), (1, 4, 1), (2, 3, 2)):
                _acc(t, r[x], [h * th.sq_f[f] for h in r[y]])
            cols.append(t)
        return self.reduce(cols)

    def sqn(self, a, n):
        for _ in range(n):
            a = self.sq(a)
        return a

    def mul(self, a, b):
        cols = []
        for th in self.t:
            t = [0, 0, 0]
            for k in range(5):
                f = 19 if k > th.j else 1
                _acc(t, _halves(a[th.mul_src[k]]),
                     [h * f for h in _halves(b[th.base + k])])
            cols.append(t)
        return self.reduce(cols)

    def mul_const(self, a, c):
        return self.mul(a, self.spread([c] * LANES))

    def spread(self, limbs_by_lane):
        """Thread t holds limb j of its group's element."""
        return [limbs_by_lane[th.base // GROUP][th.j] for th in self.t]

    def value(self, a, grp: int) -> int:
        return sum(a[GROUP * grp + j] << (51 * j) for j in range(5))

    def canonical(self, a):
        """lg_gather, then the one-thread fe_canonical on every thread."""
        out = []
        for th in self.t:
            limbs = [a[th.base + k] for k in range(5)]
            assert max(limbs) < 1 << 63
            out.append(_limbs(sum(v << (51 * k)
                                  for k, v in enumerate(limbs)) % P))
        return out

    def is_zero(self, a):
        return [int(c == [0] * 5) for c in self.canonical(a)]

    def is_negative(self, a):
        return [c[0] & 1 for c in self.canonical(a)]

    def sel(self, cond, a, b):
        return [x if c else y for c, x, y in zip(cond, a, b)]


def _pow_ladder(w, z):
    """decompress_core.cuh lg_pow_ladder: z^(2^250 - 1) and z^11."""
    z2 = w.sq(z)
    z9 = w.mul(w.sqn(z2, 2), z)
    z11 = w.mul(z9, z2)
    z_5_0 = w.mul(w.sq(z11), z9)
    z_10_0 = w.mul(w.sqn(z_5_0, 5), z_5_0)
    z_20_0 = w.mul(w.sqn(z_10_0, 10), z_10_0)
    z_40_0 = w.mul(w.sqn(z_20_0, 20), z_20_0)
    z_50_0 = w.mul(w.sqn(z_40_0, 10), z_10_0)
    z_100_0 = w.mul(w.sqn(z_50_0, 50), z_50_0)
    z_200_0 = w.mul(w.sqn(z_100_0, 100), z_100_0)
    return w.mul(w.sqn(z_200_0, 50), z_50_0), z11


def _pow22523(w, z):
    """decompress_core.cuh lg_pow22523."""
    z250, _ = _pow_ladder(w, z)
    return w.mul(w.sqn(z250, 2), z)


def _invert(w, z):
    """decompress_core.cuh lg_invert: z^(p - 2), 0 for z = 0."""
    z250, z11 = _pow_ladder(w, z)
    return w.mul(w.sqn(z250, 5), z11)


def _decompress(w, enc):
    """dc_decompress: per thread limb j of y from its lane's encoding
    (y = 0 on groups past the batch) -> X, Y, T limbs and ok."""
    y, sign = [], []
    for th in w.t:
        v, s = 0, 0
        if th.live:
            e = int.from_bytes(enc[th.lane].tobytes(), "little")
            v, s = _limbs(e & ((1 << 255) - 1))[th.j], e >> 255
        y.append(v)
        sign.append(s)
    one = [int(th.j == 0) for th in w.t]
    yy = w.sq(y)
    u = w.sub(yy, one)
    v = w.add(w.mul_const(yy, _const(fe.D_INT)), one)
    v3 = w.mul(w.sq(v), v)
    uv7 = w.mul(w.mul(w.sq(v3), v), u)
    x = w.mul(w.mul(_pow22523(w, uv7), v3), u)
    vxx = w.mul(w.sq(x), v)
    root_ok = w.is_zero(w.sub(vxx, u))
    neg_ok = w.is_zero(w.add(vxx, u))
    x = w.sel(root_ok, x, w.mul_const(x, _const(fe.SQRT_M1_INT)))
    x = w.sel([n != s for n, s in zip(w.is_negative(x), sign)], w.neg(x), x)
    t = w.mul(x, y)
    ok = [r | n for r, n in zip(root_ok, neg_ok)]
    return (w.sel(ok, x, [0] * 32), w.sel(ok, y, one),
            w.sel(ok, t, [0] * 32), ok)


def _small_order(w, x, y):
    """dc_small_order: three doublings of (X : Y : 1), 8 P == O."""
    z = [int(th.j == 0) for th in w.t]
    for _ in range(3):
        a, b, zz = w.sq(x), w.sq(y), w.sq(z)
        c = w.add(zz, zz)
        d = w.neg(a)
        e = w.sub(w.sub(w.sq(w.add(x, y)), a), b)
        g = w.add(d, b)
        f = w.sub(g, c)
        h = w.sub(d, b)
        x, y, z = w.mul(e, f), w.mul(g, h), w.mul(f, g)
    return [p & q for p, q in zip(w.is_zero(x), w.is_zero(w.sub(y, z)))]


def _kernel_grid(enc: np.ndarray):
    """Both kernels over their grid of ceil(n / DC_LANES) blocks: the
    stores of decompress_niels_kernel (K2's are its first three) into
    arrays of sentinels, and how often each element was written."""
    n = enc.shape[0]
    out = {"pt": np.full((n, 4, 5), SENTINEL), "niels": np.full(
        (n, 3, 5), SENTINEL), "neg": np.full((n, 3, 5), SENTINEL),
        "ok": np.full(n, SENTINEL), "so": np.full(n, SENTINEL)}
    writes = {k: np.zeros(v.shape, np.int64) for k, v in out.items()}
    blocks = -(-n // (WARPS * LANES))

    def store(key, th, idx, val):
        if th.live:
            out[key][(th.lane,) + idx] = val
            writes[key][(th.lane,) + idx] += 1

    for warp in range(blocks * WARPS):
        w = _Warp(warp, n)
        x, y, t, ok = _decompress(w, enc)
        so = _small_order(w, x, y)
        one = [int(th.j == 0) for th in w.t]
        yp, ym = w.add(y, x), w.sub(y, x)
        t2d = w.mul_const(t, _const(fe.D2_INT))
        rows = [("pt", 0, x), ("pt", 1, y), ("pt", 3, t), ("niels", 0, yp),
                ("niels", 1, ym), ("niels", 2, t2d), ("neg", 0, ym),
                ("neg", 1, yp), ("neg", 2, w.neg(t2d))]
        for key, row, val in rows:
            for th, c in zip(w.t, w.canonical(val)):
                store(key, th, (row, th.j), c[th.j])
        for th in w.t:
            store("pt", th, (2, th.j), one[th.j])
            if th.j == 0:
                store("ok", th, (), ok[th.base])
                store("so", th, (), so[th.base])
    return out, writes


def _warp_of(elements):
    """A warp (n = 6) holding six field elements given as limb lists."""
    w = _Warp(0, LANES)
    return w, w.spread(elements)


def _one_thread_columns(a, b):
    """fe25519.cuh fe_mul's (and, for a = b, fe_sq's) column sums."""
    return [sum(a[i] * (b[k - i] if i <= k else 19 * b[k - i + 5])
                for i in range(5)) for k in range(5)]


def _elements(kind: str, seed: int = 0):
    """Six field elements as limb lists: every limb 2^52 - 1, or random
    limbs below 2^52 with p - 1, 0 and 1 among them."""
    if kind == "largest":
        return [[(1 << 52) - 1] * 5 for _ in range(LANES)]
    rng = np.random.default_rng(seed)
    els = [[int(v) for v in rng.integers(0, 1 << 52, 5)]
           for _ in range(LANES)]
    els[1], els[2], els[3] = _limbs(P - 1), [0] * 5, [1, 0, 0, 0, 0]
    return els


def _ints(els):
    return [sum(v << (51 * i) for i, v in enumerate(e)) for e in els]


def _plain(fn, *args):
    """The port's plain field op on Python ints -> ints mod p."""
    return fe.fe_to_int(fn(*(fe.fe_from_int([x % P for x in a])
                             for a in args)))


@pytest.mark.parametrize("kind", ["largest", "random"])
@pytest.mark.parametrize("op", ["sq", "mul", "mul_const", "add", "sub",
                                "neg"])
def test_group_field_ops_keep_their_ranges(kind, op):
    """Every limb 2^52 - 1 (the most the kernels take) or random limbs:
    each column sum < 2^128, each carry < 2^64, each output limb < 2^52
    (asserted inside _Warp), and each lane's value is the plain field
    op's and the Python integers'; a product's column sums are the
    one-thread fe_mul's / fe_sq's."""
    a_el, b_el = _elements(kind, 1), _elements(kind, 2)[::-1]
    w, a = _warp_of(a_el)
    b = w.spread(b_el)
    ai, bi = _ints(a_el), _ints(b_el)
    d = _const(fe.D_INT)
    got, want, plain, cols = {
        "sq": lambda: (w.sq(a), [x * x for x in ai],
                       _plain(fe.fe_sq, ai), [(x, x) for x in a_el]),
        "mul": lambda: (w.mul(a, b), [x * y for x, y in zip(ai, bi)],
                        _plain(fe.fe_mul, ai, bi), list(zip(a_el, b_el))),
        "mul_const": lambda: (w.mul_const(a, d), [x * fe.D_INT for x in ai],
                              _plain(fe.fe_mul, ai, [fe.D_INT] * LANES),
                              [(x, d) for x in a_el]),
        "add": lambda: (w.add(a, b), [x + y for x, y in zip(ai, bi)],
                        _plain(fe.fe_add, ai, bi), None),
        "sub": lambda: (w.sub(a, b), [x - y for x, y in zip(ai, bi)],
                        _plain(fe.fe_sub, ai, bi), None),
        "neg": lambda: (w.neg(a), [-x for x in ai], _plain(fe.fe_neg, ai),
                        None)}[op]()
    for g in range(LANES):
        assert w.value(got, g) % P == want[g] % P == plain[g], (op, g)
        if cols is not None:
            assert w.columns[GROUP * g:GROUP * g + 5] == \
                _one_thread_columns(*cols[g]), (op, g)
    # threads 30-31 compute limbs 0-1 of the sixth lane again
    assert got[30:32] == got[25:27]


@pytest.mark.parametrize("seed", [0, 1])
def test_group_pow22523_ladder(seed):
    """The whole z^((p-5)/8) chain on the group (a warp of six seeded
    elements, 0, 1 and p - 1 among them, limbs up to 2^52 - 1) equals
    the plain fe_pow22523 and Python's pow."""
    els = _elements("random", 10 + seed)
    els[4] = [(1 << 52) - 1] * 5
    w, z = _warp_of(els)
    got = _pow22523(w, z)
    zi = _ints(els)
    plain = _plain(fe.fe_pow22523, zi)
    for g in range(LANES):
        want = pow(zi[g] % P, (P - 5) // 8, P)
        assert w.value(got, g) % P == want == plain[g], g


@pytest.mark.parametrize("seed", [0, 1])
def test_group_invert_ladder(seed):
    """lg_pow_ladder and lg_invert on the group (a warp of six seeded
    elements, 0, 1 and p - 1 among them, limbs up to 2^52 - 1): the
    ladder gives z^(2^250 - 1) and z^11, the inversion Python's
    pow(z, p - 2, p) and the plain fe_invert (0 for z = 0)."""
    els = _elements("random", 20 + seed)
    els[4] = [(1 << 52) - 1] * 5
    w, z = _warp_of(els)
    z250, z11 = _pow_ladder(w, z)
    got = _invert(w, z)
    zi = _ints(els)
    plain = _plain(fe.fe_invert, zi)
    for g in range(LANES):
        v = zi[g] % P
        assert w.value(z250, g) % P == pow(v, (1 << 250) - 1, P), g
        assert w.value(z11, g) % P == pow(v, 11, P), g
        assert w.value(got, g) % P == pow(v, P - 2, P) == plain[g], g
    assert w.value(got, 2) == 0          # els[2] is zero


def test_group_sources_cover_each_group():
    """lg_make: every thread reads only its own group's five lanes (never
    threads 30-31), each gather source list is a permutation of them, the
    squaring's pairs land in column j, and threads 30-31 are limbs 0-1
    of the sixth lane and never live."""
    w = _Warp(0, 10**6)
    for lane, th in enumerate(w.t):
        own = set(range(th.base, th.base + GROUP))
        assert set(th.sq_src) == set(th.mul_src) == own
        assert th.prev in own and max(own) < GROUP * LANES
        lim = [s - th.base for s in th.sq_src]
        assert 2 * lim[0] % 5 == th.j
        assert (lim[1] + lim[4]) % 5 == (lim[2] + lim[3]) % 5 == th.j
        assert th.live == (lane < GROUP * LANES)
    assert [(th.base, th.j) for th in w.t[30:]] == [(25, 0), (25, 1)]
    assert sorted({th.lane for th in w.t}) == list(range(LANES))


def _encodings(n: int, seed: int) -> np.ndarray:
    """n encodings: the decompress edges (torsion points with y = +-1,
    non-canonical y, non-squares) interleaved with random bytes."""
    rng = np.random.RandomState(seed)
    edge = corpus.edge_encodings(rng)
    enc = rng.randint(0, 256, (n, 32), dtype=np.uint8)
    pick = rng.permutation(len(edge))[:(n + 1) // 2]
    enc[::2] = np.frombuffer(b"".join(edge[i] for i in pick),
                             np.uint8).reshape(-1, 32)
    return enc


@pytest.mark.parametrize("n", [1, 5, 6, 7, 31])
def test_kernel_grid_transcription_matches_the_plain_versions(n):
    """The kernels' grid at ragged batch sizes (six lanes a warp, 24 a
    block): every lane below n is stored exactly once, limb by limb,
    equal to decompress_so_ref and decompress_niels_ref; groups past the
    batch and threads 30-31 run the chain and store nothing."""
    enc = _encodings(n, n)
    out, writes = _kernel_grid(enc)
    for key, cnt in writes.items():
        assert (cnt == 1).all(), key
    te = torch.from_numpy(enc)
    pt, ok, so = curve_cuda.decompress_so_ref(te)
    _, _, _, niels, neg = curve_cuda.decompress_niels_ref(te)
    np.testing.assert_array_equal(out["pt"], pt.numpy())
    np.testing.assert_array_equal(out["ok"], ok.numpy())
    np.testing.assert_array_equal(out["so"], so.numpy())
    np.testing.assert_array_equal(out["niels"], niels.numpy())
    np.testing.assert_array_equal(out["neg"], neg.numpy())


def test_group_width_matches_the_wrapper():
    """The core's group width and lanes a warp are the wrappers'
    (curve_cuda.GROUP, LANES_PER_WARP), and the three kernels launch on
    it (compress through lg_invert, not the one-thread fe_invert)."""
    src = CORE.read_text()
    assert f"#define DC_GROUP {curve_cuda.GROUP}" in src
    assert "#define DC_LANES_PER_WARP (32 / DC_GROUP)" in src
    assert curve_cuda.LANES_PER_WARP == 32 // curve_cuda.GROUP == 6
    comp = (CORE.parent / "compress.cu").read_text()
    assert "lg_invert(g, Z)" in comp and "fe_invert" not in comp
    for name in ("decompress_so", "decompress_niels", "compress"):
        kern = (CORE.parent / f"{name}.cu").read_text()
        assert '#include "decompress_core.cuh"' in kern
        assert "<<<dc_blocks(n), DC_THREADS" in kern



def _compress_grid(pt: np.ndarray):
    """compress_kernel over its grid of ceil(n / DC_LANES) blocks: thread
    j of a live group loads limb j of its lane's X, Y and Z (pt + 5 coords
    lane + {0, 5, 10} + j), the group runs lg_invert and the two
    multiplies, every thread gathers the canonical y and the parity of x,
    and threads j = 0..3 of a live group store 64-bit word j of the
    encoding (thread 3 with the sign in bit 63) into a sentinel-filled
    output with a grid's room past n. Returns the output, how often each
    word was written and every load's flat index. Warps with no live
    group run the chain on zeros and store nothing; they are skipped."""
    n, coords = pt.shape[:2]
    flat = pt.reshape(-1)
    blocks = -(-n // (WARPS * LANES))
    room = blocks * WARPS * LANES
    out = np.full((room, 32), SENTINEL_BYTE, np.uint8)
    writes = np.zeros((room, 4), np.int64)
    loads = []
    for warp in range(blocks * WARPS):
        w = _Warp(warp, n)
        if not any(th.live for th in w.t):
            continue
        xyz = [[0] * 32 for _ in range(3)]
        for c in range(3):
            for t, th in enumerate(w.t):
                if th.live:
                    addr = 5 * coords * th.lane + 5 * c + th.j
                    loads.append(addr)
                    xyz[c][t] = int(flat[addr])
        zinv = _invert(w, xyz[2])
        ax, ay = w.mul(xyz[0], zinv), w.mul(xyz[1], zinv)
        for th, c, sign in zip(w.t, w.canonical(ay), w.is_negative(ax)):
            words = [(c[0] | c[1] << 51) & M64,
                     (c[1] >> 13 | c[2] << 38) & M64,
                     (c[2] >> 26 | c[3] << 25) & M64,
                     c[3] >> 39 | c[4] << 12]
            assert words[3] < 1 << 63
            words[3] |= sign << 63
            if th.live and th.j < 4:
                out[th.lane, 8 * th.j:8 * th.j + 8] = np.frombuffer(
                    words[th.j].to_bytes(8, "little"), np.uint8)
                writes[th.lane, th.j] += 1
    return out, writes, loads



def _compress_points(n: int, seed: int):
    """(n, coords, 5) limbs: points (x lam : y lam : lam) of random
    decodable encodings (the identity among them) at Z = 1 and random
    lam, with their X, Y, Z as canonical limbs or as canonical + p (every
    limb in [2^51, 2^52)); Z = 0 lanes; and lanes of every limb
    2^52 - 1. Returns the limbs and the affine point of each point lane
    (None elsewhere). coords = 4 on odd n (K3's outputs carry T, which
    compress must not read), else 3."""
    rng = np.random.RandomState(seed)
    coords = 3 + n % 2
    pt = rng.randint(0, 1 << 62, (n, coords, 5)).astype(np.int64)
    affine = []
    plus_p = [(1 << 51) - 19] + [(1 << 51) - 1] * 4
    for i in range(n):
        kind = i % 5
        aff = None
        if kind == 3:
            vals = [int.from_bytes(rng.bytes(32), "little") % P
                    for _ in range(2)] + [0]
            limbs = [_limbs(v) for v in vals]
        elif kind == 4:
            limbs = [[(1 << 52) - 1] * 5] * 3
        else:
            while aff is None:
                aff = (oracle.point_decompress(rng.bytes(32)) if i else
                       (0, 1))
            lam = 1 if kind == 0 else int.from_bytes(rng.bytes(32),
                                                     "little") % (P - 1) + 1
            vals = [aff[0] * lam % P, aff[1] * lam % P, lam]
            limbs = [_limbs(v) for v in vals]
            if kind == 2:
                limbs = [[v + q for v, q in zip(lb, plus_p)] for lb in limbs]
                assert all(1 << 51 <= v < 1 << 52 for lb in limbs for v in lb)
        pt[i, :3] = np.array(limbs, np.int64)
        affine.append(aff)
    return pt, affine


@pytest.mark.parametrize("n", [1, 5, 6, 7, 31])
def test_compress_grid_transcription_matches_plain_and_oracle(n):
    """compress_kernel's grid at ragged n (six lanes a warp, 24 a block):
    each live lane's 15 limbs of X, Y, Z loaded once (T never), each of
    its four words stored once, nothing past n; the bytes equal
    compress_ref's on every lane (Z = 0 to zero bytes, limbs up to
    2^52 - 1, non-canonical X, Y, Z) and the oracle's encoding on the
    point lanes."""
    pt, affine = _compress_points(n, seed=100 + n)
    out, writes, loads = _compress_grid(pt)
    coords = pt.shape[1]
    assert sorted(loads) == sorted(5 * coords * i + 5 * c + j for i in range(n)
                                   for c in range(3) for j in range(5))
    assert (writes[:n] == 1).all() and (writes[n:] == 0).all()
    assert (out[n:] == SENTINEL_BYTE).all()
    want = curve_cuda.compress_ref(torch.from_numpy(pt)).numpy()
    np.testing.assert_array_equal(out[:n], want)
    for i, aff in enumerate(affine):
        if aff is not None:
            assert out[i].tobytes() == oracle.point_compress(aff), i
        elif i % 5 == 3:
            assert not out[i].any(), i


RAGGED = (1, 5, 6, 7, 31)
HIGH = (1 << 52) - 1


def _high(v: int):
    """Limbs of a value congruent to v mod p, every limb in [2^51, 2^52):
    2^51 plus the canonical limbs of v - S mod p, S the value of five
    limbs of 2^51 (chip_smoke.py _high_limbs)."""
    r = (v - sum(1 << (51 * i + 51) for i in range(5))) % P
    return [(1 << 51) + x for x in _limbs(r)]


def _pow_inputs(n: int):
    """(n, 5) limbs of the power chains' edges, then random values, in an
    order shuffled by n: z = 0, 1 and p - 1; p, p + 1, p + 18 and
    2^255 - 1 (values in [p, 2^255) as limbs below 2^51); 0, 1, p - 1 and
    a random value with every limb in [2^51, 2^52); every limb 2^52 - 1;
    then random values below 2^255, every third with high limbs."""
    rng = np.random.RandomState(200 + n)
    edge = [_limbs(v) for v in (0, 1, P - 1, P, P + 1, P + 18, 2**255 - 1)]
    edge += [_high(v) for v in (0, 1, P - 1, P // 3)] + [[HIGH] * 5]
    rows = []
    for i in range(max(n, len(edge))):
        v = int.from_bytes(rng.bytes(32), "little") >> 1
        rows.append(edge[i] if i < len(edge) else
                    _high(v) if i % 3 == 0 else _limbs(v))
    return np.array(rows, np.int64)[rng.permutation(len(rows))[:n]]


def _fe_pow_grid(z: np.ndarray, invert: bool):
    """fe_pow_kernel over its grid of ceil(n / DC_LANES) blocks: thread j
    of a live group loads limb j of its lane's row (z + 5 lane + j), the
    group runs lg_invert or lg_pow22523 (every limb range asserted in
    _Warp), and lg_store_canonical stores limb j of the canonical result
    into a sentinel-filled output with a grid's room past n. Returns the
    output, how often each limb was written and every load's flat index.
    Warps with no live group run the chain on zeros and store nothing;
    they are skipped."""
    n = z.shape[0]
    flat = z.reshape(-1)
    blocks = -(-n // (WARPS * LANES))
    room = blocks * WARPS * LANES
    out = np.full((room, 5), SENTINEL, np.int64)
    writes = np.zeros((room, 5), np.int64)
    loads = []
    for warp in range(blocks * WARPS):
        w = _Warp(warp, n)
        if not any(th.live for th in w.t):
            continue
        x = [0] * 32
        for t, th in enumerate(w.t):
            if th.live:
                loads.append(5 * th.lane + th.j)
                x[t] = int(flat[5 * th.lane + th.j])
                assert 0 <= x[t] < 1 << 52
        r = (_invert if invert else _pow22523)(w, x)
        for th, c in zip(w.t, w.canonical(r)):
            if th.live:
                out[th.lane, th.j] = c[th.j]
                writes[th.lane, th.j] += 1
    return out, writes, loads


def _point_eq_values(n: int):
    """Per lane the values (ax, ay, X, Y, Z) and whether each coordinate
    is given as high limbs, by lane kind (i mod 6): equal at Z = 1; equal
    at a random Z; only X differs; only Y differs (Z = 1); equal with
    every limb of all five in [2^51, 2^52); ax and ay swapped (both
    differ). About half the lanes are equal."""
    rng = np.random.RandomState(300 + n)
    kinds = rng.permutation(np.arange(max(n, 6)) % 6)[:n]
    lanes = []
    for kind in kinds:
        ax, ay = (int.from_bytes(rng.bytes(32), "little") % P
                  for _ in range(2))
        z = 1 if kind in (0, 3) else int.from_bytes(
            rng.bytes(32), "little") % (P - 1) + 1
        x, y = ax * z % P, ay * z % P
        if kind == 2:
            x = (x + 1) % P
        elif kind == 3:
            y = (y + P - 1) % P
        elif kind == 5:
            ax, ay = ay, ax
        lanes.append(((ax, ay, x, y, z), kind == 4))
    return lanes


def _point_eq_inputs(n: int, aff_coords: int, proj_coords: int):
    """(aff (n, aff_coords, 5), proj (n, proj_coords, 5)) limbs of
    _point_eq_values, the columns past (ax, ay) and (X, Y, Z) random
    limbs that the kernel must not read."""
    rng = np.random.RandomState(400 + n)
    aff = rng.randint(0, 1 << 52, (n, aff_coords, 5)).astype(np.int64)
    proj = rng.randint(0, 1 << 52, (n, proj_coords, 5)).astype(np.int64)
    for i, (vals, high) in enumerate(_point_eq_values(n)):
        rows = [(_high if high else _limbs)(v) for v in vals]
        aff[i, :2], proj[i, :3] = rows[:2], rows[2:]
    return aff, proj


def _point_eq_grid(aff: np.ndarray, proj: np.ndarray):
    """point_eq_kernel over its grid: thread j of a live group loads limb
    j of ax, ay (aff + 5 aff_coords lane + {0, 5} + j) and of X, Y, Z
    (proj + 5 proj_coords lane + {0, 5, 10} + j); the group forms ax Z
    and ay Z (Z's halves gathered once, the values w.mul gathers), tests
    ax Z - X and ay Z - Y for zero at canonical form, and thread 0 of a
    live group stores the lane's byte into a sentinel-filled output.
    Returns the output, how often each byte was written and the loads'
    flat indices into aff and proj."""
    n, aff_coords = aff.shape[:2]
    proj_coords = proj.shape[1]
    flats = (aff.reshape(-1), proj.reshape(-1))
    blocks = -(-n // (WARPS * LANES))
    room = blocks * WARPS * LANES
    out = np.full(room, SENTINEL_BYTE, np.uint8)
    writes = np.zeros(room, np.int64)
    loads = ([], [])
    for warp in range(blocks * WARPS):
        w = _Warp(warp, n)
        if not any(th.live for th in w.t):
            continue
        vals = [[0] * 32 for _ in range(5)]
        for c, (src, coords, row) in enumerate((
                (0, aff_coords, 0), (0, aff_coords, 1), (1, proj_coords, 0),
                (1, proj_coords, 1), (1, proj_coords, 2))):
            for t, th in enumerate(w.t):
                if th.live:
                    addr = 5 * coords * th.lane + 5 * row + th.j
                    loads[src].append(addr)
                    vals[c][t] = int(flats[src][addr])
                    assert 0 <= vals[c][t] < 1 << 52
        ax, ay, x, y, z = vals
        eq_x = w.is_zero(w.sub(w.mul(ax, z), x))
        eq_y = w.is_zero(w.sub(w.mul(ay, z), y))
        for t, th in enumerate(w.t):
            if th.live and th.j == 0:
                out[th.lane] = eq_x[t] & eq_y[t]
                writes[th.lane] += 1
    return out, writes, loads


def _jax_fe(values):
    """Field values as JAX (32, B) limbs: the bytes of each value below
    2^255 as they stand (non-canonical ones too), the rest mod p."""
    return jfe.fe_from_bytes(jnp.asarray(np.array([list(
        (v if v < 1 << 255 else v % P).to_bytes(32, "little"))
        for v in values], np.uint8)))


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX package's fe_invert, fe_pow22523 (jitted, one shape) and
    point_eq_affine_xla on the inputs of every n of RAGGED at once, as
    canonical port limbs and bools, split back by n."""
    zs = np.concatenate([_pow_inputs(n) for n in RAGGED])
    jz = _jax_fe(_ints(zs.tolist()))
    chains = {name: convert.fe_from_jax_limbs(jax.jit(fn)(jz)).numpy()
              for name, fn in (("invert", jfe.fe_invert),
                               ("pow22523", jfe.fe_pow22523))}
    lanes = [v for n in RAGGED for v, _ in _point_eq_values(n)]
    cols = [_jax_fe([v[c] for v in lanes]) for c in range(5)]
    eq = np.asarray(jge.point_eq_affine_xla(
        (cols[0], cols[1]), (cols[2], cols[3], cols[4], None)))
    ends = np.cumsum((0,) + RAGGED)
    return {n: ({k: v[a:b] for k, v in chains.items()}, eq[a:b])
            for n, a, b in zip(RAGGED, ends[:-1], ends[1:])}


@pytest.mark.parametrize("chain", ["invert", "pow22523"])
@pytest.mark.parametrize("n", RAGGED)
def test_fe_pow_grid_transcription_matches_plain_and_jax(n, chain,
                                                         jax_outputs):
    """fe_pow_kernel's grid at ragged n (six lanes a warp, 24 a block):
    each live lane's five limbs loaded once and stored once, nothing past
    n; the limbs equal the plain version's (pow_cuda.*_ref), Python's pow
    and the JAX package's chain on every lane: z = 0 to 0, 1, p - 1,
    values in [p, 2^255), limbs in [2^51, 2^52) and every limb
    2^52 - 1."""
    z = _pow_inputs(n)
    invert = chain == "invert"
    out, writes, loads = _fe_pow_grid(z, invert)
    assert sorted(loads) == list(range(5 * n))
    assert (writes[:n] == 1).all() and (writes[n:] == 0).all()
    assert (out[n:] == SENTINEL).all()
    ref = pow_cuda.fe_invert_ref if invert else pow_cuda.fe_pow22523_ref
    np.testing.assert_array_equal(out[:n], ref(torch.from_numpy(z)).numpy())
    np.testing.assert_array_equal(out[:n], jax_outputs[n][0][chain])
    e = P - 2 if invert else (P - 5) // 8
    assert [sum(v << (51 * i) for i, v in enumerate(r)) for r in
            out[:n].tolist()] == [pow(v % P, e, P) for v in _ints(z.tolist())]


@pytest.mark.parametrize("coords", [(2, 3), (4, 4)])
@pytest.mark.parametrize("n", RAGGED)
def test_point_eq_grid_transcription_matches_plain_and_jax(n, coords,
                                                           jax_outputs):
    """point_eq_kernel's grid at ragged n with aff of 2 and 4 and proj of
    3 and 4 coordinates: each live lane's 25 limbs of ax, ay, X, Y and Z
    loaded once (no other column), its byte stored once, nothing past n;
    the bytes equal point_eq_affine_ref's and the JAX package's
    point_eq_affine_xla on every lane (equal lanes at Z = 1 and random Z,
    only X or only Y differing, limbs in [2^51, 2^52))."""
    aff, proj = _point_eq_inputs(n, *coords)
    out, writes, loads = _point_eq_grid(aff, proj)
    assert sorted(loads[0]) == sorted(5 * coords[0] * i + 5 * c + j
                                      for i in range(n) for c in range(2)
                                      for j in range(5))
    assert sorted(loads[1]) == sorted(5 * coords[1] * i + 5 * c + j
                                      for i in range(n) for c in range(3)
                                      for j in range(5))
    assert (writes[:n] == 1).all() and (writes[n:] == 0).all()
    assert (out[n:] == SENTINEL_BYTE).all()
    want = curve_cuda.point_eq_affine_ref(torch.from_numpy(aff),
                                          torch.from_numpy(proj)).numpy()
    np.testing.assert_array_equal(out[:n], want)
    np.testing.assert_array_equal(out[:n].astype(bool), jax_outputs[n][1])
    kinds = [int(v[2] == v[0] * v[4] % P and v[3] == v[1] * v[4] % P)
             for v, _ in _point_eq_values(n)]
    assert out[:n].tolist() == kinds


def test_fe_pow_and_point_eq_run_on_the_group():
    """fe_pow.cu and point_eq.cu launch on the core's grid with its group
    functions and return nowhere before a shuffle; fe25519.cuh keeps no
    one-thread power chain or compare, and no one-thread launch
    geometry."""
    for name, calls in (("fe_pow", ("lg_invert(g, x)", "lg_pow22523(g, x)",
                                    "lg_store_canonical(")),
                        ("point_eq", ("lg_mul_halves(g, ax", "lg_mul_halves"
                                      "(g, ay", "lg_is_zero(g, lg_sub("))):
        src = (CORE.parent / f"{name}.cu").read_text()
        body = src[src.index("__global__"):src.index('extern "C"')]
        assert '#include "decompress_core.cuh"' in src
        assert "<<<dc_blocks(n), DC_THREADS" in src
        assert "lg_make(n)" in body and "return" not in body
        assert all(c in body for c in calls), name
    one = (CORE.parent / "fe25519.cuh").read_text()
    for gone in ("fe_invert", "fe_pow22523", "fe_pow_ladder", "fe_eq",
                 "fe_sqn", "fd_blocks", "FD_THREADS"):
        assert gone not in one, gone
