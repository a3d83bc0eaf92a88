"""The scalar kernels' grid (csrc/sc_reduce.cu: sc_reduce64 and sc_muladd)
and the radix-2^32 carry chains of the one shared Barrett reduction
(csrc/sha512.cuh: sc_mac, sc_sub8, sc_reduce512, muladd256), transcribed
in Python.

No compiler runs here, so the transcription is the CPU's check of the
kernels' design: blocks of SC_THREADS lanes; each block's rows copied
into shared memory by coalesced accesses of the width the launch's
pointers allow (16 bytes, 8 bytes or single bytes), each thread reading
its padded row as 8-byte words, and the results stored back the same
way. Every access is asserted to lie inside one live row and to be
aligned to its width, every warp's accesses to be contiguous in lane
order, the padded pitch to keep a half-warp's 8-byte reads on distinct
bank pairs, and lanes past n to store nothing. The chains run step by
step as the PTX instructions do (a 32-bit word and a carry flag); every
step's sum is asserted to fit a word and its carry, and every carry a
chain drops at its natural end to be zero. The outputs are held byte for
byte to Python's % L and to the plain versions (sc_cuda.sc_reduce64_ref,
sc_muladd_ref), which chip_smoke.py holds the kernels to on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from firedancer_tpu_torch.ops import sc25519, sc_cuda
from tests.test_torch_sc import MULADD_EDGES, REDUCE_EDGES

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "firedancer_tpu_torch" / "ops" / "csrc"
KERNEL = (CSRC / "sc_reduce.cu").read_text()
COMMON = (CSRC / "sha512.cuh").read_text()
THREADS = int(re.search(r"#define SC_THREADS (\d+)", KERNEL).group(1))
PAD = int(re.search(r"#define SC_PAD (\d+)", KERNEL).group(1))
L = sc25519.L
M32 = np.uint64(0xFFFFFFFF)
B = 8192
SENTINEL = 0xA5
RAGGED = [1, 31, 33, 63, 65, B - 3]
OFFSETS = [0, 8, 1]          # base addresses: 16-byte aligned, 8, odd
KINDS = ["reduce64", "muladd", "muladd_c"]


def _words(name: str) -> list:
    body = re.search(name + r"\[\d+\] = \{(.*?)\};", COMMON, re.S).group(1)
    return [int(v.rstrip("u"), 16) for v in re.findall(r"0x[0-9a-f]+u", body)]


SC_L, SC_MU = _words("SC_L"), _words("SC_MU")


def _join(words) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


# -- the carry chains, a lane per numpy element ------------------------------


class Chains:
    """sc_step, sc_mac, sc_sub8 over arrays of lanes: a word is a uint64
    array of values < 2^32. Counts the PTX instructions run."""

    def __init__(self):
        self.steps = 0

    def mac(self, na, nb, no, a, b, p):
        """sc_mac<NA, NB, NO>: p[0, NO) = (p + a b) mod 2^(32 NO), p below
        2^(32 NB) on entry."""
        assert all((w == 0).all() for w in p[nb:])
        for i in range(na):
            for par in (0, 1):
                w0 = i + par
                prods = (nb - par + 1) // 2
                full = 2 * prods + (1 if par + 2 * prods == nb else 0)
                m = min(full, no - w0)
                cf = np.uint64(0)
                for k in range(m):
                    if k >= 2 * prods:           # the chain's carry word
                        part = np.uint64(0)
                    else:
                        prod = (np.uint64(a[i]) * np.uint64(b[par + 2 * (k >> 1)]))
                        part = prod >> np.uint64(32) if k & 1 else prod & M32
                    t = p[w0 + k] + part + (cf if k else np.uint64(0))
                    assert (t >> np.uint64(33) == 0).all()   # a word + carry
                    if k < m - 1:
                        cf = t >> np.uint64(32)
                    elif m == full:
                        # The chain's natural end: its carry is zero.
                        assert (t >> np.uint64(32) == 0).all()
                    p[w0 + k] = t & M32
                    self.steps += 1
        return p

    def sub8(self, a, b):
        """sc_sub8: (a - b mod 2^256, 0xffffffff where a < b)."""
        d, bw = [], np.uint64(0)
        for k in range(8):
            sub = np.uint64(b[k]) + bw
            d.append((a[k] + (np.uint64(1) << np.uint64(32)) - sub) & M32)
            bw = (a[k] < sub).astype(np.uint64)
            self.steps += 1
        self.steps += 1
        return d, bw * M32

    def reduce512(self, x):
        """sc_reduce512 on 16 words a lane -> 8 words, canonical."""
        lanes = x[0].shape
        q2 = self.mac(9, 9, 18, x[7:16], SC_MU,
                      [np.zeros(lanes, np.uint64) for _ in range(18)])
        q3 = q2[9:]
        r2 = self.mac(4, 9, 8, SC_L[:4], q3,
                      [np.zeros(lanes, np.uint64) for _ in range(8)])
        r2[7] = (r2[7] + (q3[0] << np.uint64(28))) & M32
        r, _ = self.sub8(x[:8], r2)
        assert all(v < 3 * L for v in _ints(r))
        for _ in range(2):
            d, bw = self.sub8(r, SC_L)
            r = [np.where(bw != 0, rk, dk) for rk, dk in zip(r, d)]
        return r

    def muladd256(self, a, b, c):
        """muladd256: 8 words a, b, c -> 16 words a b + c."""
        lanes = a[0].shape
        p = list(c) + [np.zeros(lanes, np.uint64) for _ in range(8)]
        return self.mac(8, 8, 16, a, b, p)


def _ints(words) -> list:
    return [_join(col) for col in zip(*(w.tolist() for w in words))]


def _to_words(rows: np.ndarray) -> list:
    """(n, 4 k) uint8 little-endian rows -> k uint64 arrays of 32-bit
    words."""
    w = rows.reshape(rows.shape[0], -1, 4).astype(np.uint64)
    w = (w << (np.uint64(8) * np.arange(4, dtype=np.uint64))).sum(axis=2)
    return [w[:, k].astype(np.uint64) for k in range(w.shape[1])]


def _from_words(words) -> np.ndarray:
    w = np.stack(words, axis=1).astype(np.uint64)
    b = (w[:, :, None] >> (np.uint64(8) * np.arange(4, dtype=np.uint64))) & np.uint64(0xFF)
    return b.reshape(w.shape[0], -1).astype(np.uint8)


# -- the grid ----------------------------------------------------------------


def access_width(offsets) -> int:
    """sc_width: 16 when every pointer is 16-byte aligned, 8 when every
    one is 8-byte aligned, else 1."""
    ptrs = 0
    for o in offsets:
        ptrs |= o
    return 16 if ptrs % 16 == 0 else (8 if ptrs % 8 == 0 else 1)


def _accesses(b, rows, row_bytes, width):
    """Block b's accesses over its span of rows of row_bytes: access c is
    thread c % THREADS's step c // THREADS and reads bytes [width c,
    width (c + 1)) of the span."""
    c = np.arange(rows * row_bytes // width)
    # sc_stage_in's and sc_stage_out's unrolled steps a thread.
    assert (c // THREADS < row_bytes // width).all()
    return c


def _stage_index(c, words, width):
    """Byte offsets in the stage (row r at r (words + PAD) 8-byte words)
    that access c fills, as sc_stage_in / sc_stage_out place them."""
    pitch = 8 * (words + PAD)
    row_bytes = 8 * words
    first = c * width
    row, within = first // row_bytes, first % row_bytes
    return row[:, None] * pitch + within[:, None] + np.arange(width)


def _check_span(accesses, log, b, n, row_bytes, width, base):
    """The accesses of one block on one array: inside a live row,
    aligned to their width, contiguous in lane order within each warp
    and step."""
    first = b * THREADS * row_bytes + accesses * width
    rows_lo, rows_hi = first // row_bytes, (first + width - 1) // row_bytes
    assert (rows_lo == rows_hi).all() and (rows_hi < n).all()
    assert ((base + first) % width == 0).all()
    # Access c is lane c % THREADS of step c // THREADS: a warp's lanes in
    # one step read consecutive words of the span.
    assert (np.diff(first) == width).all()
    log.append((b, width, first))


def kernel_grid(kind, ins, offset, seed=0):
    """One launch of the kernel on n lanes: ins are the (n, 64) or
    (n, 32) inputs (a, b[, c] for sc_muladd; c absent is the null
    pointer), every pointer at base address `offset` (mod 16). Returns
    the output rows with THREADS rows of room past n, the accesses, and
    the chain's instruction count a lane."""
    rng = np.random.RandomState(seed)
    n = ins[0].shape[0]
    row_in = ins[0].shape[1]
    w_in = row_in // 8
    width = access_width([offset] * (len(ins) + 1))
    out = np.full((n + THREADS, 32), SENTINEL, np.uint8)
    log, lanes = [], [[] for _ in ins]
    blocks = -(-n // THREADS)
    for b in range(blocks):
        rows = min(THREADS, n - b * THREADS)
        for arr, got in zip(ins, lanes):
            # Stale bytes where nothing is copied.
            stage = rng.randint(0, 256, THREADS * 8 * (w_in + PAD), dtype=np.uint8)
            span = arr[b * THREADS:b * THREADS + rows].reshape(-1)
            c = _accesses(b, rows, row_in, width)
            _check_span(c, log, b, n, row_in, width, offset)
            stage[_stage_index(c, w_in, width)] = span[(c * width)[:, None]
                                                      + np.arange(width)]
            # Thread t < rows reads its row's words t (w + PAD) + k.
            idx = (np.arange(rows)[:, None] * (w_in + PAD)
                   + np.arange(w_in)) * 8
            got.append(stage[idx[:, :, None] + np.arange(8)].reshape(rows, -1))
    staged = [np.concatenate(g) for g in lanes]
    for arr, st in zip(ins, staged):
        np.testing.assert_array_equal(st, arr)
    ch = Chains()
    if kind == "reduce64":
        res = ch.reduce512(_to_words(staged[0]))
    else:
        a, bb = (_to_words(s) for s in staged[:2])
        c = (_to_words(staged[2]) if len(staged) == 3
             else [np.zeros(n, np.uint64) for _ in range(8)])
        res = ch.reduce512(ch.muladd256(a, bb, c))
    res_rows = _from_words(res)
    for b in range(blocks):
        rows = min(THREADS, n - b * THREADS)
        stage = rng.randint(0, 256, THREADS * 8 * (4 + PAD), dtype=np.uint8)
        idx = (np.arange(rows)[:, None] * (4 + PAD) + np.arange(4)) * 8
        stage[idx[:, :, None] + np.arange(8)] = res_rows[
            b * THREADS:b * THREADS + rows].reshape(rows, 4, 8)
        c = _accesses(b, rows, 32, width)
        _check_span(c, log, b, n, 32, width, offset)
        flat = out.reshape(-1)
        flat[b * THREADS * 32 + (c * width)[:, None] + np.arange(width)] = \
            stage[_stage_index(c, 4, width)]
    return out, log, ch.steps // n


# -- inputs ------------------------------------------------------------------


def _le(values, width):
    return np.array([list(v.to_bytes(width, "little")) for v in values],
                    np.uint8).reshape(len(values), width)


@pytest.fixture(scope="module")
def batches():
    """Inputs of B - 3 lanes (a launch of n takes the first n) with the
    edges planted first and again in the ragged last block, and the
    plain versions' outputs on them."""
    rng = np.random.RandomState(53)
    n = max(RAGGED)
    x = rng.randint(0, 256, (n, 64), dtype=np.uint8)
    x[:len(REDUCE_EDGES)] = x[-len(REDUCE_EDGES):] = _le(REDUCE_EDGES, 64)
    abc = [rng.randint(0, 256, (n, 32), dtype=np.uint8) for _ in range(3)]
    for k in range(3):
        col = _le([e[k] for e in MULADD_EDGES], 32)
        abc[k][:len(col)] = abc[k][-len(col):] = col
    t = [torch.from_numpy(v) for v in (x, *abc)]
    plain = {"reduce64": sc_cuda.sc_reduce64_ref(t[0]).numpy(),
             "muladd": sc_cuda.sc_muladd_ref(t[1], t[2]).numpy(),
             "muladd_c": sc_cuda.sc_muladd_ref(*t[1:]).numpy()}
    ins = {"reduce64": [x], "muladd": abc[:2], "muladd_c": abc}
    return ins, plain


def _python(kind, ins) -> list:
    v = [[int.from_bytes(r.tobytes(), "little") for r in a] for a in ins]
    if kind == "reduce64":
        return [x % L for x in v[0]]
    if kind == "muladd":
        return [a * b % L for a, b in zip(*v)]
    return [(a * b + c) % L for a, b, c in zip(*v)]


# -- tests -------------------------------------------------------------------


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("n", RAGGED)
@pytest.mark.parametrize("kind", KINDS)
def test_grid_matches_python_and_the_plain_versions(batches, kind, n, offset):
    """A launch at ragged n and base offset 0, 8 or 1: every access inside
    a live row, aligned and coalesced; lanes past n store nothing; every
    chain step fits; the bytes equal Python's % L and the plain
    version's."""
    ins, plain = batches
    cut = [a[:n] for a in ins[kind]]
    out, log, _ = kernel_grid(kind, cut, offset, seed=n + offset)
    assert (out[n:] == SENTINEL).all()
    assert {w for _, w, _ in log} == {access_width([offset])}
    np.testing.assert_array_equal(out[:n], plain[kind][:n])
    got = [int.from_bytes(r.tobytes(), "little") for r in out[:n]]
    assert got == _python(kind, cut)


@pytest.mark.parametrize("offset,width", [(0, 16), (16, 16), (8, 8), (24, 8),
                                          (4, 1), (1, 1), (7, 1)])
def test_access_width_follows_the_pointers(offset, width):
    """16-byte accesses where every pointer allows, else 8-byte, else
    bytes; a block's span starts at base + 64 or 32 bytes times a multiple
    of SC_THREADS, a multiple of 16, so the base decides for every
    block."""
    assert access_width([offset]) == width
    assert access_width([0, 0, offset, 0]) == width
    assert (THREADS * 32) % 16 == 0


@pytest.mark.parametrize("n", [1, THREADS - 1, THREADS, THREADS + 1, B - 3,
                               B, 2 * B])
def test_blocks_and_rows(n):
    """ceil(n / SC_THREADS) blocks; block b owns rows b SC_THREADS ..
    + min(SC_THREADS, n - b SC_THREADS) - 1, each row exactly once. At
    SC_THREADS = 64 the grid has 128 blocks at B (blocks of 128 gave 64)
    and 256 at 2B, at least one for each of the card's 132 SMs."""
    blocks = -(-n // THREADS)
    owned = np.concatenate([b * THREADS + np.arange(min(THREADS, n - b * THREADS))
                            for b in range(blocks)])
    np.testing.assert_array_equal(owned, np.arange(n))
    if n == B:
        assert blocks == B // THREADS and blocks >= 2 * B // 128
    if n == 2 * B:
        assert blocks >= 132


@pytest.mark.parametrize("words", [8, 4])
def test_stage_pitch_bank_map(words):
    """The padded pitch (W + SC_PAD 8-byte words, odd): a half-warp's
    8-byte reads or writes of word k of its 16 rows fall on 16 distinct
    bank pairs; the copies' 8- and 16-byte stage writes are at most
    two-way conflicted."""
    pitch = words + PAD
    assert pitch % 2 == 1
    for k in range(words):
        for half in range(0, THREADS, 16):
            lanes = np.arange(half, half + 16)
            assert len(set((lanes * pitch + k) % 16)) == 16
    for width in (8, 16):
        # A 16-byte access moves as two 8-byte stage words, one an
        # instruction: each instruction's half-warp hits these pairs.
        c = np.arange(THREADS * words * 8 // width)
        first = _stage_index(c, words, width)[:, 0] // 8
        for h in range(0, len(c), 16):
            assert np.bincount(first[h:h + 16] % 16).max() <= 2


def test_chain_steps_and_constants():
    """SC_L and SC_MU are L and floor(2^512 / L); the chains run 246 PTX
    instructions for sc_reduce512 and 136 for muladd256 a lane, none
    wider than a word and its carry."""
    assert _join(SC_L) == L and _join(SC_MU) == (1 << 512) // L
    assert len(SC_MU) == 9 and SC_L[4:7] == [0, 0, 0] and SC_L[7] == 1 << 28
    ch = Chains()
    x = [np.array([0xFFFFFFFF], np.uint64) for _ in range(16)]
    ch.reduce512(x)
    assert ch.steps == 246
    ch = Chains()
    ones = [np.array([0xFFFFFFFF], np.uint64) for _ in range(8)]
    ch.muladd256(ones, ones, ones)
    assert ch.steps == 136


@pytest.mark.parametrize("seed", range(4))
def test_chains_on_random_and_extreme_words(seed):
    """The chains alone on 2,000 lanes of random words, words of all ones,
    and the largest a b + c: Python's % L, every step asserted."""
    rng = np.random.RandomState(seed)
    a, b, c = (rng.randint(0, 2**32, (8, 2000), dtype=np.uint64)
               for _ in range(3))
    for k in range(8):
        a[k, :3] = b[k, :3] = c[k, :3] = 0xFFFFFFFF
        a[k, 3] = 0
    ch = Chains()
    p = ch.muladd256(list(a), list(b), list(c))
    pv = _ints(p)
    assert pv == [_join(x) * _join(y) + _join(z) for x, y, z in
                  zip(zip(*a.tolist()), zip(*b.tolist()), zip(*c.tolist()))]
    r = ch.reduce512(p)
    assert _ints(r) == [v % L for v in pv]
    x = list(rng.randint(0, 2**32, (16, 2000), dtype=np.uint64))
    assert _ints(ch.reduce512(x)) == [v % L for v in _ints(x)]


def test_kernels_run_the_one_shared_reduction():
    """sc_reduce.cu stages through shared memory and reduces with
    sha512.cuh's muladd256 and sc_reduce512, on carry chains: no u128 in
    either file and no second copy of the Barrett constants in csrc/."""
    assert '#include "sha512.cuh"' in KERNEL
    assert "muladd256(a, b, c, x);" in KERNEL
    assert KERNEL.count("sc_reduce512(x, r);") == 2
    assert "__shared__" in KERNEL and "sc_stage_in<8>(xs" in KERNEL
    assert "u128" not in KERNEL and "u128" not in COMMON
    for op in ("mad.lo.cc.u32", "madc.hi.cc.u32", "addc.u32", "sub.cc.u32"):
        assert op in COMMON
    for src in CSRC.iterdir():
        if src.name != "sha512.cuh":
            text = src.read_text()
            assert "SC_MU" not in text and "sc_mac<" not in text, src.name
