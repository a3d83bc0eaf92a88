"""The warp-staged SHA-512 core of the port's hash kernels
(csrc/sha512_warp.cuh, run by csrc/sha512_mod_l.cu, csrc/frontend_rlc.cu
and csrc/sha512_batch.cu) transcribed warp by warp in Python.

No compiler runs here, so the transcription is the CPU's check of the
kernels' grid: which thread of which warp loads which bytes of which row
for each 128-byte block index, at the load width the kernel picks from the
rows' base address and max_len; the stage in shared memory (stale words
left where nothing was read); each lane's padding and length word, the
warp's block count and the finished-lane select; the stores. Every load
is asserted to start below its row's clamped length and end inside the
row (below max_len), to be aligned to its width and coalesced across the
warp; lanes past n store nothing. The outputs are held byte for byte to
hashlib and to the plain versions (sha512_mod_l_ref, frontend_rlc_ref,
sha512_batch_ref), which chip_smoke.py holds the kernels to on the card.
"""

import hashlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from firedancer_tpu_torch.ops import frontend_cuda, sc25519
from firedancer_tpu_torch.ops import sha512 as plain_sha

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "firedancer_tpu_torch" / "ops" / "csrc"
CORE = CSRC / "sha512_warp.cuh"
PITCH = int(re.search(r"#define SW_PITCH (\d+)", CORE.read_text()).group(1))
WARPS = int(re.search(r"#define SW_WARPS (\d+)", CORE.read_text()).group(1))
L = sc25519.L
M64 = (1 << 64) - 1
K = np.array(plain_sha.K, np.uint64)
IV = np.array(plain_sha.IV, np.uint64)
RAGGED = [0, 111, 112, 239, 240, 1231]
STRIDES = [256, 257, 1299]
SENTINEL = 0xA5


def _rotr(x, n):
    return (x >> np.uint64(n)) | (x << np.uint64(64 - n))


def _rounds(st, w):
    """sw_rounds on the 32 lanes at once (numpy uint64 wraps mod 2^64):
    rounds 0-15, then four passes of 16 updating the ring in place."""
    a, b, c, d, e, f, g, h = st.copy()
    w = w.copy()
    for t in range(80):
        j = t & 15
        if t >= 16:
            w15, w2 = w[(j + 1) & 15], w[(j + 14) & 15]
            w[j] = (w[j] + (_rotr(w15, 1) ^ _rotr(w15, 8) ^ (w15 >> np.uint64(7)))
                    + w[(j + 9) & 15]
                    + (_rotr(w2, 19) ^ _rotr(w2, 61) ^ (w2 >> np.uint64(6))))
        t1 = (h + (_rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41))
              + ((e & f) ^ (~e & g)) + K[t] + w[j])
        t2 = ((_rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39))
              + ((a & b) ^ (a & c) ^ (b & c)))
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + t2
    return st + np.stack([a, b, c, d, e, f, g, h])


class Warp:
    """One warp of the kernel: rows row0 .. row0 + 31 of a launch whose
    rows start at address `base` (any value: only its residues matter)."""

    def __init__(self, mem, base, stride, lens, n, row0, loads):
        self.mem, self.base, self.stride = mem, base, stride
        self.n, self.row0, self.loads = n, row0, loads
        i = row0 + np.arange(32)
        raw = np.where(i < n, lens[np.minimum(i, n - 1)], 0)
        self.len = np.clip(raw, 0, stride)
        self.nb = (self.len + 144) >> 7
        self.wide = ((base | stride) & 15) == 0

    def addr(self, r):
        return self.base + (self.row0 + r) * self.stride

    def load(self, instr, lane, r, pos, width, slot=None):
        """A load of `width` bytes of row r at pos by thread `lane`: inside
        the row's max_len, starting below its clamped length, aligned to
        its width. slot: the address of the aligned word a byte load is
        part of (the coalescing check reads it)."""
        assert 0 <= pos and pos + width <= self.stride
        assert pos < self.len[r]
        assert (self.addr(r) + pos) % width == 0
        self.loads.append((instr, lane, r, self.addr(r) + pos if slot is None
                           else slot, width))
        off = self.addr(r) - self.base + pos
        return self.mem[off:off + width]

    def word(self, instr, lane, r, o):
        """The aligned word at row offset o (o >= -3) as sw_stage reads
        it: one load inside the row, else its bytes in [0, len)
        (sw_bytes); zero from len on."""
        v = np.zeros(4, np.uint8)
        if o >= self.len[r]:
            return v
        if o >= 0 and o + 4 <= self.stride:
            return self.load(instr, lane, r, o, 4).copy()
        for b in range(4):
            if 0 <= o + b < self.len[r]:
                v[b] = self.load(instr, lane, r, o + b, 1,
                                 slot=self.addr(r) + o)[0]
        return v

    def stage(self, stage, k):
        """sw_stage: block k of the 32 rows into the stage, coalesced."""
        base = 128 * k
        if self.wide:
            for q in range(8):
                for lane in range(32):
                    r, c = 4 * q + (lane >> 3), lane & 7
                    pos = base + 16 * c
                    if pos < self.len[r]:
                        stage[r, 16 * c:16 * c + 16] = self.load(
                            (self.row0, k, q), lane, r, pos, 16)
            return
        for r in range(32):
            s = self.addr(r) % 4
            for lane in range(32):
                pos = base + 4 * lane
                if pos >= self.len[r]:
                    continue
                lo = self.word((self.row0, k, r, 0), lane, r, pos - s)
                hi = (self.word((self.row0, k, r, 1), lane, r, pos - s + 4)
                      if s else np.zeros(4, np.uint8))
                # __funnelshift_r(lo, hi, 8 s): bytes s..s+3 of hi:lo.
                stage[r, 4 * lane:4 * lane + 4] = np.concatenate([lo, hi])[
                    s:s + 4]

    def words(self, stage, k):
        """sw_words: each lane's 16 big-endian words of block k, padded
        in registers (masks, 0x80, the bit length in its last block)."""
        w = stage[:, :128].reshape(32, 16, 8)
        w = w.astype(np.uint64) << (8 * np.arange(7, -1, -1, dtype=np.uint64))
        w = np.bitwise_or.reduce(w, axis=2).T.copy()       # (16, 32)
        for j in range(16):
            off = self.len - (128 * k + 8 * j)
            o = np.clip(off, 0, 7).astype(np.uint64)
            keep = np.where(o == 0, np.uint64(0),
                            np.uint64(M64) << (np.uint64(64) - 8 * o))
            pad = np.where(off >= 0, np.uint64(0x80) << (np.uint64(56) - 8 * o),
                           np.uint64(0))
            w[j] = np.where(off < 8, (w[j] & keep) | pad, w[j])
        last = k == self.nb - 1
        w[15] = np.where(last, self.len.astype(np.uint64) << np.uint64(3), w[15])
        return w

    def hash(self, rng):
        """sw_hash: the warp loops to its largest block count; a finished
        lane keeps its state by a select. The stage starts with garbage
        and keeps whatever a block index did not overwrite."""
        stage = rng.randint(0, 256, (32, 4 * PITCH), dtype=np.uint8)
        st = np.repeat(IV[:, None], 32, axis=1)
        for k in range(int(self.nb.max())):
            self.stage(stage, k)
            ns = _rounds(st, self.words(stage, k))
            st = np.where(k < self.nb, ns, st)
        return st


def kernel_grid(msgs, lens, n, stride, base, warps, z=None, s=None,
                seed=0, digest=False):
    """The launch: ceil(n / 32 W) blocks of W warps; a warp wholly past n
    returns at once; each live lane stores h (and m, zs for the RLC
    front half; or, with digest, as sha512_batch.cu does, its 64-byte
    digest as eight 8-byte stores of the byte-swapped state words) into
    sentinel-filled outputs with room past n. Returns the outputs, the
    digests and every load."""
    rng = np.random.RandomState(seed)
    mem = msgs.reshape(-1)
    blocks = -(-n // (32 * warps))
    outs = [np.full((n + 32 * warps, 64 if digest else 32), SENTINEL,
                    np.uint8) for _ in range(1 if z is None else 3)]
    digests = np.zeros((n, 64), np.uint8)
    loads = []
    for g in range(blocks * warps):
        row0 = 32 * g
        if row0 >= n:
            continue
        warp = Warp(mem, base, stride, lens, n, row0, loads)
        st = warp.hash(rng)
        for lane in range(32):
            i = row0 + lane
            if i >= n:
                continue
            dig = b"".join(int(v).to_bytes(8, "big") for v in st[:, lane])
            digests[i] = np.frombuffer(dig, np.uint8)
            if digest:
                for q in range(8):
                    # sha512_digest_le: word q byte-swapped, stored LE.
                    sw = int.from_bytes(int(st[q, lane]).to_bytes(8, "big"),
                                        "little")
                    outs[0][i, 8 * q:8 * q + 8] = np.frombuffer(
                        sw.to_bytes(8, "little"), np.uint8)
                continue
            h = int.from_bytes(dig, "little") % L
            vals = [h]
            if z is not None:
                zi = int.from_bytes(z[i].tobytes(), "little")
                si = int.from_bytes(s[i].tobytes(), "little")
                vals += [zi * h % L, zi * si % L]
            for out, v in zip(outs, vals):
                out[i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    return outs, digests, loads


def _batch(n, stride, seed):
    """n rows of `stride` bytes; the ragged lengths, max_len and two
    out-of-range lengths in the first warp, random lengths elsewhere."""
    rng = np.random.RandomState(seed)
    msgs = rng.randint(0, 256, (n, stride), dtype=np.uint8)
    lens = rng.randint(0, stride + 1, n).astype(np.int32)
    head = RAGGED + [stride, -3, stride + 7]
    lens[:min(n, len(head))] = head[:n]
    z = rng.randint(0, 256, (n, 32), dtype=np.uint8)
    z[:, 16:] = 0
    z[::5] = 0
    s = rng.randint(0, 256, (n, 32), dtype=np.uint8)
    return msgs, lens, z, s


@pytest.fixture(scope="module")
def plain():
    """One 100-row batch a stride and its plain versions' outputs
    (sha512_mod_l_ref's h, frontend_rlc_ref's h, m, zs); a launch of n
    rows takes the first n (the plain versions work row by row)."""
    out = {}
    for stride in STRIDES:
        msgs, lens, z, s = _batch(100, stride, seed=stride)
        tm, tl = torch.from_numpy(msgs), torch.from_numpy(lens)
        ref = (frontend_cuda.sha512_mod_l_ref(tm, tl).numpy(),
               *(t.numpy() for t in frontend_cuda.frontend_rlc_ref(
                   tm, tl, torch.from_numpy(z), torch.from_numpy(s))))
        out[stride] = (msgs, lens, z, s, ref)
    return out


def _check_coalesced(loads):
    """Each load instruction's threads that read one row read contiguous
    addresses in lane order: 16 bytes apart in a wide launch, else 4 (a
    thread's word, or the aligned word its bytes belong to)."""
    first = {}
    for instr, lane, r, addr, width in loads:
        first.setdefault((instr, r), {}).setdefault(lane, (addr, width))
    for lanes in first.values():
        order = sorted(lanes)
        step = 16 if lanes[order[0]][1] == 16 else 4
        for a, b in zip(order, order[1:]):
            assert lanes[b][0] - lanes[a][0] == step * (b - a)


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("n", [1, 31, 33, 100])
def test_warp_grid_matches_hashlib_and_plain_versions(plain, n, stride):
    """The kernels' grid at ragged n and odd strides, byte for byte:
    digests against hashlib, h against sha512_mod_l_ref, (h, m, zs)
    against frontend_rlc_ref; lanes past n store nothing."""
    msgs, lens, z, s, ref = plain[stride]
    msgs, lens, z, s = msgs[:n], lens[:n], z[:n], s[:n]
    outs, digests, loads = kernel_grid(msgs, lens, n, stride, base=0,
                                       warps=WARPS, z=z, s=s, seed=n)
    for i in range(n):
        ln = min(max(int(lens[i]), 0), stride)
        assert digests[i].tobytes() == hashlib.sha512(
            msgs[i, :ln].tobytes()).digest()
    for out in outs:
        assert (out[n:] == SENTINEL).all()
    np.testing.assert_array_equal(outs[0][:n], ref[0][:n])
    for got, want in zip(outs, ref[1:]):
        np.testing.assert_array_equal(got[:n], want[:n])
    _check_coalesced(loads)
    widths = {w for *_, w in loads}
    assert widths <= ({16} if stride % 16 == 0 else {4, 1})
    if n >= 31 and stride % 16:
        assert widths == {4, 1}


@pytest.mark.parametrize("base,stride,widths", [
    (0, 256, {16}), (0, 1296, {16}), (3, 256, {4, 1}), (4, 260, {4}),
    (8, 1296, {4}), (0, 257, {4, 1}), (2, 1300, {4, 1}), (1, 1299, {4, 1})])
def test_load_width_follows_the_row_alignment(base, stride, widths):
    """The width the kernel picks: 16-byte loads when the rows' base and
    stride are multiples of 16; else aligned 4-byte loads (two a thread,
    funnel-shifted, for rows off a 4-byte boundary), with bytes only for
    the words that reach past either end of a row. Full-length rows: no
    load reaches max_len, whatever the width."""
    n = 40
    rng = np.random.RandomState(base + stride)
    msgs = rng.randint(0, 256, (n, stride), dtype=np.uint8)
    lens = np.full(n, stride, np.int32)
    lens[:6] = RAGGED
    outs, digests, loads = kernel_grid(msgs, lens, n, stride, base=base,
                                       warps=1)
    assert {w for *_, w in loads} == widths
    for i in range(n):
        ln = min(int(lens[i]), stride)
        assert digests[i].tobytes() == hashlib.sha512(
            msgs[i, :ln].tobytes()).digest()
    _check_coalesced(loads)


@pytest.mark.parametrize("warps", [1, 2, 4])
def test_blocks_of_warps_store_each_lane_once(plain, warps):
    """Blocks of 1, 2 or 4 warps: ceil(n / 32 W) blocks, warps wholly
    past n load nothing, every lane below n is stored once."""
    n = 33
    msgs, lens, _, _, ref = plain[257]
    outs, _, loads = kernel_grid(msgs[:n], lens[:n], n, 257, base=0,
                                 warps=warps)
    assert max(addr + width for *_, addr, width in loads) <= n * 257
    assert (outs[0][n:] == SENTINEL).all()
    np.testing.assert_array_equal(outs[0][:n], ref[0][:n])


def test_block_counts_and_the_finished_lane_select():
    """Lanes of lengths 0-1296 take 1 to 11 blocks; the warp runs the
    largest count, and a lane's state stops at its own count."""
    lens = np.array(RAGGED + [1296] + list(range(0, 1300, 52))[:25],
                    np.int32)
    w = Warp(np.zeros(32 * 1296, np.uint8), 0, 1296, lens, 32, 0, [])
    assert w.nb.tolist() == [(min(v, 1296) + 17 + 127) // 128 for v in lens]
    assert w.nb.min() == 1 and w.nb.max() == 11
    for ln in (111, 112, 239, 240):
        assert (ln + 144) >> 7 == (2 if ln >= 112 else 1) + (ln >= 240)


def test_stage_pitch_is_conflict_free():
    """The stage's row pitch: a quarter-warp's 16-byte loads of their own
    rows hit eight distinct 16-byte bank groups, a row's 32 4-byte stores
    32 distinct banks, and a row's words stay 16-byte aligned."""
    assert PITCH % 4 == 0 and PITCH >= 32
    for q in range(8):
        for quarter in range(4):
            lanes = range(8 * quarter, 8 * quarter + 8)
            assert len({(lane * PITCH // 4 + q) % 8 for lane in lanes}) == 8
    for r in range(32):
        assert len({(r * PITCH + lane) % 32 for lane in range(32)}) == 32


def test_padding_at_every_length_of_up_to_three_blocks():
    """Every length 0-300 in one launch (ten warps at stride 301, a row
    in four on a 4-byte boundary): the 0x80 byte at each offset of a word and of a
    block, the length word alone in a block (lengths 112-127, 240-255)
    and the warp's lanes on one, two or three blocks, byte for byte
    against hashlib and sha512_mod_l_ref."""
    n = stride = 301
    rng = np.random.RandomState(5)
    msgs = rng.randint(0, 256, (n, stride), dtype=np.uint8)
    lens = np.arange(n, dtype=np.int32)
    outs, digests, loads = kernel_grid(msgs, lens, n, stride, base=0,
                                       warps=1)
    for i in range(n):
        assert digests[i].tobytes() == hashlib.sha512(
            msgs[i, :i].tobytes()).digest()
    want = frontend_cuda.sha512_mod_l_ref(torch.from_numpy(msgs),
                                          torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(outs[0][:n], want)
    assert (outs[0][n:] == SENTINEL).all()
    _check_coalesced(loads)


@pytest.mark.parametrize("stride,base", [
    (32, 0), (32, 1), (224, 3), (256, 0), (256, 5), (1299, 7), (1344, 0),
    (1344, 9)])
def test_digest_grid_matches_hashlib_and_sha512_batch_ref(stride, base):
    """sha512_batch.cu's grid (the core with the digest stores) at
    signing's seed rows (32), prefix || msg at (s1) (224), the main
    path's 256-byte rows, stride 1299 and signing's 1344-byte rows, on
    aligned and odd base addresses, n = 33 with the ragged lengths, 0,
    max_len and out-of-range lengths: each live lane's 64 bytes equal
    hashlib's digest and sha512_batch_ref's, nothing is stored past n,
    and every load stays inside its row below its clamped length."""
    n = 33
    msgs, lens, _, _ = _batch(n, stride, seed=stride + base)
    outs, digests, loads = kernel_grid(msgs, lens, n, stride, base=base,
                                       warps=WARPS, digest=True)
    out = outs[0]
    assert len(outs) == 1 and (out[n:] == SENTINEL).all()
    np.testing.assert_array_equal(out[:n], digests)
    for i in range(n):
        ln = min(max(int(lens[i]), 0), stride)
        assert out[i].tobytes() == hashlib.sha512(
            msgs[i, :ln].tobytes()).digest()
    want = frontend_cuda.sha512_batch_ref(torch.from_numpy(msgs),
                                          torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(out[:n], want)
    _check_coalesced(loads)
    widths = {w for *_, w in loads}
    assert widths and widths <= ({16} if (base | stride) % 16 == 0
                                 else {4, 1})


def test_hash_kernels_run_the_warp_core():
    """K1, frontend_rlc and sha512_batch are entries over sw_hash, launched
    on sw_blocks(n) blocks of SW_WARPS warps; no one-thread SHA-512 is
    left in sha512.cuh."""
    for name in ("sha512_mod_l", "frontend_rlc", "sha512_batch"):
        src = (CSRC / f"{name}.cu").read_text()
        assert '#include "sha512_warp.cuh"' in src, name
        assert "sw_hash(stage + wid * SW_STAGE" in src, name
        assert "<<<sw_blocks(n), 32 * SW_WARPS" in src, name
    common = (CSRC / "sha512.cuh").read_text()
    assert "sha512_row" not in common and "sha512_block" not in common
