"""The port's graph-coloring pack scheduler against the JAX package's
``ops/pack_gc.py``, on the same inputs.

* ``hash_account`` (and its vectorised form) and ``build_arrays`` give
  the JAX arrays.
* ``pack_schedule_ref`` gives the JAX ``pack_schedule``'s colors exactly
  on the cases of ``tests/test_pack_gc.py`` (dense and sparse conflicts,
  disjoint txns, writers that serialise, readers that share, the CU cap,
  equal scores, padding) at three JAX shapes, so that XLA:CPU compiles
  three times: N = 64, C = 8, H = 256, AW = AR = 4, and C = 64, AW = AR
  = 35 on mainnet-shaped and conflicting blocks at the pack tile's H =
  4096 and ``bench.py`` ``pack_worker``'s H = 8192.
  ``schedule_block``'s waves and leftover are the JAX ones.
* ``csrc/pack_gc.cu``'s algorithm, transcribed (the compaction of each
  sorted row's valid buckets, b >= 0 and b / 32 < H / 32, into a record;
  per-bucket write and read masks of K = ceil(C / 64) words; the lanes'
  CU ballot, CU sums wrapping at 32 bits; the least free color as the
  first set bit), gives the plain version's colors at odd C (K = 1 and
  2), H and widths, with buckets past the last word, rows of more than
  29 buckets, no accounts and CU sums past 2^31; the wrapper's launch
  geometry is the kernel's, it refuses what its shared memory cannot
  hold, and it refuses CPU tensors.
"""

import random
from pathlib import Path

import numpy as np
import pytest
import torch

from firedancer_tpu.ballet import pack as jpack
from firedancer_tpu.ops import pack_gc as jgc
from firedancer_tpu_torch.ballet import pack as ppack
from firedancer_tpu_torch.ballet.txn import MAX_ACCT_CNT
from firedancer_tpu_torch.disco import tiles as ptiles
from firedancer_tpu_torch.ops import backend
from firedancer_tpu_torch.ops import pack_gc as pgc
from firedancer_tpu_torch.ops import pack_gc_cuda

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
MAINNET = ([p.read_bytes() for p in sorted(FIXTURES.glob("transaction*.bin"))]
           + [p.read_bytes()
              for p in sorted((FIXTURES / "txn_pack").glob("*.bin"))])
SMALL = {"n_colors": 8, "h_bits": 256, "cu_cap": 12_000_000}
PATH = {"n_colors": 64, "h_bits": 4096, "cu_cap": 12_000_000}


def _mk_txns(mod, n, n_accounts=256, seed=0, max_w=4, max_r=4):
    """tests/test_pack_gc.py's _mk_txns, for either package's PackTxn."""
    rng = random.Random(seed)
    keys = [bytes([i % 256]) * 4 + i.to_bytes(4, "little") + bytes(24)
            for i in range(n_accounts)]
    txns = []
    for i in range(n):
        w = frozenset(rng.sample(keys, rng.randint(1, max_w)))
        r = frozenset(
            k for k in rng.sample(keys, rng.randint(0, max_r)) if k not in w)
        txns.append(mod.PackTxn(txn_id=i, rewards=rng.randint(1_000, 2_000_000),
                                est_cus=rng.randint(10_000, 1_400_000),
                                writable=w, readonly=r))
    return txns


def _one(mod, i, rewards=1000, cus=1000, w=(), r=()):
    return mod.PackTxn(txn_id=i, rewards=rewards, est_cus=cus,
                       writable=frozenset(w), readonly=frozenset(r))


def _key(i):
    return i.to_bytes(4, "little") + bytes(28)


CASES = {
    "dense_conflicts": lambda m: _mk_txns(m, 64, n_accounts=24, seed=1),
    "sparse_conflicts": lambda m: _mk_txns(m, 64, n_accounts=4096, seed=2),
    "disjoint": lambda m: [_one(m, i, w=[_key(i)]) for i in range(64)],
    "writers_serialise": lambda m: [
        _one(m, i, rewards=1000 * (i + 1), w=[bytes(32)]) for i in range(12)],
    "readers_share": lambda m: [_one(m, i, r=[bytes(32)]) for i in range(16)],
    "cu_cap": lambda m: [_one(m, i, cus=9_000_000, w=[_key(i)])
                         for i in range(12)],
    "equal_scores": lambda m: [
        _one(m, t.txn_id, w=t.writable, r=t.readonly)
        for t in _mk_txns(m, 40, n_accounts=16, seed=5)],
    "padding": lambda m: [],
}


def _arrays(mod, txns, n, **kw):
    """build_arrays of txns padded with PackTxnPad to n rows."""
    txns = list(txns) + [mod.PackTxnPad] * (n - len(txns))
    return mod.build_arrays(txns, **kw)


def _jax_colors(arrays, params):
    return np.asarray(jgc.pack_schedule(*arrays, **params))


def _port_colors(arrays, params):
    return pgc.pack_schedule(*(torch.from_numpy(a) for a in arrays),
                             **params).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_colors_equal_jax_small(case):
    kw = {"h_bits": SMALL["h_bits"], "max_w": 4, "max_r": 4}
    ja = _arrays(jgc, CASES[case](jpack), 64, **kw)
    pa = _arrays(pgc, CASES[case](ppack), 64, **kw)
    for a, b in zip(ja, pa):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    want = _jax_colors(ja, SMALL)
    got = _port_colors(pa, SMALL)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    if case == "cu_cap":
        assert (got[:12] >= 0).sum() == 8       # one 9M txn a color
    if case == "padding":
        assert (got == 0).all()


def _mainnet_block(mod_txns):
    est = ppack.CuEstimator()
    out = []
    for p in MAINNET:
        t = ptiles.pack_txn(p, len(out), est)
        if t is not None:
            out.append(mod_txns.PackTxn(t.txn_id, t.rewards, t.est_cus,
                                        t.writable, t.readonly))
    return out[:64]


@pytest.mark.parametrize("h_bits", [4096, 8192])
@pytest.mark.parametrize("block", ["mainnet", "conflicts"])
def test_colors_equal_jax_at_the_tiles_shape(block, h_bits):
    """C = 64, AW = AR = MAX_ACCT_CNT, H = 4096 (the pack tile's shape)
    and 8192 (bench.py pack_worker's)."""
    params = {**PATH, "h_bits": h_bits}
    def txns(m):
        if block == "mainnet":
            return _mainnet_block(m)
        return _mk_txns(m, 64, n_accounts=40, seed=9, max_w=12, max_r=20)

    kw = {"h_bits": h_bits, "max_w": MAX_ACCT_CNT, "max_r": MAX_ACCT_CNT}
    ja = _arrays(jgc, txns(jpack), 64, **kw)
    pa = _arrays(pgc, txns(ppack), 64, **kw)
    for a, b in zip(ja, pa):
        assert np.array_equal(a, b)
    assert np.array_equal(_port_colors(pa, params), _jax_colors(ja, params))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_block_equal_jax(seed):
    kw = dict(n_colors=8, h_bits=256, pad_to=64, max_w=4, max_r=4)
    jw, jl = jgc.schedule_block(_mk_txns(jpack, 50, 32, seed), **kw)
    backend.reset_counts()
    pw, pl = pgc.schedule_block(_mk_txns(ppack, 50, 32, seed), device="cpu",
                                **kw)
    assert backend.plain_calls == {"pack_schedule": 1}

    def ids(ws):
        return [[t.txn_id for t in w] for w in ws]

    assert ids(pw) == ids(jw) and ids([pl]) == ids([jl])
    assert ppack.validate_schedule(pw)
    assert pgc.schedule_block([], device="cpu") == ([], [])


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_account_equal(seed):
    rng = np.random.RandomState(seed)
    keys = [rng.randint(0, 256, 32, dtype=np.uint8).tobytes()
            for _ in range(200)]
    for h_bits in (256, 4096, 1000):
        want = [jgc.hash_account(k, h_bits) for k in keys]
        assert [pgc.hash_account(k, h_bits) for k in keys] == want
        assert pgc.hash_accounts(keys, h_bits).tolist() == want
    mixed = [b"", b"\x01", bytes(32)]
    assert pgc.hash_accounts(mixed).tolist() == [
        jgc.hash_account(k) for k in mixed]


def _wrap32(x):
    return (int(x) + 2**31) % 2**32 - 2**31


def _records(w, r, s, cu, n_words):
    """pack_compact_kernel, transcribed: for each sorted position, the
    record of pack_gc_cuda.record_words(AW + AR) words (slots 0..28 the
    valid buckets as 2 b + read, -1 past the count; word 29 the CUs, 30
    the input index, 31 the count; slots 29.. from word 32), its slots
    placed by a ballot's prefix count over 32 columns at a time."""
    aw, ar = w.shape[1], r.shape[1]
    stride = pack_gc_cuda.record_words(aw + ar)
    order = torch.sort(-torch.from_numpy(s), stable=True).indices.tolist()
    recs = np.full((len(order), stride), 0x7EADBEEF, np.int64)
    for i, o in enumerate(order):
        cols = [*w[o], *r[o]]
        cnt = 0
        for base in range(0, aw + ar, 32):
            lanes = [(c, int(cols[c])) for c in range(base, min(base + 32,
                                                                aw + ar))]
            valid = [(c, b) for c, b in lanes if b >= 0 and b >> 5 < n_words]
            for t, (c, b) in enumerate(valid, start=cnt):
                recs[i, t if t < 29 else t + 3] = 2 * b + (c >= aw)
            cnt += len(valid)
        recs[i, cnt:29] = -1
        recs[i, 29:32] = int(cu[o]), o, cnt
    return recs


def _kernel_model(w, r, s, cu, n_colors, h_bits, cu_cap):
    """pack_scan_kernel's step over _records, transcribed: lane l holds
    word l of the record and the CU totals of colors l + 32 q; each
    lane's buckets gather W[b] | R[b] (a write) or W[b] (a read), K
    64-bit words a set, ORed across the lanes; the lanes' CU verdicts
    (int32 wrapping) make a ballot a 32 colors, colors >= C off; the
    least free color is the first set bit; its bit is ORed into each
    bucket's W or R, lane m % 32 adds the CUs, lane 30's index takes the
    color."""
    n_words = h_bits // 32
    kw = -(-n_colors // 64)
    masks = np.zeros((32 * n_words, 2, kw), np.uint64)     # [b][W, R][k]
    cu_used = [[0] * 32 for _ in range(2 * kw)]           # [q][lane], u32
    colors = np.full(len(s), -7, np.int32)
    for rec in _records(w, r, s, cu, n_words).tolist():
        cnt, c_row = rec[31], rec[29]
        ents = [rec[j] for j in range(29) if rec[j] >= 0]
        ents += [rec[32 + t] for t in range(max(cnt - 29, 0))]
        assert len(ents) == cnt
        conf = [0] * kw
        for e in ents:
            for k in range(kw):
                conf[k] |= int(masks[e >> 1, 0, k]) | (
                    0 if e & 1 else int(masks[e >> 1, 1, k]))
        m = -1
        for k in range(kw):
            ok = 0
            for half in range(2):
                q = 2 * k + half
                for lane in range(32):
                    if (32 * q + lane < n_colors and _wrap32(
                            cu_used[q][lane] + c_row) <= cu_cap):
                        ok |= 1 << (32 * half + lane)
            free = ~conf[k] & ok
            if m < 0 and free:
                m = 64 * k + (free & -free).bit_length() - 1
        if m >= 0:
            for e in ents:
                masks[e >> 1, e & 1, m >> 6] |= np.uint64(1 << (m & 63))
            q, lane = m >> 5, m & 31
            cu_used[q][lane] = (cu_used[q][lane] + c_row) % 2**32
        colors[rec[30]] = m
    return colors


@pytest.mark.parametrize("seed", range(6))
def test_kernel_algorithm_equals_plain(seed):
    rng = np.random.RandomState(seed)
    n_colors = [1, 3, 8, 64, 100, 5][seed]
    h_bits = [4096, 256, 100, 64, 4096, 32][seed]
    aw, ar = [(35, 35), (4, 4), (1, 0), (0, 3), (7, 2), (3, 3)][seed]
    n = [1, 31, 40, 64, 20, 33][seed]
    w = rng.randint(-1, rng.choice([8, 96, 4096]), (n, aw)).astype(np.int32)
    r = rng.randint(-1, rng.choice([8, 96, 4096]), (n, ar)).astype(np.int32)
    s = rng.rand(n).astype(np.float32)
    s[::3] = 0.5                                 # ties keep input order
    cu = rng.randint(0, 2**31 - 1, n).astype(np.int32)
    if seed % 2:
        cu = rng.randint(1, 3_000_000, n).astype(np.int32)
    params = {"n_colors": n_colors, "h_bits": h_bits, "cu_cap": 5_000_000}
    want = pgc.pack_schedule_ref(*(torch.from_numpy(a) for a in
                                   (w, r, s, cu)), **params).numpy()
    assert np.array_equal(_kernel_model(w, r, s, cu, **params), want)


def test_launch_geometry():
    """(scan threads, compaction blocks, their threads, 16 K H' bytes)."""
    assert pack_gc_cuda.geometry(64, 4096, 1024) == (32, 128, 256, 65536)
    assert pack_gc_cuda.geometry(64, 8192, 65536) == (32, 8192, 256, 131072)
    assert pack_gc_cuda.geometry(100, 4096, 20) == (32, 3, 256, 131072)
    assert pack_gc_cuda.geometry(5, 100, 33) == (32, 5, 256, 16 * 96)
    assert pack_gc_cuda.geometry(8, 31, 1) == (32, 1, 256, 16)  # 1 bucket
    assert [pack_gc_cuda.record_words(a) for a in (0, 6, 29, 30, 61, 62, 70)] \
        == [32, 32, 32, 64, 64, 96, 96]
    a = torch.zeros(4, 2, dtype=torch.int32)
    s, c = torch.zeros(4), torch.ones(4, dtype=torch.int32)
    for kw in ({"n_colors": 64, "h_bits": 16384},     # 256 KB of masks
               {"n_colors": 1025, "h_bits": 32}, {"n_colors": 0,
                                                  "h_bits": 256}):
        with pytest.raises(ValueError, match="shared memory"):
            pack_gc_cuda.pack_schedule_cuda(a, a, s, c, cu_cap=1, **kw)


def test_wrapper_refuses_cpu_tensors():
    a = torch.zeros(4, 2, dtype=torch.int32)
    s, c = torch.zeros(4), torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pack_gc_cuda.pack_schedule_cuda(a, a, s, c, **PATH)
