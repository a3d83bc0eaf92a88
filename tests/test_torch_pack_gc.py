"""The port's graph-coloring pack scheduler against the JAX package's
``ops/pack_gc.py``, on the same inputs.

* ``hash_account`` (and its vectorised form) and ``build_arrays`` give
  the JAX arrays.
* ``pack_schedule_ref`` gives the JAX ``pack_schedule``'s colors exactly
  on the cases of ``tests/test_pack_gc.py`` (dense and sparse conflicts,
  disjoint txns, writers that serialise, readers that share, the CU cap,
  equal scores, padding) at two JAX shapes, so that XLA:CPU compiles
  twice: N = 64, C = 8, H = 256, AW = AR = 4, and the pack tile's
  C = 64, H = 4096, AW = AR = 35 on mainnet-shaped and conflicting
  blocks. ``schedule_block``'s waves and leftover are the JAX ones.
* ``csrc/pack_gc.cu``'s algorithm, transcribed (each color tests only the
  transaction's own buckets, b >= 0 and b / 32 < H / 32; the least free
  color takes it; CU sums wrap at 32 bits), gives the plain version's
  colors at odd C, H and widths, with buckets past the last word, no
  accounts and CU sums past 2^31; the wrapper's launch geometry is the
  kernel's, and it refuses CPU tensors.
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


@pytest.mark.parametrize("block", ["mainnet", "conflicts"])
def test_colors_equal_jax_at_the_tiles_shape(block):
    """C = 64, H = 4096, AW = AR = MAX_ACCT_CNT: the pack tile's shape."""
    def txns(m):
        if block == "mainnet":
            return _mainnet_block(m)
        return _mk_txns(m, 64, n_accounts=40, seed=9, max_w=12, max_r=20)

    kw = {"h_bits": PATH["h_bits"], "max_w": MAX_ACCT_CNT,
          "max_r": MAX_ACCT_CNT}
    ja = _arrays(jgc, txns(jpack), 64, **kw)
    pa = _arrays(pgc, txns(ppack), 64, **kw)
    for a, b in zip(ja, pa):
        assert np.array_equal(a, b)
    assert np.array_equal(_port_colors(pa, PATH), _jax_colors(ja, PATH))


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


def _kernel_model(w, r, s, cu, n_colors, h_bits, cu_cap):
    """pack_schedule_kernel's step, transcribed: the transaction's own
    buckets against each color, the least free color, the bits set."""
    n, aw = w.shape
    n_words = h_bits // 32
    used_w = np.zeros((n_colors, n_words + 1), np.uint32)
    used_r = np.zeros_like(used_w)
    cu_used = [0] * n_colors
    colors = np.full(n, -7, np.int32)
    for o in torch.sort(-torch.from_numpy(s), stable=True).indices.tolist():
        idx = [(k < aw, int(b)) for k, b in enumerate([*w[o], *r[o]])
               if b >= 0 and (b >> 5) < n_words]
        m = n_colors
        for c in range(n_colors):
            conflict = any(
                (used_w[c, b >> 5] | (used_r[c, b >> 5] if is_w else 0))
                >> (b & 31) & 1 for is_w, b in idx)
            if _wrap32(cu_used[c] + int(cu[o])) > cu_cap:
                conflict = True
            if not conflict:
                m = min(m, c)
        if m < n_colors:
            for is_w, b in idx:
                (used_w if is_w else used_r)[m, b >> 5] |= np.uint32(
                    1 << (b & 31))
            cu_used[m] = _wrap32(cu_used[m] + int(cu[o]))
        colors[o] = m if m < n_colors else -1
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
    assert pack_gc_cuda.geometry(64, 4096, 70) == (256, 66864)
    assert pack_gc_cuda.geometry(8, 256, 8) == (256, 4 * (2 * 8 * 9 + 8 + 16))
    assert pack_gc_cuda.geometry(1, 4096, 70) == (96, 4 * (2 * 129 + 1 + 140))
    assert pack_gc_cuda.geometry(300, 64, 2)[0] == 320


def test_wrapper_refuses_cpu_tensors():
    a = torch.zeros(4, 2, dtype=torch.int32)
    s, c = torch.zeros(4), torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pack_gc_cuda.pack_schedule_cuda(a, a, s, c, **PATH)
