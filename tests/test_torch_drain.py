"""The port's fd_drain against the JAX package's, on the CPU.

* ``dedup_filter_ref`` gives the JAX ``dedup_filter``'s novel mask, new
  bank A and count exactly, on random tags, in-batch repeats, an invalid
  prefix and invalid lanes in the middle, the all-ones tag after and
  before invalid lanes, forced bucket collisions, tags with the top bits
  set and random banks, at h_bits 2^10 and 2^17 (B = 256, so XLA:CPU
  compiles twice), and over 8 chained rounds with one rotation.
* ``csrc/dedup_filter.cu``, transcribed (the table, the window A | B and
  the new bank; phase 1's atomics of every thread in a random
  interleaving, each thread's lanes in order, the invalid lanes' warp
  minimum; phase 2's first-occurrence test from the kept slots, the
  window, bank bits and per-warp counts), gives the plain version's
  outputs at ragged n on the same cases, at the wrapper's geometry and
  with 32, 64 and 256 threads in flight; the wrapper's table size, its
  choice of the one block or the grid, one output buffer, its refusals
  and that of CPU tensors.
* The contract tests of ``tests/test_drain.py`` on the port: one-sided
  against a window oracle, ``rot_quota``, ``DrainWindow`` rotation, both
  ``TCache`` novel paths and their tripwires against the JAX ``TCache``,
  the ctl word against the JAX ``encode_ctl``, and the dedup tile's bulk
  round against its per-frag path and the JAX tile with claimed frags.
* The pipeline: ``run_pipeline`` (``device="cpu"``, its default feed, the
  drain armed) against the JAX feed runner with ``FD_DRAIN=auto`` on the
  260-txn corpus of ``test_pipeline_drain_probe_parity`` (one sink
  multiset and filter total; probes skipped plus made equal the novel
  and maybe publishes; no false novel), once at the default TCache and
  once at a TCache of 8 whose quota rotates the window, and with
  ``drain_pack`` and the gc pack on the 48 txns of
  ``test_pipeline_drain_pack_device_accounting``
  (every block device-accepted or fallen back, at least one accepted).
"""

import random
from collections import Counter
from hashlib import sha256

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from firedancer_tpu.disco import drain as jdrain
from firedancer_tpu.disco import tiles as jtiles
from firedancer_tpu.ops import dedup_filter as jdf
from firedancer_tpu.tango import rings as jrings
from firedancer_tpu.tango import tcache as jtcache
from firedancer_tpu_torch.disco import drain as pdrain
from firedancer_tpu_torch.disco import engine as pengine
from firedancer_tpu_torch.disco import flight as pflight
from firedancer_tpu_torch.disco import pipeline as ppipe
from firedancer_tpu_torch.disco import tiles as ptiles
from firedancer_tpu_torch.ops import backend
from firedancer_tpu_torch.ops import dedup_filter as pdf
from firedancer_tpu_torch.ops import dedup_filter_cuda as pdf_cuda
from firedancer_tpu_torch.tango import rings as prings
from firedancer_tpu_torch.tango import tcache as ptcache

torch.set_num_threads(1)

B = 256
H_SMALL = 1 << 10
M32 = 0xFFFFFFFF
ALL_ONES = (1 << 64) - 1


# -- the filter against the JAX graph ------------------------------------------


def _bucket_py(tag: int, h_bits: int) -> int:
    """tests/test_drain.py's host mix, the JAX _bucket."""
    hi, lo = (tag >> 32) & M32, tag & M32
    mix = lo ^ ((hi * 0x9E3779B1) & M32)
    mix = ((mix ^ (mix >> 15)) * 0x85EBCA77) & M32
    mix ^= mix >> 13
    return mix & (h_bits - 1)


def _collider(tag: int, h_bits: int, start: int = 1) -> int:
    """The least tag >= start, other than tag, in tag's bucket (a
    vectorised search over small tags: hi = 0, so the mix is of lo)."""
    want = _bucket_py(tag, h_bits)
    while True:
        lo = np.arange(start, start + 4 * h_bits, dtype=np.uint64)
        with np.errstate(over="ignore"):
            mix = (lo ^ (lo >> np.uint64(15))) * np.uint64(0x85EBCA77)
        mix &= np.uint64(M32)
        mix ^= mix >> np.uint64(13)
        hit = lo[((mix & np.uint64(h_bits - 1)) == want) & (lo != tag)]
        if len(hit):
            assert _bucket_py(int(hit[0]), h_bits) == want
            return int(hit[0])
        start += 4 * h_bits


def _case(name: str, h_bits: int, seed: int = 0, n: int = B):
    """(tags uint64, valid bool, bits_a, bits_b int32 bit patterns)."""
    rng = np.random.RandomState(seed)
    tags = rng.randint(0, 2 ** 63, n, dtype=np.int64).astype(np.uint64)
    tags |= rng.randint(0, 2, n).astype(np.uint64) << np.uint64(63)
    valid = np.ones(n, np.bool_)
    w = h_bits // 32
    bits_a = np.zeros(w, np.uint32)
    bits_b = np.zeros(w, np.uint32)
    if name == "repeats":
        # Each of 40 values up to 9 times, spread over the batch.
        tags = tags[rng.randint(0, min(40, n), n)]
    elif name == "invalid_prefix":
        valid[:n // 5] = False
    elif name == "invalid_middle":
        valid[rng.rand(n) < 0.3] = False
        tags[n // 2:] = tags[:n - n // 2]      # repeats across them
    elif name == "sentinel":
        # The all-ones tag first on a valid lane, then after invalid
        # lanes; a second all-ones lane before any invalid one.
        tags[[3, 7, 60, 61, 200]] = np.uint64(ALL_ONES)
        valid[[10, 11, 100]] = False
    elif name == "sentinel_after_invalid":
        tags[[5, 90]] = np.uint64(ALL_ONES)
        valid[[2, 3]] = False
    elif name == "collisions":
        # Pairs of distinct tags in one bucket, within the batch and
        # against bank bits set by the first of a pair.
        for i in range(0, 60, 2):
            tags[i + 1] = np.uint64(_collider(int(tags[i]), h_bits,
                                              start=int(rng.randint(1, 9999))))
        b0 = _bucket_py(int(tags[100]), h_bits)
        bits_b[b0 >> 5] |= np.uint32(1 << (b0 & 31))
        tags[101] = np.uint64(_collider(int(tags[100]), h_bits))
    elif name == "banks":
        bits_a = rng.randint(0, 2 ** 32, w, dtype=np.uint64).astype(np.uint32)
        bits_a &= rng.randint(0, 2 ** 32, w, dtype=np.uint64).astype(np.uint32)
        bits_b = rng.randint(0, 2 ** 32, w, dtype=np.uint64).astype(np.uint32)
        bits_b &= rng.randint(0, 2 ** 32, w, dtype=np.uint64).astype(np.uint32)
        tags[n // 2:] = tags[:n - n // 2]
    elif name == "empty":
        valid[:] = False
    else:
        assert name == "random"
    return tags, valid, bits_a.view(np.int32), bits_b.view(np.int32)


def _port(tags, valid, bits_a, bits_b):
    hi, lo = pdf.split_tags(tags)
    novel, a_new, cnt = pdf.dedup_filter(
        torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(valid),
        torch.from_numpy(np.ascontiguousarray(bits_a)),
        torch.from_numpy(np.ascontiguousarray(bits_b)))
    return novel.numpy(), a_new.numpy(), int(cnt)


def _jax(tags, valid, bits_a, bits_b):
    hi, lo = jdf.split_tags(tags)
    novel, a_new, cnt = jdf.dedup_filter_jit(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid),
        jnp.asarray(bits_a.view(np.uint32)), jnp.asarray(bits_b.view(np.uint32)))
    return (np.asarray(novel), np.asarray(a_new).view(np.int32), int(cnt))


CASES = ["random", "repeats", "invalid_prefix", "invalid_middle",
         "sentinel", "sentinel_after_invalid", "collisions", "banks",
         "empty"]


@pytest.mark.parametrize("h_bits", [H_SMALL, 1 << 17], ids=["h10", "h17"])
@pytest.mark.parametrize("name", CASES)
def test_filter_ref_equals_jax(name, h_bits):
    args = _case(name, h_bits)
    novel, a_new, cnt = _port(*args)
    j_novel, j_a_new, j_cnt = _jax(*args)
    assert novel.dtype == np.bool_ and a_new.dtype == np.int32
    assert np.array_equal(novel, j_novel)
    assert np.array_equal(a_new, j_a_new)
    assert cnt == j_cnt == int(novel.sum())
    if name.startswith("sentinel"):
        tags, valid = args[0], args[1]
        ones = np.nonzero(tags == np.uint64(ALL_ONES))[0]
        first_invalid = np.nonzero(~valid)[0].min()
        # A valid all-ones lane is a first occurrence only before every
        # invalid lane, and only the first of them.
        for k, i in enumerate(ones):
            if i > first_invalid or k > 0:
                assert not novel[i], i


def test_filter_chained_rounds_with_rotation_equal_jax():
    """8 rounds of one window, bank A carried over, a rotation after
    round 4; each round draws tags from a pool so rounds repeat each
    other's tags."""
    rng = np.random.RandomState(3)
    pool = rng.randint(0, 2 ** 63, 700, dtype=np.int64).astype(np.uint64)
    p_a, p_b = (t.numpy() for t in pdf.empty_banks(H_SMALL))
    j_a = j_b = np.zeros(H_SMALL // 32, np.int32)
    for rnd in range(8):
        tags = pool[rng.randint(0, len(pool), B)]
        valid = rng.rand(B) > 0.1
        novel, p_new, cnt = _port(tags, valid, p_a, p_b)
        j_novel, j_new, j_cnt = _jax(tags, valid, j_a, j_b)
        assert np.array_equal(novel, j_novel), rnd
        assert np.array_equal(p_new, j_new) and cnt == j_cnt, rnd
        p_a, j_a = p_new, j_new
        if rnd == 3:
            p_a, p_b = np.zeros_like(p_a), p_a
            j_a, j_b = np.zeros_like(j_a), j_a
    assert 0 < cnt < B


def test_mix_takes_the_product_mod_2_32():
    """The int64 mix: hi * 0x9E3779B1 mod 2^32 without an int64
    overflow, on tags with the top bits set."""
    tags = np.array([ALL_ONES, 0xFFFFFFFF00000000, 0x8000000000000001,
                     0x7FFFFFFF80000000, 0x123456789ABCDEF0], np.uint64)
    hi, lo = pdf.split_tags(tags)
    got = pdf.bucket(torch.from_numpy(hi), torch.from_numpy(lo), 1 << 30)
    assert got.tolist() == [_bucket_py(int(t), 1 << 30) for t in tags]
    j_hi, j_lo = jdf.split_tags(tags)
    assert np.array_equal(hi.view(np.uint32), j_hi)
    assert np.array_equal(lo.view(np.uint32), j_lo)


def test_filter_words_and_banks():
    for good in (32, 1 << 10, 1 << 17):
        assert pdf.filter_words(good) == jdf.filter_words(good)
    for bad in (0, -32, 31, 48, 3 * 32):
        with pytest.raises(ValueError):
            pdf.filter_words(bad)
    a, b = pdf.empty_banks(1 << 17)
    assert a.dtype == b.dtype == torch.int32 and a.shape == (4096,)
    assert a.data_ptr() != b.data_ptr() and not a.any() and not b.any()
    assert pdf.DEFAULT_FILTER_BITS == jdf.DEFAULT_FILTER_BITS
    assert (pdf.MIX_A, pdf.MIX_B) == (jdf._MIX_A, jdf._MIX_B)


# -- the kernel's algorithm, transcribed -----------------------------------------


EMPTY = 0xFFFFFFFF


def _k_slot(key: int, mask: int) -> int:
    m64 = (1 << 64) - 1
    k = key
    k ^= k >> 30
    k = (k * 0xBF58476D1CE4E5B9) & m64
    k ^= k >> 27
    k = (k * 0x94D049BB133111EB) & m64
    k ^= k >> 31
    return k & mask


def _k_dedup_filter(tags, valid, bits_a, bits_b, seed, threads=None,
                    slots=None):
    """dedup_filter.cu at the wrapper's geometry, or with `threads` threads
    in flight over a table of `slots` slots where given: lane i on thread
    i mod threads (the one block's DF_THREADS threads; the grid's blocks
    of DF_GRID_THREADS, as many as cover the lanes and the window). The
    table starts empty, the window is A | B and the new bank A (the one
    block stages both, the grid reads them from global memory); phase 1
    runs every thread's lanes in order, the threads' atomics in a random
    interleaving (a lane's probe is a sequence of atomicCAS and at most one
    atomicMin), each lane's slot kept, a warp's least invalid lane into
    the least-invalid word; phase 2 reads the table at each lane's slot
    and the window, ORs the bits into the new bank and adds each warp's
    novel lanes to the count."""
    n = len(tags)
    keys = [int(t) for t in tags]
    valid = [bool(v) for v in valid]
    n_words = len(bits_a)
    h_bits = 32 * n_words
    route, g_t, smem, g_slots = pdf_cuda.geometry(n, h_bits)
    if route == "block":
        assert g_t == pdf_cuda.THREADS and n <= pdf_cuda.ONE_CTA_LANES
        assert smem == pdf_cuda.smem_bytes(n, h_bits, g_slots)
        assert smem <= pdf_cuda.SMEM_LIMIT
        g_threads = g_t
    else:
        assert (g_t, smem) == (pdf_cuda.GRID_THREADS, 0)
        g_threads = g_t * max(-(-n // g_t), -(-n_words // g_t), 1)
    nt = g_threads if threads is None else threads
    slots = g_slots if slots is None else slots
    assert nt % 32 == 0
    assert slots >= pdf_cuda.table_slots(n) >= 2 * n
    assert slots & (slots - 1) == 0
    mask = slots - 1
    a = [int(x) & M32 for x in bits_a]
    b = [int(x) & M32 for x in bits_b]
    table = [EMPTY] * slots
    win = [x | y for x, y in zip(a, b)]
    newb = list(a)
    least_inv = EMPTY

    def lanes(t):
        return range(t, n, nt)

    # Phase 1: a generator a thread, its lanes in order.
    slot = {}

    def thread(t):
        for i in lanes(t):
            if not valid[i]:
                continue
            s = _k_slot(keys[i], mask)
            for _ in range(slots):
                yield
                prev = table[s]              # atomicCAS(EMPTY -> i)
                if prev == EMPTY:
                    table[s] = i
                    break
                assert valid[prev]           # only valid lanes insert
                if keys[prev] == keys[i]:
                    yield
                    table[s] = min(table[s], i)  # atomicMin
                    break
                s = (s + 1) & mask
            else:
                raise AssertionError("a probe cycled the table")
            slot[i] = s

    for w0 in range(0, nt, 32):              # one atomicMin a warp
        inv = min([i for t in range(w0, w0 + 32) for i in lanes(t)
                   if not valid[i]], default=EMPTY)
        least_inv = min(least_inv, inv)
    rng = random.Random(seed)
    live = [thread(t) for t in range(nt) if lanes(t)]
    while live:
        gen = rng.choice(live)
        try:
            next(gen)
        except StopIteration:
            live.remove(gen)
    # Phase 2.
    novel = np.zeros(n, np.bool_)
    cnt = 0
    for w0 in range(0, nt, 32):
        mine = 0
        for t in range(w0, w0 + 32):
            for i in lanes(t):
                s = slot.get(i)
                if s is None or table[s] != i:
                    continue
                if keys[i] == ALL_ONES and not i < least_inv:
                    continue
                bkt = _bucket_py(keys[i], h_bits)
                w, bit = bkt >> 5, 1 << (bkt & 31)
                novel[i] = not win[w] & bit
                newb[w] |= bit               # atomicOr
                mine += int(novel[i])
        cnt += mine                          # one atomicAdd a warp
    return novel, np.array(newb, np.uint32).view(np.int32), cnt


@pytest.mark.parametrize("n", [1, 31, 33, 100, B])
@pytest.mark.parametrize("name", CASES)
def test_kernel_transcription_equals_ref(name, n):
    tags, valid, bits_a, bits_b = _case(name, H_SMALL, seed=n, n=max(n, B))
    tags, valid = tags[:n], valid[:n]
    want = _port(tags, valid, bits_a, bits_b)
    for seed in range(3):
        novel, a_new, cnt = _k_dedup_filter(tags, valid, bits_a, bits_b,
                                            seed)
        assert np.array_equal(novel, want[0]), seed
        assert np.array_equal(a_new, want[1]) and cnt == want[2], seed


@pytest.mark.parametrize("threads", [32, 64, 256])
@pytest.mark.parametrize("n", [1, 31, 33, 100])
@pytest.mark.parametrize("name", CASES)
def test_kernel_transcription_equals_ref_on_fewer_threads(name, n, threads):
    """The same cases with 32, 64 and 256 threads in flight (a thread runs
    several lanes in order, as the one block's threads do past 1,024
    lanes and the grid's past its blocks), at the least table (at most
    half full: long probes) and at 8 times its size."""
    tags, valid, bits_a, bits_b = _case(name, H_SMALL, seed=n, n=max(n, B))
    tags, valid = tags[:n], valid[:n]
    want = _port(tags, valid, bits_a, bits_b)
    least = pdf_cuda.table_slots(n)
    for seed, slots in ((0, least), (1, least), (2, 8 * least)):
        novel, a_new, cnt = _k_dedup_filter(tags, valid, bits_a, bits_b,
                                            seed, threads=threads,
                                            slots=slots)
        assert np.array_equal(novel, want[0]), seed
        assert np.array_equal(a_new, want[1]) and cnt == want[2], seed


def test_kernel_transcription_windows_of_one_and_two_words():
    """Windows of 1 and 2 words (the one block's scalar staging), with 32
    threads and with the one block's 1,024."""
    for h_bits in (32, 64):
        for name in ("banks", "repeats", "sentinel", "collisions"):
            tags, valid, bits_a, bits_b = _case(name, h_bits, seed=5)
            tags, valid = tags[:100], valid[:100]
            want = _port(tags, valid, bits_a, bits_b)
            for threads in (32, None):
                novel, a_new, cnt = _k_dedup_filter(
                    tags, valid, bits_a, bits_b, seed=h_bits,
                    threads=threads, slots=pdf_cuda.table_slots(100))
                assert np.array_equal(novel, want[0]), (h_bits, name)
                assert np.array_equal(a_new, want[1]), (h_bits, name)
                assert cnt == want[2], (h_bits, name)


def test_kernel_table_geometry_and_cpu_refusal():
    import chip_smoke

    assert [pdf_cuda.table_slots(n) for n in (0, 1, 16, 17, 8192, 65536)] \
        == [32, 32, 32, 64, 16384, 131072]
    limit = pdf_cuda.SMEM_LIMIT
    assert limit == 232_448 and pdf_cuda.ONE_CTA_LANES == 2048
    # One block up to 2,048 lanes (a feed batch's staged txns), its table
    # grown up to 8 times its least size while it fits; the grid past
    # them, or for a window too wide for the block's shared memory.
    assert pdf_cuda.geometry(1200, 1 << 17) == ("block", 1024, 172_048,
                                                32768)
    assert pdf_cuda.geometry(2048, 1 << 17)[0] == "block"
    assert pdf_cuda.geometry(2049, 1 << 17) == ("grid", 256, 0, 65536)
    assert pdf_cuda.geometry(8192, 1 << 17) == ("grid", 256, 0, 131072)
    assert pdf_cuda.geometry(65536, 1 << 20) == ("grid", 256, 0, 1 << 20)
    assert pdf_cuda.geometry(1, 1 << 19)[::3] == ("block", 256)
    assert pdf_cuda.geometry(1, 1 << 20) == ("grid", 256, 0, 256)
    shapes = [(n, h) for n in chip_smoke.DRAIN_N for h in chip_smoke.DRAIN_H]
    shapes += [(131072, 1 << 17), (0, 32), (2048, 1 << 19), (4097, 32),
               (8192, 1 << 23), (1, 1 << 26), (pdf_cuda.MAX_LANES, 32)]
    for n, h in shapes:
        route, threads, smem, slots = pdf_cuda.geometry(n, h)
        least = pdf_cuda.table_slots(n)
        assert slots & (slots - 1) == 0 and least <= slots <= 8 * least
        fits = pdf_cuda.smem_bytes(n, h, least) <= limit
        if route == "block":
            assert n <= pdf_cuda.ONE_CTA_LANES and fits, (n, h)
            assert threads == pdf_cuda.THREADS == 1024
            assert smem == pdf_cuda.smem_bytes(n, h, slots) <= limit, (n, h)
            assert slots == 8 * least or \
                pdf_cuda.smem_bytes(n, h, 2 * slots) > limit, (n, h)
            assert pdf_cuda.scratch_words(n, route, slots) == 0
        else:
            assert route == "grid" and (threads, smem) == (256, 0), (n, h)
            assert n > pdf_cuda.ONE_CTA_LANES or not fits, (n, h)
            assert slots == min(8 * least, 1 << 30) and slots < 2 ** 31
            assert pdf_cuda.scratch_words(n, route, slots) == slots + 1 + n
    # Refused before any tensor check or launch: past MAX_LANES, and a
    # window that is not a power of two.
    backend.reset_counts()
    with pytest.raises(ValueError, match="lanes"):
        pdf_cuda.geometry(pdf_cuda.MAX_LANES + 1, 32)
    with pytest.raises(ValueError, match="power of two"):
        pdf_cuda.geometry(8, 48)
    lanes = torch.zeros(8, dtype=torch.int32)
    bank = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        pdf_cuda.dedup_filter_cuda(lanes, lanes,
                                   torch.ones(8, dtype=torch.bool), bank,
                                   bank)
    assert not backend.launches
    # The call's one allocation: bank, count, scratch and verdicts as views.
    for scratch in (0, 100):
        buf, novel, bank, cnt, scr = pdf_cuda.outputs(33, 4096, "cpu",
                                                      scratch)
        assert buf.dtype == torch.uint8
        assert buf.numel() == 4 * 4096 + 16 + 4 * scratch + 33
        assert (novel.dtype, tuple(novel.shape)) == (torch.bool, (33,))
        assert (bank.dtype, tuple(bank.shape)) == (torch.int32, (4096,))
        assert (scr.dtype, tuple(scr.shape)) == (torch.int32, (scratch,))
        assert (cnt.dtype, cnt.dim()) == (torch.int32, 0)
        base = buf.data_ptr()
        assert bank.data_ptr() == base and cnt.data_ptr() == base + 4 * 4096
        assert novel.data_ptr() == base + 4 * 4096 + 16 + 4 * scratch
        if scratch:
            assert scr.data_ptr() == base + 4 * 4096 + 16
    hi = torch.zeros(4, dtype=torch.int32)
    a, b = pdf.empty_banks(32)
    with pytest.raises(ValueError, match="CUDA"):
        pdf_cuda.dedup_filter_cuda(hi, hi, torch.zeros(4, dtype=torch.bool),
                                   a, b)
    backend.reset_counts()
    pdf.dedup_filter(hi, hi, torch.ones(4, dtype=torch.bool), a, b)
    assert backend.plain_calls == {"dedup_filter": 1}
    assert not backend.launches


# -- the contract tests of tests/test_drain.py, on the port ---------------------


def _round(tags, valid=None, banks=None, h_bits=H_SMALL):
    """One port filter round from python ints: (novel, (a_new, b), cnt)."""
    tags = np.asarray(tags, np.uint64)
    if valid is None:
        valid = np.ones(len(tags), np.bool_)
    if banks is None:
        banks = pdf.empty_banks(h_bits)
    hi, lo = pdf.split_tags(tags)
    novel, a_new, cnt = pdf.dedup_filter(
        torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(valid),
        *banks)
    return novel.numpy(), (a_new, banks[1]), int(cnt)


def _bit_set(bits, bucket: int) -> bool:
    return bool((int(bits[bucket >> 5]) >> (bucket & 31)) & 1)


def test_filter_one_sided_vs_window_oracle():
    """Random rounds (repeats, invalid lanes, a rotation) against an exact
    bucket-set oracle: novel only for a lane that is its batch's first
    valid occurrence with its bucket clear at entry; bank A carries the
    old bits and every valid first occurrence's bucket."""
    rng = random.Random(99)
    banks = pdf.empty_banks(H_SMALL)
    seen: set = set()
    bank_a: set = set()
    pool = [rng.getrandbits(64) for _ in range(300)]
    for rnd in range(6):
        tags = [rng.choice(pool) for _ in range(64)]
        valid = np.array([rng.random() > 0.1 for _ in range(64)], np.bool_)
        novel, banks, cnt = _round(tags, valid, banks)
        firsts: set = set()
        batch: set = set()
        for i, t in enumerate(tags):
            if not valid[i] or t in firsts:
                assert not novel[i], (rnd, i)
                continue
            firsts.add(t)
            assert bool(novel[i]) == (_bucket_py(t, H_SMALL) not in seen)
            batch.add(_bucket_py(t, H_SMALL))
        bank_a |= batch
        seen |= batch
        assert cnt == int(novel.sum())
        for bkt in bank_a:
            assert _bit_set(banks[0], bkt)
        if rnd == 3:
            banks = (torch.zeros_like(banks[0]), banks[0])
            seen = set(bank_a)
            bank_a = set()


def test_seen_tag_never_novel_again_and_invalid_lane_leaves_no_trace():
    rng = random.Random(7)
    tags = [rng.getrandbits(64) for _ in range(128)]
    _, banks, _ = _round(tags)
    again, banks, cnt = _round(tags, banks=banks)
    assert not again.any() and cnt == 0
    after_rot, _, cnt = _round(tags, banks=(torch.zeros_like(banks[0]),
                                            banks[0]))
    assert not after_rot.any() and cnt == 0
    t = 0xABCD_EF01_2345_6789
    novel, banks, _ = _round([t, 0x42], valid=np.array([False, True]))
    assert not novel[0] and novel[1]
    assert not _bit_set(banks[0], _bucket_py(t, H_SMALL))
    assert _round([t], banks=banks)[0][0]


def test_rot_quota_and_window_rotation():
    assert pdrain.rot_quota(4096, 2048, 128) == jdrain.rot_quota(
        4096, 2048, 128) == 4096 + 2048 + 128
    w = pdrain.DrainWindow(H_SMALL, rot_quota=10)
    t = 0x1357_9BDF_0246_8ACE
    novel, (a_new, _), cnt = _round([t], banks=w.banks())
    assert novel[0]
    w.commit(a_new)
    w.note_published(cnt)
    assert not w.maybe_rotate()
    w.note_published(9)
    assert not w.maybe_rotate(blocked=True)
    assert w.maybe_rotate() and w.rotations == 1 and w.novel_since_rot == 0
    # Bank B is the old bank A, the tensor the filter returned; bank A a
    # new zero tensor.
    assert w.bits_b is a_new and not w.bits_a.any()
    assert w.bits_a.data_ptr() != a_new.data_ptr()
    assert not _round([t], banks=w.banks())[0][0]
    w.note_published(10)
    assert w.maybe_rotate() and w.rotations == 2
    assert _round([t], banks=w.banks())[0][0]


def _tc_state(tc):
    return (tc._ring[:], tc._next, set(tc._map), tc.hit_cnt, tc.miss_cnt,
            tc.false_novel_cnt)


def test_tcache_insert_novel_batch_and_tripwire_equal_jax():
    port, jax = ptcache.TCache(8), jtcache.TCache(8)
    for tc in (port, jax):
        assert not tc.insert_novel_batch([100, 200, 300]).any()
        tc.insert(7)
    assert _tc_state(port) == _tc_state(jax)
    # A false claim on a member: flagged, the state insert() would leave.
    got = port.insert_novel_batch([7, 9])
    assert got.tolist() == jax.insert_novel_batch([7, 9]).tolist() \
        == [True, False]
    ref = ptcache.TCache(8)
    for t in (100, 200, 300, 7):
        ref.insert(t)
    assert ref.insert(7) and not ref.insert(9)
    assert _tc_state(port) == _tc_state(jax)
    assert _tc_state(port)[:5] == _tc_state(ref)[:5]


def test_tcache_insert_batch_novel_verdicts_equal_loop_and_jax():
    """The fast path, the eviction-window fallback and n >= depth, with
    true claims and one false claim a round: verdicts equal insert()'s
    with and without novel, false_novel_cnt the false claims, the state
    the JAX TCache's; reset clears the tripwire."""
    rng = random.Random(3)
    for depth, n in ((64, 24), (16, 12), (8, 20)):
        port, jax, ref = (ptcache.TCache(depth), jtcache.TCache(depth),
                          ptcache.TCache(depth))
        plain = ptcache.TCache(depth)
        seen: set = set()
        for rnd in range(6):
            tags = np.array([rng.randrange(40) for _ in range(n)], np.uint64)
            novel = np.zeros(n, np.bool_)
            firsts: set = set()
            for i, t in enumerate(tags.tolist()):
                if t not in seen and t not in firsts and rng.random() < .5:
                    novel[i] = True
                firsts.add(t)
            dups = [i for i, t in enumerate(tags.tolist()) if t in ref._map]
            if dups:
                novel[rng.choice(dups)] = True
            fn0 = port.false_novel_cnt
            got = port.insert_batch(tags, novel=novel)
            want = np.array([ref.insert(int(t)) for t in tags.tolist()])
            assert np.array_equal(got, want), (depth, rnd)
            assert np.array_equal(plain.insert_batch(tags), want)
            assert np.array_equal(jax.insert_batch(tags, novel=novel), want)
            assert port.false_novel_cnt - fn0 == int((novel & want).sum())
            assert _tc_state(port) == _tc_state(jax)
            seen |= set(tags.tolist())
        assert port.false_novel_cnt > 0
        port.reset()
        assert port.false_novel_cnt == 0 and not port._map


def test_ctl_word_equals_jax():
    rng = np.random.RandomState(4)
    novel = rng.rand(300) < 0.5
    colors = rng.randint(-3, 140, 300).astype(np.int32)
    for base in (0x3, 0x7):
        for cols, block in ((None, 0), (colors, 37), (colors, 5)):
            got = pdrain.encode_ctl(base, novel, cols, block)
            want = jdrain.encode_ctl(base, novel, cols, block)
            assert got.dtype == np.uint16 and np.array_equal(got, want)
            for c in got.tolist():
                # The dedup tile tests CTL_NOVEL and keeps the tango
                # bits by the masks, as the JAX ctl_novel and ctl_strip.
                assert bool(c & pdrain.CTL_NOVEL) == jdrain.ctl_novel(c)
                assert pdrain.ctl_color(c) == jdrain.ctl_color(c)
                assert pdrain.ctl_block(c) == jdrain.ctl_block(c)
                assert c & pdrain.CTL_BASE_MASK == jdrain.ctl_strip(c)
    for name in ("CTL_NOVEL", "CTL_COLOR_SHIFT", "CTL_COLOR_MASK",
                 "CTL_BLOCK_SHIFT", "CTL_BLOCK_MASK", "CTL_BASE_MASK",
                 "MAX_CTL_COLORS"):
        assert getattr(pdrain, name) == getattr(jdrain, name), name
    ctl = pdrain.encode_ctl(3, np.array([True, False]),
                            np.array([0, pdrain.MAX_CTL_COLORS + 1]), 33)
    assert [pdrain.ctl_color(int(c)) for c in ctl] == [0, -1]
    assert [pdrain.ctl_block(int(c)) for c in ctl] == [1, 1]


def test_drain_mode_resolution():
    assert pengine.resolve_drain_mode("auto") == "auto"
    assert pengine.resolve_drain_mode("off") == "off"
    for bad in ("on", "", "AUTO"):
        with pytest.raises(ValueError, match="drain mode"):
            pengine.resolve_drain_mode(bad)


# -- the dedup tile with claimed frags ----------------------------------------


def _claimed_frags(n, seed):
    """(payload, sig, ctl, tsorig): sigs from 50 values; a claim on the
    first sight of a sig (true) and on some repeats (false: the tripwire
    drops them); CTL_ERR copies with and without a claim; pack colors and
    block ids on a third of the frags."""
    rng = np.random.RandomState(seed)
    seen: set = set()
    out = []
    for i in range(n):
        pay = rng.randint(0, 256, int(rng.randint(1, 200)),
                          dtype=np.uint8).tobytes()
        sig = int(rng.randint(0, 50))
        ctl = 3
        if sig not in seen or rng.rand() < 0.1:
            ctl |= pdrain.CTL_NOVEL
        if i % 9 == 4:
            ctl |= prings.CTL_ERR
        else:
            seen.add(sig)
        if i % 3 == 0:
            ctl |= ((int(rng.randint(0, 64)) + 1) << 4) | ((i // 30) << 11)
        out.append((pay, sig, ctl, 1000 + i))
    return out


def _dedup_run(path, pkg, frags, **kw):
    """frags through one dedup tile (tcache depth 16) on the
    verify_dedup link: its dedup_pack frags, the in-link's filter and
    publish counters, and the tile."""
    topo = ppipe.build_topology(str(path), depth=512)
    rmod = prings if pkg is ptiles else jrings
    w = rmod.Workspace.join(topo.wksp_path)
    names = [pkg.LinkNames(f"{k}.mcache", f"{k}.dcache", f"{k}.fseq")
             for k in ("verify_dedup", "dedup_pack")]
    src = pkg.OutLink(w, names[0], mtu=1232)
    for pay, sig, ctl, ts in frags:
        src.publish(pay, sig, tsorig=ts, ctl=ctl)
    out = pkg.OutLink(w, names[1], mtu=1232,
                      reliable_fseqs=[rmod.FSeq(w, names[1].fseq)])
    tile = pkg.DedupTile(w, "dedup.cnc", in_links=[pkg.InLink(w, names[0])],
                         out_link=out, tcache_depth=16, **kw)
    while any(tile.poll_inputs()):
        pass
    mc = rmod.MCache(w, "dedup_pack.mcache")
    dc = rmod.DCache(w, "dedup_pack.dcache")
    got = []
    for seq in range(mc.seq_next()):
        _, f = mc.poll(seq)
        got.append((dc.read(f.chunk, f.sz), f.sig, f.ctl, f.tsorig))
    fs = rmod.FSeq(w, names[0].fseq)
    diag = tuple(fs.diag(k) for k in (rmod.DIAG_FILT_CNT, rmod.DIAG_FILT_SZ,
                                      rmod.DIAG_PUB_CNT, rmod.DIAG_PUB_SZ))
    w.leave()
    return got, diag, tile


@pytest.mark.parametrize("seed", [0, 1])
def test_dedup_round_with_claims_equals_per_frag_and_jax(tmp_path, seed):
    frags = _claimed_frags(300, seed)
    bulk, b_diag, tile = _dedup_run(tmp_path / "b.wksp", ptiles, frags)
    per, f_diag, ftile = _dedup_run(tmp_path / "f.wksp", ptiles, frags,
                                    bulk=False)
    jax, j_diag, _ = _dedup_run(tmp_path / "j.wksp", jtiles, frags)
    # The bulk round forwards the color and block bits without the claim,
    # as the JAX tile does; the per-frag path publishes SOM|EOM.
    assert bulk == jax
    strip = [(p, s, 3, t) for p, s, _, t in bulk]
    assert per == strip
    assert all(not ctl & pdrain.CTL_NOVEL for _, _, ctl, _ in bulk)
    assert any(pdrain.ctl_color(ctl) >= 0 for _, _, ctl, _ in bulk)
    assert b_diag[0] == f_diag[0] == j_diag[0]
    assert b_diag[2:] == f_diag[2:] == j_diag[2:]
    # The ledger: every clean frag is a skipped probe or a probe; the
    # false claims are the claimed repeats the tcache holds.
    clean = [f for f in frags if not f[2] & prings.CTL_ERR]
    claims = sum(1 for f in clean if f[2] & pdrain.CTL_NOVEL)
    for t in (tile, ftile):
        assert t.stat_drain_probe_skip == claims
        assert t.stat_drain_probed == len(clean) - claims
        assert t.stat_drain_false_novel == tile.tcache.false_novel_cnt > 0
    assert len(bulk) + b_diag[0] == len(frags)


def test_dedup_on_frag_ctl_err_drops_before_probe():
    """tests/test_drain.py:318 on the port's tile: a CTL_ERR frag with a
    stale claim is dropped before the tcache; the clean claim after it
    skips the probe; a repeated claim trips the wire."""
    published: list = []
    filt: list = []

    class Fake:
        tcache = ptcache.TCache(16)
        # The tile counts through its flight lane.
        fl = pflight.TileLane("dedup")
        flightrec = pflight.FlightRecorder("dedup", 8)
        stat_drain_probe_skip = ptiles.DedupTile.stat_drain_probe_skip
        stat_drain_probed = ptiles.DedupTile.stat_drain_probed
        stat_drain_false_novel = ptiles.DedupTile.stat_drain_false_novel

        def _filter(self, frag):
            filt.append(frag.sig)

        def publish_backp(self, payload, sig, tsorig=0):
            published.append(sig)

    fake = Fake()
    err = prings.Frag(seq=0, sig=0xA1, chunk=0, sz=4,
                      ctl=prings.CTL_ERR | pdrain.CTL_NOVEL, tsorig=0,
                      tspub=0)
    ptiles.DedupTile.on_frag(fake, err, b"errp")
    assert not published and filt == [0xA1]
    assert 0xA1 not in fake.tcache._map and fake.stat_drain_probe_skip == 0
    good = prings.Frag(seq=1, sig=0xA1, chunk=0, sz=4, ctl=pdrain.CTL_NOVEL,
                       tsorig=0, tspub=0)
    ptiles.DedupTile.on_frag(fake, good, b"okay")
    assert published == [0xA1] and fake.stat_drain_probe_skip == 1
    ptiles.DedupTile.on_frag(fake, good, b"okay")
    assert published == [0xA1] and fake.stat_drain_false_novel == 1
    assert fake.stat_drain_probe_skip == 2 and fake.stat_drain_probed == 0


# -- the pipeline against the JAX runner -----------------------------------------


@pytest.fixture(scope="module")
def probe_corpus():
    from firedancer_tpu.disco.corpus import mainnet_corpus

    return mainnet_corpus(n=260, seed=31, dup_rate=0.08, corrupt_rate=0.04,
                          parse_err_rate=0.03, sign_batch_size=128,
                          max_data_sz=140)


def _filters(diag):
    return (diag["tile.verify"]["ha_filt_cnt"]
            + diag["tile.verify"]["sv_filt_cnt"]
            + diag["link.verify_dedup"]["filt_cnt"]
            + diag["link.dedup_pack"]["filt_cnt"])


def _jax_fl(res, tile):
    out: dict = {}
    for key, d in res.diag.items():
        if key.startswith("tile.") and key.split(".", 1)[1].split(
                ".shard")[0] == tile:
            for k, v in d.items():
                if k.startswith("fl_") and isinstance(v, int):
                    out[k] = out.get(k, 0) + v
    return out


def _warm(batch: int) -> None:
    """Warm the B = batch CPU engine and its filter before a run, so the
    run's counts hold its own calls only."""
    entry, _ = pengine.registry().acquire(
        pengine.EngineSpec("direct", batch), device="cpu")
    entry.warm_drain(pdf.DEFAULT_FILTER_BITS)


@pytest.mark.parametrize("tcache_depth, depth, batch",
                         [(4096, 1024, 128), (8, 32, 32)],
                         ids=["default", "rotating"])
def test_pipeline_drain_equals_jax(probe_corpus, tmp_path, monkeypatch,
                                   tcache_depth, depth, batch):
    """"default": the runners' TCache of 4096 spans the corpus, so the
    sink gets the corpus oracle's multiset and the window never rotates.
    "rotating": a TCache of 8 and the port's automatic quota (TCache +
    ring + batch = 72 confirmed-novel publishes), which the JAX runner is
    given as FD_DRAIN_ROT_QUOTA: the window rotates while batches are in
    flight, duplicates far apart pass both TCaches alike, and no claim
    is false."""
    from firedancer_tpu.disco import pipeline as jpipe
    from firedancer_tpu.disco.corpus import expected_sink_digests

    quota = pdrain.rot_quota(tcache_depth, depth, batch)
    monkeypatch.setenv("FD_DRAIN", "auto")
    monkeypatch.setenv("FD_DRAIN_ROT_QUOTA", str(quota))
    monkeypatch.setenv("FD_FEED_PROC", "0")
    jtopo = jpipe.build_topology(str(tmp_path / "j.wksp"), depth=depth)
    jres = jpipe.run_pipeline(jtopo, probe_corpus.payloads,
                              verify_backend="cpu", verify_batch=batch,
                              tcache_depth=tcache_depth, timeout_s=240.0,
                              record_digests=True, feed=True)
    topo = ppipe.build_topology(str(tmp_path / "p.wksp"), depth=depth)
    _warm(batch)
    backend.reset_counts()
    res = ppipe.run_pipeline(topo, probe_corpus.payloads, verify_batch=batch,
                             tcache_depth=tcache_depth, record_digests=True,
                             device="cpu", timeout_s=240.0, feed_proc=False)
    plain = dict(backend.plain_calls)
    assert jres.feed and res.feed and res.feed_fallback_reason is None
    assert Counter(res.sink_digests) == Counter(jres.sink_digests)
    assert _filters(res.diag) == _filters(jres.diag)
    vs, jvs = res.verify_stats[0], jres.verify_stats[0]
    if tcache_depth == 4096:
        assert Counter(res.sink_digests) == expected_sink_digests(
            probe_corpus)
        assert vs["drain_rot"] == jvs["drain_rot"] == 0
    else:
        assert vs["drain_rot"] >= 2 and jvs["drain_rot"] >= 2
    # Every batch carries txns (a slot commits only with some), and each
    # was filtered.
    assert vs["drain_batches"] == vs["batches"] >= 1
    assert jvs["drain_batches"] >= 1
    dd = res.dedup_stats
    assert dd["probe_skip"] >= 1 and dd["false_novel"] == 0
    # Every clean txn verify published carried one verdict, and the
    # dedup tile honoured each once.
    assert dd["probe_skip"] + dd["probed"] == vs["drain_novel"] \
        + vs["drain_maybe"] == res.diag["link.verify_dedup"]["tx_seq"]
    jd = _jax_fl(jres, "dedup")
    assert jd["fl_drain_probe_skip"] + jd["fl_drain_probed"] \
        == jvs["drain_novel"] + jvs["drain_maybe"]
    assert vs["drain_novel"] + vs["drain_maybe"] \
        == jvs["drain_novel"] + jvs["drain_maybe"]
    # One filter a batch, the plain version (CPU tensors).
    assert plain["dedup_filter"] == vs["drain_batches"]


def _gc_payloads():
    from firedancer_tpu.ballet.txn import build_txn

    shared = bytes([77]) * 32
    out = []
    for i in range(48):
        extra = [shared] if i % 4 == 0 else [bytes([i]) * 32]
        out.append(build_txn(
            signer_seeds=[bytes([i + 1]) + bytes(31)],
            extra_accounts=extra + [bytes([180 + i % 40]) * 32],
            n_readonly_unsigned=1, instrs=[(2, [0], b"gd%02d" % i)]))
    return out


def test_pipeline_drain_pack_device_accounting(tmp_path):
    payloads = _gc_payloads()
    topo = ppipe.build_topology(str(tmp_path / "gc.wksp"), depth=512)
    _warm(128)
    backend.reset_counts()
    res = ppipe.run_pipeline(topo, payloads, verify_batch=128,
                             record_digests=True, device="cpu",
                             timeout_s=240.0, pack_scheduler="gc",
                             verify_opts={"drain_pack": True})
    plain = dict(backend.plain_calls)
    ps, vs = res.pack_stats, res.verify_stats[0]
    assert res.feed and res.recv_cnt == len(payloads)
    assert Counter(res.sink_digests) == Counter(
        sha256(p).digest() for p in payloads)
    assert ps["block_device"] + ps["sched_fallback"] == ps["blocks"]
    assert ps["block_device"] >= 1
    assert ps["wave_device"] >= ps["block_device"]
    assert sum(res.bank_hist.values()) == len(payloads)
    # The coloring ran once a verify batch (drain_pack) and once a block
    # the pack colored itself (none here: every txn came colored).
    assert ps["dev_blocks"] == ps["blocks"] >= 1
    assert plain["pack_schedule"] == vs["drain_batches"] + (
        ps["blocks"] - ps["dev_blocks"])
    assert plain["dedup_filter"] == vs["drain_batches"] >= 1
    assert res.dedup_stats["false_novel"] == 0


def test_drain_off_and_unknown_mode(tmp_path):
    topo = ppipe.build_topology(str(tmp_path / "o.wksp"), depth=64)
    w = prings.Workspace.join(topo.wksp_path)

    def tile(**kw):
        return ptiles.VerifyTile(w, "verify.cnc",
                                 ppipe.in_link(w, "replay_verify"),
                                 ppipe.out_link(w, "verify_dedup"), batch=32,
                                 device="cpu", feed=True, **kw)

    assert tile(drain="off")._drain is None
    armed = tile(drain_filter_bits=1 << 10)
    assert armed._drain.h_bits == 1 << 10
    assert armed._drain.rot_quota == pdrain.rot_quota(4096, 64, 32)
    # The automatic quota follows the TCache depth the tile is given.
    assert tile(tcache_depth=16)._drain.rot_quota == pdrain.rot_quota(
        16, 64, 32)
    assert armed._engine_entry.snapshot()["drain"] is True
    with pytest.raises(ValueError, match="drain mode"):
        tile(drain="on")
    w.leave()


def test_port_scan_reaches_the_drain_modules():
    """tests/test_torch_verify.py's import scan (no jax, no
    firedancer_tpu) covers the drain's new modules."""
    from tests.test_torch_verify import ROOT, _port_sources

    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {"firedancer_tpu_torch/ops/dedup_filter.py",
            "firedancer_tpu_torch/ops/dedup_filter_cuda.py",
            "firedancer_tpu_torch/disco/drain.py"} <= names
