"""The Pippenger MSM of the PyTorch port against the JAX package.

* Live against the JAX package, eager, on seeded numpy inputs: the plan
  math (every plan of all_plans), digit extraction, the slot tables and
  their fill verdicts, the signed recode, and the scalar glue (sc_sum,
  sc_muladd).
* The fill verdict is never laxer than the reference's: at the edge of
  the static round count, and with bucket 0 never counted.
* The four kernels' plain versions against the JAX kernels' interpret-
  mode outputs in tests/fixtures/torch_port/rlc_goldens.npz (written by
  ``JAX_PLATFORMS=cpu python -m tests.test_torch_rlc``): equal in
  canonical affine bytes and in a digest of the projective coordinates.
  The CUDA kernels are held against these plain versions on the card by
  chip_smoke.py.
* The fill and aggregation kernels add in their own order (a lane's
  slots and a column's buckets split over a warp). Their plain mirrors
  (``*_split_ref``) are held to the JAX-order versions and the goldens
  as points (affine bytes): the projective limbs differ, the group
  elements do not. A limb-exact transcription of the kernels in Python
  integers (radix 2^51, csrc/fe25519.cuh and msm.cuh) runs the same
  order at the inputs' largest limbs, asserts that no limb leaves the
  range the CUDA arithmetic takes, and must equal the mirrors.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu import msm_plan as jplan
from firedancer_tpu.ops import msm as jmsm
from firedancer_tpu.ops import msm_recode as jrecode
from firedancer_tpu.ops import sc25519 as jsc
from firedancer_tpu.ops.sign import _sc_muladd as j_sc_muladd
from firedancer_tpu_torch import convert, msm_plan
from firedancer_tpu_torch.ops import backend, curve_cuda, msm, msm_cuda
from firedancer_tpu_torch.ops import curve25519 as ge
from firedancer_tpu_torch.ops import fe25519 as fe
from firedancer_tpu_torch.ops import sc25519 as sc
from firedancer_tpu_torch.ops import verify_rlc as vr
from firedancer_tpu_torch.ops.msm_recode import recode_signed

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "torch_port" / "rlc_goldens.npz"
PLANS = msm_plan.all_plans()
PLAN_IDS = [msm_plan.plan_token(p) for p in PLANS]
B = 16
BP = B + 1       # the 253-bit MSM's points: B lanes and the u B lane


def _jplan(plan):
    return jplan.MsmPlan(*plan)


# -- plan math ------------------------------------------------------------


@pytest.mark.parametrize("plan", PLANS, ids=PLAN_IDS)
def test_plan_math_matches_jax(plan):
    jp = _jplan(plan)
    tok = msm_plan.plan_token(plan)
    assert tok == jplan.plan_token(jp)
    assert msm_plan.parse_plan(tok) == plan == tuple(jplan.parse_plan(tok))
    assert msm_plan.plan_buckets(plan) == jplan.plan_buckets(jp)
    for bits in (126, 128, 253):
        for signed in (False, True):
            assert (msm_plan.plan_windows(bits, plan.w, signed)
                    == jplan.plan_windows(bits, plan.w, signed))
    for n_windows in (msm.WINDOWS_Z, msm.WINDOWS_253):
        for bsz in (1, 17, 8193):
            dims = msm._plan_dims(n_windows, bsz, plan)
            assert dims == jmsm._plan_dims(n_windows, bsz, jp)
            assert (msm._top_tree_planes(n_windows, dims[0], plan)
                    == jmsm._top_tree_planes(n_windows, dims[0], jp))


def test_all_plans_and_constants_match_jax():
    assert [tuple(p) for p in PLANS] == [tuple(p) for p in jplan.all_plans()]
    assert PLANS[0] == msm_plan.BASELINE_PLAN
    assert (msm.W_BITS, msm.N_BUCKETS, msm.WINDOWS_Z, msm.WINDOWS_253,
            msm_plan.TORSION_BUCKET_BITS) == (
        jmsm.W_BITS, jmsm.N_BUCKETS, jmsm.WINDOWS_Z, jmsm.WINDOWS_253,
        jplan.TORSION_BUCKET_BITS)
    for k, v in msm.SCALAR_BITS.items():
        assert jmsm.SCALAR_BITS[k] == v


@pytest.mark.parametrize("token", ["", "x7", "u", "u9", "s7", "u7l2", "s"])
def test_parse_plan_rejects_what_jax_rejects(token):
    with pytest.raises(ValueError):
        jplan.parse_plan(token)
    with pytest.raises(ValueError):
        msm_plan.parse_plan(token)


@pytest.mark.parametrize("n_buckets,signed", [
    (128, False), (64, False), (256, False), (32, False),
    (32, True), (64, True), (128, True)])
def test_default_rounds_pinned_to_jax(n_buckets, signed):
    """Every B from 1 to 20000 at every bucket count in use: the fill
    verdict rests on this number, so it may not drift."""
    for bsz in range(1, 20001):
        assert (msm_plan.default_rounds(bsz, n_buckets, signed)
                == jplan.default_rounds(bsz, n_buckets, signed)), bsz


# -- staging ----------------------------------------------------------------


def _scalars(seed: int, n: int = B, top_bits: int = 253) -> np.ndarray:
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    vals = [int.from_bytes(r.tobytes(), "little") % (1 << top_bits)
            for r in s]
    return np.array([list(v.to_bytes(32, "little")) for v in vals], np.uint8)


@pytest.mark.parametrize("w,n_windows", [(6, 43), (7, 18), (7, 37), (8, 32)])
def test_digits_match_jax(w, n_windows):
    s = _scalars(w, BP)
    got = msm._digits(torch.from_numpy(s), n_windows, w).numpy()
    want = np.asarray(jmsm._digits(jnp.asarray(s), n_windows, w))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w", msm_plan.PLAN_WIDTHS)
def test_recode_signed_matches_jax_and_the_scalar(w):
    s = _scalars(10 + w)
    nw = msm_plan.plan_windows(253, w, True)
    d = msm._digits(torch.from_numpy(s), nw, w)
    got = recode_signed(d, w).numpy()
    want = np.asarray(jrecode.recode_signed(jnp.asarray(d.numpy()), w))
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() <= 1 << (w - 1)
    for lane in range(B):
        total = sum(int(got[t, lane]) << (w * t) for t in range(nw))
        assert total == int.from_bytes(s[lane].tobytes(), "little")


def _jax_staging(d, bsz, rounds, nb):
    idx, ok = jmsm._staging_from_digits(jnp.asarray(d), bsz, rounds, nb)
    return np.asarray(idx), bool(ok)


@pytest.mark.parametrize("nb,nw,seed", [(128, 36, 1), (64, 42, 2),
                                         (256, 31, 3)])
def test_staging_from_digits_matches_jax(nb, nw, seed):
    """Skewed digits (a quarter of the buckets), so buckets fill several
    rounds deep, on the unsigned plans' grids (what JAX compiled for
    test_plan_staging_matches_jax it reuses here)."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, nb // 4, (nw, BP)).astype(np.int32)
    rounds = msm_plan.default_rounds(BP, nb)
    idx, ok = msm._staging_from_digits(torch.from_numpy(d), BP, rounds, nb)
    want_idx, want_ok = _jax_staging(d, BP, rounds, nb)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert bool(ok) == want_ok


@pytest.mark.parametrize("plan", PLANS, ids=PLAN_IDS)
def test_plan_staging_matches_jax(plan):
    jp = _jplan(plan)
    s = _scalars(20 + plan.w, BP)
    nw, nb, rounds = msm._plan_dims(msm.WINDOWS_253, BP, plan)
    planes = msm._top_tree_planes(msm.WINDOWS_253, nw, plan)
    idx, neg, ok, top = msm._plan_staging(torch.from_numpy(s), BP, rounds,
                                          nw, nb, plan, planes)
    jidx, jneg, jok, jtop = jmsm._plan_staging(jnp.asarray(s), BP, rounds,
                                               nw, nb, jp, planes)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert bool(ok) == bool(jok)
    assert (neg is None) == (jneg is None) == (not plan.signed)
    if neg is not None:
        np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))
    assert (top is None) == (jtop is None) == (planes == 0)
    if top is not None:
        np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))


@pytest.mark.parametrize("extra", [0, 1])
def test_fill_verdict_is_never_laxer_than_the_reference(extra):
    """Biased digits at the edge: one bucket receives exactly max_rounds
    points (ok) or one more (overflow), in both packages."""
    nb, nw = 128, 36
    rounds = msm_plan.default_rounds(BP, nb)
    d = np.tile(np.arange(BP, dtype=np.int32), (nw, 1))
    d[0, :rounds + extra] = 5
    idx, ok = msm._staging_from_digits(torch.from_numpy(d), BP, rounds, nb)
    want_idx, want_ok = _jax_staging(d, BP, rounds, nb)
    assert bool(ok) == want_ok == (extra == 0)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert (idx[0, 5] >= 0).sum() == rounds


def test_bucket_zero_is_never_counted():
    """Every digit 0: bucket 0 holds all B points, far past the round
    count, and the fill is still accepted (digit 0 adds nothing)."""
    d = np.zeros((36, BP), np.int32)
    rounds = msm_plan.default_rounds(BP)
    assert rounds < BP
    idx, ok = msm._staging_from_digits(torch.from_numpy(d), BP, rounds, 128)
    assert bool(ok) and _jax_staging(d, BP, rounds, 128)[1]
    assert bool((idx == -1).all())


# -- scalar glue ----------------------------------------------------------


def _sc_inputs(seed: int):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    a[0] = 0xFF                                 # the widest operands
    a[1] = 0
    return a


@pytest.mark.parametrize("seed", [1, 2])
def test_sc_muladd_matches_jax(seed):
    a, b, c = _sc_inputs(seed), _sc_inputs(seed + 10), _sc_inputs(seed + 20)
    got = sc.sc_muladd(*map(torch.from_numpy, (a, b, c))).numpy()
    want = np.asarray(j_sc_muladd(*map(jnp.asarray, (a, b, c))))
    np.testing.assert_array_equal(got, want)
    for i in range(B):
        v = (int.from_bytes(a[i].tobytes(), "little")
             * int.from_bytes(b[i].tobytes(), "little")
             + int.from_bytes(c[i].tobytes(), "little")) % sc.L
        assert int.from_bytes(got[i].tobytes(), "little") == v


def test_parallel_carry_is_exact_on_long_chains():
    """The scalar glue's carry (two parallel passes, then one resolved
    chain) against Python ints, on chains of 0xFFFF limbs that a carry
    must cross end to end, and on the widest limbs it takes."""
    rng = np.random.default_rng(5)
    rows = [[0x10000] + [0xFFFF] * 31, [0xFFFF] * 31 + [0], [0xFFFF] * 32,
            [0x1FFFF] * 32, [(1 << 47) - 1] * 32, [0] * 32,
            rng.integers(0, 1 << 47, 32).tolist(),
            ([0xFFFF] * 8 + [0x10000]) * 3 + [0xFFFF] * 5]
    got, top = sc._normalize(torch.tensor(rows, dtype=torch.int64))
    for row, limbs, carry in zip(rows, got.tolist(), top.tolist()):
        assert all(0 <= v < 1 << 16 for v in limbs)
        assert (sum(v << (16 * i) for i, v in enumerate(limbs))
                + (carry << (16 * len(row)))) == sum(
                    v << (16 * i) for i, v in enumerate(row))


@pytest.mark.parametrize("n", [1, 16, 300])
def test_sc_sum_matches_jax(n):
    s = np.tile(_sc_inputs(n), (-(-n // B), 1))[:n]
    got = sc.sc_sum(torch.from_numpy(s)).numpy()
    want = np.asarray(jsc.sc_sum(jnp.asarray(s)))
    np.testing.assert_array_equal(got, want)
    total = sum(int.from_bytes(r.tobytes(), "little") for r in s) % sc.L
    assert int.from_bytes(got[0].tobytes(), "little") == total


# -- the four kernels' plain versions against the JAX kernels --------------


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def clean_points(golden):
    """The clean case's decompressed A || R (the torsion grid's points)."""
    pubs, sigs = golden["clean/pubs"], golden["clean/sigs"]
    enc = torch.from_numpy(np.concatenate([pubs, sigs[:, :32]]))
    pt, ok, _ = curve_cuda.decompress_so(enc)
    assert bool(ok.all())
    return pt


def _assert_points(got, golden, key):
    np.testing.assert_array_equal(convert.point_to_affine_bytes(got),
                                  golden[f"{key}_aff"], err_msg=key)
    np.testing.assert_array_equal(convert.point_digest(got),
                                  golden[f"{key}_dig"], err_msg=key)


@pytest.fixture(scope="module")
def torsion_buckets(golden, clean_points):
    nb = 1 << msm_plan.TORSION_BUCKET_BITS
    u = torch.from_numpy(golden["clean/u"].astype(np.int64)) & (nb - 1)
    rounds = msm_plan.default_rounds(2 * B, nb)
    idx, ok = msm._staging_from_digits(u, 2 * B, rounds, nb)
    return idx, ok, msm_cuda.fill_buckets_ref(ge.niels_limbs(clean_points),
                                              idx)


def test_fill_plain_matches_jax_kernel(golden, torsion_buckets):
    idx, ok, buckets = torsion_buckets
    np.testing.assert_array_equal(idx.numpy(), golden["kernel/fill_idx"])
    assert bool(ok) == bool(golden["kernel/fill_ok"])
    _assert_points(buckets, golden, "kernel/fill")


def test_aggregate_plain_matches_jax_kernel(golden, torsion_buckets):
    k = golden["clean/u"].shape[0]
    agg = msm_cuda.aggregate_buckets_ref(torsion_buckets[2].reshape(
        k, 1 << msm_plan.TORSION_BUCKET_BITS, 4, 5))
    _assert_points(agg, golden, "u7/clean/sub")


def test_order_plain_matches_jax_kernel(golden, torsion_buckets):
    k = golden["clean/u"].shape[0]
    agg = msm_cuda.aggregate_buckets_ref(torsion_buckets[2].reshape(
        k, 1 << msm_plan.TORSION_BUCKET_BITS, 4, 5))
    la = msm_cuda.mul_by_group_order_ref(agg)
    _assert_points(la, golden, "u7/clean/la")
    assert bool(ge.is_identity_limbs(la).all())


def test_horner_plain_matches_jax_kernel(golden, clean_points):
    """The z MSM of the clean case: its window sums, then the Horner."""
    z = torch.from_numpy(golden["clean/z"])
    w_r, ok = msm.msm_fast_partial(z, ge.point_neg_limbs(clean_points[B:]),
                                   msm.WINDOWS_Z)
    assert bool(ok)
    _assert_points(w_r, golden, "u7/clean/w_r")
    _assert_points(msm_cuda.window_horner_ref(w_r, msm.W_BITS), golden,
                   "u7/clean/t1")


def test_plain_versions_count_and_launch_nothing_on_the_cpu(clean_points):
    backend.reset_counts()
    idx, _ = msm._staging_from_digits(
        torch.zeros(2, 2 * B, dtype=torch.int64) + 3, 2 * B, 40, 32)
    niels = ge.niels_limbs(clean_points)
    buckets = msm_cuda.fill_buckets(niels, idx)
    agg = msm_cuda.aggregate_buckets(buckets.reshape(2, 32, 4, 5))
    msm_cuda.window_horner(agg, 7)
    msm_cuda.mul_by_group_order(agg)
    split = msm_cuda.fill_buckets_split_ref(niels, idx)
    split_agg = msm_cuda.aggregate_buckets_split_ref(split.reshape(2, 32, 4,
                                                                   5))
    assert backend.launches == {}
    assert backend.plain_calls == {"msm_fill": 2, "msm_aggregate": 2,
                                   "msm_horner": 1, "msm_order": 1}
    np.testing.assert_array_equal(convert.point_to_affine_bytes(split_agg),
                                  convert.point_to_affine_bytes(agg))


def test_empty_fill_lanes_match_the_rounds_of_identity_adds():
    """The plain fill's closed form for a lane with no point equals R
    identity-niels madds from the identity (what the kernel runs)."""
    pts = ge.base_point_limbs(torch.device("cpu"))
    idx = torch.full((1, 4, 3), -1, dtype=torch.int32)
    idx[0, 2, 0] = 0
    got = msm_cuda.fill_buckets_ref(ge.niels_limbs(pts), idx)
    one, zero = fe.fe_one((1,)), fe.fe_zero((1,))
    acc = ge.identity((1,))
    for _ in range(3):
        acc = ge.madd_niels(acc, (one, one, zero))
    assert torch.equal(got[1:2], ge.to_limbs51(acc))
    assert convert.point_to_affine_bytes(got[2:3]).tobytes() == \
        bytes.fromhex("5866666666666666666666666666666666666666666666666666666666666666")


def test_kernel_group_order_words_match_l():
    src = (ROOT / "firedancer_tpu_torch" / "ops" / "csrc" /
           "msm_order.cu").read_text()
    words = re.search(r"L_WORDS\[4\] = \{([^}]*)\}", src).group(1)
    vals = [int(w.strip().rstrip("ULL"), 16) for w in words.split(",")]
    assert sum(v << (64 * i) for i, v in enumerate(vals)) == sc.L
    assert f"#define L_TOP_BIT {sc.L.bit_length() - 1}" in src


# -- the fill and aggregation kernels' order: the split mirrors -------------


def test_fill_chunks_and_aggregate_segments():
    """The kernels' thread mappings at the main path's shapes (B = 8192)
    and the rules behind them."""
    assert msm_cuda.fill_chunks(698, 64 * 32) == 16        # torsion grid
    assert msm_cuda.fill_chunks(129, 18 * 128) == 8        # z grid
    assert msm_cuda.fill_chunks(129, 37 * 128) == 4        # 253-bit grid
    assert msm_cuda.fill_chunks(129, 31 * 129) == 8        # s8l3
    assert msm_cuda.fill_chunks(15, 10 ** 6) == 1
    assert msm_cuda.fill_chunks(3, 64) == 2
    wave = msm_cuda.FILL_WAVE_THREADS
    for rounds in (1, 7, 16, 40, 129, 698, 5000):
        for lanes in (1, 2048, 4736, 10 ** 5):
            c = msm_cuda.fill_chunks(rounds, lanes)
            assert c & (c - 1) == 0 and 1 <= c <= msm_cuda.WARP
            assert c == 1 or (c <= rounds and lanes * c <= wave)
            assert (c == msm_cuda.WARP or 2 * c > rounds
                    or lanes * 2 * c > wave)
    for nb in (2, 32, 33, 64, 65, 128, 129, 256):
        s = msm_cuda.aggregate_segment(nb)
        assert s & (s - 1) == 0
        assert msm_cuda.WARP * s >= nb - 1 > msm_cuda.WARP * s // 2 or s == 1
    assert [msm_cuda.aggregate_segment(nb) for nb in (32, 128, 129, 256)] == [
        1, 4, 4, 8]


@pytest.fixture(scope="module")
def point_pool(clean_points):
    """Z = 1 points: the clean case's A || R, the decodable torsion
    encodings (small order) and the points with y within 19 of p."""
    from firedancer_tpu_torch.ballet.ed25519 import corpus, oracle

    enc = np.frombuffer(b"".join(corpus.torsion_encodings()),
                        np.uint8).reshape(-1, 32)
    tors, ok, small = curve_cuda.decompress_so(torch.from_numpy(enc.copy()))
    assert bool(small[ok].all())
    edge = []
    for k in range(1, 20):
        x = oracle._recover_x(fe.P - k, 0)
        if x:
            edge += [(x, fe.P - k), (fe.P - x, fe.P - k)]
    edge_pts = ge.to_limbs51(tuple(
        fe.fe_from_int([q[0] for q in edge]) if c == 0 else
        fe.fe_from_int([q[1] for q in edge]) if c == 1 else
        fe.fe_from_int([1] * len(edge)) if c == 2 else
        fe.fe_from_int([q[0] * q[1] for q in edge]) for c in range(4)))
    return torch.cat([clean_points, tors[ok], edge_pts])


def _slot_table(nw, nb, rounds, chunks, n_points, seed):
    """(nw, nb, R) int32 table of prefixes: lanes of 0, 1, C - 1, C,
    C + 1, 2C + 1 and R points, the rest random in [0, R]."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, rounds + 1, nw * nb)
    special = [0, 1, chunks - 1, chunks, chunks + 1, 2 * chunks + 1, rounds]
    special = np.clip(special, 0, rounds)[:nw * nb]
    counts[:len(special)] = special
    idx = np.full((nw * nb, rounds), -1, np.int32)
    for lane, n in enumerate(counts):
        idx[lane, :n] = rng.integers(0, n_points, n)
    return torch.from_numpy(idx.reshape(nw, nb, rounds))


def _neg_table(idx, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2, idx.shape).astype(bool)) & (
        idx >= 0)


def _same_points(a, b):
    np.testing.assert_array_equal(convert.point_to_affine_bytes(a),
                                  convert.point_to_affine_bytes(b))


@pytest.mark.parametrize("nb,chunks,rounds", [
    (2, 1, 3), (32, 4, 11), (33, 2, 9), (128, 8, 19), (129, 32, 70),
    (129, 16, 33)])
def test_fill_split_gives_the_jax_order_points(point_pool, nb, chunks,
                                               rounds):
    """Every lane of the split mirror is the JAX-order lane's point, on
    prefix tables whose lanes hold 0, 1, C - 1, C, C + 1, 2C + 1 and R
    points, torsion and y ~ p points among them, signed heights with
    negated slots; empty lanes are the identity."""
    niels = ge.niels_limbs(point_pool)
    idx = _slot_table(2, nb, rounds, chunks, point_pool.shape[0], nb)
    neg = _neg_table(idx, nb) if nb % 2 else None
    got = msm_cuda.fill_buckets_split_ref(niels, idx, neg, chunks=chunks)
    _same_points(got, msm_cuda.fill_buckets_ref(niels, idx, neg))
    empty = (idx < 0).all(dim=-1).reshape(-1)
    assert bool(ge.is_identity_limbs(got)[empty].all())


@pytest.mark.parametrize("nb", [2, 32, 33, 64, 128, 129, 256])
def test_aggregate_split_gives_the_jax_order_points(point_pool, nb):
    """Three columns: random pool points (torsion and y ~ p points among
    them), negated points (limbs up to 2^52, point_neg_limbs), identity
    buckets, and a column that is the identity but for its top bucket;
    segments run short or empty where 32 s > nb - 1."""
    rng = np.random.default_rng(100 + nb)
    pick = torch.from_numpy(rng.integers(0, point_pool.shape[0], 3 * nb))
    buckets = point_pool[pick].clone()
    flip = torch.from_numpy(rng.integers(0, 2, 3 * nb).astype(bool))
    buckets[flip] = ge.point_neg_limbs(buckets[flip])
    ident = ge.to_limbs51(ge.identity((1,)))
    buckets[torch.from_numpy(rng.integers(0, 2, 3 * nb).astype(bool))] = ident
    buckets = buckets.reshape(3, nb, 4, 5)
    buckets[2, :nb - 1] = ident
    buckets[0, nb - 1] = ge.point_neg_limbs(point_pool[:1])[0]
    assert int(buckets.max()) >= 1 << 51
    got = msm_cuda.aggregate_buckets_split_ref(buckets)
    _same_points(got, msm_cuda.aggregate_buckets_ref(buckets))


def test_split_order_changes_the_limbs_not_the_points(golden, clean_points,
                                                      torsion_buckets):
    """The JAX kernels' torsion fill and its trials' aggregation: the
    split mirrors give the goldens' points in other projective
    coordinates on every lane with more than one point, which is why the
    kernels are held to the JAX order affinely and to their mirrors
    exactly."""
    idx, _, jax_order = torsion_buckets
    np.testing.assert_array_equal(convert.point_digest(jax_order),
                                  golden["kernel/fill_dig"])
    nb = 1 << msm_plan.TORSION_BUCKET_BITS
    k = golden["clean/u"].shape[0]
    multi = ((idx >= 0).sum(dim=-1) > 1).reshape(-1).numpy()
    assert multi.any()
    for chunks in (None, 4):
        split = msm_cuda.fill_buckets_split_ref(ge.niels_limbs(clean_points),
                                                idx, chunks=chunks)
        np.testing.assert_array_equal(convert.point_to_affine_bytes(split),
                                      golden["kernel/fill_aff"])
        differ = (convert.point_digest(split)
                  != golden["kernel/fill_dig"]).any(axis=1)
        assert differ[multi].all()
        agg = msm_cuda.aggregate_buckets_split_ref(split.reshape(k, nb, 4, 5))
        np.testing.assert_array_equal(convert.point_to_affine_bytes(agg),
                                      golden["u7/clean/sub_aff"])
        assert (convert.point_digest(agg)
                != golden["u7/clean/sub_dig"]).any(axis=1).all()


# A limb-exact transcription of csrc/fe25519.cuh and msm.cuh in Python
# integers: five radix-2^51 limbs, with the ranges the CUDA code relies
# on asserted at every step (u64 limbs, u128 column sums, fe_sub's 4p
# offset larger than the subtrahend's limbs).
_M51 = (1 << 51) - 1
_FOUR_P = [(1 << 53) - 76] + [(1 << 53) - 4] * 4
_K_D2 = [(fe.D2_INT >> (51 * i)) & _M51 for i in range(5)]
_K_ZERO, _K_ONE = [0] * 5, [1, 0, 0, 0, 0]


def _k_carry(a):
    assert all(0 <= v < 1 << 63 for v in a)
    a = list(a)
    for i in range(4):
        a[i + 1] += a[i] >> 51
        a[i] &= _M51
    a[0] += 19 * (a[4] >> 51)
    a[4] &= _M51
    a[1] += a[0] >> 51
    a[0] &= _M51
    return a


def _k_add(a, b):
    return _k_carry([x + y for x, y in zip(a, b)])


def _k_sub(a, b):
    assert all(y < f for y, f in zip(b, _FOUR_P))
    return _k_carry([x + f - y for x, y, f in zip(a, b, _FOUR_P)])


def _k_wide(t):
    assert all(v < 1 << 128 for v in t)
    r = [0] * 5
    for i in range(4):
        assert t[i] >> 51 < 1 << 64
        t[i + 1] += t[i] >> 51
        assert t[i + 1] < 1 << 128
        r[i] = t[i] & _M51
    c = t[4] >> 51
    assert c < 1 << 64
    r[4] = t[4] & _M51
    w = r[0] + 19 * c
    r[0] = w & _M51
    r[1] += w >> 51
    assert all(v < 1 << 52 for v in r)
    return r


def _k_mul(a, b):
    b19 = [19 * v for v in b]
    assert all(v < 1 << 64 for v in a + b19)
    return _k_wide([sum(a[i] * (b[k - i] if i <= k else b19[k - i + 5])
                        for i in range(5)) for k in range(5)])


def _k_sq(a):
    a0, a1, a2, a3, a4 = a
    d0, d1, d2, a3_19, a4_19 = 2 * a0, 2 * a1, 2 * a2, 19 * a3, 19 * a4
    assert all(v < 1 << 64 for v in (d0, d1, d2, a3_19, a4_19, 2 * a3))
    return _k_wide([a0 * a0 + d1 * a4_19 + d2 * a3_19,
                    d0 * a1 + d2 * a4_19 + a3 * a3_19,
                    d0 * a2 + a1 * a1 + 2 * a3 * a4_19,
                    d0 * a3 + d1 * a2 + a4 * a4_19,
                    d0 * a4 + d1 * a3 + a2 * a2])


def _k_out(e, f, g, h):
    return (_k_mul(e, f), _k_mul(g, h), _k_mul(f, g), _k_mul(e, h))


def _k_madd(p, q):
    x, y, z, t = p
    yp, ym, t2d = q
    a, b = _k_mul(_k_sub(y, x), ym), _k_mul(_k_add(y, x), yp)
    c, d = _k_mul(t, t2d), _k_add(z, z)
    return _k_out(_k_sub(b, a), _k_sub(d, c), _k_add(d, c), _k_add(b, a))


def _k_add_ext(p, q):
    a = _k_mul(_k_sub(p[1], p[0]), _k_sub(q[1], q[0]))
    b = _k_mul(_k_add(p[1], p[0]), _k_add(q[1], q[0]))
    c = _k_mul(_k_mul(p[3], q[3]), _K_D2)
    zz = _k_mul(p[2], q[2])
    d = _k_add(zz, zz)
    return _k_out(_k_sub(b, a), _k_sub(d, c), _k_add(d, c), _k_add(b, a))


def _k_double(p):
    x, y, z, _ = p
    a, b, zz = _k_sq(x), _k_sq(y), _k_sq(z)
    c, d = _k_add(zz, zz), _k_sub(_K_ZERO, a)
    e = _k_sub(_k_sub(_k_sq(_k_add(x, y)), a), b)
    g = _k_add(d, b)
    return _k_out(e, _k_sub(g, c), g, _k_sub(d, b))


def _k_identity():
    return (_K_ZERO, _K_ONE, _K_ONE, _K_ZERO)


def _k_butterfly(vals):
    """ge_warp_tree: every thread adds its xor partner's point."""
    o = len(vals) // 2
    while o:
        vals = [_k_add_ext(vals[j], vals[j ^ o]) for j in range(len(vals))]
        o //= 2
    return vals[0]


def _k_fill_lane(niels, row, negs, chunks):
    """msm_fill_kernel for one lane: its C threads, then the butterfly."""
    parts = []
    for c in range(chunks):
        acc = _k_identity()
        for r in range(c, len(row), chunks):
            if row[r] < 0:
                break
            yp, ym, t2d = (list(v) for v in niels[row[r]])
            if negs is not None and negs[r]:
                yp, ym, t2d = ym, yp, _k_sub(_K_ZERO, t2d)
            acc = _k_madd(acc, (yp, ym, t2d))
        parts.append(acc)
    return _k_butterfly(parts)


def _k_aggregate_column(col, seg):
    """msm_aggregate_kernel for one column: 32 threads' segments, the
    suffix scan, U_0 := identity, log2 s doublings, T_j + s U_j, the
    butterfly."""
    nb = len(col)
    s_j, t_j = [], []
    for j in range(32):
        lo, s, t = 1 + j * seg, _k_identity(), _k_identity()
        hi = min(lo + seg - 1, nb - 1)
        if lo <= hi:
            s = t = col[hi]
            for b in range(hi - 1, lo - 1, -1):
                s = _k_add_ext(s, col[b])
                t = _k_add_ext(t, s)
        s_j.append(s)
        t_j.append(t)
    u, o = s_j, 1
    while o < 32:
        u = [_k_add_ext(u[j], u[j + o]) if j + o < 32 else u[j]
             for j in range(32)]
        o *= 2
    u[0] = _k_identity()
    for _ in range(seg.bit_length() - 1):
        u = [_k_double(p) for p in u]
    return _k_butterfly([_k_add_ext(t, v) for t, v in zip(t_j, u)])


def _k_ints(pt):
    return [sum(v << (51 * i) for i, v in enumerate(c)) % fe.P for c in pt]


def _limb_ints(t: torch.Tensor):
    return [[sum(int(v) << (51 * i) for i, v in enumerate(c)) % fe.P
             for c in lane] for lane in t.tolist()]


def test_fill_transcription_matches_the_mirror_at_the_largest_limbs():
    """Niels forms whose every limb is 2^51 - 1 (and random ones), on the
    signed height 33 with negated slots and C = 8: the CUDA arithmetic
    stays in its ranges through the adds and the butterfly, and the
    transcription equals fill_buckets_split_ref coordinate for
    coordinate."""
    rng = np.random.default_rng(8)
    niels = torch.from_numpy(rng.integers(0, 1 << 51, (6, 3, 5)))
    niels[0] = _M51
    idx = _slot_table(1, 33, 20, 8, 6, 8)
    idx[0, :, 0] = torch.where(idx[0, :, 0] >= 0, 0, idx[0, :, 0])
    neg = _neg_table(idx, 8)
    want = _limb_ints(msm_cuda.fill_buckets_split_ref(niels, idx, neg,
                                                      chunks=8))
    rows, negs = idx[0].tolist(), neg[0].tolist()
    for lane in range(33):
        got = _k_fill_lane(niels.tolist(), rows[lane], negs[lane], 8)
        assert _k_ints(got) == want[lane], lane


@pytest.mark.parametrize("nb", [32, 129, 256])
def test_aggregate_transcription_matches_the_mirror_at_the_largest_limbs(nb):
    """Bucket limbs of 2^52 - 1, the most the kernels take (and random
    ones below 2^52), at s = 1, 4 and 8: the CUDA arithmetic stays in its
    ranges through the segments, scan, doublings and butterfly, and the
    transcription equals aggregate_buckets_split_ref."""
    rng = np.random.default_rng(nb)
    buckets = torch.from_numpy(rng.integers(0, 1 << 52, (1, nb, 4, 5)))
    buckets[0, nb - 1] = (1 << 52) - 1
    buckets[0, ::3] = (1 << 52) - 1
    want = _limb_ints(msm_cuda.aggregate_buckets_split_ref(buckets))
    col = [tuple(list(c) for c in b) for b in buckets[0].tolist()]
    got = _k_aggregate_column(col, msm_cuda.aggregate_segment(nb))
    assert _k_ints(got) == want[0]


# The quad mapping of csrc/ge_quad.cuh, thread by thread: a quad is the
# list of its four threads' fe (thread q holds coordinate q of X, Y, Z,
# T), a shuffle hands a thread another thread's value, and every thread's
# own arithmetic (the operands fe_pick discards included) runs through
# the _k_* helpers, which assert the CUDA ranges.


def _q_idx(v, src):
    """fe_shfl_idx(v, src, 4): every thread gets thread src's value."""
    return [v[src]] * 4


def _q_xor1(v):
    """fe_shfl_xor(v, 1)."""
    return [v[q ^ 1] for q in range(4)]


def _q_stage2(e, f, g, h):
    """quad_stage2: e, f, g, h are the same on every thread."""
    return [_k_mul((e, g, f, e)[q], (f, h, g, h)[q]) for q in range(4)]


def _q_double(p):
    x, y = _q_idx(p, 0), _q_idx(p, 1)
    t = [_k_sq((p[q], p[q], p[q], _k_add(x[q], y[q]))[q]) for q in range(4)]
    t = [(t[q], t[q], _k_add(t[q], t[q]), t[q])[q] for q in range(4)]
    a, b, c, sq = (_q_idx(t, j)[0] for j in range(4))
    d = _k_sub(_K_ZERO, a)
    e = _k_sub(_k_sub(sq, a), b)
    g = _k_add(d, b)
    return _q_stage2(e, _k_sub(g, c), g, _k_sub(d, b))


def _q_add(p, tq):
    o = _q_xor1(p)
    t = [_k_mul((_k_sub(o[q], p[q]), _k_add(p[q], o[q]), o[q], o[q])[q],
                tq[q]) for q in range(4)]
    a, b, c, d = (_q_idx(t, j)[0] for j in range(4))
    return _q_stage2(_k_sub(b, a), _k_sub(d, c), _k_add(d, c), _k_add(b, a))


def _q_cached(p):
    o = _q_xor1(p)
    return [(_k_sub(o[q], p[q]), _k_add(p[q], o[q]), _k_mul(o[q], _K_D2),
             _k_add(o[q], o[q]))[q] for q in range(4)]


def _q_horner(w, w_bits):
    """msm_horner.cu horner_quad: from the top window down, w_bits
    quad_doubles and a quad_add of the window's cached form."""
    r = list(w[-1])
    for t in range(len(w) - 2, -1, -1):
        for _ in range(w_bits):
            r = _q_double(r)
        r = _q_add(r, _q_cached(w[t]))
    return r


def _q_ladder(p):
    """msm_order.cu order_quad: P's cached form once, then per bit of L
    below the leading one a quad_double and, on a set bit, a quad_add."""
    pc = _q_cached(p)
    r = list(p)
    for bit in bin(sc.L)[3:]:
        r = _q_double(r)
        if bit == "1":
            r = _q_add(r, pc)
    return r


def _canonical_limbs(quad):
    return [[(v >> (51 * i)) & _M51 for i in range(5)] for v in _k_ints(quad)]


def _rows(t: torch.Tensor):
    """(n, 4, 5) limbs -> n quads of Python-int limbs."""
    return [[list(c) for c in row] for row in t.tolist()]


def test_quad_formulas_match_the_one_thread_formulas():
    """quad_double, quad_add (on quad_cached's form) and quad_cached
    give the field elements of the one-thread transcription (_k_double,
    _k_add_ext), at limbs of 2^52 - 1 and random ones below 2^52."""
    rng = np.random.default_rng(81)
    pts = torch.from_numpy(rng.integers(0, 1 << 52, (4, 4, 5)))
    pts[0] = (1 << 52) - 1
    p, q = _rows(pts[:2]), _rows(pts[2:])
    for a, b in zip(p, q):
        assert _k_ints(_q_double(a)) == _k_ints(_k_double(a))
        assert _k_ints(_q_add(a, _q_cached(b))) == _k_ints(_k_add_ext(a, b))
        x, y, z, t = _k_ints(b)
        assert _k_ints(_q_cached(b)) == [(y - x) % fe.P, (y + x) % fe.P,
                                         fe.D2_INT * t % fe.P, 2 * z % fe.P]


@pytest.mark.parametrize("w_bits", [6, 7, 8])
@pytest.mark.parametrize("nw", [1, 2, 18, 37, 43])
def test_quad_horner_matches_the_plain_version(nw, w_bits):
    """The quad Horner of msm_horner.cu against window_horner_ref,
    canonical limb for limb, at the plans' widths and window counts (18
    and 37 the baseline's, 43 the most a plan has), on window sums with
    limbs of 2^52 - 1 and random ones below 2^52."""
    rng = np.random.default_rng(100 * nw + w_bits)
    w = torch.from_numpy(rng.integers(0, 1 << 52, (nw, 4, 5)))
    w[::3] = (1 << 52) - 1
    want = msm_cuda.window_horner_ref(w, w_bits)[0].tolist()
    assert _canonical_limbs(_q_horner(_rows(w), w_bits)) == want


def _ladder_points(clean_points):
    """The eight torsion points (the identity, order 2, 4 and 8) at Z = 1
    and at a random Z, two clean points, both negated (limbs up to
    2^52), and a row of limbs 2^52 - 1."""
    from firedancer_tpu_torch.ballet.ed25519 import corpus, oracle

    rng = np.random.default_rng(5)
    t8 = corpus._order8_point()
    rows = []
    for k in range(8):
        x, y = oracle.scalarmult(k, t8)
        for z in (1, int(rng.integers(2, 1 << 62))):
            rows.append([v * z % fe.P for v in (x, y, 1, x * y)])
    tors = torch.tensor([[[(v >> (51 * i)) & _M51 for i in range(5)]
                          for v in r] for r in rows], dtype=torch.int64)
    clean = clean_points[:2]
    ones = torch.full((1, 4, 5), (1 << 52) - 1, dtype=torch.int64)
    return torch.cat([tors, clean, ge.point_neg_limbs(clean), ones])


def test_quad_ladder_matches_the_plain_version(clean_points):
    """The quad ladder of msm_order.cu against mul_by_group_order_ref,
    canonical limb for limb: [L] T is the identity for the identity and
    the clean points and a point of T's order for the other torsion
    points (L = 5 mod 8)."""
    pts = _ladder_points(clean_points)
    want = msm_cuda.mul_by_group_order_ref(pts)
    for row, exp in zip(_rows(pts), want.tolist()):
        assert _canonical_limbs(_q_ladder(row)) == exp
    ident = ge.is_identity_limbs(want).tolist()
    assert ident == [True, True] + [False] * 14 + [True] * 4 + [False]


def test_horner_chunks_visit_every_window_once():
    """horner_quad's chunk loops (HORNER_CHUNK from the source): every
    window below the top one, once, from the top down, for nw = 1 to
    three chunks and more."""
    src = (ROOT / "firedancer_tpu_torch" / "ops" / "csrc" /
           "msm_horner.cu").read_text()
    chunk = int(re.search(r"#define HORNER_CHUNK (\d+)", src).group(1))
    for nw in range(1, 3 * chunk + 3):
        seen = []
        hi = nw - 2
        while hi >= 0:
            lo = max(hi - chunk + 1, 0)
            formed = {min(t0 + quad, hi) for t0 in range(lo, hi + 1, 8)
                      for quad in range(8) if t0 + quad <= hi}
            assert formed == set(range(lo, hi + 1))
            seen += list(range(hi, lo - 1, -1))
            hi -= chunk
        assert seen == list(range(nw - 2, -1, -1))


def test_combine_points_on_the_cpu_runs_the_three_plain_versions():
    """combine_points' outputs on CPU tensors equal the two Horners and
    the ladder called one by one, and only their plain versions run."""
    rng = np.random.default_rng(9)
    plan = msm_plan.parse_plan("u6l3")
    parts = {"w_r": torch.from_numpy(rng.integers(0, 1 << 51, (3, 4, 5))),
             "w_m": torch.from_numpy(rng.integers(0, 1 << 51, (4, 4, 5))),
             "sub": torch.from_numpy(rng.integers(0, 1 << 51, (2, 4, 5))),
             "ok_r": torch.tensor(True), "ok_m": torch.tensor(True),
             "sub_ok": torch.tensor(False)}
    backend.reset_counts()
    t1, t2, cert, ok = vr.combine_points(parts, plan)
    assert backend.launches == {}
    assert backend.plain_calls == {"msm_horner": 2, "msm_order": 1}
    want_t1, ok_r = msm.msm_fast_combine(parts["w_r"], parts["ok_r"], plan)
    want_t2, ok_m = msm.msm_fast_combine(parts["w_m"], parts["ok_m"], plan)
    want_cert, sub_ok = msm.subgroup_fast_combine(parts["sub"],
                                                  parts["sub_ok"])
    assert torch.equal(t1, want_t1) and torch.equal(t2, want_t2)
    assert bool(cert) == bool(want_cert)
    assert bool(ok) == bool(ok_r & ok_m & sub_ok)
    parts["sub"] = ge.to_limbs51(ge.identity((2,)))
    parts["sub_ok"] = torch.tensor(True)
    _, _, cert, ok = vr.combine_points(parts, plan)
    assert bool(cert) and bool(ok) and not bool(want_cert)


@pytest.mark.parametrize("wrapper,args", [
    ("msm_tails_cuda", lambda p: (p, p, p, 7)),
    ("window_horner_cuda", lambda p: (p, 7)),
    ("mul_by_group_order_cuda", lambda p: (p,))])
def test_tails_kernels_refuse_cpu_tensors(wrapper, args):
    pts = torch.zeros(2, 4, 5, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(msm_cuda, wrapper)(*args(pts))


@pytest.mark.parametrize("wrapper,args", [
    ("fill_buckets_cuda", lambda n: (n, torch.zeros(4, 3,
                                                    dtype=torch.int32))),
    ("aggregate_buckets_cuda", lambda n: (torch.zeros(2, 8, 4, 5,
                                                      dtype=torch.int64),))])
def test_fill_and_aggregate_kernels_refuse_cpu_tensors(wrapper, args):
    niels = torch.zeros(3, 3, 5, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(msm_cuda, wrapper)(*args(niels))


@pytest.mark.parametrize("source,line", [
    ("msm_fill.cu", "if (chunks < 1 || chunks > 32 ||"),
    ("msm_aggregate.cu", "#define AGG_WARP 32")])
def test_kernel_warp_width_matches_the_wrappers(source, line):
    """The fill's most threads a lane and the aggregation's threads a
    column are the warp the mirrors (msm_cuda.WARP) split over."""
    assert msm_cuda.WARP == 32
    src = (ROOT / "firedancer_tpu_torch" / "ops" / "csrc" /
           source).read_text()
    assert line in src
