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
    buckets = msm_cuda.fill_buckets(ge.niels_limbs(clean_points), idx)
    agg = msm_cuda.aggregate_buckets(buckets.reshape(2, 32, 4, 5))
    msm_cuda.window_horner(agg, 7)
    msm_cuda.mul_by_group_order(agg)
    assert backend.launches == {}
    assert backend.plain_calls == {"msm_fill": 1, "msm_aggregate": 1,
                                   "msm_horner": 1, "msm_order": 1}


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
