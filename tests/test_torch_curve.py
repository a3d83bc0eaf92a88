"""Group layer of the PyTorch port against the JAX package and the oracle.

Decompress with the small-order mask, the affine point compare and the
double-scalar multiply run as plain versions on the CPU here, on the
same seeded inputs as the JAX package's CPU/XLA path; points cross the
package boundary with firedancer_tpu_torch.convert and are compared as
canonical bytes, never as raw limbs or projective coordinates. The CUDA
kernels are held against these plain versions on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ballet.ed25519 import oracle as jax_oracle
from firedancer_tpu.ops import curve25519 as jge
from firedancer_tpu.ops import decompress_pallas as jdp
from firedancer_tpu.ops import fe25519 as jfe
from firedancer_tpu_torch import convert
from firedancer_tpu_torch.ballet.ed25519 import corpus, oracle
from firedancer_tpu_torch.ops import backend, curve_cuda, dsm_cuda
from firedancer_tpu_torch.ops import curve25519 as ge
from firedancer_tpu_torch.ops import fe25519 as fe

torch.set_num_threads(1)


def _corpus():
    """(encodings (N, 32) uint8, category per row): the edge corpus,
    oracle-made points and random bytes."""
    rng = np.random.RandomState(21)
    torsion = corpus.torsion_encodings()
    noncanon = [(y | (s << 255)).to_bytes(32, "little")
                for y in range(oracle.P, 1 << 255) for s in (0, 1)]
    bad = corpus.undecodable_encodings(8, rng)
    points = [oracle.point_compress(oracle.scalarmult(k, oracle.B))
              for k in (1, 2, 7, 12345)]
    rand = [rng.randint(0, 256, 32, dtype=np.uint8).tobytes()
            for _ in range(12)]
    rows, cats = [], []
    for cat, encs in (("torsion", torsion), ("noncanonical", noncanon),
                      ("undecodable", bad), ("points", points),
                      ("random", rand)):
        rows += encs
        cats += [cat] * len(encs)
    return np.frombuffer(b"".join(rows), np.uint8).reshape(-1, 32).copy(), cats


@pytest.fixture(scope="module")
def decoded():
    enc, cats = _corpus()
    port = curve_cuda.decompress_so(torch.from_numpy(enc))
    jpt, jok, jso = jdp.decompress_batched_auto(jnp.asarray(enc),
                                                want_small_order=True)
    jax_out = (tuple(np.asarray(c) for c in jpt), np.asarray(jok),
               np.asarray(jso))
    return enc, np.asarray(cats), port, jax_out


CATEGORIES = ["torsion", "noncanonical", "undecodable", "points", "random"]


@pytest.mark.parametrize("cat", CATEGORIES)
def test_decompress_so_masks_match_jax(decoded, cat):
    enc, cats, (pt, ok, so), (jpt, jok, jso) = decoded
    rows = cats == cat
    np.testing.assert_array_equal(ok.numpy()[rows], jok[rows])
    np.testing.assert_array_equal(so.numpy()[rows], jso[rows])
    if cat == "torsion":
        assert ok.numpy()[rows].all() and so.numpy()[rows].all()
    if cat == "undecodable":
        assert not ok.numpy()[rows].any()


@pytest.mark.parametrize("coord", range(4), ids=["X", "Y", "Z", "T"])
@pytest.mark.parametrize("cat", CATEGORIES)
def test_decompress_so_coordinates_match_jax(decoded, cat, coord):
    """Decompress emits affine points (Z = 1), so every coordinate is
    compared as canonical bytes; failed lanes hold the identity."""
    enc, cats, (pt, ok, so), (jpt, jok, jso) = decoded
    rows = cats == cat
    got = convert.fe_to_canonical_bytes(pt[:, coord])[rows]
    want = convert.fe_to_canonical_bytes(jpt[coord])[rows]
    np.testing.assert_array_equal(got, want)


def test_decompress_so_matches_oracle(decoded):
    enc, cats, (pt, ok, so), _ = decoded
    aff = convert.point_to_affine_bytes(pt)
    for b, e in enumerate(enc):
        want = oracle.point_decompress(e.tobytes())
        assert bool(ok[b]) == (want is not None)
        if want is not None:
            assert aff[b].tobytes() == oracle.point_compress(want)
            assert bool(so[b]) == oracle.is_small_order(want)


def _jax_points(ks):
    """k*B for each k as a JAX-layout extended point (Z = 1), built
    from the oracle's affine coordinates."""
    pts = [oracle.scalarmult(k, oracle.B) for k in ks]
    n = (len(pts),)
    x = jnp.concatenate([jfe.int_to_limbs(x, (1,)) for x, _ in pts], 1)
    y = jnp.concatenate([jfe.int_to_limbs(y, (1,)) for _, y in pts], 1)
    t = jnp.concatenate([jfe.int_to_limbs(x * y, (1,)) for x, y in pts], 1)
    return x, y, jfe.fe_one(n), t


def test_point_eq_affine_matches_jax():
    rng = np.random.RandomState(22)
    jx, jy, _, _ = _jax_points(range(1, 17))
    lam = rng.randint(0, 256, (16, 32), dtype=np.uint8)
    lam[:, 31] &= 0x7F
    jl = jfe.fe_from_bytes(jnp.asarray(lam))
    jproj = (jfe.fe_mul(jx, jl), jfe.fe_mul(jy, jl), jl, None)
    # Half the lanes compare against the next lane's point.
    perm = np.where(np.arange(16) % 2 == 0, np.arange(16),
                    (np.arange(16) + 1) % 16)
    jaff = (jx[:, perm], jy[:, perm])
    want = np.asarray(jge.point_eq_affine_xla(jaff, jproj))

    aff = convert.point_from_jax((jx[:, perm], jy[:, perm],
                                  jfe.fe_one((16,)), None))
    proj = convert.point_from_jax(jproj)
    backend.reset_counts()
    got = curve_cuda.point_eq_affine(aff, proj).numpy()
    assert backend.plain_calls == {"point_eq": 1}
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [i % 2 == 0 for i in range(16)]


def _scalars(rng, n):
    return np.array([list((int.from_bytes(rng.bytes(32), "little")
                           % oracle.L).to_bytes(32, "little"))
                     for _ in range(n)], np.uint8)


def test_double_scalarmult_matches_jax_four_windows():
    """Points in the JAX package's layout, carried across with
    convert.point_from_jax, through the port's plain DSM and JAX's
    double_scalarmult over the four most significant windows."""
    rng = np.random.RandomState(23)
    jpt = _jax_points((3, 5, 99, 2**200 + 1))
    h, s = _scalars(rng, 4), _scalars(rng, 4)
    want = jge.double_scalarmult(jnp.asarray(h), jpt, jnp.asarray(s),
                                 n_windows=4)
    a = ge.from_limbs51(convert.point_from_jax(
        tuple(np.asarray(c) for c in jpt)))
    got = ge.double_scalarmult(torch.from_numpy(h), a, torch.from_numpy(s),
                               n_windows=4)
    np.testing.assert_array_equal(
        convert.point_to_affine_bytes(ge.to_limbs51(got[:3])),
        convert.point_to_affine_bytes(want[:3]))


@pytest.mark.parametrize("seed", [24, 25])
def test_double_scalarmult_matches_oracle(seed):
    """All 64 windows against the oracle's scalar arithmetic (the JAX
    package's oracle module): R' = h*(-A) + s*B."""
    rng = np.random.RandomState(seed)
    ks = [11, 2**252 + 3, 424242]
    enc = np.array([list(oracle.point_compress(oracle.scalarmult(k, oracle.B)))
                    for k in ks], np.uint8)
    pt, ok, _ = curve_cuda.decompress_so(torch.from_numpy(enc))
    assert bool(ok.all())
    h, s = _scalars(rng, 3), _scalars(rng, 3)
    h[0] = 0
    s[1] = 0
    got = dsm_cuda.double_scalarmult(torch.from_numpy(h), pt,
                                     torch.from_numpy(s))
    aff = convert.point_to_affine_bytes(got)
    for b, k in enumerate(ks):
        hv = int.from_bytes(h[b].tobytes(), "little")
        sv = int.from_bytes(s[b].tobytes(), "little")
        a_pt = jax_oracle.scalarmult(k, jax_oracle.B)
        a_pt = ((jax_oracle.P - a_pt[0]) % jax_oracle.P, a_pt[1])     # -A
        want = jax_oracle.point_add(jax_oracle.scalarmult(hv, a_pt),
                                    jax_oracle.scalarmult(sv, jax_oracle.B))
        assert aff[b].tobytes() == jax_oracle.point_compress(want)


def test_small_order_mask_on_torsion():
    enc = np.frombuffer(b"".join(corpus.torsion_encodings()),
                        np.uint8).reshape(-1, 32).copy()
    pt, ok = ge.decompress(torch.from_numpy(enc))
    assert bool(ok.all())
    assert bool(ge.small_order_mask(pt).all())
    full = ge.decompress(torch.from_numpy(np.array(
        [list(oracle.point_compress(oracle.B))], np.uint8)))[0]
    assert not bool(ge.small_order_mask(full).any())


@pytest.mark.parametrize("wrapper,args", [
    ("decompress_so_cuda", lambda: (torch.zeros(2, 32, dtype=torch.uint8),)),
    ("point_eq_affine_cuda", lambda: (torch.zeros(2, 4, 5, dtype=torch.int64),
                                      torch.zeros(2, 3, 5, dtype=torch.int64))),
])
def test_curve_kernel_wrappers_refuse_cpu_tensors(wrapper, args):
    with pytest.raises(ValueError, match="CUDA"):
        getattr(curve_cuda, wrapper)(*args())


def test_dsm_kernel_wrapper_refuses_cpu_tensors():
    z = torch.zeros(2, 32, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        dsm_cuda.double_scalarmult_cuda(
            z, torch.zeros(2, 4, 5, dtype=torch.int64), z)


def test_base_table_matches_oracle():
    tab = dsm_cuda.base_table_niels().astype(object)
    for t, (x, y) in enumerate(ge.base_multiples()):
        ypx, ymx, t2d = (sum(int(v) << (51 * i) for i, v in enumerate(c))
                         for c in tab[t])
        assert (ypx, ymx) == ((y + x) % fe.P, (y - x) % fe.P)
        assert t2d == 2 * fe.D_INT * x * y % fe.P
    assert ge.base_multiples()[1] == oracle.B
