"""The port's scalar arithmetic mod L, power chains and point compression
against the JAX package's TPU kernels: sc_reduce64 and sc_muladd
(sc_pallas.py ``_sc_reduce_kernel``:72, ``_sc_mul_kernel``:76, and
sign.py ``_sc_muladd``:63), fe_invert and fe_pow22523 (pow_pallas.py
``_pow_kernel``:113) and compress (curve_pallas.py ``_compress_kernel``:307).

The plain versions run here on the CPU against goldens of the JAX kernel
bodies, run eagerly on whole-array refs at 256 lanes (what the Pallas
interpreter evaluates), kept in tests/fixtures/torch_port/sign_goldens.npz
and rewritten with ``JAX_PLATFORMS=cpu python -m tests.test_torch_sign``;
and against Python integers and the oracle, lane by lane over the edges.
The CUDA kernels (csrc/sc_reduce.cu, csrc/fe_pow.cu, csrc/compress.cu) are
held against the same plain versions on the card by chip_smoke.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from firedancer_tpu_torch.ballet.ed25519 import corpus, oracle
from firedancer_tpu_torch.ops import (backend, curve_cuda, fe25519, pow_cuda,
                                      sc_cuda)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "torch_port" / "sign_goldens.npz"
L = oracle.L
P = oracle.P
LANES = 256

# x mod L edges: 0, L - 1, L, 2^255 - 1, 2^512 - 1 and their neighbours.
REDUCE_EDGES = [0, 1, L - 1, L, L + 1, 2 * L - 1, 2 * L, 3 * L, 2**252,
                2**253 - 1, 2**255 - 1, 2**256 - 1, 2**256, L * L - 1,
                L * L, 2**508, 2**511, 2**512 - 1,
                (2**512 - 1) // L * L, (2**512 - 1) // L * L - 1]
# (a, b, c) edges of a b + c mod L: zeros, L - 1, L, 2^255 - 1, 2^256 - 1,
# and signing's shape (h < L, a clamped to [2^254, 2^255), r < L).
_CLAMPED = (2**255 - 1) & ~7
MULADD_EDGES = [(0, 0, 0), (0, 2**256 - 1, 0), (1, 1, 0), (L - 1, L - 1, 0),
                (L, 2**256 - 1, 0), (2**255 - 1, 2**255 - 1, 0),
                (2**256 - 1, 2**256 - 1, 0), (2**256 - 1, 2**256 - 1, L - 1),
                (2**256 - 1, 2**256 - 1, 2**256 - 1),
                (L - 1, _CLAMPED, L - 1), (L - 1, 2**254, 0),
                (0, 0, 2**256 - 1), (L, 1, L)]
# z of the power chains, as values < 2^255 (p .. 2^255 - 1 non-canonical).
POW_EDGES = [0, 1, 2, P - 1, P, P + 1, 2**255 - 1, oracle.SQRT_M1,
             oracle.D, 2**254, 2**51, 2**51 - 1]


def _int(b) -> int:
    return int.from_bytes(bytes(b), "little")


def _bytes(values, width: int) -> np.ndarray:
    return np.array([list(v.to_bytes(width, "little")) for v in values],
                    np.uint8).reshape(len(values), width)


def _limbs51(values) -> torch.Tensor:
    """Python ints < 2^255 -> (n, 5) radix-2^51 limbs (not reduced)."""
    return torch.tensor([[(v >> (51 * i)) & fe25519.M51 for i in range(5)]
                         for v in values], dtype=torch.int64).reshape(-1, 5)


def sc_inputs():
    """x (LANES, 64) for the reduction; a, b, c (LANES, 32) for the
    products: the edges first, then seeded random bytes."""
    rng = np.random.RandomState(41)
    x = rng.randint(0, 256, (LANES, 64), dtype=np.uint8)
    x[:len(REDUCE_EDGES)] = _bytes(REDUCE_EDGES, 64)
    a, b, c = (rng.randint(0, 256, (LANES, 32), dtype=np.uint8)
               for _ in range(3))
    for i, (ai, bi, ci) in enumerate(MULADD_EDGES):
        a[i], b[i], c[i] = (_bytes([v], 32)[0] for v in (ai, bi, ci))
    return x, a, b, c


def pow_inputs() -> np.ndarray:
    """(LANES, 32) little-endian values < 2^255: the edges, then random."""
    rng = np.random.RandomState(42)
    z = rng.randint(0, 256, (LANES, 32), dtype=np.uint8)
    z[:, 31] &= 0x7F
    z[:len(POW_EDGES)] = _bytes(POW_EDGES, 32)
    return z


def compress_cases():
    """(name, affine point) cases: the identity, B, the eight torsion
    points, points with y within 19 of p (both x), multiples of B."""
    cases = [("identity", (0, 1)), ("base", oracle.B)]
    torsion = dict.fromkeys(oracle.point_decompress(e)
                            for e in corpus.torsion_encodings())
    cases += [(f"torsion{i}", pt) for i, pt in enumerate(sorted(torsion))]
    for k in range(1, 20):
        x = oracle._recover_x(P - k, 0)
        if x:
            cases += [(f"y=p-{k}", (x, P - k)), (f"y=p-{k},-x", (P - x, P - k))]
    for k in (2, 3, 7, 2**200 + 5):
        cases.append((f"{k:#x}B", oracle.scalarmult(k, oracle.B)))
    return cases


def compress_inputs():
    """(X, Y, Z) (LANES, 32) canonical bytes: each case with Z = 1, then
    each case again scaled by a random lambda (Z != 1), then lambda-scaled
    random multiples of B; and the cases' names."""
    rng = np.random.RandomState(43)
    cases = compress_cases()
    pts = [(x, y, 1) for _, (x, y) in cases]
    while len(pts) < LANES:
        if len(pts) < 2 * len(cases):
            x, y = cases[len(pts) - len(cases)][1]
        else:
            x, y = oracle.scalarmult(int(rng.randint(1, 2**62)), oracle.B)
        lam = int.from_bytes(rng.bytes(32), "little") % (P - 1) + 1
        pts.append((x * lam % P, y * lam % P, lam))
    cols = [_bytes([p[c] for p in pts], 32) for c in range(3)]
    return cols, [name for name, _ in cases]


def _points(cols) -> torch.Tensor:
    """(X, Y, Z) canonical byte columns -> (LANES, 3, 5) port limbs."""
    return torch.stack([fe25519.fe_to_limbs51(fe25519.fe_from_bytes(
        torch.from_numpy(c))) for c in cols], dim=1)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


# -- sc_reduce64 and sc_muladd --------------------------------------------


@pytest.fixture(scope="module")
def sc_port(golden):
    x, a, b, c = (torch.from_numpy(golden[f"sc/{k}"]) for k in "xabc")
    return {"reduce": sc_cuda.sc_reduce64(x).numpy(),
            "mul": sc_cuda.sc_muladd(a, b).numpy(),
            "muladd": sc_cuda.sc_muladd(a, b, c).numpy()}


@pytest.mark.parametrize("out", ("reduce", "mul", "muladd"))
def test_plain_scalar_ops_match_jax_golden(golden, sc_port, out):
    """reduce: _sc_reduce_kernel; mul: _sc_mul_kernel; muladd: the XLA
    _sc_muladd with an addend."""
    np.testing.assert_array_equal(sc_port[out], golden[f"sc/{out}"])


def test_golden_inputs_are_the_edges(golden):
    x, a, b, c = sc_inputs()
    for k, v in zip("xabc", (x, a, b, c)):
        np.testing.assert_array_equal(golden[f"sc/{k}"], v)
    np.testing.assert_array_equal(golden["pow/z"], pow_inputs())
    cols, _ = compress_inputs()
    for k, v in zip("XYZ", cols):
        np.testing.assert_array_equal(golden[f"cmp/{k}"], v)


@pytest.mark.parametrize("value", REDUCE_EDGES, ids=hex)
def test_sc_reduce64_edge(value):
    x = torch.from_numpy(_bytes([value], 64))
    assert _int(sc_cuda.sc_reduce64(x).numpy()[0]) == value % L


@pytest.mark.parametrize("abc", MULADD_EDGES,
                         ids=lambda t: "-".join(hex(v) for v in t))
def test_sc_muladd_edge(abc):
    a, b, c = (torch.from_numpy(_bytes([v], 32)) for v in abc)
    assert _int(sc_cuda.sc_muladd(a, b, c).numpy()[0]) == \
        (abc[0] * abc[1] + abc[2]) % L
    if abc[2] == 0:
        assert _int(sc_cuda.sc_muladd(a, b).numpy()[0]) == \
            abc[0] * abc[1] % L


def test_scalar_ops_match_python_on_random_lanes(golden, sc_port):
    for i in range(len(MULADD_EDGES), len(MULADD_EDGES) + 16):
        x, a, b, c = (_int(golden[f"sc/{k}"][i]) for k in "xabc")
        assert _int(sc_port["reduce"][i]) == x % L
        assert _int(sc_port["mul"][i]) == a * b % L
        assert _int(sc_port["muladd"][i]) == (a * b + c) % L


# -- the power chains -------------------------------------------------------


@pytest.fixture(scope="module")
def pow_port(golden):
    z = _limbs51([_int(r) for r in golden["pow/z"]])
    return {k: fn(z) for k, fn in (("invert", pow_cuda.fe_invert),
                                   ("pow22523", pow_cuda.fe_pow22523))}


@pytest.mark.parametrize("kind", ("invert", "pow22523"))
def test_plain_power_chain_matches_jax_golden(golden, pow_port, kind):
    from firedancer_tpu_torch import convert

    out = pow_port[kind]
    assert bool((out < 2**51).all()) and bool((out >= 0).all())
    np.testing.assert_array_equal(convert.fe_to_canonical_bytes(out),
                                  golden[f"pow/{kind}"])


@pytest.mark.parametrize("value", POW_EDGES, ids=hex)
def test_power_chain_edge(pow_port, value):
    i = POW_EDGES.index(value)
    got = {k: sum(int(v) << (51 * j) for j, v in enumerate(pow_port[k][i]))
           for k in pow_port}
    assert got["invert"] == pow(value, P - 2, P)
    assert got["pow22523"] == pow(value, (P - 5) // 8, P)


# -- compress -----------------------------------------------------------------


@pytest.fixture(scope="module")
def compress_port(golden):
    pts = _points([golden[f"cmp/{k}"] for k in "XYZ"])
    return pts, curve_cuda.compress(pts).numpy()


def test_plain_compress_matches_jax_golden(golden, compress_port):
    np.testing.assert_array_equal(compress_port[1], golden["cmp/enc"])


def test_plain_compress_matches_the_affine_encoding(compress_port):
    from firedancer_tpu_torch import convert

    pts, got = compress_port
    np.testing.assert_array_equal(got, convert.point_to_affine_bytes(pts))


@pytest.mark.parametrize("name", [n for n, _ in compress_cases()])
def test_compress_case_matches_the_oracle(compress_port, name):
    """Each case, at Z = 1 and scaled by lambda, encodes as the oracle
    encodes it; y within 19 of p stays below p, the sign bit is x's
    parity (the torsion cases hold x = 0 and y = +-1)."""
    names = [n for n, _ in compress_cases()]
    i = names.index(name)
    pt = dict(compress_cases())[name]
    want = oracle.point_compress(pt)
    _, got = compress_port
    assert bytes(got[i]) == want
    assert bytes(got[i + len(names)]) == want


def test_compress_of_z_zero_is_zero_bytes():
    pts = _limbs51([1, 1, 0]).reshape(1, 3, 5)
    assert not curve_cuda.compress(pts).numpy().any()


# -- dispatch ---------------------------------------------------------------


def test_plain_versions_count_and_launch_nothing_on_the_cpu():
    t = torch.zeros(2, 32, dtype=torch.uint8)
    backend.reset_counts()
    sc_cuda.sc_reduce64(torch.zeros(2, 64, dtype=torch.uint8))
    sc_cuda.sc_muladd(t, t)
    sc_cuda.sc_muladd(t, t, t)
    pow_cuda.fe_invert(torch.ones(2, 5, dtype=torch.int64))
    pow_cuda.fe_pow22523(torch.ones(2, 5, dtype=torch.int64))
    curve_cuda.compress(torch.ones(2, 3, 5, dtype=torch.int64))
    assert backend.launches == {}
    assert backend.plain_calls == {"sc_reduce64": 1, "sc_muladd": 2,
                                   "fe_pow": 2, "compress": 1}


@pytest.mark.parametrize("fn,args", [
    (sc_cuda.sc_reduce64_cuda, (((2, 64), torch.uint8),)),
    (sc_cuda.sc_muladd_cuda, (((2, 32), torch.uint8),) * 2),
    (sc_cuda.sc_muladd_cuda, (((2, 32), torch.uint8),) * 3),
    (pow_cuda.fe_invert_cuda, (((2, 5), torch.int64),)),
    (pow_cuda.fe_pow22523_cuda, (((2, 5), torch.int64),)),
    (curve_cuda.compress_cuda, (((2, 3, 5), torch.int64),))],
    ids=["sc_reduce64", "sc_mul", "sc_muladd", "fe_invert", "fe_pow22523",
         "compress"])
def test_kernel_wrappers_refuse_cpu_tensors(fn, args):
    with pytest.raises(ValueError, match="CUDA"):
        fn(*(torch.zeros(shape, dtype=dt) for shape, dt in args))


# -- writing the goldens (called by tests/test_torch_sign.py) -------------


def jax_kernel_goldens() -> dict:
    """The JAX package's _sc_reduce_kernel, _sc_mul_kernel, _pow_kernel
    (both kinds) and _compress_kernel run eagerly on LANES-wide whole-array
    refs, with their launch wrappers' packing and unpacking
    (sc_pallas.py:124 and :90, pow_pallas.py:123, curve_pallas.py:318),
    and the XLA _sc_muladd with an addend."""
    import jax.numpy as jnp

    from firedancer_tpu.ops import curve_pallas as cp
    from firedancer_tpu.ops import fe25519 as jfe
    from firedancer_tpu.ops import pow_pallas as pp
    from firedancer_tpu.ops import sc_pallas as sp
    from firedancer_tpu.ops.sign import _sc_muladd
    from firedancer_tpu_torch import convert
    from tests.test_torch_frontend import _Ref

    def cols(a):
        return jnp.moveaxis(jnp.asarray(a).astype(jnp.int32), -1, 0)

    def rows(v):
        return np.asarray(jnp.moveaxis(v, 0, -1).astype(jnp.uint8))

    out = {}
    x, a, b, c = sc_inputs()
    out.update({"sc/x": x, "sc/a": a, "sc/b": b, "sc/c": c})
    o = _Ref()
    sp._sc_reduce_kernel(_Ref(cols(x)), o)
    out["sc/reduce"] = rows(o.value)
    o = _Ref()
    sp._sc_mul_kernel(_Ref(cols(a)), _Ref(cols(b)), o)
    out["sc/mul"] = rows(o.value)
    out["sc/muladd"] = np.asarray(_sc_muladd(*map(jnp.asarray, (a, b, c))))

    z = pow_inputs()
    out["pow/z"] = z
    zl = jfe.fe_from_bytes(jnp.asarray(z), mask_high_bit=True)
    for kind in ("invert", "pow22523"):
        o = _Ref()
        pp._pow_kernel(_Ref(zl), o, kind=kind)
        out[f"pow/{kind}"] = convert.fe_to_canonical_bytes(np.asarray(o.value))

    pts, _ = compress_inputs()
    out.update({f"cmp/{k}": v for k, v in zip("XYZ", pts)})
    cy, sgn = _Ref(), _Ref()
    cp._compress_kernel(*(_Ref(jfe.fe_from_bytes(jnp.asarray(v)))
                          for v in pts), cy, sgn)
    enc = rows(cy.value).copy()
    enc[:, 31] |= (np.asarray(sgn.value[0]) << 7).astype(np.uint8)
    out["cmp/enc"] = enc
    return out
