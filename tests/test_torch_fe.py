"""Field arithmetic of the PyTorch port against the JAX package.

The same seeded inputs go through firedancer_tpu.ops.fe25519 and the
port's plain version (firedancer_tpu_torch.ops.fe25519); outputs are
compared as canonical bytes, exactly. The constants compiled into the
CUDA kernels are parsed out of their sources and held against the
oracle, since the kernels themselves build only on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import curve25519 as jge
from firedancer_tpu.ops import fe25519 as jfe
from firedancer_tpu_torch import convert
from firedancer_tpu_torch.ballet.ed25519 import oracle
from firedancer_tpu_torch.ops import fe25519 as fe
from firedancer_tpu_torch.ops import sc25519, sha512

torch.set_num_threads(1)

P = fe.P
CSRC = Path(__file__).resolve().parents[1] / "firedancer_tpu_torch" / "ops" / "csrc"
EDGE = [0, 1, 2, 19, P - 1, P, P + 1, P + 18, 2**255 - 1, 2**255 - 20,
        2**254, 2**51 - 1, 2**51, 2**204 + 7]


def _bytes(values):
    return np.array([list(v.to_bytes(32, "little")) for v in values],
                    np.uint8)


def _inputs(seed: int, n: int = 64):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, (n, 32), dtype=np.uint8)
    b = rng.randint(0, 256, (n, 32), dtype=np.uint8)
    a[:len(EDGE)] = _bytes(EDGE)
    b[len(EDGE):2 * len(EDGE)] = _bytes(EDGE)
    a[:, 31] &= 0x7F
    b[:, 31] &= 0x7F
    return a, b


def _chain(mul, add, sub, a, b):
    x = a
    for _ in range(6):
        x = mul(sub(x, b), add(x, a))
    return x


OPS = {
    "mul": (fe.fe_mul, jfe.fe_mul),
    "sq": (lambda a, b: fe.fe_sq(a), lambda a, b: jfe.fe_sq(a)),
    "add": (fe.fe_add, jfe.fe_add),
    "sub": (fe.fe_sub, jfe.fe_sub),
    "neg": (lambda a, b: fe.fe_neg(a), lambda a, b: jfe.fe_neg(a)),
    "chain": (lambda a, b: _chain(fe.fe_mul, fe.fe_add, fe.fe_sub, a, b),
              lambda a, b: _chain(jfe.fe_mul, jfe.fe_add, jfe.fe_sub, a, b)),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_jax(op, seed):
    port_fn, jax_fn = OPS[op]
    a, b = _inputs(seed)
    got = fe.fe_to_bytes(port_fn(fe.fe_from_bytes(torch.from_numpy(a)),
                                 fe.fe_from_bytes(torch.from_numpy(b))))
    want = jfe.fe_to_bytes(jax_fn(jfe.fe_from_bytes(jnp.asarray(a)),
                                  jfe.fe_from_bytes(jnp.asarray(b))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mask_high_bit", [True, False])
def test_canonical_bytes_at_p_boundary(mask_high_bit):
    """Every y in [p, 2^255) and both sign bits reduce like JAX's."""
    vals = [y | (s << 255) for y in range(P - 3, 2**255) for s in (0, 1)]
    enc = _bytes(vals)
    got = fe.fe_to_bytes(fe.fe_from_bytes(torch.from_numpy(enc),
                                          mask_high_bit)).numpy()
    want = np.asarray(jfe.fe_to_bytes(jfe.fe_from_bytes(jnp.asarray(enc),
                                                        mask_high_bit)))
    np.testing.assert_array_equal(got, want)
    keep = (1 << 255) - 1 if mask_high_bit else (1 << 256) - 1
    np.testing.assert_array_equal(got, _bytes([(v & keep) % P for v in vals]))


@pytest.mark.parametrize("fn,exp", [(fe.fe_invert, P - 2),
                                    (fe.fe_pow22523, (P - 5) // 8)],
                         ids=["invert", "pow22523"])
def test_power_chains_match_python(fn, exp):
    rng = np.random.RandomState(3)
    vals = EDGE + [int.from_bytes(rng.bytes(32), "little") % P
                   for _ in range(18)]
    got = fe.fe_to_int(fn(fe.fe_from_int(vals)))
    assert got == [pow(v % P, exp, P) for v in vals]


def test_predicates_match_jax():
    a, _ = _inputs(5)
    a[:4] = _bytes([0, P, 1, P - 1])
    x = fe.fe_from_bytes(torch.from_numpy(a))
    jx = jfe.fe_from_bytes(jnp.asarray(a))
    np.testing.assert_array_equal(fe.fe_is_zero(x).numpy(),
                                  np.asarray(jfe.fe_is_zero(jx)))
    np.testing.assert_array_equal(fe.fe_is_negative(x).numpy(),
                                  np.asarray(jfe.fe_is_negative(jx)))


def test_limbs51_round_trip():
    a, _ = _inputs(6)
    x = fe.fe_from_bytes(torch.from_numpy(a))
    l51 = fe.fe_to_limbs51(x)
    assert int(l51.max()) < 2**51 and int(l51.min()) >= 0
    np.testing.assert_array_equal(
        fe.fe_to_bytes(fe.fe_from_limbs51(l51)).numpy(),
        fe.fe_to_bytes(x).numpy())


def test_convert_field_elements_from_jax():
    """Lazy JAX limbs (a product's output) carried across equal the
    port's own product in canonical bytes, both ways of normalising."""
    a, b = _inputs(7)
    jprod = jfe.fe_mul(jfe.fe_from_bytes(jnp.asarray(a)),
                       jfe.fe_from_bytes(jnp.asarray(b)))
    carried = convert.fe_from_jax_limbs(np.asarray(jprod))
    port = fe.fe_to_limbs51(fe.fe_mul(fe.fe_from_bytes(torch.from_numpy(a)),
                                      fe.fe_from_bytes(torch.from_numpy(b))))
    assert torch.equal(carried, port)
    np.testing.assert_array_equal(convert.fe_to_canonical_bytes(port),
                                  convert.fe_to_canonical_bytes(
                                      np.asarray(jprod)))
    np.testing.assert_array_equal(convert.fe_to_canonical_bytes(port),
                                  np.asarray(jfe.fe_to_bytes(jprod)))


def test_convert_points_from_jax():
    enc = np.array([list(oracle.point_compress(oracle.scalarmult(k, oracle.B)))
                    for k in (1, 2, 3, 1000)], np.uint8)
    (jx, jy, jz, jt), ok = jge.decompress(jnp.asarray(enc))
    assert bool(np.all(np.asarray(ok)))
    pt = convert.point_from_jax(tuple(np.asarray(c) for c in (jx, jy, jz, jt)))
    assert tuple(pt.shape) == (4, 4, 5)
    np.testing.assert_array_equal(convert.point_to_affine_bytes(pt), enc)
    np.testing.assert_array_equal(
        convert.point_to_affine_bytes((jx, jy, jz)), enc)
    no_t = convert.point_from_jax((jx, jy, jz, None))
    assert torch.equal(no_t, pt)


# -- constants compiled into the kernels --------------------------------


def _c_array(path: Path, name: str) -> list[int]:
    src = path.read_text()
    body = re.search(rf"{name}\[[^\]]*\](?:\[[^\]]*\])*\s*=\s*\{{(.*?)\}};",
                     src, re.S).group(1)
    return [int(v, 0) for v in re.findall(r"(0x[0-9a-fA-F]+|\d+)ULL", body)]


def _radix51(limbs) -> int:
    return sum(v << (51 * i) for i, v in enumerate(limbs))


@pytest.mark.parametrize("name,value", [
    ("FE_D", oracle.D), ("FE_D2", 2 * oracle.D % P),
    ("FE_SQRTM1", oracle.SQRT_M1)])
def test_kernel_field_constants(name, value):
    limbs = _c_array(CSRC / "fe25519.cuh", name)
    assert len(limbs) == 5 and all(v < 2**51 for v in limbs)
    assert _radix51(limbs) == value


@pytest.mark.parametrize("name,want", [
    ("K512", sha512.K), ("SHA512_IV", sha512.IV),
    ("SC_L", [(sc25519.L >> (64 * i)) & (2**64 - 1) for i in range(4)]),
    ("SC_MU", [((1 << 512) // sc25519.L >> (64 * i)) & (2**64 - 1)
               for i in range(5)])])
def test_kernel_sha512_constants(name, want):
    assert _c_array(CSRC / "sha512.cuh", name) == want


def test_sha512_constants_match_hashlib():
    import hashlib

    rows = torch.zeros(1, 0, dtype=torch.uint8)
    got = sha512.sha512_batch(rows, torch.zeros(1, dtype=torch.int32))
    assert bytes(got[0].tolist()) == hashlib.sha512(b"").digest()
