"""The Montgomery-batched point decompression of the PyTorch port against
the JAX package: fe_invert_batch, the y = +-1 mask, and the plain version
of the decompress_niels kernel (ops/decompress.py's batched math, the
niels forms and the small-order mask).

The JAX package's batched decompress runs some 30 s per call eagerly on
one CPU core (a ~520-step field chain of eager ops), so tier-1 holds the
port against goldens in tests/fixtures/torch_port/front_goldens.npz:
its XLA graph (decompress_batched_xla, niels formed from its points) at
256 lanes and its TPU kernel (decompress_pallas with want_niels, in
interpret mode) at 1024 lanes, both over the edge corpus: y = +-1 lanes
and non-squares among valid group mates, torsion points, non-canonical
y, and a group whose lanes all fail. The goldens are rewritten by
``JAX_PLATFORMS=cpu python -m tests.test_torch_frontend``; the live
comparisons are slow tests. The CUDA kernel (csrc/decompress_niels.cu)
is held against the same plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from firedancer_tpu_torch import convert
from firedancer_tpu_torch.ballet.ed25519 import corpus, oracle
from firedancer_tpu_torch.ops import backend, curve_cuda
from firedancer_tpu_torch.ops import decompress as dec
from firedancer_tpu_torch.ops import fe25519 as fe

from tests.test_torch_frontend import (DEC_FIELDS, DEC_MASKS, GOLDEN, XLA_B,
                                      _digests, jax_dec_record, jax_niels)

torch.set_num_threads(1)

P = fe.P


def port_record(enc: np.ndarray) -> dict:
    """The plain decompress_niels on encodings, as canonical bytes keyed
    like the goldens."""
    pt, ok, so, niels, neg = curve_cuda.decompress_niels_ref(
        torch.from_numpy(enc))
    rec = {f: convert.fe_to_canonical_bytes(pt[:, c])
           for c, f in enumerate(DEC_FIELDS[:4])}
    for f, t in zip(DEC_FIELDS[4:], (niels[:, 0], niels[:, 1], niels[:, 2],
                                     neg[:, 2])):
        rec[f] = convert.fe_to_canonical_bytes(t)
    rec.update(ok=ok.numpy(), x_zero=dec._y_pm1_mask(
        torch.from_numpy(enc)).numpy(), small_order=so.numpy())
    rec["neg"] = neg
    rec["niels"] = niels
    return rec


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def port_kernel_batch(golden):
    return port_record(golden["dec/enc"])


@pytest.mark.parametrize("field", DEC_FIELDS + DEC_MASKS)
def test_plain_decompress_niels_matches_jax_kernel_golden(
        golden, port_kernel_batch, field):
    got = _digests({field: port_kernel_batch[field]})[field]
    np.testing.assert_array_equal(got, golden[f"dec/kernel/{field}"],
                                  err_msg=field)


@pytest.mark.parametrize("field", DEC_FIELDS + DEC_MASKS)
def test_plain_decompress_niels_matches_jax_xla_golden(
        golden, port_kernel_batch, field):
    got = port_kernel_batch[field][:XLA_B]
    np.testing.assert_array_equal(got, golden[f"dec/xla/{field}"],
                                  err_msg=field)


def test_golden_batch_covers_the_edges(golden, port_kernel_batch):
    """What the golden batch is built to hold, group by group (32 lanes):
    failing and y = +-1 lanes beside valid ones, a whole failing group,
    torsion points and non-canonical y."""
    enc = golden["dec/enc"]
    ok, xz = port_kernel_batch["ok"], port_kernel_batch["x_zero"]
    so = port_kernel_batch["small_order"]
    groups = ok[:XLA_B].reshape(-1, dec.GROUP)
    mixed = (~groups).any(axis=1) & groups.any(axis=1)
    assert mixed.sum() >= 4
    pm1 = xz[:XLA_B].reshape(-1, dec.GROUP)
    assert (pm1.any(axis=1) & (groups & ~pm1).any(axis=1)).sum() >= 2
    assert xz[:XLA_B].sum() >= 6
    assert not ok[256:320].any()
    y = [int.from_bytes(e.tobytes(), "little") & ((1 << 255) - 1)
         for e in enc[:XLA_B]]
    assert sum(v >= P for v in y) >= 2 * 19
    assert (so & ok).sum() >= 16


def test_plain_decompress_equals_the_per_lane_chain(golden):
    """The batched plain version equals the per-lane decompress_so on
    the golden batch: points, ok and the small-order mask."""
    enc = torch.from_numpy(golden["dec/enc"][:XLA_B])
    pt, ok, so, _, _ = curve_cuda.decompress_niels_ref(enc)
    pt1, ok1, so1 = curve_cuda.decompress_so_ref(enc)
    assert torch.equal(pt, pt1) and torch.equal(ok, ok1)
    assert torch.equal(so, so1)


def _one_group(lanes):
    """A 32-lane group: `lanes` (encodings) first, valid points after."""
    rng = np.random.RandomState(50)
    valid = [oracle.point_compress(oracle.scalarmult(int(k), oracle.B))
             for k in rng.randint(1, 2**40, dec.GROUP)]
    enc = list(lanes) + valid[:dec.GROUP - len(lanes)]
    return np.frombuffer(b"".join(enc), np.uint8).reshape(-1, 32).copy()


def _enc(y: int, sign: int = 0) -> bytes:
    return (y | (sign << 255)).to_bytes(32, "little")


_POISON_CASES = {
    "y=+1": [_enc(1), _enc(1, 1)],
    "y=-1": [_enc(P - 1), _enc(P - 1, 1)],
    "y=p+1": [_enc(P + 1, 1)],
    "non-square": corpus.undecodable_encodings(3, np.random.RandomState(51)),
    "all-fail": corpus.undecodable_encodings(dec.GROUP,
                                             np.random.RandomState(52))}


@pytest.mark.parametrize("name", list(_POISON_CASES))
def test_a_lane_does_not_poison_its_group_mates(name):
    """Lanes with u = 0 or no square root share the inversion of their
    group with valid lanes; every lane still equals the per-lane chain."""
    enc = torch.from_numpy(_one_group(_POISON_CASES[name]))
    pt, ok, so, niels, neg = curve_cuda.decompress_niels_ref(enc)
    pt1, ok1, so1 = curve_cuda.decompress_so_ref(enc)
    assert torch.equal(pt, pt1) and torch.equal(ok, ok1), name
    assert torch.equal(so, so1)
    fails = ~ok
    assert torch.equal(niels[fails], torch.tensor(
        [[1, 0, 0, 0, 0], [1, 0, 0, 0, 0], [0] * 5]).expand(
            int(fails.sum()), 3, 5))
    assert torch.equal(neg[fails], niels[fails])


@pytest.mark.parametrize("bsz", [1, 31, 33, 45, 70])
def test_batches_off_the_group_are_padded(bsz):
    """B not a multiple of the group: the plain version pads with 1 and
    the outputs equal the per-lane chain."""
    rng = np.random.RandomState(bsz)
    enc = torch.from_numpy(rng.randint(0, 256, (bsz, 32), dtype=np.uint8))
    pt, ok, so, _, _ = curve_cuda.decompress_niels_ref(enc)
    pt1, ok1, so1 = curve_cuda.decompress_so_ref(enc)
    assert torch.equal(pt, pt1) and torch.equal(ok, ok1)
    assert torch.equal(so, so1)


def test_niels_forms_are_those_of_the_points(golden):
    """niels = (y + x, y - x, 2d t) and niels_neg = (y - x, y + x, -2d t)
    of the decoded points, as Python integers."""
    rec = port_record(golden["dec/enc"][:64])
    ints = {f: [int.from_bytes(r.tobytes(), "little") for r in rec[f]]
            for f in DEC_FIELDS}
    d2 = 2 * oracle.D % P
    for i in range(64):
        x, y, t = ints["X"][i], ints["Y"][i], ints["T"][i]
        assert ints["yp"][i] == (y + x) % P
        assert ints["ym"][i] == (y - x) % P
        assert ints["t2d"][i] == d2 * t % P
        assert ints["t2dn"][i] == -d2 * t % P
    assert torch.equal(rec["neg"][:, 0], rec["niels"][:, 1])
    assert torch.equal(rec["neg"][:, 1], rec["niels"][:, 0])


def test_niels_convert_from_jax(golden):
    """JAX niels forms, made with the JAX package's field ops from the
    decoded points, convert to the port's limbs and canonical bytes: the
    same as the plain decompress_niels writes."""
    import jax.numpy as jnp

    from firedancer_tpu.ops import fe25519 as jfe

    enc = golden["dec/enc"][:16]
    pt, _, _, niels, _ = curve_cuda.decompress_niels_ref(
        torch.from_numpy(enc))
    x, y = (jfe.fe_from_bytes(jnp.asarray(convert.fe_to_canonical_bytes(
        pt[:, c])), mask_high_bit=False) for c in (0, 1))
    jniels = tuple(np.asarray(c) for c in jax_niels(
        (x, y, None, jfe.fe_mul(x, y))))
    assert torch.equal(convert.niels_from_jax(jniels), niels)
    np.testing.assert_array_equal(convert.niels_to_canonical_bytes(jniels),
                                  convert.niels_to_canonical_bytes(niels))


def test_y_pm1_mask_matches_jax():
    import jax.numpy as jnp

    from firedancer_tpu.ops import decompress_pallas as jdp
    from firedancer_tpu.ops import fe25519 as jfe

    rng = np.random.RandomState(53)
    ys = [1, P - 1, P + 1, 0, 2, P, P - 2, P + 2, 2**255 - 1]
    enc = rng.randint(0, 256, (32, 32), dtype=np.uint8)
    for i, y in enumerate(ys):
        enc[2 * i] = np.frombuffer(_enc(y), np.uint8)
        enc[2 * i + 1] = np.frombuffer(_enc(y, 1), np.uint8)
    got = dec._y_pm1_mask(torch.from_numpy(enc)).numpy()
    want = np.asarray(jdp._y_pm1_mask(jfe.fe_from_bytes(jnp.asarray(enc),
                                                    mask_high_bit=True)))
    np.testing.assert_array_equal(got, want[0] != 0)
    assert got[:6].all() and not got[6:2 * len(ys)].any()


@pytest.mark.parametrize("group_log2", [0, 3, 6])
def test_fe_invert_batch_matches_jax_golden(golden, group_log2):
    """fe_invert_batch on 96 lanes (a group of 64 does not divide them:
    both packages shrink it to 32) equals the JAX package's, and every
    output is the inverse."""
    zin = golden["dec/enc"][320:320 + 96]
    z = fe.fe_from_bytes(torch.from_numpy(zin))
    got = convert.fe_to_canonical_bytes(
        fe.fe_to_limbs51(fe.fe_invert_batch(z, group_log2)))
    np.testing.assert_array_equal(got, golden[f"inv/g{group_log2}"])
    for a, b in zip(fe.fe_to_int(z), got[:8]):
        assert a * int.from_bytes(b.tobytes(), "little") % P == 1


def test_inversion_count_is_the_inversions_run(monkeypatch):
    """inversion_count(B) is the number of lanes fe_invert runs on: one
    per group of 32, over the batch padded to a multiple of it."""
    seen = []
    real = fe.fe_invert
    monkeypatch.setattr(fe, "fe_invert",
                        lambda z: seen.append(z.shape[0]) or real(z))
    for bsz in (1, 32, 33, 96):
        enc = torch.from_numpy(np.random.RandomState(bsz).randint(
            0, 256, (bsz, 32), dtype=np.uint8))
        curve_cuda.decompress_niels_ref(enc)
        assert seen.pop() == dec.inversion_count(bsz)
    assert [dec.inversion_count(b) for b in (0, 1, 32, 33, 16384)] == \
        [0, 1, 1, 2, 512]


def test_plain_version_counts_and_the_kernel_refuses_cpu_tensors():
    backend.reset_counts()
    enc = torch.zeros(4, 32, dtype=torch.uint8)
    curve_cuda.decompress_niels(enc)
    assert backend.plain_calls == {"decompress_niels": 1}
    assert backend.launches == {}
    with pytest.raises(ValueError, match="CUDA"):
        curve_cuda.decompress_niels_cuda(enc)


@pytest.mark.slow
@pytest.mark.parametrize("bsz", [64, 256])
def test_plain_decompress_niels_matches_live_jax_xla(golden, bsz):
    """The live eager JAX batched decompress (about 30 s a call)."""
    import jax.numpy as jnp

    from firedancer_tpu.ops import decompress_pallas as jdp

    enc = golden["dec/enc"][:bsz]
    pt, ok, xz, so = jdp.decompress_batched_xla(
        jnp.asarray(enc), want_x_zero=True, want_small_order=True)
    want = jax_dec_record(pt, ok, xz, so, jax_niels(pt))
    got = port_record(enc)
    for k in DEC_FIELDS + DEC_MASKS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.slow
def test_fe_invert_batch_matches_live_jax(golden):
    import jax.numpy as jnp

    from firedancer_tpu.ops import fe25519 as jfe

    zin = golden["dec/enc"][320:320 + 96]
    for g in (0, 3, 6):
        want = jfe.fe_invert_batch(jfe.fe_from_bytes(jnp.asarray(zin)),
                                   group_log2=g)
        got = fe.fe_invert_batch(fe.fe_from_bytes(torch.from_numpy(zin)), g)
        np.testing.assert_array_equal(
            convert.fe_to_canonical_bytes(fe.fe_to_limbs51(got)),
            convert.fe_to_canonical_bytes(np.asarray(want)))
