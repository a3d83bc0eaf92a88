"""Batched Ed25519 signing of the PyTorch port against the JAX package
and the oracle: ``ops.sign`` (``keygen_batch``, ``sign_batch``; the JAX
package's ``ops/sign.py``:83 and :95) and ``disco.corpus.sign_jobs`` (the
device branch of ``disco/corpus.py:226`` ``_sign_jobs``).

Tier-1 reads the JAX side from tests/fixtures/torch_port/sign_goldens.npz:
JAX ``keygen_batch``/``sign_batch`` at B = 8 over message lengths 0 to
1232, its base point ``_b_point``, and the kernel-body goldens that
tests/test_torch_sc.py reads. Rewrite it with
``JAX_PLATFORMS=cpu python -m tests.test_torch_sign`` from the repository
root. On the CPU the port signs through the plain versions; chip_smoke.py
holds the kernels' signing against the same composition on the card.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from firedancer_tpu_torch import convert
from firedancer_tpu_torch.ballet.ed25519 import oracle
from firedancer_tpu_torch.disco import corpus as dcorpus
from firedancer_tpu_torch.ops import backend
from firedancer_tpu_torch.ops import curve25519 as ge
from firedancer_tpu_torch.ops import sign
from firedancer_tpu_torch.ops.verify import verify_batch
from tests import test_torch_sc
from tests.test_oracle import RFC8032_VECTORS, _msg_bytes

torch.set_num_threads(1)

GOLDEN = test_torch_sc.GOLDEN
# The golden batch: B = 8, the hashed rows of every SHA-512 block count
# from 1 to 11 (1232 + 64 bytes hash in 11 blocks, the last the padding).
SIGN_LENS = [0, 1, 32, 111, 112, 240, 777, 1232]
SIGN_MAX = 1232
# The plain versions one sign_batch call runs.
SIGN_CALLS = {"sha512_batch": 3, "sc_reduce64": 2, "double_scalarmult": 2,
              "compress": 2, "sc_muladd": 1}


def sign_inputs():
    """(msgs (8, SIGN_MAX), lens, seeds (8, 32)); the bytes past each
    length are random, so a signer that reads them differs."""
    rng = np.random.RandomState(44)
    msgs = rng.randint(0, 256, (len(SIGN_LENS), SIGN_MAX), dtype=np.uint8)
    seeds = rng.randint(0, 256, (len(SIGN_LENS), 32), dtype=np.uint8)
    return msgs, np.asarray(SIGN_LENS, np.int32), seeds


def _lane_msg(msgs, lens, i) -> bytes:
    return msgs[i, :lens[i]].tobytes()


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def port_signed(golden):
    """The golden batch through the port's keygen_batch and sign_batch on
    the CPU, with the plain calls of the sign_batch call."""
    args = [torch.from_numpy(golden[f"sign/{k}"])
            for k in ("msgs", "lens", "seeds")]
    out = dict(zip(("a", "prefix", "pub"),
                   (t.numpy() for t in sign.keygen_batch(args[2]))))
    backend.reset_counts()
    sigs, pubs = sign.sign_batch(*args)
    calls = dict(backend.plain_calls), dict(backend.launches)
    out.update(sigs=sigs.numpy(), pubs=pubs.numpy())
    return out, calls


@pytest.mark.parametrize("out", ("a", "prefix", "pub", "sigs", "pubs"))
def test_port_signing_matches_jax_golden(golden, port_signed, out):
    np.testing.assert_array_equal(port_signed[0][out], golden[f"sign/{out}"])


def test_golden_inputs_are_the_seeded_batch(golden):
    for k, v in zip(("msgs", "lens", "seeds"), sign_inputs()):
        np.testing.assert_array_equal(golden[f"sign/{k}"], v)


@pytest.mark.parametrize("lane", range(len(SIGN_LENS)))
def test_port_signing_matches_the_oracle(golden, port_signed, lane):
    got, _ = port_signed
    msgs, lens, seeds = (golden[f"sign/{k}"] for k in ("msgs", "lens",
                                                      "seeds"))
    seed = seeds[lane].tobytes()
    a, prefix, pub = oracle.keypair_from_seed(seed)
    assert int.from_bytes(got["a"][lane].tobytes(), "little") == a
    assert got["prefix"][lane].tobytes() == prefix
    assert got["pub"][lane].tobytes() == pub == got["pubs"][lane].tobytes()
    assert got["sigs"][lane].tobytes() == oracle.sign(
        _lane_msg(msgs, lens, lane), seed)


def test_clamped_scalars(port_signed):
    """a < 2^255 with bit 254 set and the low three bits clear: above L,
    and K3's top window reaches 4 to 7."""
    a = port_signed[0]["a"]
    assert (a[:, 0] & 7 == 0).all() and (a[:, 31] >> 6 == 1).all()
    assert all(int.from_bytes(r.tobytes(), "little") > oracle.L for r in a)


def test_sign_batch_runs_the_plain_versions_on_the_cpu(port_signed):
    calls, launches = port_signed[1]
    assert calls == SIGN_CALLS
    assert launches == {}


def test_base_point_constant_matches_jax(golden):
    """The port's A operand of scalarmult_base (curve25519.base_point_limbs)
    is JAX's _b_point, decompressed from B's encoding, canonically."""
    pt = ge.base_point_limbs(torch.device("cpu"))
    np.testing.assert_array_equal(convert.point_to_projective_bytes(pt),
                                  golden["sign/b_point"])


def test_signed_batch_verifies(golden, port_signed):
    """Sign, then the port's direct verify on the CPU: every status 0."""
    got, _ = port_signed
    msgs, lens = (torch.from_numpy(golden[f"sign/{k}"])
                  for k in ("msgs", "lens"))
    st = verify_batch(msgs, lens, torch.from_numpy(got["sigs"]),
                      torch.from_numpy(got["pubs"]))
    assert st.tolist() == [0] * len(SIGN_LENS)


# -- RFC 8032 ------------------------------------------------------------------


@pytest.fixture(scope="module")
def rfc_signed():
    """The RFC 8032 vectors as one batch through sign_batch and
    sign_batch_ref."""
    msgs = [_msg_bytes(v[2]) for v in RFC8032_VECTORS]
    max_len = max(len(m) for m in msgs)
    rows = np.zeros((len(msgs), max_len), np.uint8)
    for i, m in enumerate(msgs):
        rows[i, :len(m)] = np.frombuffer(m, np.uint8)
    args = (torch.from_numpy(rows),
            torch.tensor([len(m) for m in msgs], dtype=torch.int32),
            torch.from_numpy(np.array([list(bytes.fromhex(v[0]))
                                       for v in RFC8032_VECTORS], np.uint8)))
    return sign.sign_batch(*args), sign.sign_batch_ref(*args)


@pytest.mark.parametrize("i", range(len(RFC8032_VECTORS)))
def test_rfc8032_vector(rfc_signed, i):
    _, pub, _, sig = RFC8032_VECTORS[i]
    for sigs, pubs in rfc_signed:
        assert sigs[i].numpy().tobytes().hex() == sig
        assert pubs[i].numpy().tobytes().hex() == pub


# -- corpus signing -------------------------------------------------------------


def test_sign_jobs_matches_the_oracle(monkeypatch):
    """Five jobs in batches of 3: the second batch padded to 3 lanes, and
    the rows bucketed to 256 and 512 bytes."""
    jobs = [(bytes(i % 251 for i in range(n)), hashlib.sha256(
        bytes([n % 256])).digest()) for n in (0, 10, 255, 256, 300)]
    shapes = []
    real = dcorpus.sign_batch

    def spy(msgs, lens, seeds):
        shapes.append(tuple(msgs.shape))
        return real(msgs, lens, seeds)

    monkeypatch.setattr(dcorpus, "sign_batch", spy)
    got = dcorpus.sign_jobs(jobs, batch=3, device="cpu")
    assert shapes == [(3, 256), (3, 512)]
    assert got == [oracle.sign(m, s) for m, s in jobs]


def test_sign_jobs_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dcorpus.sign_jobs([(b"", bytes(32))])


# -- the JAX side (the goldens and the slow live tests) -----------------------


def _write_goldens() -> None:
    import time

    import jax.numpy as jnp

    from firedancer_tpu.ops import sign as jsign

    t0 = time.time()
    out = test_torch_sc.jax_kernel_goldens()
    print(f"kernel-body goldens ({time.time() - t0:.0f} s)", flush=True)
    msgs, lens, seeds = sign_inputs()
    out.update({"sign/msgs": msgs, "sign/lens": lens, "sign/seeds": seeds})
    a, prefix, pub = jsign.keygen_batch(jnp.asarray(seeds))
    sigs, pubs = jsign.sign_batch(jnp.asarray(msgs), jnp.asarray(lens),
                                  jnp.asarray(seeds))
    out.update({f"sign/{k}": np.asarray(v) for k, v in (
        ("a", a), ("prefix", prefix), ("pub", pub), ("sigs", sigs),
        ("pubs", pubs))})
    pt, _ = jsign._b_point(1)
    out["sign/b_point"] = convert.point_to_projective_bytes(pt)
    print(f"signing goldens ({time.time() - t0:.0f} s)", flush=True)
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes, "
          f"{time.time() - t0:.0f} s)")


@pytest.mark.slow
def test_live_jax_signing_matches_the_port():
    """JAX's keygen_batch and sign_batch live on a seeded batch of four
    with lengths at the SHA-512 padding edges, against the port."""
    import jax.numpy as jnp

    from firedancer_tpu.ops import sign as jsign

    rng = np.random.RandomState(45)
    msgs = rng.randint(0, 256, (4, 128), dtype=np.uint8)
    lens = np.asarray([0, 47, 48, 128], np.int32)
    seeds = rng.randint(0, 256, (4, 32), dtype=np.uint8)
    want = jsign.sign_batch(*map(jnp.asarray, (msgs, lens, seeds)))
    got = sign.sign_batch(*map(torch.from_numpy, (msgs, lens, seeds)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.slow
def test_goldens_match_the_kernels_in_interpret_mode(golden):
    """The kernel-body goldens equal the JAX package's kernels under the
    Pallas interpreter, launched as their wrappers launch them."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from firedancer_tpu.ops import fe25519 as jfe
    from firedancer_tpu.ops import pow_pallas as pp
    from firedancer_tpu.ops.curve_pallas import compress_pallas
    from firedancer_tpu.ops.sc_pallas import sc_mul_pallas, sc_reduce64_pallas

    x, a, b = (jnp.asarray(golden[f"sc/{k}"]) for k in "xab")
    np.testing.assert_array_equal(
        np.asarray(sc_reduce64_pallas(x, interpret=True)), golden["sc/reduce"])
    np.testing.assert_array_equal(
        np.asarray(sc_mul_pallas(a, b, interpret=True)), golden["sc/mul"])
    z = jfe.fe_from_bytes(jnp.asarray(golden["pow/z"]))
    spec = pl.BlockSpec((pp.NLIMBS, z.shape[1]), lambda i: (0, i))
    for kind in ("invert", "pow22523"):
        got = pl.pallas_call(
            functools.partial(pp._pow_kernel, kind=kind), grid=(1,),
            in_specs=[spec], out_specs=spec,
            out_shape=jax.ShapeDtypeStruct(z.shape, jnp.int32),
            interpret=True)(z)
        np.testing.assert_array_equal(
            convert.fe_to_canonical_bytes(np.asarray(got)),
            golden[f"pow/{kind}"])
    pt = tuple(jfe.fe_from_bytes(jnp.asarray(golden[f"cmp/{k}"]))
               for k in "XYZ") + (None,)
    np.testing.assert_array_equal(
        np.asarray(compress_pallas(pt, interpret=True)), golden["cmp/enc"])


if __name__ == "__main__":
    _write_goldens()
