"""The RLC pass's scalar front half of the PyTorch port against the JAX
package: the fused frontend_rlc (h = SHA-512(row) mod L, m = z h mod L,
zs = z s mod L) and the staged path's sha512_batch.

The plain versions run here on the CPU against the JAX package's staged
composition (sha512_batch, sc_reduce64, _sc_muladd) live, at small B,
and against goldens of its TPU kernels at B = 1024 (the bodies of
frontend_rlc_pallas, sha512_batch_pallas and decompress_pallas with
want_niels, the last read by tests/test_torch_decompress.py), kept in
tests/fixtures/torch_port/front_goldens.npz. The goldens run each
kernel's body eagerly on whole-array refs, which is what the Pallas
interpreter evaluates: XLA's compile of the interpret-mode graphs at
B = 1024 did not finish in half an hour on one CPU. A slow test holds
them against the kernels in interpret mode. Rewrite the goldens with
``JAX_PLATFORMS=cpu python -m tests.test_torch_frontend`` from the
repository root. The CUDA kernels (csrc/frontend_rlc.cu,
csrc/sha512_batch.cu) are held against the same plain versions on the
card by chip_smoke.py.
"""

import hashlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu_torch.ballet.ed25519 import corpus, oracle
from firedancer_tpu_torch.ops import backend, frontend_cuda, sc25519

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "torch_port" / "front_goldens.npz"
L = sc25519.L

# Live comparison: row lengths at the SHA-512 padding edges, max_len 1232.
LIVE_LENS = [0, 111, 112, 128, 1232]
LIVE_MAX = 1232
# Goldens: 16 mixed lanes tiled to B = 1024 (the JAX kernels' smallest
# folded batch), rows r || A || msg with msg < 64 bytes.
GOLD_B = 1024
BASE = 16
MSG_MAX = 64
DEC_B = 1024
XLA_B = 256


def _int(b) -> int:
    return int.from_bytes(bytes(b), "little")


def _live_inputs():
    """(rows, lens, z, s) at B = 10: two rows of each LIVE_LENS length; z
    with its top bits set on one lane and 0 on another (a dead lane), s
    >= L on one lane."""
    rng = np.random.RandomState(31)
    lens = np.asarray(LIVE_LENS * 2, np.int32)
    rows = rng.randint(0, 256, (len(lens), LIVE_MAX), dtype=np.uint8)
    z = rng.randint(0, 256, (len(lens), 32), dtype=np.uint8)
    z[:, 16:] = 0
    z[1] = 0xFF
    z[2] = 0
    s = rng.randint(0, 256, (len(lens), 32), dtype=np.uint8)
    s[3] = 0xFF
    return rows, lens, z, s


@pytest.fixture(scope="module")
def live():
    """The live batch through the JAX package's staged composition and
    the port's plain versions."""
    from firedancer_tpu.ops import sc25519 as jsc
    from firedancer_tpu.ops.sha512 import sha512_batch as jsha
    from firedancer_tpu.ops.sign import _sc_muladd

    rows, lens, z, s = _live_inputs()
    digest = jsha(jnp.asarray(rows), jnp.asarray(lens))
    h = jsc.sc_reduce64(digest)
    zero = jnp.zeros_like(h)
    want = {"digest": np.asarray(digest), "h": np.asarray(h),
            "m": np.asarray(_sc_muladd(jnp.asarray(z), h, zero)),
            "zs": np.asarray(_sc_muladd(jnp.asarray(z), jnp.asarray(s),
                                        zero))}
    args = [torch.from_numpy(a) for a in (rows, lens, z, s)]
    backend.reset_counts()
    got = dict(zip(("h", "m", "zs"), (t.numpy() for t in
                                      frontend_cuda.frontend_rlc(*args))))
    got["digest"] = frontend_cuda.sha512_batch(*args[:2]).numpy()
    calls = dict(backend.plain_calls), dict(backend.launches)
    return (rows, lens, z, s), want, got, calls


@pytest.mark.parametrize("out", ("h", "m", "zs", "digest"))
def test_plain_front_half_matches_jax_staged(live, out):
    _, want, got, _ = live
    np.testing.assert_array_equal(got[out], want[out])


def test_plain_front_half_matches_python(live):
    (rows, lens, z, s), _, got, _ = live
    for b in range(len(lens)):
        d = hashlib.sha512(rows[b, :lens[b]].tobytes()).digest()
        assert bytes(got["digest"][b]) == d
        h = _int(d) % L
        assert _int(got["h"][b]) == h
        assert _int(got["m"][b]) == _int(z[b]) * h % L
        assert _int(got["zs"][b]) == _int(z[b]) * _int(s[b]) % L
    assert not got["m"][2].any() and not got["zs"][2].any()   # z = 0


def test_plain_versions_count_and_launch_nothing_on_the_cpu(live):
    calls, launches = live[3]
    assert calls == {"frontend_rlc": 1, "sha512_batch": 1}
    assert launches == {}


@pytest.mark.parametrize("n", [1, 16, 300])
def test_fused_and_staged_scalars_agree(n):
    """rlc_scalars gives the same (h, m, zs) in both configurations, and
    sc_sum(zs) is u = sum z s mod L, with z < 2^126 as fresh_z draws."""
    rng = np.random.RandomState(40 + n)
    rows = torch.from_numpy(rng.randint(0, 256, (n, 100), dtype=np.uint8))
    lens = torch.from_numpy(rng.randint(0, 101, n).astype(np.int32))
    z = rng.randint(0, 256, (n, 32), dtype=np.uint8)
    z[:, 16:] = 0
    z[:, 15] &= 0x3F
    s = rng.randint(0, 256, (n, 32), dtype=np.uint8)
    z, s = torch.from_numpy(z), torch.from_numpy(s)
    fused = frontend_cuda.rlc_scalars("fused", rows, lens, z, s)
    staged = frontend_cuda.rlc_scalars("staged", rows, lens, z, s)
    for a, b in zip(fused, staged):
        assert torch.equal(a, b)
    u = sc25519.sc_sum(fused[2])
    want = sum(_int(a) * _int(b) for a, b in zip(z.numpy(), s.numpy())) % L
    assert _int(u.numpy()[0]) == want


@pytest.mark.parametrize("frontend,calls", [
    ("fused", {"frontend_rlc": 1}),
    ("staged", {"sha512_batch": 1, "sc_reduce64": 1, "sc_muladd": 1})])
def test_rlc_scalars_dispatch(frontend, calls):
    """Each front half's ops, one call each: the staged half reduces and
    multiplies through sc_cuda (one sc_muladd on the stacked products),
    which on the CPU runs the plain versions and launches nothing."""
    t = torch.zeros(3, 32, dtype=torch.uint8)
    backend.reset_counts()
    frontend_cuda.rlc_scalars(frontend, torch.zeros(3, 8, dtype=torch.uint8),
                              torch.zeros(3, dtype=torch.int32), t, t)
    assert backend.plain_calls == calls
    assert backend.launches == {}


def test_unknown_frontend_raises():
    t = torch.zeros(1, 32, dtype=torch.uint8)
    with pytest.raises(ValueError, match="unknown frontend"):
        frontend_cuda.rlc_scalars("xla", t, torch.zeros(1, dtype=torch.int32),
                                  t, t)


@pytest.mark.parametrize("fn,args", [
    (frontend_cuda.frontend_rlc_cuda,
     ((2, 8), (2,), (2, 32), (2, 32))),
    (frontend_cuda.sha512_batch_cuda, ((2, 8), (2,)))])
def test_kernel_wrappers_refuse_cpu_tensors(fn, args):
    tensors = [torch.zeros(shape, dtype=torch.int32 if len(shape) == 1
                           else torch.uint8) for shape in args]
    with pytest.raises(ValueError, match="CUDA"):
        fn(*tensors)


# -- the goldens (the JAX package's kernels in interpret mode) -----------


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def golden_rows(golden):
    """The golden batch: the BASE mixed rows tiled to GOLD_B lanes."""
    reps = GOLD_B // BASE
    return (np.tile(golden["rlc/rows"], (reps, 1)),
            np.tile(golden["rlc/lens"], reps), golden["rlc/z"],
            np.tile(golden["rlc/s"], (reps, 1)))


@pytest.fixture(scope="module")
def golden_port(golden):
    rows, lens, z, s = (torch.from_numpy(a) for a in golden_rows(golden))
    h, m, zs = frontend_cuda.frontend_rlc_ref(rows, lens, z, s)
    return {"h": h.numpy(), "m": m.numpy(), "zs": zs.numpy(),
            "digest": frontend_cuda.sha512_batch_ref(rows, lens).numpy()}


@pytest.mark.parametrize("out", ("h", "m", "zs", "digest"))
def test_plain_front_half_matches_interpret_golden(golden, golden_port, out):
    want = golden["sha/digest" if out == "digest" else f"rlc/{out}"]
    np.testing.assert_array_equal(golden_port[out], want)


def test_golden_batch_covers_the_edges(golden):
    """What the golden batch is built to hold: hashed lengths at the
    padding edges, a dead lane, s >= L, a non-canonical R."""
    rows, lens, z, s = golden_rows(golden)
    assert {64, 111, 112, 128} <= set(lens[:BASE].tolist())
    assert not z[0].any() and z[1:].any(axis=1).all()
    assert _int(s[5]) >= L
    assert _int(rows[4, :32]) & ((1 << 255) - 1) >= oracle.P


# -- writing the goldens ---------------------------------------------------


def _golden_front_inputs():
    """The BASE mixed lanes (oracle-signed; a salted R, a non-canonical R,
    s >= L, an order-2 torsion forgery; message lengths 0, 47, 48, 64 put
    the hashed rows at the padding edges) and z for GOLD_B lanes (lane 0
    dead)."""
    items = corpus.rlc_items(BASE, MSG_MAX, seed=23)
    for i, n in zip(range(8, 12), (0, 47, 48, 64)):
        key = bytes([90 + i]) * 32
        _, _, pub = oracle.keypair_from_seed(key)
        m = bytes(range(n))
        items[i] = (m, oracle.sign(m, key), pub)
    items[3] = (items[3][0], items[3][1][:2] + bytes([items[3][1][2] ^ 0x40])
                + items[3][1][3:], items[3][2])
    items[4] = (items[4][0], b"\xff" * 31 + b"\x7f" + items[4][1][32:],
                items[4][2])
    items[5] = (items[5][0], items[5][1][:32] + b"\xff" * 32, items[5][2])
    items = corpus.torsion_offset(items, corpus.ORDER2, (6,))
    msgs, lens, sigs, pubs = corpus.to_arrays(items, MSG_MAX)
    rows = np.concatenate([sigs[:, :32], pubs, msgs], axis=1)
    rng = np.random.RandomState(24)
    z = rng.randint(0, 256, (GOLD_B, 32), dtype=np.uint8)
    z[0] = 0
    return rows, lens + 64, z, sigs[:, 32:].copy()


def golden_dec_inputs() -> np.ndarray:
    """DEC_B encodings for the decompress goldens. Lanes 0-255 (the live
    XLA golden's batch): the torsion encodings (y = +-1 among them, both
    sign bits), every non-canonical y in [p, 2^255) with both sign bits
    and 32 undecodable encodings, spread one per lane among encodings of
    valid points so that every inversion group holds failing and +-1
    lanes beside valid ones; lanes 256-319: 64 undecodable encodings (a
    whole group fails); the rest valid points and random bytes."""
    rng = np.random.RandomState(25)
    edge = corpus.edge_encodings(rng)
    edge += corpus.undecodable_encodings(32 - 8, rng)
    edge = [edge[i] for i in rng.permutation(len(edge))]
    valid = [oracle.point_compress(oracle.scalarmult(int(k), oracle.B))
             for k in rng.randint(1, 2**62, 600)]
    enc = []
    vi = iter(valid)
    for e in edge:
        enc += [e, next(vi)]
    while len(enc) < XLA_B:
        enc.append(next(vi))
    enc = enc[:XLA_B]
    enc += corpus.undecodable_encodings(64, rng)
    rest = DEC_B - len(enc)
    for i in range(rest):
        enc.append(next(vi) if i % 2 else
                   rng.randint(0, 256, 32, dtype=np.uint8).tobytes())
    return np.frombuffer(b"".join(enc), np.uint8).reshape(DEC_B, 32).copy()


DEC_FIELDS = ("X", "Y", "Z", "T", "yp", "ym", "t2d", "t2dn")
DEC_MASKS = ("ok", "x_zero", "small_order")


def jax_dec_record(pt, ok, xz, so, niels) -> dict:
    """Canonical bytes of a JAX decompress's outputs (points and niels as
    (32, B) limb tuples), keyed by DEC_FIELDS and DEC_MASKS."""
    from firedancer_tpu_torch import convert

    rec = {f: convert.fe_to_canonical_bytes(np.asarray(c))
           for f, c in zip(DEC_FIELDS, tuple(pt) + tuple(niels))}
    rec.update({m: np.asarray(v) for m, v in zip(DEC_MASKS, (ok, xz, so))})
    return rec


def jax_niels(pt):
    """(yp, ym, t2d, t2dn) of JAX points, formed with the JAX package's
    field ops (what its decompress kernel writes)."""
    from firedancer_tpu.ops import fe25519 as jfe

    x, y, _, t = pt
    t2d = jfe.fe_mul(t, jfe.FE_D2)
    return (jfe.fe_add(y, x), jfe.fe_sub(y, x), t2d, jfe.fe_neg(t2d))


def _digests(rec: dict) -> dict:
    """Per-lane 8-byte SHA-256 digests of each field's canonical bytes
    (the kernel golden's compact form)."""
    return {k: (np.array([list(hashlib.sha256(r.tobytes()).digest()[:8])
                          for r in v], np.uint8) if k in DEC_FIELDS else v)
            for k, v in rec.items()}


class _Ref:
    """A whole-array stand-in for a Pallas ref: a kernel body reads
    ref[...] and writes ref[...] = value."""

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, value):
        self.value = value


def jax_front_kernels(rows, lens, z, s):
    """The JAX package's _frontend_rlc_kernel and _sha512_kernel run
    eagerly on the whole batch, with the launch wrappers' packing and
    unpacking (frontend_rlc_pallas:300, sha512_batch_pallas:201):
    ((h, m, zs), digest) as numpy arrays."""
    from firedancer_tpu.ops import frontend_pallas as fp
    from firedancer_tpu.ops import sha512_pallas as sp

    bsz = rows.shape[0]
    hi, lo, nblk, lb, mb = sp._pack_schedule(jnp.asarray(rows),
                                             jnp.asarray(lens))
    refs = [_Ref(a) for a in (hi, lo, nblk, fp._fold_scalar(z, lb),
                              fp._fold_scalar(s, lb))]
    outs = [_Ref() for _ in range(3)]
    fp._frontend_rlc_kernel(*refs, *outs, max_blocks=mb)
    scalars = tuple(np.asarray(fp._unfold_scalar(o.value, bsz))
                    for o in outs)
    out = _Ref()
    sp._sha512_kernel(*refs[:3], out, max_blocks=mb)
    words = jnp.transpose(out.value.reshape(8, 2, sp.SUB, lb).reshape(
        8, 2, bsz), (2, 0, 1))
    shifts = jnp.asarray([24, 16, 8, 0], jnp.uint32)
    digest = jnp.concatenate(
        [(words[:, :, 0:1] >> shifts) & 0xFF,
         (words[:, :, 1:2] >> shifts) & 0xFF], axis=-1)
    return scalars, np.asarray(digest.reshape(bsz, 64).astype(jnp.uint8))


def jax_decompress_kernel(enc):
    """The JAX package's _decompress_niels_kernel run eagerly, one
    LANES-wide tile at a time, with decompress_pallas's packing (:180):
    ((X, Y, Z, T), ok, x_zero, (yp, ym, t2d, t2dn)), limbs (32, B)."""
    from firedancer_tpu.ops import curve_pallas as cp
    from firedancer_tpu.ops import fe25519 as jfe

    sign = (jnp.asarray(enc)[:, 31] >> 7).astype(jnp.int32)[None, :]
    y = jfe.fe_from_bytes(jnp.asarray(enc), mask_high_bit=True)
    consts = jnp.asarray(cp._const_cols())
    tiles = []
    for t in range(0, enc.shape[0], cp.LANES):
        outs = [_Ref() for _ in range(10)]
        cp._decompress_niels_kernel(_Ref(y[:, t:t + cp.LANES]),
                                    _Ref(sign[:, t:t + cp.LANES]),
                                    _Ref(consts), *outs)
        tiles.append([o.value for o in outs])
    cols = [jnp.concatenate(c, axis=1) for c in zip(*tiles)]
    return (tuple(cols[:4]), cols[4][0] != 0, cols[5][0] != 0,
            tuple(cols[6:]))


def _write_goldens() -> None:
    import time

    from firedancer_tpu.ops import curve25519 as jge
    from firedancer_tpu.ops import decompress_pallas as jdp
    from firedancer_tpu.ops import fe25519 as jfe
    from firedancer_tpu_torch import convert

    out = {}
    t0 = time.time()
    rows, lens, z, s = _golden_front_inputs()
    out.update({"rlc/rows": rows, "rlc/lens": lens, "rlc/z": z, "rlc/s": s})
    (h, m, zs), digest = jax_front_kernels(*golden_rows(
        {"rlc/rows": rows, "rlc/lens": lens, "rlc/z": z, "rlc/s": s}))
    out.update({"rlc/h": h, "rlc/m": m, "rlc/zs": zs, "sha/digest": digest})
    print(f"front half goldens ({time.time() - t0:.0f} s)", flush=True)

    enc = golden_dec_inputs()
    out["dec/enc"] = enc
    pt, ok, xz, niels = jax_decompress_kernel(enc)
    rec = jax_dec_record(pt, ok, xz, jge.small_order_mask(pt), niels)
    out.update({f"dec/kernel/{k}": v for k, v in _digests(rec).items()})
    print(f"decompress kernel golden ({time.time() - t0:.0f} s)", flush=True)
    pt, ok, xz, so = jdp.decompress_batched_xla(
        jnp.asarray(enc[:XLA_B]), want_x_zero=True, want_small_order=True)
    rec = jax_dec_record(pt, ok, xz, so, jax_niels(pt))
    out.update({f"dec/xla/{k}": v for k, v in rec.items()})
    print(f"decompress XLA golden ({time.time() - t0:.0f} s)", flush=True)
    for g in (0, 3, 6):
        zin = enc[320:320 + 96]
        inv = jfe.fe_invert_batch(jfe.fe_from_bytes(jnp.asarray(zin)),
                                  group_log2=g)
        out[f"inv/g{g}"] = convert.fe_to_canonical_bytes(np.asarray(inv))
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes, "
          f"{time.time() - t0:.0f} s)")


@pytest.mark.slow
def test_goldens_match_the_kernels_in_interpret_mode(golden):
    """The goldens equal the JAX package's kernels under the Pallas
    interpreter (an XLA compile of over half an hour on one CPU core)."""
    from firedancer_tpu.ops import curve25519 as jge
    from firedancer_tpu.ops.curve_pallas import decompress_pallas
    from firedancer_tpu.ops.frontend_pallas import frontend_rlc_pallas
    from firedancer_tpu.ops.sha512_pallas import sha512_batch_pallas

    rows, lens, z, s = (jnp.asarray(a) for a in golden_rows(golden))
    for k, v in zip(("h", "m", "zs"),
                    frontend_rlc_pallas(rows, lens, z, s, interpret=True)):
        np.testing.assert_array_equal(np.asarray(v), golden[f"rlc/{k}"])
    np.testing.assert_array_equal(
        np.asarray(sha512_batch_pallas(rows, lens, interpret=True)),
        golden["sha/digest"])
    pt, ok, xz, niels = decompress_pallas(
        jnp.asarray(golden["dec/enc"]), interpret=True, want_x_zero=True,
        want_niels=True)
    rec = _digests(jax_dec_record(pt, ok, xz, jge.small_order_mask(pt),
                                  niels))
    for k, v in rec.items():
        np.testing.assert_array_equal(v, golden[f"dec/kernel/{k}"])


if __name__ == "__main__":
    _write_goldens()
