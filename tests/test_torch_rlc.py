"""RLC batch verify of the PyTorch port against the JAX package.

The corpus (ballet/ed25519/corpus.rlc_corpus: clean, one salted lane,
definite lanes, a non-canonical R, the order-2 pair, the order-8
forgery, small-order A and R, and an overflow batch whose z weights are
all equal) runs at B = 16, MAX_LEN = 64 and K = 8 trials, at plans u7
and s8l3, in both front halves (frontend "fused" and "staged"), through
the port's RLC pass (rlc_front, msm_partials, the tails) on the CPU.
Compiling the JAX package's kernel path (its Pallas kernels in interpret
mode) costs minutes, so tier-1 compares against goldens in
tests/fixtures/torch_port/rlc_goldens.npz, and the live comparison is a
slow test. Rewrite the goldens with
``JAX_PLATFORMS=cpu python -m tests.test_torch_rlc`` from the
repository root.

Verdicts (status, definite, batch_ok and the three fill verdicts) must
equal the goldens exactly; points (window partials, trial aggregates,
Horner and ladder outputs) must match in canonical affine bytes, and in
a digest of their canonical projective coordinates, since the port runs
the reference's formulas in the reference's order.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from firedancer_tpu_torch import convert
from firedancer_tpu_torch.ballet.ed25519 import corpus
from firedancer_tpu_torch.disco.engine import EngineSpec, registry
from firedancer_tpu_torch.msm_plan import parse_plan
from firedancer_tpu_torch.ops import backend
from firedancer_tpu_torch.ops import verify_rlc as vr
from firedancer_tpu_torch.ops.verify import verify_batch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "torch_port" / "rlc_goldens.npz"

N = 16
MAX_LEN = 64
K = 8
PLANS = ("u7", "s8l3")
FRONTENDS = ("fused", "staged")
CASES = ("clean", "salted", "definite", "noncanon_r", "order2", "order8",
         "small_order", "overflow")


@functools.lru_cache(maxsize=None)
def _rlc_corpus():
    return corpus.rlc_corpus(N, MAX_LEN)


def case_inputs(name: str, fresh_z, fresh_u):
    """(msgs, lens, sigs, pubs), z (N, 32) uint8, u (K, 2N) int32 for one
    corpus case, with weights from numpy's Generator seeded per case."""
    arrays = corpus.to_arrays(_rlc_corpus()[name], MAX_LEN)
    rng = np.random.default_rng(100 + CASES.index(name))
    z = fresh_z(N, rng)
    u = fresh_u(K, 2 * N, rng)
    if name == "overflow":
        z[:] = z[0]           # every lane's digit lands in one bucket
    return arrays, z, u


def _points_record(prefix: str, pt) -> dict:
    return {f"{prefix}_aff": convert.point_to_affine_bytes(pt),
            f"{prefix}_dig": convert.point_digest(pt)}


# -- the port on the CPU --------------------------------------------------

VERDICTS = ("status", "definite", "batch_ok", "ok_r", "ok_m", "sub_ok",
            "cert")
PARTS = ("w_r", "w_m", "sub", "t1", "t2")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def port_front(arrays, z, u, frontend: str):
    """One corpus case through the port's RLC front half (plain
    versions): (status, definite, msm_in)."""
    args = [torch.from_numpy(a) for a in arrays + (z, u)]
    return vr.rlc_front(*args, frontend=frontend)


def port_case(token: str, front) -> dict:
    """A case's front half through the rest of the port's RLC pass, the
    MSM partials and the tails at plan `token`, into golden records."""
    plan = parse_plan(token)
    status, definite, msm_in = front
    parts = vr.msm_partials(msm_in, plan)
    t1, t2, cert, fills_ok = vr.combine_points(parts, plan)
    rec = {"status": status.numpy(), "definite": definite.numpy(),
           "batch_ok": vr.batch_verdict(t1, t2, cert, fills_ok).numpy(),
           "ok_r": parts["ok_r"].numpy(), "ok_m": parts["ok_m"].numpy(),
           "sub_ok": parts["sub_ok"].numpy(), "cert": cert.numpy()}
    for name, pt in (("w_r", parts["w_r"]), ("w_m", parts["w_m"]),
                     ("sub", parts["sub"]), ("t1", t1), ("t2", t2)):
        rec.update(_points_record(name, pt))
    return rec


def _assert_case(got: dict, golden: dict, prefix: str) -> None:
    for k in VERDICTS:
        want = golden[f"{prefix}/{k}"]
        np.testing.assert_array_equal(np.reshape(got[k], want.shape), want,
                                      err_msg=f"{prefix} {k}")
    for k in PARTS:
        for kind in ("aff", "dig"):
            np.testing.assert_array_equal(
                got[f"{k}_{kind}"], golden[f"{prefix}/{k}_{kind}"],
                err_msg=f"{prefix} {k}_{kind}")


def _golden_inputs(golden, case: str):
    arrays = tuple(golden[f"{case}/{k}"] for k in ("msgs", "lens", "sigs",
                                                   "pubs"))
    return arrays, golden[f"{case}/z"], golden[f"{case}/u"]


@pytest.mark.parametrize("case", CASES)
def test_corpus_and_weights_match_golden_inputs(golden, case):
    arrays, z, u = case_inputs(case, vr.fresh_z, vr.fresh_u)
    want_arrays, want_z, want_u = _golden_inputs(golden, case)
    for a, b in zip(arrays + (z, u), want_arrays + (want_z, want_u)):
        np.testing.assert_array_equal(a, b)


def test_fresh_weights_match_jax():
    from firedancer_tpu.ops import verify_rlc as jrlc

    for seed in (1, 2):
        np.testing.assert_array_equal(
            vr.fresh_z(N, np.random.default_rng(seed)),
            jrlc.fresh_z(N, np.random.default_rng(seed)))
        np.testing.assert_array_equal(
            vr.fresh_u(K, 2 * N, np.random.default_rng(seed)),
            jrlc.fresh_u(K, 2 * N, np.random.default_rng(seed)))
    z = vr.fresh_z(64)
    assert not z[:, 16:].any() and (z[:, 15] < 0x40).all()
    assert vr.fresh_u(K, 64).max() < 128


class _Recorder:
    """An rlc_fn for make_async_verifier that runs the case's own weights
    through the port's halves and keeps every partial for the checks."""

    def __init__(self, z, u, frontend, fronts):
        self.z, self.u, self.frontend, self.rec = z, u, frontend, None
        self.fronts = fronts

    def __call__(self, msgs, lens, sigs, pubs, _z, _u):
        front = port_front((msgs.numpy(), lens.numpy(), sigs.numpy(),
                            pubs.numpy()), self.z, self.u, self.frontend)
        self.fronts.append(front)
        self.rec = port_case("u7", front)
        return (torch.from_numpy(self.rec["status"]),
                torch.from_numpy(self.rec["definite"]),
                torch.from_numpy(np.asarray(self.rec["batch_ok"])))


@pytest.fixture(scope="module")
def direct_statuses(golden):
    """Every case's per-lane statuses from the direct path."""
    return {case: verify_batch(*map(torch.from_numpy,
                                    _golden_inputs(golden, case)[0])).numpy()
            for case in CASES}


@pytest.fixture(scope="module")
def u7_runs(golden, direct_statuses):
    """Every case at u7, in both front halves, through the port's async
    verifier (the RLC pass on the case's weights; when it fails, the
    fallback returns the case's direct statuses): (frontend, case) ->
    (partials, result, statuses, front half). The s8l3 runs reuse the
    front half: the plans differ only after it."""
    out = {}
    for frontend in FRONTENDS:
        for case in CASES:
            arrays, z, u = _golden_inputs(golden, case)
            fronts = []
            rec = _Recorder(z, u, frontend, fronts)
            direct = torch.from_numpy(direct_statuses[case])
            fn = vr.make_async_verifier(lambda *a, d=direct: d,
                                        rng=np.random.default_rng(0),
                                        rlc_fn=rec, torsion_k=K)
            res = fn(*map(torch.from_numpy, arrays))
            out[frontend, case] = (rec.rec, res, np.asarray(res), fronts[0])
    return out


@pytest.mark.parametrize("frontend", FRONTENDS)
@pytest.mark.parametrize("case", CASES)
def test_rlc_u7_matches_jax_golden(golden, u7_runs, case, frontend):
    _assert_case(u7_runs[frontend, case][0], golden, f"u7/{case}")


@pytest.mark.parametrize("frontend", FRONTENDS)
@pytest.mark.parametrize("case", CASES)
def test_rlc_s8l3_matches_jax_golden(golden, u7_runs, case, frontend):
    _assert_case(port_case("s8l3", u7_runs[frontend, case][3]), golden,
                 f"s8l3/{case}")


@pytest.mark.parametrize("frontend", FRONTENDS)
@pytest.mark.parametrize("case", CASES)
def test_async_verifier_gives_the_direct_statuses(u7_runs, direct_statuses,
                                                  case, frontend):
    rec, res, statuses, _ = u7_runs[frontend, case]
    direct = direct_statuses[case]
    np.testing.assert_array_equal(statuses, direct)
    assert res.is_ready()
    assert res.used_fallback == (not bool(rec["batch_ok"]))
    definite = rec["definite"]
    np.testing.assert_array_equal(rec["status"][definite], direct[definite])


def test_corpus_outcomes(golden):
    """What each case is built to show, read from the goldens."""
    ok = {c: bool(golden[f"u7/{c}/batch_ok"]) for c in CASES}
    assert ok == {"clean": True, "salted": True, "definite": True,
                  "noncanon_r": False, "order2": False, "order8": False,
                  "small_order": True, "overflow": False}
    assert not bool(golden["u7/overflow/ok_r"])
    assert not bool(golden["u7/order2/cert"])
    assert not bool(golden["u7/order8/cert"])
    assert golden["u7/definite/definite"][[1, 2]].all()
    assert golden["u7/small_order/status"][[2, 9]].tolist() == [-2, -1]
    assert not golden["u7/order2/definite"][[4, 5]].any()


def test_async_verifier_default_entropy_is_urandom(monkeypatch):
    """Without a test's rng, z and u come from os.urandom (a CSPRNG)."""
    calls = []
    real = vr.os.urandom
    monkeypatch.setattr(vr.os, "urandom",
                        lambda n: calls.append(n) or real(n))
    seen = {}

    def rlc(msgs, lens, sigs, pubs, z, u):
        seen.update(z=z, u=u)
        n = msgs.shape[0]
        return (torch.zeros(n, dtype=torch.int32),
                torch.zeros(n, dtype=torch.bool), torch.tensor(True))

    res = vr.make_async_verifier(verify_batch, rlc_fn=rlc, torsion_k=K)(
        *(torch.zeros(s, dtype=d) for s, d in (
            ((N, 4), torch.uint8), ((N,), torch.int32),
            ((N, 64), torch.uint8), ((N, 32), torch.uint8))))
    assert calls == [N * 16, K * 2 * N]
    assert tuple(seen["z"].shape) == (N, 32)
    assert tuple(seen["u"].shape) == (K, 2 * N)
    assert (np.asarray(res) == 0).all() and not res.used_fallback


@pytest.mark.slow
@pytest.mark.parametrize("token", PLANS)
def test_goldens_match_live_jax(golden, token):
    """The goldens are the JAX package's kernel path, recompiled (about
    six minutes of compile per plan on one CPU core)."""
    from firedancer_tpu.ops.verify_rlc import fresh_u, fresh_z

    fns = _jax_plan_fns(token)
    for case in CASES:
        arrays, z, u = case_inputs(case, fresh_z, fresh_u)
        got = jax_case(token, fns, arrays, z, u)
        for k, v in got.items():
            np.testing.assert_array_equal(v, golden[f"{token}/{case}/{k}"],
                                          err_msg=f"{token}/{case}/{k}")


# -- the engine and the port's rules ---------------------------------------


def test_acquire_rlc_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="capability 9"):
        registry().acquire(EngineSpec("rlc", N))
    with pytest.raises(ValueError, match="msm plan"):
        registry().acquire(EngineSpec("rlc", N, msm="u9"), device="cpu")
    with pytest.raises(ValueError, match="unknown frontend"):
        registry().acquire(EngineSpec("rlc", N, frontend="xla"),
                           device="cpu")


# The plain versions one RLC pass and its direct fallback run on the CPU,
# by front half.
_PASS_PLAIN = {"fused": {"frontend_rlc": 1},
               "staged": {"sha512_batch": 1, "sc_reduce64": 1,
                          "sc_muladd": 1}}
_FALLBACK_PLAIN = {"sha512_mod_l": 1, "decompress_so": 1,
                   "double_scalarmult": 1, "point_eq": 1}


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_cpu_rlc_engine_runs_the_plain_path(golden, direct_statuses,
                                            frontend):
    entry, warmed = registry().acquire(
        EngineSpec("rlc", N, msm="u7", frontend=frontend), device="cpu",
        max_msg_len=MAX_LEN)
    assert warmed and entry.state == "warm"
    assert entry.key == f"rlc:B{N}:fe{frontend}:u7"
    assert entry.snapshot()["frontend"] == frontend
    arrays, _, _ = _golden_inputs(golden, "order2")
    backend.reset_counts()
    res = entry.fn(*arrays)
    st = np.asarray(res)
    assert res.used_fallback and res.is_ready()
    assert backend.launches == {}
    assert backend.plain_calls == {
        **_PASS_PLAIN[frontend], "decompress_niels": 1, "msm_fill": 3,
        "msm_aggregate": 3, "msm_horner": 2, "msm_order": 1,
        **_FALLBACK_PLAIN}
    np.testing.assert_array_equal(st, direct_statuses["order2"])


# -- the JAX side (goldens and the slow live test) -----------------------


def _jax_plan_fns(token: str):
    import jax

    from firedancer_tpu.msm_plan import parse_plan
    from firedancer_tpu.ops import msm as jmsm
    from firedancer_tpu.ops import verify_rlc as jrlc

    plan = parse_plan(token)
    local = jax.jit(functools.partial(jrlc.verify_rlc_local, plan=plan,
                                      engine="interpret"))
    combine = jax.jit(functools.partial(jrlc.verify_rlc_combine, plan=plan,
                                        engine="interpret"))

    def tails(parts):
        t1, _ = jmsm.msm_fast_combine(parts["w_r"], parts["ok_r"],
                                      jmsm.WINDOWS_Z, interpret=True,
                                      plan=plan)
        t2, _ = jmsm.msm_fast_combine(parts["w_m"], parts["ok_m"],
                                      jmsm.WINDOWS_253, interpret=True,
                                      plan=plan)
        from firedancer_tpu.ops import fe25519 as jfe
        from firedancer_tpu.ops.msm_pallas import mul_by_group_order_pallas

        la = mul_by_group_order_pallas(
            tuple(c[:, :K] for c in parts["sub"]),
            jfe.FE_D2.astype("int32"), jmsm._l_bits_col(), interpret=True)
        cert, _ = jmsm.subgroup_fast_combine(parts["sub"], parts["sub_ok"],
                                             k=K, interpret=True)
        return t1, t2, la, cert

    return local, combine, jax.jit(tails)


def jax_case(token: str, fns, arrays, z, u) -> dict:
    """One corpus case through the JAX package's kernel path."""
    import jax.numpy as jnp

    local, combine, tails = fns
    status, definite, parts = local(*map(jnp.asarray, arrays),
                                    jnp.asarray(z), jnp.asarray(u))
    batch_ok = combine(parts)
    t1, t2, la, cert = tails(parts)
    rec = {"status": np.asarray(status), "definite": np.asarray(definite),
           "batch_ok": np.asarray(batch_ok), "ok_r": np.asarray(parts["ok_r"]),
           "ok_m": np.asarray(parts["ok_m"]),
           "sub_ok": np.asarray(parts["sub_ok"]), "cert": np.asarray(cert)}
    pts = {"w_r": parts["w_r"], "w_m": parts["w_m"],
           "sub": tuple(c[:, :K] for c in parts["sub"]),
           "t1": t1, "t2": t2, "la": la}
    for name, pt in pts.items():
        rec.update(_points_record(name, tuple(np.asarray(c) for c in pt)))
    return rec


def jax_fill_kernel(arrays, u) -> dict:
    """The JAX bucket fill alone (interpret mode) on the clean case's
    torsion grid: its inputs (digits, rounds) and its bucket points."""
    import jax
    import jax.numpy as jnp

    from firedancer_tpu.msm_plan import TORSION_BUCKET_BITS, default_rounds
    from firedancer_tpu.ops import curve25519 as jge
    from firedancer_tpu.ops import msm as jmsm
    from firedancer_tpu.ops import msm_pallas as jmp

    _, _, sigs, pubs = arrays
    nb = 1 << TORSION_BUCKET_BITS
    rounds = default_rounds(2 * N, nb)

    def run(enc, d):
        both, _ = jge.decompress(enc)
        idx, ok = jmsm._staging_from_digits(d, 2 * N, rounds, nb)
        staged = jmsm._stage_niels(both, idx, rounds, K * nb, 2 * N)
        return jmp.fill_buckets_pallas(*staged, interpret=True), idx, ok

    enc = np.concatenate([pubs, sigs[:, :32]], axis=0)
    buckets, idx, ok = jax.jit(run)(jnp.asarray(enc),
                                    jnp.asarray(u & (nb - 1)))
    rec = {"fill_idx": np.asarray(idx), "fill_ok": np.asarray(ok)}
    rec.update(_points_record("fill", tuple(np.asarray(c) for c in buckets)))
    return rec


def _write_goldens() -> None:
    import time

    from firedancer_tpu.ops.verify_rlc import fresh_u, fresh_z

    out = {}
    inputs = {c: case_inputs(c, fresh_z, fresh_u) for c in CASES}
    for c, (arrays, z, u) in inputs.items():
        for name, a in zip(("msgs", "lens", "sigs", "pubs", "z", "u"),
                           arrays + (z, u)):
            out[f"{c}/{name}"] = a
    for token in PLANS:
        t0 = time.time()
        fns = _jax_plan_fns(token)
        for c, (arrays, z, u) in inputs.items():
            for k, v in jax_case(token, fns, arrays, z, u).items():
                out[f"{token}/{c}/{k}"] = v
            print(f"{token} {c}: batch_ok {out[f'{token}/{c}/batch_ok']} "
                  f"({time.time() - t0:.0f} s)", flush=True)
    arrays, _, u = inputs["clean"]
    for k, v in jax_fill_kernel(arrays, u).items():
        out[f"kernel/{k}"] = v
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")


if __name__ == "__main__":
    _write_goldens()
