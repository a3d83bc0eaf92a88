"""Direct Ed25519 batch verify of the PyTorch port (the whole slice).

* A seeded mix (valid, salted, s >= L, undecodable A, small-order A and
  R, non-canonical R) at B=16 against the JAX package's jitted
  verify_batch. Compiling that graph takes about a minute on one CPU
  core, so tier-1 compares against its statuses in
  tests/fixtures/torch_port/verify_mix.npz, and the live comparison is
  a slow test. Rewrite the golden file from the JAX package with
  ``JAX_PLATFORMS=cpu python -m tests.test_torch_verify`` from the
  repository root.
* All 396 Zcash malleability vectors in one batch, and the RFC 8032
  vectors. The port's oracle against RFC 8032 and the JAX package's
  scalar multiplication.
* The port's rules: no JAX import, an entry point that refuses to run
  on the CPU unless asked, a kernel build that fails loudly.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from firedancer_tpu_torch.ballet.ed25519 import corpus, oracle
from firedancer_tpu_torch.disco.engine import EngineSpec, registry
from firedancer_tpu_torch.ops import backend, build
from firedancer_tpu_torch.ops.verify import verify_batch, verify_batch_ref

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
GOLDEN = FIXTURES / "torch_port" / "verify_mix.npz"

MIX = ["valid", "valid", "valid", "valid", "salted", "salted", "s_ge_l",
       "s_ge_l", "bad_a", "bad_a", "small_a", "small_a", "small_r",
       "small_r", "noncanon_r", "noncanon_r"]


def _mix():
    """The seeded B=16 mix: (msgs, lens, sigs, pubs) and the category of
    each lane."""
    rng = np.random.RandomState(31)
    items = corpus.signed_items(len(MIX), [0, 1, 47, 192, 300], rng)
    torsion = corpus.torsion_encodings()
    bad = corpus.undecodable_encodings(2, rng)
    # Non-canonical R: y + p encodings that decode to points of full
    # order (R' never equals them, so the compare fails).
    noncanon = [e for e in ((oracle.P + k).to_bytes(32, "little")
                            for k in range(2, 19))
                if (pt := oracle.point_decompress(e)) is not None
                and not oracle.is_small_order(pt)][:2]
    out = []
    for b, (cat, (m, sig, pub)) in enumerate(zip(MIX, items)):
        if cat == "salted":             # one byte flipped or appended
            m = bytes([m[0] ^ 0x40]) + m[1:] if m else b"\x40"
        elif cat == "s_ge_l":
            s = int.from_bytes(sig[32:], "little") + oracle.L
            sig = sig[:32] + s.to_bytes(32, "little")
        elif cat == "bad_a":
            pub = bad[b % 2]
        elif cat == "small_a":
            pub = torsion[3 + b % 2]
        elif cat == "small_r":
            sig = torsion[5 + b % 2] + sig[32:]
        elif cat == "noncanon_r":
            sig = noncanon[b % 2] + sig[32:]
        out.append((m, sig, pub))
    return corpus.to_arrays(out, 300)


@pytest.fixture(scope="module")
def mix():
    arrays = _mix()
    got = verify_batch(*map(torch.from_numpy, arrays)).numpy()
    return arrays, got


def test_mix_inputs_match_golden(mix):
    arrays, _ = mix
    g = np.load(GOLDEN)
    for name, a in zip(("msgs", "lens", "sigs", "pubs"), arrays):
        np.testing.assert_array_equal(a, g[name], err_msg=name)


@pytest.mark.parametrize("cat", sorted(set(MIX)))
def test_verify_mix_matches_jax_golden(mix, cat):
    arrays, got = mix
    want = np.load(GOLDEN)["status"]
    lanes = [b for b, c in enumerate(MIX) if c == cat]
    assert got[lanes].tolist() == want[lanes].tolist()
    msgs, lens, sigs, pubs = arrays
    for b in lanes:
        assert got[b] == oracle.verify(msgs[b, :lens[b]].tobytes(),
                                       sigs[b].tobytes(), pubs[b].tobytes())


def test_verify_mix_statuses_cover_the_ladder(mix):
    _, got = mix
    by_cat = {c: {int(got[b]) for b, cc in enumerate(MIX) if cc == c}
              for c in set(MIX)}
    assert by_cat == {
        "valid": {oracle.FD_ED25519_SUCCESS},
        "salted": {oracle.FD_ED25519_ERR_MSG},
        "s_ge_l": {oracle.FD_ED25519_ERR_SIG},
        "bad_a": {oracle.FD_ED25519_ERR_PUBKEY},
        "small_a": {oracle.FD_ED25519_ERR_PUBKEY},
        "small_r": {oracle.FD_ED25519_ERR_SIG},
        "noncanon_r": {oracle.FD_ED25519_ERR_MSG},
    }


def _jax_statuses(arrays) -> np.ndarray:
    import jax
    import jax.numpy as jnp

    from firedancer_tpu.ops.verify import verify_batch as jax_verify

    return np.asarray(jax.jit(jax_verify)(*map(jnp.asarray, arrays)))


@pytest.mark.slow
def test_verify_mix_matches_live_jax(mix):
    """The golden file's statuses are the JAX package's, recompiled."""
    arrays, got = mix
    want = _jax_statuses(arrays)
    np.testing.assert_array_equal(want, np.load(GOLDEN)["status"])
    np.testing.assert_array_equal(got, want)


# -- vector suites ------------------------------------------------------


def _zcash():
    out = []
    for fname, passes in (("ed25519_malleability_should_pass.bin", True),
                          ("ed25519_malleability_should_fail.bin", False)):
        raw = (FIXTURES / fname).read_bytes()
        out += [(raw[o:o + 64], raw[o + 64:o + 96], passes)
                for o in range(0, len(raw), 96)]
    return out


ZCASH = _zcash()


@pytest.fixture(scope="module")
def zcash_statuses():
    """All 396 vectors (message "Zcash") through one port batch."""
    arrays = corpus.to_arrays([(b"Zcash", sig, pub) for sig, pub, _ in ZCASH])
    return verify_batch(*map(torch.from_numpy, arrays)).numpy()


def test_zcash_vector_count():
    assert len(ZCASH) == 396
    assert sum(p for _, _, p in ZCASH) == 200


@pytest.mark.parametrize("i", range(len(ZCASH)),
                         ids=[f"{'pass' if p else 'fail'}{i}"
                              for i, (_, _, p) in enumerate(ZCASH)])
def test_zcash_vector(zcash_statuses, i):
    assert (zcash_statuses[i] == 0) == ZCASH[i][2]


def _rfc8032():
    from tests.test_oracle import RFC8032_VECTORS, _msg_bytes

    return [(_msg_bytes(msg), bytes.fromhex(sig), bytes.fromhex(pub))
            for _, pub, msg, sig in RFC8032_VECTORS]


@pytest.fixture(scope="module")
def rfc_statuses():
    items = _rfc8032()
    arrays = corpus.to_arrays(items)
    tampered = corpus.to_arrays([(m + b"!", s, p) for m, s, p in items])
    run = lambda a: verify_batch(*map(torch.from_numpy, a)).numpy()
    return run(arrays), run(tampered)


@pytest.mark.parametrize("i", range(4))
def test_rfc8032_vector(rfc_statuses, i):
    good, tampered = rfc_statuses
    assert good[i] == oracle.FD_ED25519_SUCCESS
    assert tampered[i] == oracle.FD_ED25519_ERR_MSG


# -- the port's oracle against the JAX package's --------------------------
# The port's oracle ladder runs in extended coordinates; the tests above
# and test_torch_curve.py take it as their reference, so it is held here
# against RFC 8032 and against the JAX package's affine ladder.


@pytest.mark.parametrize("i", range(4))
def test_oracle_keypair_and_sign_match_rfc8032(i):
    from tests.test_oracle import RFC8032_VECTORS, _msg_bytes

    seed, pub, msg, sig = RFC8032_VECTORS[i]
    seed_b = bytes.fromhex(seed)
    assert oracle.keypair_from_seed(seed_b)[2] == bytes.fromhex(pub)
    assert oracle.sign(_msg_bytes(msg), seed_b) == bytes.fromhex(sig)


_LADDER_KS = [0, 1, 2, 7, 8, 9, oracle.L - 1, oracle.L, oracle.L + 1,
              (1 << 255) - 1, 0x1d3a5f9c2b4e6d8071e2c3b4a5968778]


@pytest.mark.parametrize("point", ["base", "order8", "mixed"])
@pytest.mark.parametrize("k", _LADDER_KS,
                         ids=[f"k{i}" for i in range(len(_LADDER_KS))])
def test_oracle_scalarmult_matches_jax_oracle(point, k):
    """Full-order, order-8 and mixed-order points: the identity and the
    torsion cancel at k = 0, 8 and L."""
    from firedancer_tpu.ballet.ed25519 import oracle as joracle

    t8 = next(p for p in map(oracle.point_decompress,
                             corpus.torsion_encodings())
              if joracle.scalarmult(4, p) != (0, 1))
    pt = {"base": oracle.B, "order8": t8,
          "mixed": oracle.point_add(oracle.B, t8)}[point]
    assert oracle.scalarmult(k, pt) == joracle.scalarmult(k, pt)


# -- rules of the port --------------------------------------------------


def _port_sources():
    files = sorted((ROOT / "firedancer_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "firedancer_tpu"), (
                f"{path.name} imports {name}")


def test_port_scan_reaches_the_feed_modules():
    """The scan covers the fd_feed runtime, its worker process (which
    runs as its own interpreter) and the staging slots."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {"firedancer_tpu_torch/disco/worker.py",
            "firedancer_tpu_torch/disco/feed/runtime.py",
            "firedancer_tpu_torch/disco/feed/slots.py"} <= names


FLIGHT_MODULES = ("firedancer_tpu_torch/disco/flight.py",
                  "firedancer_tpu_torch/disco/sentinel.py",
                  "firedancer_tpu_torch/tools/fd_top.py")


def test_port_scan_reaches_the_flight_modules():
    """The scan covers fd_flight, fd_sentinel's SLO engine and fd_top,
    and none of them reads the environment: their flags are options."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert set(FLIGHT_MODULES) <= names
    for rel in FLIGHT_MODULES:
        tree = ast.parse((ROOT / rel).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("environ", "getenv", "environb"), (
                    f"{rel} reads the environment")


XRAY_MODULES = ("firedancer_tpu_torch/disco/xray.py",
                "firedancer_tpu_torch/tools/fd_xray.py",
                "firedancer_tpu_torch/tools/fd_report.py")


def test_port_scan_reaches_the_xray_modules():
    """The scan covers fd_xray and its two tools, and none of them reads
    the environment: their flags are options."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert set(XRAY_MODULES) <= names
    for rel in XRAY_MODULES:
        tree = ast.parse((ROOT / rel).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("environ", "getenv", "environb"), (
                    f"{rel} reads the environment")


def test_port_scan_reaches_the_app_and_utils_modules():
    """The scan covers the operator entry point and the utilities it
    copied from the JAX package."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {f"firedancer_tpu_torch/app/{m}.py" for m in (
        "config", "configure", "fdctl", "fddev", "ctl", "security")} <= names
    assert {f"firedancer_tpu_torch/utils/{m}.py" for m in (
        "pod", "pcap", "pcapng")} <= names


def test_port_scan_reaches_the_healing_modules():
    """The scan covers the verify tile's healing lane: the fault
    injector, the native CPU verifier's binding, the breaker's policy
    module and the Rng they draw from."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {"firedancer_tpu_torch/utils/rng.py",
            "firedancer_tpu_torch/disco/chaos.py",
            "firedancer_tpu_torch/ballet/ed25519/native.py",
            "firedancer_tpu_torch/disco/feed/policy.py"} <= names


SOAK_MODULES = ("firedancer_tpu_torch/disco/soak.py",
                "firedancer_tpu_torch/disco/siege.py",
                "firedancer_tpu_torch/disco/supervisor.py",
                "firedancer_tpu_torch/tools/fd_soak.py",
                "firedancer_tpu_torch/tools/bench_log_check.py")


def test_port_scan_reaches_the_soak_modules():
    """The scan covers fd_soak, the two tables it copied and its two
    tools, and none of them reads the environment: their flags are
    options."""
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert set(SOAK_MODULES) <= names
    for rel in SOAK_MODULES:
        tree = ast.parse((ROOT / rel).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("environ", "getenv", "environb"), (
                    f"{rel} reads the environment")


def test_acquire_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="capability 9"):
        registry().acquire(EngineSpec("direct", 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry().acquire(EngineSpec("direct", 8), device="cuda")


def test_acquire_rejects_rlc_and_unknown_modes():
    """RLC mode is served (tests/test_torch_rlc.py drives it); an rlc spec
    with an unknown MSM plan and an unknown mode are refused."""
    with pytest.raises(ValueError, match="msm plan"):
        registry().acquire(EngineSpec("rlc", 8, msm="x7"), device="cpu")
    with pytest.raises(ValueError, match="verify mode"):
        registry().acquire(EngineSpec("cpu", 8), device="cpu")
    entry, warmed = registry().acquire(EngineSpec("rlc", 8), device="cpu",
                                       warm=False)
    assert (entry.key, warmed, entry.state) == ("rlc:B8:fefused:u7", False,
                                                "cold")


def test_cpu_engine_runs_the_plain_path(mix):
    arrays, want = mix
    entry, warmed = registry().acquire(EngineSpec("direct", 16),
                                       device="cpu", max_msg_len=300)
    assert warmed and entry.state == "warm"
    assert registry().acquire(EngineSpec("direct", 16), device="cpu",
                              max_msg_len=300) == (entry, False)
    backend.reset_counts()
    got = entry.fn(*arrays).numpy()
    np.testing.assert_array_equal(got, want)
    assert backend.launches == {}
    assert backend.plain_calls == {"sha512_mod_l": 1, "decompress_so": 1,
                                   "double_scalarmult": 1, "point_eq": 1}
    snap = entry.snapshot()
    assert (snap["dispatches"], snap["lanes"], snap["device"]) == \
        (1, 16, "cpu")


def test_verify_batch_ref_equals_verify_batch_on_cpu(mix):
    arrays, want = mix
    got = verify_batch_ref(*map(torch.from_numpy, arrays)).numpy()
    np.testing.assert_array_equal(got, want)


def test_empty_batch():
    out = verify_batch(torch.zeros(0, 10, dtype=torch.uint8),
                       torch.zeros(0, dtype=torch.int32),
                       torch.zeros(0, 64, dtype=torch.uint8),
                       torch.zeros(0, 32, dtype=torch.uint8))
    assert out.shape == (0,) and out.dtype == torch.int32


def test_build_raises_naming_nvcc_without_the_toolkit(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


def _write_golden() -> None:
    arrays = _mix()
    status = _jax_statuses(arrays)
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez(GOLDEN, msgs=arrays[0], lens=arrays[1], sigs=arrays[2],
             pubs=arrays[3], status=status)
    print(f"wrote {GOLDEN}: status {status.tolist()}")


if __name__ == "__main__":
    _write_golden()
