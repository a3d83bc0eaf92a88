"""SHA-512 and h = SHA-512(.) mod L of the PyTorch port against hashlib,
Python integers and the JAX package's staged path.

The port's plain versions run here on the CPU; the CUDA kernel
(csrc/sha512_mod_l.cu) is held against the same plain version on the
card by chip_smoke.py.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import frontend_pallas as jfront
from firedancer_tpu.ops import sc25519 as jsc
from firedancer_tpu_torch.ops import backend, frontend_cuda, sc25519, sha512

torch.set_num_threads(1)

L = sc25519.L
MAX_LEN = 1232
LENGTHS = [0, 1, 55, 64, 111, 112, 113, 127, 128, 129, 200, 239, 240, 241,
           255, 256, 383, 384, 500, 767, 1000, 1231, 1232]


@pytest.fixture(scope="module")
def digests():
    """One batch over every length (two rows each) at max_len 1232."""
    rng = np.random.RandomState(11)
    lens = np.repeat(np.asarray(LENGTHS, np.int32), 2)
    msgs = rng.randint(0, 256, (len(lens), MAX_LEN), dtype=np.uint8)
    got = sha512.sha512_batch(torch.from_numpy(msgs), torch.from_numpy(lens))
    return msgs, lens, got.numpy()


@pytest.mark.parametrize("length", LENGTHS)
def test_sha512_batch_matches_hashlib(digests, length):
    msgs, lens, got = digests
    for b in np.nonzero(lens == length)[0]:
        want = hashlib.sha512(msgs[b, :length].tobytes()).digest()
        assert bytes(got[b]) == want


def test_sha512_lengths_clamp_to_row():
    """Lengths outside [0, max_len] hash as the clamped length (the
    kernel reads no byte outside its row)."""
    msgs = torch.arange(40, dtype=torch.uint8).reshape(2, 20)
    got = sha512.sha512_batch(msgs, torch.tensor([-5, 99]))
    assert bytes(got[0].tolist()) == hashlib.sha512(b"").digest()
    assert bytes(got[1].tolist()) == hashlib.sha512(
        bytes(range(20, 40))).digest()


SC_EDGE = [0, 1, L - 1, L, L + 1, 2 * L, 3 * L - 1, 3 * L, 2**252,
           2**253 - 1, 2**256 - 1, 2**511, 2**512 - 1, (2**512 // L) * L,
           (2**512 // L) * L - 1]


@pytest.mark.parametrize("value", SC_EDGE, ids=range(len(SC_EDGE)))
def test_sc_reduce64_edges(value):
    x = torch.tensor([list(value.to_bytes(64, "little"))], dtype=torch.uint8)
    got = sc25519.sc_reduce64(x)
    assert int.from_bytes(bytes(got[0].tolist()), "little") == value % L


def test_sc_reduce64_matches_jax():
    rng = np.random.RandomState(12)
    x = rng.randint(0, 256, (64, 64), dtype=np.uint8)
    x[:len(SC_EDGE)] = [list(v.to_bytes(64, "little")) for v in SC_EDGE]
    got = sc25519.sc_reduce64(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jsc.sc_reduce64(jnp.asarray(x))))


def test_sc_check_range_matches_jax():
    rng = np.random.RandomState(13)
    vals = [0, L - 1, L, L + 1, 2**256 - 1, 2**252, L - 2**8, L + 2**128]
    s = rng.randint(0, 256, (40, 32), dtype=np.uint8)
    s[:, 31] &= rng.choice([0x0F, 0x1F, 0xFF], 40).astype(np.uint8)
    s[:len(vals)] = [list(v.to_bytes(32, "little")) for v in vals]
    got = sc25519.sc_check_range(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jsc.sc_check_range(jnp.asarray(s))))
    assert got[:len(vals)].tolist() == [v < L for v in vals]


def test_sha512_mod_l_matches_python_and_jax():
    """h of the port's plain version equals int(digest) % L and the
    JAX package's sha512_mod_l_auto (its staged XLA path on the CPU),
    at B=16 with the verify front half's row shape (r || A || msg)."""
    rng = np.random.RandomState(14)
    msgs = rng.randint(0, 256, (16, 64 + 300), dtype=np.uint8)
    lens = np.asarray([64 + n for n in (0, 1, 47, 48, 111, 175, 176, 300)]
                      * 2, np.int32)
    backend.reset_counts()
    got = frontend_cuda.sha512_mod_l(torch.from_numpy(msgs),
                                     torch.from_numpy(lens)).numpy()
    assert backend.plain_calls == {"sha512_mod_l": 1}
    assert backend.launches == {}
    for b in range(16):
        d = hashlib.sha512(msgs[b, :lens[b]].tobytes()).digest()
        assert int.from_bytes(bytes(got[b]), "little") == \
            int.from_bytes(d, "little") % L
    want = np.asarray(jfront.sha512_mod_l_auto(jnp.asarray(msgs),
                                               jnp.asarray(lens)))
    np.testing.assert_array_equal(got, want)


def test_sha512_mod_l_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        frontend_cuda.sha512_mod_l_cuda(
            torch.zeros(2, 8, dtype=torch.uint8),
            torch.zeros(2, dtype=torch.int32))
