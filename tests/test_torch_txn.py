"""The port's transaction parser and corpus against the JAX package's.

* ``parse_txn`` gives the JAX package's descriptor field for field, or
  raises ``TxnParseError`` with the same code, on every mainnet fixture
  (``tests/fixtures/transaction*.bin``, ``txn_pack/*.bin``), on a JAX
  ``mainnet_corpus`` with every traffic class, and on hypothesis-mutated
  and truncated bytes of both.
* ``build_txn`` is byte-equal given the same public keys and signer.
* The port's ``mainnet_corpus(device="cpu")`` is byte-equal to the JAX
  package's at the same seed, with the same classes.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from firedancer_tpu.ballet import txn as jtxn
from firedancer_tpu.disco import corpus as jcorpus
from firedancer_tpu_torch.ballet import txn as ptxn
from firedancer_tpu_torch.ballet.compute_budget import (
    COMPUTE_BUDGET_PROGRAM_ID,
)
from firedancer_tpu_torch.ballet.ed25519 import oracle
from firedancer_tpu_torch.disco import corpus as pcorpus

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
MAINNET = (sorted(FIXTURES.glob("transaction*.bin"))
           + sorted((FIXTURES / "txn_pack").glob("*.bin")))


def _parse(mod, buf: bytes):
    """The descriptor as a dict, or the parse error's code."""
    try:
        return dataclasses.asdict(mod.parse_txn(buf))
    except mod.TxnParseError as e:
        return ("error", e.code)


def _same_parse(buf: bytes) -> None:
    got, want = _parse(ptxn, buf), _parse(jtxn, buf)
    assert got == want, (buf[:16].hex(), got, want)


def test_fixtures_are_the_corpus():
    assert len(MAINNET) == 67


@pytest.mark.parametrize("path", MAINNET, ids=lambda p: p.name)
def test_parse_mainnet_fixture(path):
    buf = path.read_bytes()
    _same_parse(buf)
    d = ptxn.parse_txn(buf)
    items = d.verify_items(buf)
    want = jtxn.parse_txn(buf).verify_items(buf)
    assert items == want and len(items) == d.signature_cnt


@pytest.fixture(scope="module")
def jax_corpus():
    return jcorpus.mainnet_corpus(n=48, seed=21, dup_rate=0.1,
                                  corrupt_rate=0.1, parse_err_rate=0.2)


def test_parse_jax_corpus(jax_corpus):
    classes = set()
    for p, e in zip(jax_corpus.payloads, jax_corpus.expected):
        _same_parse(p)
        classes.add(int(e))
        if e == jcorpus.BAD_PARSE:
            with pytest.raises(ptxn.TxnParseError):
                ptxn.parse_txn(p)
    assert classes == {jcorpus.OK, jcorpus.DUP, jcorpus.BAD_SIG,
                       jcorpus.BAD_PARSE}


_SEEDS = [p.read_bytes() for p in MAINNET[:12]]


@settings(max_examples=300, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(which=st.integers(0, len(_SEEDS) - 1),
       flips=st.lists(st.tuples(st.integers(0, 1231), st.integers(1, 255)),
                      max_size=4),
       cut=st.integers(0, 1232), grow=st.binary(max_size=8))
def test_parse_mutated(which, flips, cut, grow):
    buf = bytearray(_SEEDS[which])
    for pos, x in flips:
        buf[pos % len(buf)] ^= x
    _same_parse(bytes(buf))
    _same_parse(bytes(buf[:cut]))
    _same_parse(bytes(buf) + grow)


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(st.binary(max_size=300))
def test_parse_random_bytes(buf):
    _same_parse(buf)


def test_compact_u16_round_trip():
    for v in list(range(0, 300)) + [0x3FFF, 0x4000, 0xFFFF]:
        enc = ptxn.write_compact_u16(v)
        assert enc == jtxn.write_compact_u16(v)
        assert ptxn.read_compact_u16(enc, 0) == (v, len(enc))
    for bad in (b"\x80\x00", b"\x80\x80\x00", b"\xff\xff\x04", b"\x80"):
        with pytest.raises(ptxn.TxnParseError) as e:
            ptxn.read_compact_u16(bad, 0)
        with pytest.raises(jtxn.TxnParseError) as f:
            jtxn.read_compact_u16(bad, 0)
        assert e.value.code == f.value.code


def _sign(msg: bytes, seed: bytes) -> bytes:
    return oracle.sign(msg, seed)


@pytest.mark.parametrize("case", ["legacy_1", "legacy_3_ro", "v0_luts"])
def test_build_txn_byte_equal(case):
    seeds = {"legacy_1": [bytes([7]) * 32],
             "legacy_3_ro": [bytes([i]) * 32 for i in (1, 2, 3)],
             "v0_luts": [bytes([9]) * 32, bytes([10]) * 32]}[case]
    pubs = [oracle.keypair_from_seed(s)[2] for s in seeds]
    kw = dict(extra_accounts=[COMPUTE_BUDGET_PROGRAM_ID, bytes(range(32))],
              n_readonly_unsigned=1,
              recent_blockhash=bytes(range(32, 64)),
              instrs=[(len(seeds), [], b"\x02\x40\x42\x0f\x00"),
                      (len(seeds) + 1, [0, 1], b"data" * 9)])
    if case == "legacy_3_ro":
        kw["n_readonly_signed"] = 1
    if case == "v0_luts":
        kw.update(version=0, addr_luts=[(bytes([5]) * 32, [1, 2], [3]),
                                        (bytes([6]) * 32, [], [0, 4])])
    got = ptxn.build_txn(signer_seeds=seeds, pubs=pubs, sign_fn=_sign, **kw)
    want = jtxn.build_txn(signer_seeds=seeds, sign_fn=_sign, **kw)
    assert got == want
    _same_parse(got)
    d = ptxn.parse_txn(got)
    for sig, pub, msg in d.verify_items(got):
        assert oracle.verify(msg, sig, pub) == 0
    with pytest.raises(ValueError, match="one public key"):
        ptxn.build_txn(signer_seeds=seeds, pubs=pubs[:-1], sign_fn=_sign,
                       **kw)


def test_compute_budget_program_id():
    from firedancer_tpu.ballet.compute_budget import (
        COMPUTE_BUDGET_PROGRAM_ID as want,
    )

    assert COMPUTE_BUDGET_PROGRAM_ID == want


@pytest.mark.parametrize("seed,rates", [
    (42, {}),
    (5, {"dup_rate": 0.25, "corrupt_rate": 0.25, "parse_err_rate": 0.17}),
])
def test_mainnet_corpus_byte_equal(seed, rates):
    got = pcorpus.mainnet_corpus(n=12, seed=seed, device="cpu", **rates)
    want = jcorpus.mainnet_corpus(n=12, seed=seed, **rates)
    assert got.payloads == want.payloads
    assert np.array_equal(got.expected, want.expected)
    assert got.n_unique_ok == want.n_unique_ok == 12
    assert (pcorpus.expected_sink_digests(got)
            == jcorpus.expected_sink_digests(want))
