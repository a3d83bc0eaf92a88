"""The port's block packing host side against the JAX package's, on the
same inputs.

* ``estimate_rewards_and_compute`` on the mainnet fixtures and a JAX
  ``mainnet_corpus``, with and without an estimator, and
  ``ComputeBudgetState`` on every instruction shape (each tag, a repeat,
  a bad length, a heap size off the granularity, an unknown tag).
* ``Pack``: the same seeded insert / schedule / complete / end_block
  sequence, eviction at a small depth included, returns the same
  transactions and counters; ``CuEstimator`` gives the same estimates
  after the same observations.
* ``validate_schedule``, ``greedy_waves``, ``schedule_value`` and
  ``device_beats_greedy`` agree on random waves and blocks.
"""

import random
import struct
from pathlib import Path

import numpy as np
import pytest

from firedancer_tpu.ballet import compute_budget as jcb
from firedancer_tpu.ballet import pack as jpack
from firedancer_tpu.ballet import txn as jtxn
from firedancer_tpu.disco import corpus as jcorpus
from firedancer_tpu.disco import drain as jdrain
from firedancer_tpu_torch.ballet import compute_budget as pcb
from firedancer_tpu_torch.ballet import pack as ppack
from firedancer_tpu_torch.ballet import txn as ptxn
from firedancer_tpu_torch.disco import drain as pdrain
from firedancer_tpu_torch.disco import tiles as ptiles

FIXTURES = Path(__file__).resolve().parent / "fixtures"
MAINNET = ([p.read_bytes() for p in sorted(FIXTURES.glob("transaction*.bin"))]
           + [p.read_bytes()
              for p in sorted((FIXTURES / "txn_pack").glob("*.bin"))])


@pytest.fixture(scope="module")
def payloads():
    c = jcorpus.mainnet_corpus(n=48, seed=3, dup_rate=0.0, corrupt_rate=0.0,
                               parse_err_rate=0.0)
    return MAINNET + c.payloads


def _estimate(mod, txnmod, est, p):
    try:
        t = txnmod.parse_txn(p)
    except txnmod.TxnParseError:
        return "parse"
    return mod.estimate_rewards_and_compute(t, p, estimator=est)


def test_estimates_equal(payloads):
    assert len(MAINNET) == 67
    pe, je = ppack.CuEstimator(), jpack.CuEstimator()
    for i, p in enumerate(payloads):
        t = jtxn.parse_txn(p)
        if i % 5 == 0 and t.instrs:   # a moving estimate: observe first
            prog = t.account(p, t.instrs[-1].program_id_index)
            pe.observe(prog, 1000 * i)
            je.observe(prog, 1000 * i)
        for pest, jest in ((None, None), (pe, je)):
            assert (_estimate(pcb, ptxn, pest, p)
                    == _estimate(jcb, jtxn, jest, p))


INSTRS = [
    b"\x00" + struct.pack("<II", 300_000, 9_000),
    b"\x01" + struct.pack("<I", 64 * 1024),
    b"\x01" + struct.pack("<I", 1000),          # not a multiple of 1024
    b"\x02" + struct.pack("<I", 1_400_000),
    b"\x03" + struct.pack("<Q", 2**63 + 7),      # saturates the fee
    b"\x03" + struct.pack("<Q", 12_345),
    b"\x02\x01\x02",                            # short
    b"\x02" + struct.pack("<I", 5) + b"\x00",   # long
    b"\x07" + struct.pack("<I", 5),             # unknown tag
]


@pytest.mark.parametrize("seed", range(6))
def test_compute_budget_state_equal(seed):
    rng = random.Random(seed)
    for _ in range(40):
        seq = [rng.choice(INSTRS) for _ in range(rng.randint(0, 4))]
        ps, js = pcb.ComputeBudgetState(), jcb.ComputeBudgetState()
        for d in seq:
            assert ps.parse_instr(d) == js.parse_instr(d)
        assert vars(ps) == vars(js)
        total = rng.randint(len(seq), len(seq) + 3)
        assert ps.finalize(total) == js.finalize(total)


def _mk(mod, n, seed, n_accounts=24, max_w=3, max_r=3):
    """n PackTxns over n_accounts keys (heavy conflicts), seeded."""
    rng = random.Random(seed)
    keys = [bytes([i]) * 32 for i in range(n_accounts)]
    out = []
    for i in range(n):
        w = frozenset(rng.sample(keys, rng.randint(0, max_w)))
        r = frozenset(k for k in rng.sample(keys, rng.randint(0, max_r))
                      if k not in w)
        out.append(mod.PackTxn(txn_id=i, rewards=rng.randint(1, 2_000_000),
                               est_cus=rng.randint(1, 3_000_000),
                               writable=w, readonly=r))
    return out


def _ids(x):
    if x is None:
        return None
    if isinstance(x, list):
        return [_ids(t) for t in x]
    return x.txn_id


@pytest.mark.parametrize("seed", range(4))
def test_pack_sequence_equal(seed):
    """One seeded operation sequence on both packages' Pack at depth 12
    (eviction by the seeded bottom-half rule), two banks, a 4M budget."""
    rng = random.Random(100 + seed)
    txns = {m: _mk(m, 160, seed) for m in (ppack, jpack)}
    packs = {m: m.Pack(bank_cnt=2, depth=12, max_cu_per_bank=4_000_000)
             for m in (ppack, jpack)}
    nxt = 0
    for _ in range(400):
        op, bank, limit = rng.random(), rng.randrange(2), rng.randint(1, 8)
        if op < 0.45:
            if nxt == len(txns[ppack]):
                continue
            got = {m: pk.insert(txns[m][nxt]) for m, pk in packs.items()}
            nxt += 1
        elif op < 0.8:
            got = {m: _ids(pk.schedule(bank, scan_limit=limit))
                   for m, pk in packs.items()}
        elif op < 0.95:
            got = {m: sorted(pk._inflight[bank]) for m, pk in packs.items()}
            if got[ppack]:
                tid = got[ppack][0]
                for pk in packs.values():
                    pk.complete(bank, tid, actual_cus=tid * 1000)
        else:
            got = {m: pk.end_block() for m, pk in packs.items()}
        assert got[ppack] == got[jpack]
        p, j = packs[ppack], packs[jpack]
        assert (p.pending_cnt(), p.inflight_cnt(), p.insert_cnt, p.drop_cnt,
                p.schedule_cnt, p.conflict_skip_cnt, p._bank_cu) == (
            j.pending_cnt(), j.inflight_cnt(), j.insert_cnt, j.drop_cnt,
            j.schedule_cnt, j.conflict_skip_cnt, j._bank_cu)
        assert [_ids(e[2]) for e in p._heap] == [_ids(e[2]) for e in j._heap]
    assert packs[ppack].drop_cnt > 0


def test_compare_worse_and_score_equal():
    rng = random.Random(7)
    for _ in range(200):
        a = [rng.randint(0, 10**12) for _ in range(4)]
        assert ppack.compare_worse(*a) == jpack.compare_worse(*a)
    for t, u in zip(_mk(ppack, 50, 1), _mk(jpack, 50, 1)):
        assert t.score == u.score


@pytest.mark.parametrize("seed", range(3))
def test_cu_estimator_equal(seed):
    rng = random.Random(seed)
    pe = ppack.CuEstimator(bin_cnt=16, history=8)
    je = jpack.CuEstimator(bin_cnt=16, history=8)
    progs = [bytes([i]) * 32 for i in range(40)]
    for _ in range(300):
        k = rng.choice(progs)
        if rng.random() < 0.6:
            v = rng.randint(0, 2_000_000)
            pe.observe(k, v)
            je.observe(k, v)
        ks = rng.sample(progs, rng.randint(0, 4))
        assert pe.estimate(ks) == je.estimate(ks)
        assert pe.estimate_with_variance(ks) == je.estimate_with_variance(ks)
    with pytest.raises(ValueError):
        ppack.EstTbl(bin_cnt=12)


@pytest.mark.parametrize("seed", range(4))
def test_waves_and_gate_equal(seed):
    """greedy_waves, validate_schedule, schedule_value and
    device_beats_greedy on the same blocks; random waves are often
    inadmissible, greedy's never."""
    rng = random.Random(seed)
    for n_colors, cu_cap in ((4, 3_000_000), (16, 12_000_000)):
        pt, jt = _mk(ppack, 90, seed), _mk(jpack, 90, seed)
        pw, pl = pdrain.greedy_waves(pt, n_colors, cu_cap)
        jw, jl = jdrain.greedy_waves(jt, n_colors, cu_cap)
        assert (_ids(pw), _ids(pl)) == (_ids(jw), _ids(jl))
        assert ppack.validate_schedule(pw) and jpack.validate_schedule(jw)
        assert pdrain.schedule_value(pw) == jdrain.schedule_value(jw)
        for _ in range(20):
            cut = [rng.randrange(len(pt)) for _ in range(rng.randint(0, 30))]
            waves = [[pt[i] for i in cut[k::3]] for k in range(3)]
            jwaves = [[jt[i] for i in cut[k::3]] for k in range(3)]
            assert (ppack.validate_schedule(waves)
                    == jpack.validate_schedule(jwaves))
            assert (pdrain.device_beats_greedy(waves, [], pw, pl)
                    == jdrain.device_beats_greedy(jwaves, [], jw, jl))
    assert pdrain.device_beats_greedy([], [], [], [])
    assert not pdrain.device_beats_greedy([], pt, pw, pl)


def test_pack_txn_view(payloads):
    """The pack tile's view of a txn: its static accounts split by the
    write-lock rule, the JAX estimate's rewards and CUs."""
    est = ppack.CuEstimator()
    for i, p in enumerate(payloads[:80]):
        pt = ptiles.pack_txn(p, i, est)
        t = jtxn.parse_txn(p)
        want = jcb.estimate_rewards_and_compute(
            t, p, estimator=jpack.CuEstimator())
        if want is None:   # a malformed compute-budget instruction
            assert pt is None
            continue
        keys = [t.account(p, k) for k in range(t.acct_cnt)]
        assert pt.writable == frozenset(
            k for j, k in enumerate(keys) if t.is_writable(j))
        assert pt.readonly == frozenset(keys) - pt.writable
        assert (pt.rewards, pt.est_cus, pt.txn_id) == (*want[:2], i)
    assert ptiles.pack_txn(b"\x01\x02", 0, est) is None
