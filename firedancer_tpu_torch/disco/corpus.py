"""Mainnet-shaped transaction corpus, generated and signed on the card:
the counterpart of ``firedancer_tpu/disco/corpus.py`` (``Corpus``,
``OK``/``DUP``/``BAD_SIG``/``BAD_PARSE``, ``mainnet_corpus``:67,
``expected_sink_digests``:185, and the device branch
of ``_sign_jobs``:226-264).

``mainnet_corpus`` draws the JAX package's mix from the same seed with
the same numpy generator, so its payloads are byte for byte the JAX
package's: signers 1/2/3/4 at 87/8/3/2 %, 30 % v0 with one lookup table,
60 % with compute-budget instructions, 8-700 bytes of instruction data
trimmed to the 1232-byte MTU, then exact duplicates, corrupted
signatures and truncated payloads, shuffled. Public keys come from one
``ops.sign.keygen_batch`` call over every signer seed and signatures
from ``sign_jobs``, both on the card unless the caller passes
``device="cpu"``.

``sign_jobs`` signs (message, seed) jobs in batches through
``ops.sign.sign_batch``. Shapes are bucketed as the JAX package buckets
them: each batch is padded to the full batch size (when the jobs fill
more than one), and its rows to the next multiple of 256 bytes. It runs
on the card unless the caller passes ``device="cpu"``, and raises
without one; there is no native signer and no fallback to the oracle.
"""

from __future__ import annotations

import hashlib
import struct
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from ..ballet.compute_budget import COMPUTE_BUDGET_PROGRAM_ID
from ..ballet.txn import MTU, build_txn
from ..ops import backend
from ..ops.sign import keygen_batch, sign_batch

LEN_BUCKET = 256

OK = 0          # expected to verify and reach the sink (unless a dup)
DUP = 1         # exact duplicate of an earlier payload: dedup drops it
BAD_SIG = 2     # corrupted signature bytes: verify drops it
BAD_PARSE = 3   # malformed wire bytes: parse drops it


@dataclass
class Corpus:
    payloads: list            # wire bytes, shuffled
    expected: np.ndarray      # per-payload class above (int8)
    n_unique_ok: int          # distinct valid txns (the sink's count)


def _signer_seed(i: int, j: int, seed: int) -> bytes:
    return struct.pack("<IIB", i, j, seed & 0xFF) + bytes(23)


def _splice_signatures(payload: bytes, sigs: list) -> bytes:
    """Replace the zero holes left by the deferred signer."""
    n = payload[0]
    assert n < 0x80 and n == len(sigs)  # 1-byte compact-u16 for sig counts
    out = bytearray(payload)
    for i, sig in enumerate(sigs):
        out[1 + 64 * i:1 + 64 * (i + 1)] = sig
    return bytes(out)


def public_keys(seeds: list, device=None) -> list:
    """Ed25519 public keys of 32-byte seeds, one keygen_batch call."""
    dev = backend.resolve_device(device)
    arr = np.frombuffer(b"".join(seeds), np.uint8).reshape(-1, 32)
    pub = keygen_batch(torch.from_numpy(arr.copy()).to(dev))[2]
    pub = pub.cpu().numpy()
    return [pub[i].tobytes() for i in range(len(seeds))]


def mainnet_corpus(
    n: int,
    seed: int = 0,
    dup_rate: float = 0.05,
    corrupt_rate: float = 0.03,
    parse_err_rate: float = 0.01,
    v0_rate: float = 0.3,
    budget_rate: float = 0.6,
    max_data_sz: int = 700,
    sign_batch_size: int = 4096,
    device=None,
) -> Corpus:
    """n unique valid txns plus duplicate, corrupt and truncated
    traffic, signed on device (the card unless "cpu")."""
    rng = np.random.RandomState(seed)
    signer_counts = rng.choice(
        [1, 2, 3, 4], size=n, p=[0.87, 0.08, 0.03, 0.02]
    )
    seeds = [[_signer_seed(i, j, seed) for j in range(int(signer_counts[i]))]
             for i in range(int(n))]
    flat = [s for row in seeds for s in row]
    pub_list = public_keys(flat, device) if flat else []
    jobs: list = []

    def sign_fn(msg: bytes, sd: bytes) -> bytes:
        jobs.append((msg, sd))
        return bytes(64)

    raw: list = []
    pos = 0
    for i in range(int(n)):
        n_sign = len(seeds[i])
        pubs = pub_list[pos:pos + n_sign]
        pos += n_sign
        extra = [COMPUTE_BUDGET_PROGRAM_ID,
                 rng.randint(0, 256, 32, dtype=np.uint8).tobytes(),
                 rng.randint(0, 256, 32, dtype=np.uint8).tobytes()]
        instrs = []
        if rng.rand() < budget_rate:
            instrs.append((n_sign, [], b"\x02" + struct.pack(
                "<I", int(rng.randint(50_000, 1_400_000)))))
            instrs.append((n_sign, [], b"\x03" + struct.pack(
                "<Q", int(rng.randint(0, 3_000_000)))))
        data_sz = int(rng.randint(8, max_data_sz))
        instrs.append((n_sign + 1, [0],
                       rng.randint(0, 256, data_sz, dtype=np.uint8).tobytes()))
        kw = {}
        if rng.rand() < v0_rate:
            kw = dict(version=0, addr_luts=[(
                rng.randint(0, 256, 32, dtype=np.uint8).tobytes(),
                [int(rng.randint(0, 64))], [int(rng.randint(0, 64))])])
        blockhash = rng.randint(0, 256, 32, dtype=np.uint8).tobytes()

        def build():
            return build_txn(signer_seeds=seeds[i], pubs=pubs,
                             sign_fn=sign_fn, extra_accounts=extra,
                             n_readonly_unsigned=len(extra), instrs=instrs,
                             recent_blockhash=blockhash, **kw)

        p = build()
        if len(p) > MTU:
            # A fat multisig with a long data draw can pass the MTU:
            # rebuild with the data trimmed to fit, dropping the
            # deferred jobs of the oversized attempt.
            del jobs[len(jobs) - n_sign:]
            instrs[-1] = (instrs[-1][0], instrs[-1][1],
                          instrs[-1][2][:max(8, MTU - (len(p) - data_sz))])
            p = build()
            assert len(p) <= MTU, len(p)
        raw.append(p)

    all_sigs = sign_jobs(jobs, batch=sign_batch_size, device=device)
    payloads: list = []
    pos = 0
    for i, p in enumerate(raw):
        k = len(seeds[i])
        payloads.append(_splice_signatures(p, all_sigs[pos:pos + k]))
        pos += k

    out = [(p, OK) for p in payloads]
    for _ in range(int(n * dup_rate)):
        out.append((payloads[int(rng.randint(0, n))], DUP))
    for _ in range(int(n * corrupt_rate)):
        t = bytearray(payloads[int(rng.randint(0, n))])
        t[1 + int(rng.randint(0, 64))] ^= 1 + int(rng.randint(0, 255))
        out.append((bytes(t), BAD_SIG))
    for _ in range(int(n * parse_err_rate)):
        src = payloads[int(rng.randint(0, n))]
        cut = int(rng.randint(1, max(2, len(src) - 1)))
        out.append((src[:cut], BAD_PARSE))

    order = rng.permutation(len(out))
    return Corpus([out[int(j)][0] for j in order],
                  np.asarray([out[int(j)][1] for j in order], np.int8),
                  n_unique_ok=n)


def expected_sink_digests(corpus: Corpus) -> Counter:
    """sha256 multiset of the payloads the sink must receive (the OK
    class): content equality, so a wrongly dropped valid txn cannot
    cancel against a wrongly passed corrupt one."""
    return Counter(hashlib.sha256(p).digest()
                   for p, e in zip(corpus.payloads, corpus.expected)
                   if e == OK)


def sign_jobs(jobs: list, batch: int = 4096, device=None) -> list:
    """Batch-sign (msg, seed) jobs of bytes; returns the 64-byte
    signatures in job order."""
    dev = backend.resolve_device(device)
    sigs: list = []
    for start in range(0, len(jobs), batch):
        chunk = jobs[start:start + batch]
        max_len = -(-max(len(m) for m, _ in chunk) // LEN_BUCKET) * LEN_BUCKET
        bsz = batch if len(jobs) > batch else len(chunk)
        msgs = np.zeros((bsz, max_len), np.uint8)
        lens = np.zeros(bsz, np.int32)
        seeds = np.zeros((bsz, 32), np.uint8)
        for i, (m, s) in enumerate(chunk):
            msgs[i, :len(m)] = np.frombuffer(m, np.uint8)
            lens[i] = len(m)
            seeds[i] = np.frombuffer(s, np.uint8)
        got, _ = sign_batch(*(torch.from_numpy(a).to(dev)
                              for a in (msgs, lens, seeds)))
        got = got.cpu().numpy()
        sigs.extend(got[i].tobytes() for i in range(len(chunk)))
    return sigs
