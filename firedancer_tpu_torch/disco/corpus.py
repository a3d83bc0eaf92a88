"""Corpus signing on the card: the counterpart of the device branch of
``firedancer_tpu/disco/corpus.py:226-264`` ``_sign_jobs``.

``sign_jobs`` signs (message, seed) jobs in batches through
``ops.sign.sign_batch``. Shapes are bucketed as the JAX package buckets
them: each batch is padded to the full batch size (when the jobs fill
more than one), and its rows to the next multiple of 256 bytes. It runs
on the card unless the caller passes ``device="cpu"``, and raises
without one; there is no native signer and no fallback to the oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import backend
from ..ops.sign import sign_batch

LEN_BUCKET = 256


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
