"""ComputeBudgetProgram instructions: a transaction's rewards and compute
units, a copy of ``firedancer_tpu/ballet/compute_budget.py``
(``COMPUTE_BUDGET_PROGRAM_ID``, ``ComputeBudgetState``:50,
``estimate_rewards_and_compute``:117), the role of the reference's
fd_compute_budget_program.h.

Every ComputeBudgetProgram instruction of a parsed transaction folds into
a small per-transaction state machine, which gives (a) the priority fee
the sender offers and (b) the compute-unit ceiling. The pack tile orders
by rewards per compute unit with them (fd_pack.c:283-330).

  * tag 0 RequestUnitsDeprecated (u32 units, u32 fee): both a
    SetComputeUnitLimit and a SetComputeUnitPrice; sets the total fee.
  * tag 1 RequestHeapFrame (u32 bytes, a multiple of 1024).
  * tag 2 SetComputeUnitLimit (u32 units).
  * tag 3 SetComputeUnitPrice (u64 micro-lamports a CU).
  * each appears at most once (tag 0 counts as 2 and 3); a duplicate or
    malformed data makes the whole transaction malformed.
  * finalize: the CU limit defaults to 200k a non-budget instruction; the
    priority fee is ceil(cu_limit * price / 1e6) lamports, saturating at
    the u64 maximum.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

# The base58 decode of "ComputeBudget111111111111111111111111111111".
COMPUTE_BUDGET_PROGRAM_ID = bytes.fromhex(
    "0306466fe5211732ffecadba72c39be7bc8ce5bbc5f7126b2c439b3a40000000")

_FLAG_SET_CU = 0x01
_FLAG_SET_FEE = 0x02
_FLAG_SET_HEAP = 0x04
_FLAG_SET_TOTAL_FEE = 0x08

HEAP_FRAME_GRANULARITY = 1024
MICRO_LAMPORTS_PER_LAMPORT = 1_000_000
DEFAULT_INSTR_CU_LIMIT = 200_000
_U64_MAX = (1 << 64) - 1


@dataclass
class ComputeBudgetState:
    flags: int = 0
    instr_cnt: int = 0              # compute-budget instrs seen
    compute_units: int = 0          # valid iff SET_CU
    total_fee: int = 0              # valid iff SET_TOTAL_FEE
    heap_size: int = 0              # valid iff SET_HEAP
    micro_lamports_per_cu: int = 0  # valid iff SET_FEE and not SET_TOTAL_FEE

    def parse_instr(self, data: bytes) -> bool:
        """Fold one ComputeBudgetProgram instruction. False = txn malformed."""
        if len(data) < 5:
            return False
        tag = data[0]
        if tag == 0:  # RequestUnitsDeprecated
            if len(data) != 9:
                return False
            if self.flags & (_FLAG_SET_CU | _FLAG_SET_FEE):
                return False
            self.compute_units, self.total_fee = struct.unpack_from("<II", data, 1)
            self.flags |= _FLAG_SET_CU | _FLAG_SET_FEE | _FLAG_SET_TOTAL_FEE
        elif tag == 1:  # RequestHeapFrame
            if len(data) != 5:
                return False
            if self.flags & _FLAG_SET_HEAP:
                return False
            (self.heap_size,) = struct.unpack_from("<I", data, 1)
            if self.heap_size % HEAP_FRAME_GRANULARITY:
                return False
            self.flags |= _FLAG_SET_HEAP
        elif tag == 2:  # SetComputeUnitLimit
            if len(data) != 5:
                return False
            if self.flags & _FLAG_SET_CU:
                return False
            (self.compute_units,) = struct.unpack_from("<I", data, 1)
            self.flags |= _FLAG_SET_CU
        elif tag == 3:  # SetComputeUnitPrice
            if len(data) != 9:
                return False
            if self.flags & _FLAG_SET_FEE:
                return False
            (self.micro_lamports_per_cu,) = struct.unpack_from("<Q", data, 1)
            self.flags |= _FLAG_SET_FEE
        else:
            return False
        self.instr_cnt += 1
        return True

    def finalize(self, total_instr_cnt: int) -> tuple[int, int]:
        """(priority_rewards_lamports, cu_limit) after all instrs folded."""
        if self.flags & _FLAG_SET_CU:
            cu_limit = self.compute_units
        else:
            cu_limit = (
                total_instr_cnt - self.instr_cnt
            ) * DEFAULT_INSTR_CU_LIMIT
        if self.flags & _FLAG_SET_TOTAL_FEE:
            return self.total_fee, cu_limit
        # ceil(cu_limit * price / 1e6), saturating at u64 max.
        fee = (
            cu_limit * self.micro_lamports_per_cu
            + MICRO_LAMPORTS_PER_LAMPORT
            - 1
        ) // MICRO_LAMPORTS_PER_LAMPORT
        return min(fee, _U64_MAX), cu_limit


def estimate_rewards_and_compute(
    txn,
    payload: bytes,
    lamports_per_signature: int = 5000,
    estimator=None,
) -> tuple[int, int, int] | None:
    """Per-txn (rewards, est_cus, cu_limit) for pack ordering.

    txn is a ballet.txn.TxnDescriptor over payload. Mirrors
    fd_pack_estimate_rewards_and_compute (fd_pack.c:283-330): base fee per
    signature + the compute-budget priority fee; expected CUs from the
    per-program estimator (or the CU limit if no estimator). Returns None
    if any ComputeBudgetProgram instruction is malformed (txn must be
    dropped).
    """
    sig_rewards = lamports_per_signature * txn.signature_cnt
    st = ComputeBudgetState()
    expected = 0
    for ins in txn.instrs:
        prog = txn.account(payload, ins.program_id_index)
        data = payload[ins.data_off : ins.data_off + ins.data_sz]
        if prog == COMPUTE_BUDGET_PROGRAM_ID:
            if not st.parse_instr(data):
                return None
        elif estimator is not None:
            expected += estimator.estimate([prog])
    adtl, cu_limit = st.finalize(len(txn.instrs))
    rewards = min(sig_rewards + adtl, _U64_MAX)
    est_cus = max(expected, 1) if estimator is not None else max(cu_limit, 1)
    return rewards, est_cus, cu_limit
