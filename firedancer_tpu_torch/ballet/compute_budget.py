"""The ComputeBudgetProgram's id, copied from
``firedancer_tpu/ballet/compute_budget.py`` (``COMPUTE_BUDGET_PROGRAM_ID``):
the base58 decode of "ComputeBudget111111111111111111111111111111".
The mainnet corpus names it in the instructions that set a
transaction's compute-unit limit and price."""

COMPUTE_BUDGET_PROGRAM_ID = bytes.fromhex(
    "0306466fe5211732ffecadba72c39be7bc8ce5bbc5f7126b2c439b3a40000000")
