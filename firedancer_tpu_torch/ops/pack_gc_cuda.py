"""The account-lock graph coloring on the card: the counterpart of
``firedancer_tpu/ops/pack_gc.py:64`` ``pack_schedule``, an XLA
``lax.scan`` (not a ``pallas_call``), as ``csrc/pack_gc.cu``.

``pack_schedule_cuda`` sorts the scores on the device
(``torch.sort(-scores, stable=True)``: descending, ties in input order,
as ``jnp.argsort(-scores)``) and launches one block that runs the whole
scan (the kernel's header gives its design). ``chain_floor_ms`` times
the same block's step skeleton with no work (``pack_chain_floor``, on no
transaction path), the least the scan's chain of steps costs.
"""

from __future__ import annotations

import ctypes

import torch

from . import backend, build

_V = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# Dynamic shared memory a block can opt into on Hopper (227 KB), less the
# kernel's static words.
SMEM_LIMIT = 232_448 - 16


def geometry(n_colors: int, h_bits: int, a: int) -> tuple[int, int]:
    """(threads, dynamic shared bytes) of the launch, as the kernel's
    pg_threads / pg_smem_bytes compute them."""
    g = 32
    while g > 1 and g * n_colors > 256:
        g >>= 1
    threads = max(g * n_colors, a + 1)
    threads = (threads + 31) // 32 * 32
    smem = 4 * (2 * n_colors * (h_bits // 32 + 1) + n_colors + 2 * a)
    return threads, smem


def pack_schedule_cuda(w_idx: torch.Tensor, r_idx: torch.Tensor,
                       scores: torch.Tensor, cus: torch.Tensor, *,
                       n_colors: int, h_bits: int,
                       cu_cap: int) -> torch.Tensor:
    """The kernel: (N,) int32 colors (-1 unscheduled), in input order, of
    (N, AW) and (N, AR) int32 buckets (-1 padded), (N,) float32 scores
    and (N,) int32 compute units, all contiguous on one CUDA device."""
    n = w_idx.shape[0] if w_idx.dim() == 2 else -1
    backend.check_tensor("w_idx", w_idx, torch.int32, (None, None))
    backend.check_tensor("r_idx", r_idx, torch.int32, (n, None))
    backend.check_tensor("scores", scores, torch.float32, (n,))
    backend.check_tensor("cus", cus, torch.int32, (n,))
    aw, ar = w_idx.shape[1], r_idx.shape[1]
    threads, smem = geometry(n_colors, h_bits, aw + ar)
    if not 1 <= n_colors or threads > 1024 or smem > SMEM_LIMIT:
        raise ValueError(
            f"pack_schedule: n_colors={n_colors}, h_bits={h_bits}, "
            f"AW + AR = {aw + ar} need {threads} threads and {smem} B of "
            f"shared memory (at most 1024 and {SMEM_LIMIT})")
    if not 0 <= cu_cap < 2 ** 31:
        raise ValueError(f"pack_schedule: cu_cap {cu_cap} is not an int32")
    colors = torch.empty(n, dtype=torch.int32, device=w_idx.device)
    if n == 0:
        return colors
    order = torch.sort(-scores, stable=True).indices
    fn = build.bind("pack_gc", "fd_pack_schedule",
                    [_V, _V, _V, _V, _V, _LL, _I, _I, _I, _I, _I, _V])
    stream = torch.cuda.current_stream(w_idx.device).cuda_stream
    build.check_rc("fd_pack_schedule", fn(
        w_idx.data_ptr(), r_idx.data_ptr(), order.data_ptr(),
        cus.data_ptr(), colors.data_ptr(), n, aw, ar, n_colors, h_bits,
        cu_cap, stream))
    backend.count_launch("pack_schedule")
    return colors


def chain_floor_ms(n: int, threads: int, device, reps: int = 20) -> float:
    """Mean ms (CUDA events) of pack_chain_floor over n steps on one
    block of threads: a shared-memory round and two barriers a step."""
    out = torch.empty(1, dtype=torch.int32, device=device)
    fn = build.bind("pack_gc", "fd_pack_chain_floor", [_V, _LL, _I, _V])
    stream = torch.cuda.current_stream(out.device).cuda_stream

    def launch():
        build.check_rc("fd_pack_chain_floor",
                       fn(out.data_ptr(), n, threads, stream))

    launch()
    torch.cuda.synchronize(out.device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    stop.record()
    torch.cuda.synchronize(out.device)
    return start.elapsed_time(stop) / reps
