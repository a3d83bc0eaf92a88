"""The account-lock graph coloring on the card: the counterpart of
``firedancer_tpu/ops/pack_gc.py:64`` ``pack_schedule``, an XLA
``lax.scan`` (not a ``pallas_call``), as ``csrc/pack_gc.cu``.

``pack_schedule_cuda`` sorts the scores on the device
(``torch.sort(-scores, stable=True)``: descending, ties in input order,
as ``jnp.argsort(-scores)``) and makes one call into the library: a
compaction launch (each sorted row's valid buckets into a record of
``record_words`` words) and the scan, one warp that carries per-bucket
color masks in shared memory (the kernel's header gives the design).
``chain_floor_ms`` times one warp's step skeleton with no work
(``pack_chain_floor``, on no transaction path), the least a step of a
one-warp scan costs.
"""

from __future__ import annotations

import ctypes

import torch

from . import backend, build

_V = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# Dynamic shared memory a block can opt into on Hopper (227 KB); the scan
# has no static shared memory.
SMEM_LIMIT = 232_448
SCAN_THREADS = 32
PRE_ROWS = 8            # rows of a compaction block, a warp each
MAX_COLORS = 1024       # 16 mask words a bucket set (pack_gc.cu PG_MAX_K)
_HEAD = 29              # bucket slots in a record's first 32 words


def record_words(a: int) -> int:
    """Words of a compacted row of a = AW + AR bucket columns
    (pack_gc.cu pg_record_words)."""
    return 32 + (max(a - _HEAD, 0) + 31) // 32 * 32


def geometry(n_colors: int, h_bits: int, n: int) -> tuple[int, int, int, int]:
    """(scan threads, compaction blocks, compaction threads, the scan's
    dynamic shared bytes) of a launch over n rows: 16 K H' bytes, K =
    ceil(C / 64) mask words, H' = 32 (h_bits // 32) buckets, at least
    one."""
    k = -(-n_colors // 64)
    return (SCAN_THREADS, -(-n // PRE_ROWS), 32 * PRE_ROWS,
            16 * k * max(32 * (h_bits // 32), 1))


def pack_schedule_cuda(w_idx: torch.Tensor, r_idx: torch.Tensor,
                       scores: torch.Tensor, cus: torch.Tensor, *,
                       n_colors: int, h_bits: int,
                       cu_cap: int) -> torch.Tensor:
    """The kernel: (N,) int32 colors (-1 unscheduled), in input order, of
    (N, AW) and (N, AR) int32 buckets (-1 padded), (N,) float32 scores
    and (N,) int32 compute units, all contiguous on one CUDA device."""
    smem = geometry(n_colors, h_bits, 1)[3]
    if not 1 <= n_colors <= MAX_COLORS or smem > SMEM_LIMIT:
        raise ValueError(
            f"pack_schedule: n_colors={n_colors}, h_bits={h_bits} need "
            f"{smem} B of shared memory (at most {MAX_COLORS} colors and "
            f"{SMEM_LIMIT} B)")
    if not 0 <= cu_cap < 2 ** 31:
        raise ValueError(f"pack_schedule: cu_cap {cu_cap} is not an int32")
    n = w_idx.shape[0] if w_idx.dim() == 2 else -1
    backend.check_tensor("w_idx", w_idx, torch.int32, (None, None))
    backend.check_tensor("r_idx", r_idx, torch.int32, (n, None))
    backend.check_tensor("scores", scores, torch.float32, (n,))
    backend.check_tensor("cus", cus, torch.int32, (n,))
    if n >= 2 ** 31:
        raise ValueError(f"pack_schedule: {n} rows do not fit an int32 index")
    aw, ar = w_idx.shape[1], r_idx.shape[1]
    colors = torch.empty(n, dtype=torch.int32, device=w_idx.device)
    if n == 0:
        return colors
    order = torch.sort(-scores, stable=True).indices
    rows = torch.empty(n * record_words(aw + ar), dtype=torch.int32,
                       device=w_idx.device)
    fn = build.bind("pack_gc", "fd_pack_schedule",
                    [_V, _V, _V, _V, _V, _V, _LL, _I, _I, _I, _I, _I, _V])
    stream = torch.cuda.current_stream(w_idx.device).cuda_stream
    build.check_rc("fd_pack_schedule", fn(
        w_idx.data_ptr(), r_idx.data_ptr(), order.data_ptr(),
        cus.data_ptr(), rows.data_ptr(), colors.data_ptr(), n, aw, ar,
        n_colors, h_bits, cu_cap, stream))
    backend.count_launch("pack_schedule")
    return colors


def chain_floor_ms(n: int, device, reps: int = 20) -> float:
    """Mean ms (CUDA events) of pack_chain_floor over n steps of one
    warp: a shared store, __syncwarp, a shared load and a REDUX a step."""
    out = torch.empty(1, dtype=torch.int32, device=device)
    fn = build.bind("pack_gc", "fd_pack_chain_floor", [_V, _LL, _V])
    stream = torch.cuda.current_stream(out.device).cuda_stream

    def launch():
        build.check_rc("fd_pack_chain_floor",
                       fn(out.data_ptr(), n, stream))

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
