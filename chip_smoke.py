#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (firedancer_tpu_torch) on one Hopper
card: the quickest proof that the port builds, verifies and signs on the
GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):

1. Card: print the card's name and power limit (nvidia-smi) and its
   compute capability; require CUDA with capability 9.x.
2. Build: compile every kernel from firedancer_tpu_torch/ops/csrc with
   nvcc into build/torch_kernels/, print the seconds and ptxas's
   registers and spills.
3. Kernel parity: each of the fifteen kernels against its plain PyTorch
   version on the same CUDA tensors, at the main paths' shapes; they must
   agree exactly (canonical bytes, limbs and masks). The RLC front half's
   three: frontend_rlc and sha512_batch on 8192 hash rows (and on rows
   of every length 0-1296; sha512_batch also on signing's 1344-byte rows
   of the 1280-byte bucket), decompress_niels on 2 x 8192 encodings with
   y = +-1, non-square, non-canonical and small-order lanes planted (and
   on a batch that is not a multiple of its 32-lane group). The four MSM
   kernels take their inputs staged from a clean 8192-lane batch through
   the RLC front half: the three bucket fills (z, 253-bit, torsion) on
   the decompress kernel's niels forms, the three aggregations, both
   Horners and the K = 64 [L] ladder; then the signed plan s8l3's 253-bit
   fill (the sign folded into the gather) and its pass's verdict. The
   signing path's four: sc_reduce64 on 8192 64-byte values with the edges
   0, L - 1, L, 2^255 - 1 and 2^512 - 1 planted; sc_muladd with c != 0
   (signing's h a + r, a clamped) and c = 0 (the staged pass's stacked
   z || z times h || s); fe_pow, both chains, on 8192 lanes; compress on
   K3's outputs with the edge points planted (the identity, the torsion
   points and y within 19 of p, at Z = 1 and Z != 1); and K3 itself with
   h = 0 and clamped scalars, as signing calls it. Times with CUDA
   events, warm, the kernel's mean over 20 launches beside the plain
   version's, summed over the launches of one pass (one signing call for
   the signing kernels).
4. Direct path: registry().acquire(EngineSpec("direct", 8192)) answers
   three 8192-lane batches (bench traffic; the same with salted,
   s >= L, undecodable-key lanes and the 396 Zcash vectors; MTU-sized
   messages). Statuses must equal the constructed ones and the plain
   path's on the card; every kernel's launch count must advance and every
   plain count stay 0. Then verifies/s over 10 timed batches, and the
   device time by kernel over 3 batches (torch.profiler).
5. RLC path, in both front halves: registry().acquire(EngineSpec("rlc",
   8192, frontend=f)) for f = "fused" and "staged" answers (a) the bench
   batch (batch_ok True, no fallback, every status 0; decompress_niels
   launches once, frontend_rlc (fused) or sha512_batch (staged) once,
   the MSM kernels 3, 3, 2, 1 times, and no direct-path kernel), (b) the
   mixed batch and (t) a torsion batch (an order-2 pair and four
   order-8-offset lanes): both fall back, with the direct path's
   statuses. Then verifies/s on (a), the cost of (b), the device time by
   kernel (torch.profiler) and the host clock of the pass's stages. The
   staged pass launches sha512_batch, sc_reduce64 and sc_muladd once
   each and no plain version.
6. Signing path: disco.corpus.sign_jobs at two shapes, B = 8192 with
   192-byte messages and B = 4096 with 100-1232-byte messages (rows of
   the 1280-byte bucket). Each signing call must launch sha512_batch 3,
   sc_reduce64 2, double_scalarmult 2, compress 2 and sc_muladd 1 times
   and no plain version; its bytes must equal the plain composition's on
   the same CUDA tensors and the oracle's on 64 lanes; the signed batch
   must verify through EngineSpec("direct") (every status 0) and
   EngineSpec("rlc") (batch_ok True, no fallback). Then signatures/s by
   CUDA events and by the host clock, and the device time by kernel.
7. Output: the card line, one JSON line of per-kernel numbers, and the
   last line {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
B = 8192                 # FD_BENCH_BATCH
MSG_LEN = 192            # FD_BENCH_MSG_LEN
MTU_MSG = 1232
REPS = 20
TIMED_BATCHES = 10
DIRECT_KERNELS = ("sha512_mod_l", "decompress_so", "double_scalarmult",
                  "point_eq")
# The front half's launches in one clean RLC pass, by front half.
FRONT_LAUNCHES = {"fused": {"frontend_rlc": 1},
                  "staged": {"sha512_batch": 1, "sc_reduce64": 1,
                             "sc_muladd": 1}}
# Launches of one signing call (ops/sign.py sign_batch).
SIGN_LAUNCHES = {"sha512_batch": 3, "sc_reduce64": 2, "double_scalarmult": 2,
                 "compress": 2, "sc_muladd": 1}
SIGN_SHAPES = ((8192, "192-byte messages"), (4096, "100-1232-byte messages"))
# Launches of one clean RLC pass, by front half.
RLC_PASS = {"decompress_niels": 1, "msm_fill": 3, "msm_aggregate": 3,
            "msm_horner": 2, "msm_order": 1}

# Peak rates of an H100 SXM at its 700 W limit (NVIDIA's data sheet):
# 3.35 TB/s of HBM; 67 TFLOP/s fp32 = 33.5 T FMA/s, and the
# 32-bit integer multiply-add (IMAD) and integer ALU pipes issue at half
# the fp32 FMA rate (64 vs 128 per SM per clock on compute capability
# 9.0, CUDA C++ Programming Guide throughput table).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 33.5e12 / 2
# A 64x64->128-bit product costs at least four 32x32->64 IMAD.WIDE.
IMAD_PER_MUL, IMAD_PER_SQ = 25 * 4, 15 * 4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- bounds
# Least time of each kernel's work on this card, from the operations its
# inputs need (counted from the kernel source) and the bytes it must move.

def _bound(int_ops: float, nbytes: float):
    t_ops = int_ops / INT_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _sha512_ops(lens: np.ndarray, row_bytes: int) -> int:
    """Per block: 80 rounds x 34 int32 ops (three 64-bit rotates = 6
    funnel shifts per Sigma, 3-input logic ops, 64-bit adds as 2 ops)
    + 64 schedule words x 22 ops + 16 for the state."""
    nblocks = (np.clip(lens, 0, row_bytes).astype(np.int64) + 17 + 127) // 128
    return int(nblocks.sum()) * (80 * 34 + 64 * 22 + 16)


# A Barrett reduction mod L of a 512-bit value: 5 x 5 + 14 64-bit
# products (sha512.cuh sc_reduce512); a 256 x 256-bit product: 16.
BARRETT_PRODUCTS, MUL256_PRODUCTS = 39, 16


def bound_sha512_mod_l(lens: np.ndarray, row_bytes: int):
    """The rounds (_sha512_ops), then one Barrett reduction per lane."""
    return _bound(_sha512_ops(lens, row_bytes)
                  + len(lens) * BARRETT_PRODUCTS * 4,
                  len(lens) * (row_bytes + 4 + 32))


def bound_sha512_batch(lens: np.ndarray, row_bytes: int):
    """The rounds alone; reads the rows, writes 64-byte digests."""
    return _bound(_sha512_ops(lens, row_bytes),
                  len(lens) * (row_bytes + 4 + 64))


def bound_frontend_rlc(lens: np.ndarray, row_bytes: int):
    """The rounds, then per lane three Barrett reductions (h, z h, z s)
    and two 256-bit products; reads rows, z and s, writes h, m, zs."""
    per_lane = 3 * BARRETT_PRODUCTS + 2 * MUL256_PRODUCTS
    return _bound(_sha512_ops(lens, row_bytes) + len(lens) * per_lane * 4,
                  len(lens) * (row_bytes + 4 + 2 * 32 + 3 * 32))


def bound_decompress_so(n: int):
    """Per lane 267 squarings + 28 multiplies: the pow22523 chain (251 S
    + 11 M), the curve equation and root checks, and the three
    small-order doublings (12 S + 9 M)."""
    return _bound(n * (267 * IMAD_PER_SQ + 28 * IMAD_PER_MUL),
                  n * (32 + 4 * 40 + 2))


def bound_decompress_niels(n: int, group: int):
    """Per lane 267 squarings and 19 multiplies: the curve equation, the
    252-squaring ladder, the root checks, T, 2d T and the three
    small-order doublings (12 S + 9 M), with Montgomery's trick at its
    least, 3 multiplies a lane; per group of `group` lanes one inversion
    (254 S + 11 M). Reads 32 B a lane; writes the point, both niels forms
    and two masks."""
    groups = -(-n // group)
    ops = (n * (267 * IMAD_PER_SQ + 19 * IMAD_PER_MUL)
           + groups * (254 * IMAD_PER_SQ + 11 * IMAD_PER_MUL))
    return _bound(ops, n * (32 + 4 * 40 + 2 * 3 * 40 + 2))


def bound_double_scalarmult(n: int):
    """Per lane: the A table (1 + 14 x 9 multiplies), then 64 windows of
    4 doublings (16 S + 13 M) and two adds (8 + 6 M): 1024 S + 1855 M."""
    return _bound(n * (1024 * IMAD_PER_SQ + 1855 * IMAD_PER_MUL),
                  n * (64 + 4 * 40 + 3 * 40))


def bound_scalarmult_base(n: int):
    """K3 with h = 0, as signing calls it: the A table and the A adds
    are not needed, so 64 windows of 4 doublings (16 S + 13 M) and the
    B add (6 M): 1024 S + 1216 M a lane."""
    return _bound(n * (1024 * IMAD_PER_SQ + 1216 * IMAD_PER_MUL),
                  n * (64 + 4 * 40 + 3 * 40))


def bound_point_eq(n: int):
    """Per lane two multiplies; reads five field elements, writes 1 B."""
    return _bound(n * 2 * IMAD_PER_MUL, n * (5 * 40 + 1))


def bound_sc_reduce64(n: int):
    """A Barrett reduction a lane; reads 64 B, writes 32 B."""
    return _bound(n * BARRETT_PRODUCTS * 4, n * (64 + 32))


def bound_sc_muladd(n: int, addend: bool):
    """A 256-bit product and a Barrett reduction a lane; reads a, b (and
    c), writes 32 B."""
    return _bound(n * (MUL256_PRODUCTS + BARRETT_PRODUCTS) * 4,
                  n * (64 + 32 * addend + 32))


def bound_fe_pow(n: int, invert: bool):
    """The chain a lane: 254 squarings and 11 multiplies (z^(p - 2)) or
    251 and 11 (z^((p - 5)/8)); reads and writes 40 B."""
    return _bound(n * ((254 if invert else 251) * IMAD_PER_SQ
                       + 11 * IMAD_PER_MUL), n * 80)


def bound_compress(n: int):
    """The inversion chain (254 S + 11 M) and two multiplies a lane; reads
    X, Y, Z (120 B), writes 32 B."""
    return _bound(n * (254 * IMAD_PER_SQ + 13 * IMAD_PER_MUL), n * (120 + 32))


# The MSM kernels: a mixed add (madd) is 7 multiplies, a unified add 9, a
# doubling 4 squarings + 4 multiplies; a point crosses as 160 B of limbs.
IMAD_PER_DBL = 4 * IMAD_PER_SQ + 4 * IMAD_PER_MUL
PT_BYTES = 4 * 5 * 8


def _sum_bounds(bounds):
    """Bounds of one kernel's launches in a pass, summed (sequential
    launches); bound_by is the kind that bounds most of the total."""
    by_ops = sum(t for t, by in bounds if by == "operations")
    return sum(t for t, _ in bounds), (
        "operations" if 2 * by_ops >= sum(t for t, _ in bounds) else "bytes")


def bound_fill(lanes: int, rounds: int, filled: int, n_points: int):
    """A madd (7 multiplies) for each filled slot: the bucket sums need
    no more. The kernel's identity adds on empty slots exist only
    because it runs a static number of rounds, so they are not counted.
    Reads the niels forms (120 B a point) once and the slot table,
    writes the buckets."""
    return _bound(filled * 7 * IMAD_PER_MUL,
                  n_points * 3 * 40 + rounds * lanes * 4 + lanes * PT_BYTES)


def bound_aggregate(ncols: int, nb: int):
    """2 (nb - 2) unified adds per column."""
    return _bound(ncols * 2 * (nb - 2) * 9 * IMAD_PER_MUL,
                  ncols * (nb + 1) * PT_BYTES)


def bound_horner(nw: int, w_bits: int):
    """(nw - 1) x (w doublings + 1 unified add)."""
    return _bound((nw - 1) * (w_bits * IMAD_PER_DBL + 9 * IMAD_PER_MUL),
                  (nw + 1) * PT_BYTES)


def bound_order(k: int, order: int):
    """Per point a doubling for each bit of L below the leading one and a
    unified add for each set bit among them."""
    n_dbl = order.bit_length() - 1
    n_add = bin(order).count("1") - 1
    return _bound(k * (n_dbl * IMAD_PER_DBL + n_add * 9 * IMAD_PER_MUL),
                  2 * k * PT_BYTES)


# ------------------------------------------------------------- timing

def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_batches(torch, fn, batch_ms: float, n: int = 3) -> None:
    """Device time by kernel over n batches (torch.profiler), and the
    device's busy and idle share of batch_ms, the batch time measured
    without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            kernels.append((dev_us / n, ev.key, ev.count // n))
    if not kernels:
        say("profile: the trace shows no device time (not measured)")
        return
    busy = sum(k[0] for k in kernels)
    share = busy / (batch_ms * 1e3)
    say(f"profile over {n} batches: {sum(k[2] for k in kernels)} device "
        f"operations per batch, device busy {busy:.1f} us/batch = "
        f"{100 * share:.1f}% of the {batch_ms:.3f} ms batch, idle "
        f"{100 - 100 * share:.1f}%")
    for dev_us, key, count in sorted(kernels, reverse=True):
        say(f"  {dev_us:9.1f} us/batch {100 * dev_us / busy:5.1f}% "
            f"x{count} {key[:60]}")


def max_abs_err(torch, a, b) -> float:
    if isinstance(a, tuple):
        return max(max_abs_err(torch, x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        a, b = torch.from_numpy(a), torch.from_numpy(b)
    if a.shape != b.shape:
        return float("inf")
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def kernel_pass(torch, parity, record, name, runs, replaces, source):
    """runs: (label, kernel fn, plain fn, bound) per launch of a pass;
    each launch held against its plain version and timed; one JSON row
    with the pass's summed times and bounds. Returns the kernel outputs
    by label."""
    err = ms = plain_ms = 0.0
    outs = {}
    for label, kern, plain, bound in runs:
        out = kern()
        err = max(err, parity(f"{name} {label}", out, plain()))
        k_ms, p_ms = time_ms(torch, kern, REPS), time_ms(torch, plain, 1)
        say(f"  {name} {label}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.1f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
        ms, plain_ms = ms + k_ms, plain_ms + p_ms
        outs[label] = out
    record(name, err, ms, plain_ms, _sum_bounds([r[3] for r in runs]),
           replaces, source)
    return outs


def _le(values, width: int) -> np.ndarray:
    return np.array([list(v.to_bytes(width, "little")) for v in values],
                    np.uint8).reshape(len(values), width)


def _limbs51(torch, values, dev):
    """Python ints -> (n, 5) int64 radix-2^51 limbs on dev."""
    return torch.tensor([[(v >> (51 * i)) & ((1 << 51) - 1)
                          for i in range(5)] for v in values],
                        dtype=torch.int64, device=dev).reshape(-1, 5)


def _edge_points(torch, rng, dev):
    """(n, 3, 5) limbs of compress's edge points: the identity (0:1:1)
    and (0:lambda:lambda), the torsion points and the points with y
    within 19 of p, each at Z = 1 and at a random Z."""
    from firedancer_tpu_torch.ballet.ed25519 import corpus, oracle

    p = oracle.P
    aff = [(0, 1)] + list(dict.fromkeys(
        oracle.point_decompress(e) for e in corpus.torsion_encodings()))
    for k in range(1, 20):
        x = oracle._recover_x(p - k, 0)
        if x:
            aff += [(x, p - k), (p - x, p - k)]
    pts = []
    for x, y in aff:
        lam = int.from_bytes(rng.bytes(32), "little") % (p - 1) + 1
        pts += [(x, y, 1), (x * lam % p, y * lam % p, lam)]
    return torch.stack([_limbs51(torch, [q[c] for q in pts], dev)
                        for c in range(3)], dim=1)


def sign_kernel_parity(torch, gpu, parity, record, rng) -> None:
    """Phase 3, the signing path's kernels at a signing call's shapes
    (B = 8192): sc_reduce64 (two launches), sc_muladd (one, c = r), fe_pow
    (both chains, off the paths), compress (two, on K3's outputs); K3 with
    h = 0 and clamped scalars; sha512_batch on 1344-byte rows; and
    sc_muladd at the staged pass's shape (2B lanes, c = 0)."""
    from firedancer_tpu_torch import convert
    from firedancer_tpu_torch.ballet.ed25519 import oracle
    from firedancer_tpu_torch.ops import (curve_cuda, dsm_cuda, frontend_cuda,
                                          pow_cuda, sc_cuda, sign)

    L, P = oracle.L, oracle.P

    def timed(label, kern, plain, bound=None):
        """A launch outside a pass row: parity and time, printed."""
        parity(label, kern(), plain())
        extra = f", bound {bound[0]:.4f} ms ({bound[1]})" if bound else ""
        say(f"  {label}: kernel {time_ms(torch, kern, REPS):.4f} ms, plain "
            f"{time_ms(torch, plain, 1):.1f} ms{extra}")

    # sc_reduce64: the digests of r and h; edges planted in r's.
    edges = [0, 1, L - 1, L, L + 1, 2 * L, 2**255 - 1, 2**256 - 1, 2**511,
             2**512 - 1]
    x_np = rng.randint(0, 256, (2, B, 64), dtype=np.uint8)
    x_np[0, :len(edges)] = _le(edges, 64)
    xs = [gpu(x_np[0]), gpu(x_np[1])]
    dev = xs[0].device
    red = kernel_pass(torch, parity, record, "sc_reduce64", [
        (f"{name} {B} x 64 B", lambda v=v: sc_cuda.sc_reduce64_cuda(v),
         lambda v=v: sc_cuda.sc_reduce64_ref(v), bound_sc_reduce64(B))
        for name, v in (("r", xs[0]), ("h", xs[1]))],
        "firedancer_tpu/ops/sc_pallas.py:141",
        "firedancer_tpu_torch/ops/csrc/sc_reduce.cu")
    got = red[f"r {B} x 64 B"][:len(edges)].cpu().numpy()
    if [int.from_bytes(r.tobytes(), "little") for r in got] != \
            [v % L for v in edges]:
        fail("sc_reduce64: an edge lane is not x mod L")

    # sc_muladd: s = h a + r with a clamped, h and r < L (edges planted:
    # a, b, c of 0, L - 1, L, 2^255 - 1, 2^256 - 1); c = 0 at the staged
    # pass's 2B stacked lanes.
    a_np = rng.randint(0, 256, (B, 32), dtype=np.uint8)
    a_np[:, 0] &= 248
    a_np[:, 31] = (a_np[:, 31] & 63) | 64
    h_t, r_t = (sc_cuda.sc_reduce64_ref(v) for v in xs)
    a_t = gpu(a_np)
    mx = [0, L - 1, L, 2**255 - 1, 2**256 - 1]
    for t, pick in ((h_t, lambda i: mx[i // 5]), (a_t, lambda i: mx[i % 5]),
                    (r_t, lambda i: mx[3 * i % 5])):
        t[:25] = gpu(_le([pick(i) for i in range(25)], 32))
    ma_out = kernel_pass(torch, parity, record, "sc_muladd", [(
        f"s = h a + r, {B} lanes",
        lambda: sc_cuda.sc_muladd_cuda(h_t, a_t, r_t),
        lambda: sc_cuda.sc_muladd_ref(h_t, a_t, r_t),
        bound_sc_muladd(B, True))],
        "firedancer_tpu/ops/sc_pallas.py:111",
        "firedancer_tpu_torch/ops/csrc/sc_reduce.cu")
    ints = [[int.from_bytes(r.tobytes(), "little") for r in
             t[:25].cpu().numpy()] for t in (h_t, a_t, r_t,
                                             *ma_out.values())]
    if ints[3] != [(h * a + r) % L for h, a, r in zip(*ints[:3])]:
        fail("sc_muladd: an edge lane is not (h a + r) mod L")
    z_np = rng.randint(0, 256, (B, 32), dtype=np.uint8)
    z_np[:, 16:] = 0
    zz, hs = gpu(np.concatenate([z_np, z_np])), torch.cat([h_t, xs[1][:, :32]])
    timed(f"sc_muladd c = 0, staged z||z h||s, {2 * B} lanes",
          lambda: sc_cuda.sc_muladd_cuda(zz, hs),
          lambda: sc_cuda.sc_muladd_ref(zz, hs), bound_sc_muladd(2 * B, False))

    # fe_pow: both chains on 8192 lanes of values < 2^255 (edges planted).
    pe = [0, 1, 2, P - 1, P, P + 1, 2**255 - 1]
    zv = [int.from_bytes(rng.bytes(32), "little") >> 1 for _ in range(B)]
    zv[:len(pe)] = pe
    zl = _limbs51(torch, zv, dev)
    kernel_pass(torch, parity, record, "fe_pow", [
        (f"{name} {B} lanes", lambda f=f: f[0](zl), lambda f=f: f[1](zl),
         bound_fe_pow(B, name == "invert"))
        for name, f in (("invert", (pow_cuda.fe_invert_cuda,
                                    pow_cuda.fe_invert_ref)),
                        ("pow22523", (pow_cuda.fe_pow22523_cuda,
                                      pow_cuda.fe_pow22523_ref)))],
        "firedancer_tpu/ops/pow_pallas.py:148",
        "firedancer_tpu_torch/ops/csrc/fe_pow.cu")

    # K3 as signing calls it (h = 0, the base point, clamped a and r < L),
    # then compress on its outputs with the edge points planted.
    zero = torch.zeros_like(a_t)
    base = sign._b_rows(dev, B)
    k3 = {}
    for name, sc_t in (("pub = a B", a_t), ("R = r B", r_t)):
        timed(f"double_scalarmult h = 0, {name}, {B} lanes",
              lambda v=sc_t: dsm_cuda.double_scalarmult_cuda(zero, base, v),
              lambda v=sc_t: dsm_cuda.double_scalarmult_ref(zero, base, v),
              bound_scalarmult_base(B))
        k3[name] = dsm_cuda.double_scalarmult_cuda(zero, base, sc_t)
    edge_pts = _edge_points(torch, rng, dev)
    k3["pub = a B"][:edge_pts.shape[0]] = edge_pts
    enc = kernel_pass(torch, parity, record, "compress", [
        (f"{name} {B} lanes", lambda p=p: curve_cuda.compress_cuda(p),
         lambda p=p: curve_cuda.compress_ref(p), bound_compress(B))
        for name, p in k3.items()],
        "firedancer_tpu/ops/curve_pallas.py:340",
        "firedancer_tpu_torch/ops/csrc/compress.cu")
    parity("compress vs the affine encoding (512 lanes)",
           enc[f"pub = a B {B} lanes"][:512].cpu().numpy(),
           convert.point_to_affine_bytes(k3["pub = a B"][:512]))
    r_enc = enc[f"R = r B {B} lanes"].cpu().numpy()
    for i in range(16):
        r_int = int.from_bytes(r_t[i].cpu().numpy().tobytes(), "little")
        if r_enc[i].tobytes() != oracle.point_compress(
                oracle.scalarmult(r_int, oracle.B)):
            fail(f"compress(K3 r B): lane {i} differs from the oracle")

    # sha512_batch on signing's longest rows: R || pub || msg in the
    # 1280-byte bucket, 1344 bytes, every block count 1-11.
    row = 64 + 1280
    sl = rng.randint(0, row + 1, B).astype(np.int32)
    sl[:8] = [0, 111, 112, 239, 240, 1231, row - 1, row]
    s_rows, s_lens = gpu(rng.randint(0, 256, (B, row), dtype=np.uint8)), gpu(sl)
    timed(f"sha512_batch, rows of {row} bytes",
          lambda: frontend_cuda.sha512_batch_cuda(s_rows, s_lens),
          lambda: frontend_cuda.sha512_batch_ref(s_rows, s_lens),
          bound_sha512_batch(sl, row))
    say("signing kernels: sc_reduce64, sc_muladd, fe_pow, compress and K3 "
        "with h = 0 equal their plain versions; the edge lanes equal "
        "Python's integers and the oracle")


def signing_path(torch, gpu, rows, card) -> None:
    """Phase 6: sign_jobs at the two shapes, each call's launch counts
    (reset just before, read just after), its bytes against the plain
    composition and the oracle, the signed batch through the direct and
    rlc engines, signatures/s and the device time by kernel."""
    from firedancer_tpu_torch.ballet.ed25519 import oracle
    from firedancer_tpu_torch.disco import corpus as dcorpus
    from firedancer_tpu_torch.disco.engine import EngineSpec, registry
    from firedancer_tpu_torch.ops import backend, sign

    rng = np.random.RandomState(9)
    for bsz, desc in SIGN_SHAPES:
        if bsz == B:
            lens = np.full(bsz, MSG_LEN, np.int32)
        else:
            lens = rng.randint(100, MTU_MSG + 1, bsz).astype(np.int32)
            lens[:2] = [100, MTU_MSG]
        row = -(-int(lens.max()) // dcorpus.LEN_BUCKET) * dcorpus.LEN_BUCKET
        msgs = rng.randint(0, 256, (bsz, row), dtype=np.uint8)
        msgs[np.arange(row)[None, :] >= lens[:, None]] = 0
        seeds = rng.randint(0, 256, (bsz, 32), dtype=np.uint8)
        jobs = [(msgs[i, :lens[i]].tobytes(), seeds[i].tobytes())
                for i in range(bsz)]
        torch.cuda.synchronize()
        backend.reset_counts()
        t0 = time.perf_counter()
        sigs = dcorpus.sign_jobs(jobs, batch=bsz)
        jobs_s = time.perf_counter() - t0
        launches, plain = dict(backend.launches), dict(backend.plain_calls)
        say(f"sign_jobs B={bsz} ({desc}, rows of {row} bytes): launches "
            f"{launches}, plain calls {plain}, {jobs_s:.3f} s with the "
            f"host's packing")
        if launches != SIGN_LAUNCHES or plain:
            fail(f"signing B={bsz}: launches {launches}, plain {plain}; "
                 f"want {SIGN_LAUNCHES} and no plain call")
        if bsz == B:
            for name in ("sc_reduce64", "sc_muladd", "compress"):
                rows[name]["launches"] = launches[name]

        args = (gpu(msgs), gpu(lens), gpu(seeds))
        k_sigs, k_pubs = sign.sign_batch(*args)
        p_sigs, p_pubs = sign.sign_batch_ref(*args)
        if not (torch.equal(k_sigs, p_sigs) and torch.equal(k_pubs, p_pubs)):
            fail(f"signing B={bsz}: the kernels' bytes differ from the plain "
                 f"composition on {int((k_sigs != p_sigs).any(1).sum())} "
                 f"lanes")
        got = k_sigs.cpu().numpy()
        if [got[i].tobytes() for i in range(bsz)] != sigs:
            fail(f"signing B={bsz}: sign_jobs differs from sign_batch")
        for i in np.linspace(0, bsz - 1, 64).astype(int):
            if sigs[i] != oracle.sign(*jobs[i]):
                fail(f"signing B={bsz}: lane {i} differs from the oracle")
        say(f"signing B={bsz}: {bsz} signatures equal the plain "
            f"composition's, 64 lanes equal the oracle's")

        vargs = (args[0], args[1], k_sigs, k_pubs)
        entry, _ = registry().acquire(EngineSpec("direct", bsz))
        st = entry.fn(*vargs).cpu().numpy()
        rlc, _ = registry().acquire(EngineSpec("rlc", bsz))
        res = rlc.fn(*vargs)
        st_rlc = np.asarray(res)
        if st.any() or st_rlc.any() or res.used_fallback:
            fail(f"signing B={bsz}: direct statuses "
                 f"{dict(zip(*np.unique(st, return_counts=True)))}, rlc "
                 f"fallback {res.used_fallback}")
        say(f"signing B={bsz}: the signed batch verifies, direct every "
            f"status 0, rlc batch_ok True without fallback")

        ms = time_ms(torch, lambda: sign.sign_batch(*args), TIMED_BATCHES)
        t0 = time.perf_counter()
        for _ in range(TIMED_BATCHES):
            sign.sign_batch(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / TIMED_BATCHES
        say(f"sign B={bsz} ({desc}): {ms:.3f} ms/call (CUDA events), "
            f"{bsz / (ms / 1e3):.0f} signatures/s; host clock "
            f"{wall * 1e3:.3f} ms/call, {bsz / wall:.0f} signatures/s "
            f"[{card}]")
        profile_batches(torch, lambda: sign.sign_batch(*args), wall * 1e3)


def rlc_path(torch, gpu, rows, card, batches, expects, direct_b, zcash_pass,
             direct_entry) -> None:
    """Phase 5: the RLC engine in both front halves on the bench, mixed
    and torsion batches."""
    inputs = [tuple(gpu(a) for a in arrs) for arrs in batches]
    torch.cuda.synchronize()
    want_b = expects[1].copy()
    for b in zcash_pass:
        want_b[b] = direct_b[b]
    direct_t = np.asarray(direct_entry.fn(*inputs[2]).cpu())
    for frontend in FRONT_LAUNCHES:
        rlc_front_half(torch, rows, card, inputs, frontend,
                       (expects[0], want_b, direct_b, direct_t))


def rlc_front_half(torch, rows, card, inputs, frontend, wants) -> None:
    """One front half's engine: its launch counts on the three batches
    (reset just before, read just after), statuses, verifies/s, device
    time by kernel and the host clock of the pass's stages."""
    from firedancer_tpu_torch.disco.engine import EngineSpec, registry
    from firedancer_tpu_torch.ops import backend

    want_a_st, want_b, direct_b, direct_t = wants
    t0 = time.perf_counter()
    entry, warmed = registry().acquire(EngineSpec("rlc", B,
                                                  frontend=frontend))
    say(f"engine {entry.key} on {entry.device}: warmed={warmed} "
        f"in {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()

    backend.reset_counts()
    res_a = entry.fn(*inputs[0])
    st_a = np.asarray(res_a)
    counts_a, plain_a = dict(backend.launches), dict(backend.plain_calls)
    res_b = entry.fn(*inputs[1])
    st_b = np.asarray(res_b)
    res_t = entry.fn(*inputs[2])
    st_t = np.asarray(res_t)
    torch.cuda.synchronize()
    launches, plain = dict(backend.launches), dict(backend.plain_calls)
    say(f"rlc path ({frontend}): batch (a) launches {counts_a}; all three "
        f"batches launches {launches}, plain calls {plain}")
    want_a = {**FRONT_LAUNCHES[frontend], **RLC_PASS}
    if counts_a != want_a or plain_a:
        fail(f"rlc batch (a), {frontend}: launches {counts_a}, plain "
             f"{plain_a}; want {want_a} and no plain call")
    if any(plain.values()):
        fail(f"a plain version ran on the rlc path ({frontend}): {plain}")
    # Rows 12 and 13 take their launches from the signing path.
    own = (("sha512_batch",) if frontend == "staged" else
           ("frontend_rlc", *RLC_PASS))
    for name in own:
        rows[name]["launches"] = launches[name]

    if res_a.used_fallback or not np.array_equal(st_a, want_a_st):
        fail(f"rlc batch (a), {frontend}: fallback {res_a.used_fallback}, "
             f"statuses {dict(zip(*np.unique(st_a, return_counts=True)))}")
    say(f"rlc batch a bench ({frontend}): batch_ok True, no fallback, {B} "
        f"lanes SUCCESS")
    if (not res_b.used_fallback or not np.array_equal(st_b, want_b)
            or not np.array_equal(st_b, direct_b)):
        fail(f"rlc batch (b), {frontend}: fallback {res_b.used_fallback}, "
             f"{int((st_b != direct_b).sum())} lanes differ from direct")
    say(f"rlc batch b mixed ({frontend}): fallback used, {B} lanes equal "
        f"the direct path's and the constructed statuses")
    if (not res_t.used_fallback or not np.array_equal(st_t, direct_t)
            or not (direct_t[4:10] != 0).all()):
        fail(f"rlc batch (t), {frontend}: fallback {res_t.used_fallback}, "
             f"statuses {st_t[:12].tolist()} vs direct "
             f"{direct_t[:12].tolist()}")
    say(f"rlc batch t torsion ({frontend}): fallback used, lanes 4-9 "
        f"rejected {st_t[4:10].tolist()}, {B} lanes equal the direct "
        f"path's")

    a_args = inputs[0]
    ms = time_ms(torch, lambda: entry.fn(*a_args), TIMED_BATCHES)
    t0 = time.perf_counter()
    for _ in range(TIMED_BATCHES):
        np.asarray(entry.fn(*a_args))
    wall = (time.perf_counter() - t0) / TIMED_BATCHES
    entry.note_service(int(wall * 1e9))
    say(f"verify rlc ({frontend}) B={B} msg={MSG_LEN}: {ms:.3f} ms/batch "
        f"(CUDA events), {B / (ms / 1e3):.0f} verifies/s; host clock with "
        f"the batch_ok read-back {wall * 1e3:.3f} ms/batch, "
        f"{B / wall:.0f} verifies/s [{card}]")
    t0 = time.perf_counter()
    for _ in range(3):
        np.asarray(entry.fn(*inputs[1]))
    wall_b = (time.perf_counter() - t0) / 3
    say(f"verify rlc ({frontend}), batch (b) with its fallback: host clock "
        f"{wall_b * 1e3:.3f} ms/batch, {B / wall_b:.0f} verifies/s")
    profile_batches(torch, lambda: np.asarray(entry.fn(*a_args)), wall * 1e3)
    rlc_stages(torch, a_args, frontend)


def rlc_stages(torch, args, frontend: str, n: int = 5) -> None:
    """Host clock of the stages of a clean RLC pass, each ended by a
    synchronise, so a stage's time holds its host enqueue and its device
    work: drawing z and u (os.urandom) with their copy to the card, the
    front half (decompress_niels, the scalars, glue), the local half
    after it (staging, three fills and aggregations), the tails (two
    Horners, the ladder, the verdict) and the batch_ok read-back: the
    functions the engine's pass runs, in its order. Mean of n passes."""
    from firedancer_tpu_torch.ops import verify_rlc as vr

    dev = args[0].device
    names = ("weights", "front half", "fills and aggregations", "tails",
             "read-back")
    spent = dict.fromkeys(names, 0.0)
    for _ in range(n):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        z, u = vr.draw_weights(B, dev)
        mark()
        _, _, msm_in = vr.rlc_front(*args, z, u, frontend=frontend)
        mark()
        parts = vr.msm_partials(msm_in)
        mark()
        ok = vr.verify_rlc_combine(parts)
        mark()
        if not bool(ok):
            fail(f"rlc stages ({frontend}): the clean batch's verdict is "
                 f"False")
        mark()
        for name, a, b in zip(names, marks, marks[1:]):
            spent[name] += (b - a) / n
    total = sum(spent.values())
    say(f"rlc stages ({frontend}), host clock with a synchronise after "
        f"each, mean of {n} clean passes: {total * 1e3:.3f} ms")
    for name, t in spent.items():
        say(f"  {t * 1e3:8.3f} ms {100 * t / total:5.1f}% {name}")


def msm_parity(torch, gpu, parity, record, batch_a) -> None:
    """Phase 3, the MSM kernels: each against its plain version at the
    main path's shapes, staged from the clean batch (a) through the RLC
    front half with seeded weights; the fills read the niels forms the
    decompress kernel wrote."""
    from firedancer_tpu_torch import msm_plan
    from firedancer_tpu_torch.ops import curve25519 as ge
    from firedancer_tpu_torch.ops import msm, msm_cuda
    from firedancer_tpu_torch.ops import verify_rlc as vr
    from firedancer_tpu_torch.ops.sc25519 import L

    rng = np.random.default_rng(11)
    z = gpu(vr.fresh_z(B, rng))
    u = gpu(vr.fresh_u(vr.TORSION_K, 2 * B, rng))
    args = tuple(gpu(a) for a in batch_a)
    _, definite, msm_in = vr.rlc_front(*args, z, u)
    if bool(definite.any()):
        fail("msm parity: the clean batch has definite lanes")
    for name, (_, pts, niels) in msm_in.items():
        parity(f"niels forms of the {name} MSM (kernel vs formed in "
               f"PyTorch)", niels, ge.niels_limbs(pts))
    grids = []
    for name, (scalars, _, niels), nw in (
            ("z", msm_in["r"], msm.WINDOWS_Z),
            ("253", msm_in["m"], msm.WINDOWS_253)):
        rounds = msm_plan.default_rounds(niels.shape[0])
        grids.append((name, niels) + msm._staging_indices(
            scalars, nw, niels.shape[0], rounds))
    u_live, _, niels = msm_in["sub"]
    nb_t = 1 << msm_plan.TORSION_BUCKET_BITS
    grids.append(("torsion", niels) + msm._staging_from_digits(
        u_live & (nb_t - 1), 2 * B, msm_plan.default_rounds(2 * B, nb_t),
        nb_t))

    def kernel_row(name, runs, replaces, source):
        return kernel_pass(torch, parity, record, name, runs, replaces,
                           source)

    runs = []
    for name, pts, idx, ok in grids:
        if not bool(ok):
            fail(f"msm_fill {name}: the clean batch overflowed a bucket")
        nw, nb, rounds = idx.shape
        idx_r = idx.permute(2, 0, 1).reshape(rounds, nw * nb).contiguous()
        runs.append((f"{name} {nw}x{nb} lanes x {rounds} rounds",
                     lambda p=pts, i=idx_r: msm_cuda.fill_buckets_cuda(p, i),
                     lambda p=pts, i=idx: msm_cuda.fill_buckets_ref(p, i),
                     bound_fill(nw * nb, rounds, int((idx >= 0).sum()),
                                pts.shape[0])))
    fills = kernel_row("msm_fill", runs,
                       "firedancer_tpu/ops/msm_pallas.py:148",
                       "firedancer_tpu_torch/ops/csrc/msm_fill.cu")
    runs = []
    for (name, _, idx, _), out in zip(grids, fills.values()):
        buckets = out.reshape(idx.shape[0], idx.shape[1], 4, 5)
        runs.append((f"{name} {idx.shape[0]} columns x {idx.shape[1]}",
                     lambda b=buckets: msm_cuda.aggregate_buckets_cuda(b),
                     lambda b=buckets: msm_cuda.aggregate_buckets_ref(b),
                     bound_aggregate(idx.shape[0], idx.shape[1])))
    aggs = list(kernel_row("msm_aggregate", runs,
                           "firedancer_tpu/ops/msm_pallas.py:353",
                           "firedancer_tpu_torch/ops/csrc/msm_aggregate.cu"
                           ).values())
    runs = [(f"{name} {w.shape[0]} windows",
             lambda w=w: msm_cuda.window_horner_cuda(w, msm.W_BITS),
             lambda w=w: msm_cuda.window_horner_ref(w, msm.W_BITS),
             bound_horner(w.shape[0], msm.W_BITS))
            for name, w in (("z", aggs[0]), ("253", aggs[1]))]
    kernel_row("msm_horner", runs, "firedancer_tpu/ops/msm_pallas.py:295",
               "firedancer_tpu_torch/ops/csrc/msm_horner.cu")
    trials = aggs[2]
    kernel_row("msm_order", [(
        f"K = {trials.shape[0]} trials",
        lambda: msm_cuda.mul_by_group_order_cuda(trials),
        lambda: msm_cuda.mul_by_group_order_ref(trials),
        bound_order(trials.shape[0], L))],
        "firedancer_tpu/ops/msm_pallas.py:218",
        "firedancer_tpu_torch/ops/csrc/msm_order.cu")
    parts = {"w_r": aggs[0], "ok_r": grids[0][3], "w_m": aggs[1],
             "ok_m": grids[1][3], "sub": trials, "sub_ok": grids[2][3]}
    if not bool(vr.verify_rlc_combine(parts)):
        fail("msm parity: the clean batch's RLC verdict is False")
    say("msm parity: the clean batch's staged MSMs verify (batch_ok True)")

    # The signed plans' branch of the fill (the sign folded into the
    # gather), which EngineSpec(..., msm="s8l3") runs: its 253-bit grid
    # against the plain version, then the whole pass's verdict.
    plan = msm_plan.parse_plan("s8l3")
    scalars, _, niels = msm_in["m"]
    nw, nb, rounds = msm._plan_dims(msm.WINDOWS_253, niels.shape[0], plan)
    planes = msm._top_tree_planes(msm.WINDOWS_253, nw, plan)
    idx, neg, ok, _ = msm._plan_staging(scalars, niels.shape[0], rounds, nw,
                                        nb, plan, planes)
    if not bool(ok) or not bool(neg.any()):
        fail(f"msm_fill s8l3: fill verdict {bool(ok)}, "
             f"{int(neg.sum())} negated slots")
    parity(f"msm_fill s8l3 {idx.shape[0]}x{nb} lanes x {rounds} rounds",
           msm_cuda.fill_buckets(niels, idx, neg),
           msm_cuda.fill_buckets_ref(niels, idx, neg))
    if not bool(vr.verify_batch_rlc(*args, z, u, plan=plan)[2]):
        fail("msm parity: the clean batch's RLC verdict at s8l3 is False")
    say(f"msm parity: s8l3 fill ({int(neg.sum())} of "
        f"{int((idx >= 0).sum())} slots negated) equals its plain version; "
        f"the clean batch verifies at s8l3 (batch_ok True)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke run "
              "needs a CUDA device", flush=True)
        return 2
    sys.path.insert(0, REPO)
    from firedancer_tpu_torch import convert
    from firedancer_tpu_torch.ballet.ed25519 import corpus, oracle
    from firedancer_tpu_torch.disco.engine import EngineSpec, registry
    from firedancer_tpu_torch.ops import backend, build
    from firedancer_tpu_torch.ops import curve_cuda, dsm_cuda, fe25519
    from firedancer_tpu_torch.ops import frontend_cuda
    from firedancer_tpu_torch.ops.verify import verify_batch_ref

    # 1. Card.
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    kind = torch.cuda.get_device_name(0)
    say(f"card: {card}; capability {cap[0]}.{cap[1]}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    if cap[0] != 9:
        fail(f"need compute capability 9.x, found {cap}")
    dev = torch.device("cuda", 0)

    # 2. Build.
    t0 = time.perf_counter()
    build.build_all()
    say(f"build: {time.perf_counter() - t0:.2f} s "
        f"(stamp {build.stamp()}, {build.BUILD_DIR})")
    for name, text in build.ptxas_report().items():
        lines = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln]
        say(f"ptxas {name}: " + " | ".join(lines))

    rng = np.random.RandomState(7)

    def gpu(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def parity(name, got, want):
        err = max_abs_err(torch, got, want)
        if err != 0:
            fail(f"{name}: kernel disagrees with its plain version "
                 f"(max_abs_err {err})")
        return err

    rows = {}

    def record(name, err, ms, plain_ms, bound, replaces, source):
        rows[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None}
        say(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
            f"{bound[0]:.4f} ms ({bound[1]}), max_abs_err {err}")

    # 3. Kernel parity and times at the main path's shapes.
    # K1: the main path's hash rows r || A || msg, (8192, 64 + 192).
    k1_msgs = gpu(rng.randint(0, 256, (B, 64 + MSG_LEN), dtype=np.uint8))
    k1_lens = torch.full((B,), 64 + MSG_LEN, dtype=torch.int32, device=dev)
    err = parity("sha512_mod_l",
                 frontend_cuda.sha512_mod_l_cuda(k1_msgs, k1_lens),
                 frontend_cuda.sha512_mod_l_ref(k1_msgs, k1_lens))
    spread = rng.randint(0, 64 + MTU_MSG + 1, B).astype(np.int32)
    spread[:6] = [0, 111, 112, 239, 240, 64 + MTU_MSG]
    s_msgs = gpu(rng.randint(0, 256, (B, 64 + MTU_MSG), dtype=np.uint8))
    s_lens = gpu(spread)
    err = max(err, parity("sha512_mod_l (lengths 0-1296)",
                          frontend_cuda.sha512_mod_l_cuda(s_msgs, s_lens),
                          frontend_cuda.sha512_mod_l_ref(s_msgs, s_lens)))
    record("sha512_mod_l", err,
           time_ms(torch, lambda: frontend_cuda.sha512_mod_l_cuda(
               k1_msgs, k1_lens), REPS),
           time_ms(torch, lambda: frontend_cuda.sha512_mod_l_ref(
               k1_msgs, k1_lens), 2),
           bound_sha512_mod_l(np.full(B, 64 + MSG_LEN), 64 + MSG_LEN),
           "firedancer_tpu/ops/frontend_pallas.py:290",
           "firedancer_tpu_torch/ops/csrc/sha512_mod_l.cu")

    # K2: the stacked A || R pass, 2B lanes: the edge corpus, then
    # encodings of random points and random bytes.
    edge = corpus.edge_encodings(rng)
    k2_np = rng.randint(0, 256, (2 * B, 32), dtype=np.uint8)
    k2_np[:len(edge)] = np.frombuffer(b"".join(edge), np.uint8).reshape(-1, 32)
    enc = gpu(k2_np)
    k2 = curve_cuda.decompress_so_cuda(enc)
    err = parity("decompress_so", k2, curve_cuda.decompress_so_ref(enc))
    torsion = len(corpus.torsion_encodings())
    if not (bool(k2[2][:torsion].all()) and bool(k2[1][:torsion].all())):
        fail("decompress_so: a torsion encoding is not decoded small-order")
    say(f"decompress_so: {int(k2[1].sum())}/{2 * B} lanes decode, "
        f"{len(edge)} edge encodings")
    record("decompress_so", err,
           time_ms(torch, lambda: curve_cuda.decompress_so_cuda(enc), REPS),
           time_ms(torch, lambda: curve_cuda.decompress_so_ref(enc), 2),
           bound_decompress_so(2 * B),
           "firedancer_tpu/ops/curve_pallas.py:234",
           "firedancer_tpu_torch/ops/csrc/decompress_so.cu")

    # K3: B decoded points (ok lanes, repeated), random h and s.
    ok_idx = torch.nonzero(k2[1]).flatten()
    a_pt = k2[0][ok_idx[torch.arange(B, device=dev) % ok_idx.numel()]]
    a_pt = a_pt.contiguous()
    h = gpu(rng.randint(0, 256, (B, 32), dtype=np.uint8))
    s = gpu(rng.randint(0, 256, (B, 32), dtype=np.uint8))
    k3 = dsm_cuda.double_scalarmult_cuda(h, a_pt, s)
    err = parity("double_scalarmult", k3,
                 dsm_cuda.double_scalarmult_ref(h, a_pt, s))
    err = max(err, parity("double_scalarmult (affine)",
                          convert.point_to_affine_bytes(k3[:512]),
                          convert.point_to_affine_bytes(
                              dsm_cuda.double_scalarmult_ref(
                                  h[:512], a_pt[:512], s[:512]))))
    record("double_scalarmult", err,
           time_ms(torch, lambda: dsm_cuda.double_scalarmult_cuda(
               h, a_pt, s), REPS),
           time_ms(torch, lambda: dsm_cuda.double_scalarmult_ref(
               h, a_pt, s), 2),
           bound_double_scalarmult(B),
           "firedancer_tpu/ops/dsm_pallas.py:252",
           "firedancer_tpu_torch/ops/csrc/double_scalarmult.cu")

    # K4: affine points against projective (lam X : lam Y : lam), half of
    # the lanes holding the next lane's point instead.
    lam = fe25519.fe_from_bytes(gpu(rng.randint(0, 256, (B, 32),
                                                dtype=np.uint8)))
    x, y = (fe25519.fe_from_limbs51(a_pt[:, c]) for c in (0, 1))
    proj = torch.stack([fe25519.fe_to_limbs51(c) for c in
                        (fe25519.fe_mul(lam, x), fe25519.fe_mul(lam, y),
                         lam)], dim=1)
    swap = gpu(rng.randint(0, 2, B).astype(bool))
    aff = torch.where(swap[:, None, None], a_pt.roll(1, 0), a_pt).contiguous()
    k4 = curve_cuda.point_eq_affine_cuda(aff, proj)
    err = parity("point_eq", k4, curve_cuda.point_eq_affine_ref(aff, proj))
    say(f"point_eq: {int(k4.sum())}/{B} lanes equal")
    if not 0.4 * B < int(k4.sum()) < 0.6 * B:
        fail("point_eq: expected about half of the lanes equal")
    record("point_eq", err,
           time_ms(torch, lambda: curve_cuda.point_eq_affine_cuda(aff, proj),
                   REPS),
           time_ms(torch, lambda: curve_cuda.point_eq_affine_ref(aff, proj),
                   2),
           bound_point_eq(B),
           "firedancer_tpu/ops/curve_pallas.py:296",
           "firedancer_tpu_torch/ops/csrc/point_eq.cu")

    # The RLC front half's kernels. frontend_rlc and sha512_batch on the
    # main path's hash rows and on rows of every length; z < 2^126 as
    # fresh_z draws it, zero on dead lanes, and s of any 32 bytes.
    z_np = rng.randint(0, 256, (B, 32), dtype=np.uint8)
    z_np[:, 16:] = 0
    z_np[:, 15] &= 0x3F
    z_np[::97] = 0
    fz, fs = gpu(z_np), gpu(rng.randint(0, 256, (B, 32), dtype=np.uint8))
    err = parity("frontend_rlc",
                 frontend_cuda.frontend_rlc_cuda(k1_msgs, k1_lens, fz, fs),
                 frontend_cuda.frontend_rlc_ref(k1_msgs, k1_lens, fz, fs))
    err = max(err, parity(
        "frontend_rlc (lengths 0-1296)",
        frontend_cuda.frontend_rlc_cuda(s_msgs, s_lens, fz, fs),
        frontend_cuda.frontend_rlc_ref(s_msgs, s_lens, fz, fs)))
    record("frontend_rlc", err,
           time_ms(torch, lambda: frontend_cuda.frontend_rlc_cuda(
               k1_msgs, k1_lens, fz, fs), REPS),
           time_ms(torch, lambda: frontend_cuda.frontend_rlc_ref(
               k1_msgs, k1_lens, fz, fs), 2),
           bound_frontend_rlc(np.full(B, 64 + MSG_LEN), 64 + MSG_LEN),
           "firedancer_tpu/ops/frontend_pallas.py:319",
           "firedancer_tpu_torch/ops/csrc/frontend_rlc.cu")
    err = parity("sha512_batch",
                 frontend_cuda.sha512_batch_cuda(k1_msgs, k1_lens),
                 frontend_cuda.sha512_batch_ref(k1_msgs, k1_lens))
    err = max(err, parity("sha512_batch (lengths 0-1296)",
                          frontend_cuda.sha512_batch_cuda(s_msgs, s_lens),
                          frontend_cuda.sha512_batch_ref(s_msgs, s_lens)))
    record("sha512_batch", err,
           time_ms(torch, lambda: frontend_cuda.sha512_batch_cuda(
               k1_msgs, k1_lens), REPS),
           time_ms(torch, lambda: frontend_cuda.sha512_batch_ref(
               k1_msgs, k1_lens), 2),
           bound_sha512_batch(np.full(B, 64 + MSG_LEN), 64 + MSG_LEN),
           "firedancer_tpu/ops/sha512_pallas.py:220",
           "firedancer_tpu_torch/ops/csrc/sha512_batch.cu")

    # decompress_niels on 2B encodings: random bytes (about half decode,
    # so every 32-lane group mixes failing and valid lanes), the edge
    # corpus spread over the first B lanes (y = +-1, non-square,
    # non-canonical and small-order lanes among valid group mates) and
    # one whole group of undecodable encodings at lane B; then the batch
    # cut to 2B - 3 lanes, off the group.
    dn_np = rng.randint(0, 256, (2 * B, 32), dtype=np.uint8)
    spots = np.linspace(5, B - 1, len(edge)).astype(np.int64)
    dn_np[spots] = np.frombuffer(b"".join(edge), np.uint8).reshape(-1, 32)
    dn_np[B:B + 32] = np.frombuffer(b"".join(
        corpus.undecodable_encodings(32, rng)), np.uint8).reshape(-1, 32)
    dn_enc = gpu(dn_np)
    dn = curve_cuda.decompress_niels_cuda(dn_enc)
    err = parity("decompress_niels", dn,
                 curve_cuda.decompress_niels_ref(dn_enc))
    err = max(err, parity(
        f"decompress_niels ({2 * B - 3} lanes)",
        curve_cuda.decompress_niels_cuda(dn_enc[:2 * B - 3].contiguous()),
        curve_cuda.decompress_niels_ref(dn_enc[:2 * B - 3])))
    err = max(err, parity("decompress_niels points vs decompress_so",
                          dn[:3], curve_cuda.decompress_so_cuda(dn_enc)))
    t_spots = gpu(spots[:torsion])
    if not (bool(dn[2][t_spots].all()) and bool(dn[1][t_spots].all())
            and not bool(dn[1][B:B + 32].any())):
        fail("decompress_niels: a torsion encoding is not decoded "
             "small-order, or an undecodable lane decoded")
    say(f"decompress_niels: {int(dn[1].sum())}/{2 * B} lanes decode, "
        f"{len(edge)} edge encodings spread, one failing group")
    from firedancer_tpu_torch.ops import decompress as dec_mod

    record("decompress_niels", err,
           time_ms(torch, lambda: curve_cuda.decompress_niels_cuda(dn_enc),
                   REPS),
           time_ms(torch, lambda: curve_cuda.decompress_niels_ref(dn_enc),
                   2),
           bound_decompress_niels(2 * B, dec_mod.GROUP),
           "firedancer_tpu/ops/curve_pallas.py:234",
           "firedancer_tpu_torch/ops/csrc/decompress_niels.cu")

    sign_kernel_parity(torch, gpu, parity, record, rng)

    # Traffic (oracle signing on the host), for phases 3 to 5.
    t0 = time.perf_counter()
    bench_rng = np.random.RandomState(42)
    uniq = corpus.signed_items(64, [MSG_LEN], bench_rng)
    tiled = [uniq[b % 64] for b in range(B)]
    batch_a = corpus.to_arrays(tiled, MSG_LEN)
    expect_a = np.zeros(B, np.int32)

    fixtures = os.path.join(REPO, "tests", "fixtures")
    zcash = []
    for fname, passes in (("ed25519_malleability_should_pass.bin", True),
                          ("ed25519_malleability_should_fail.bin", False)):
        raw = open(os.path.join(fixtures, fname), "rb").read()
        zcash += [(raw[o:o + 64], raw[o + 64:o + 96], passes)
                  for o in range(0, len(raw), 96)]
    if len(zcash) != 396:
        fail(f"expected 396 Zcash vectors, found {len(zcash)}")
    bad_pub = corpus.undecodable_encodings(1, bench_rng)[0]
    items_b, expect_b, zcash_pass = [], np.zeros(B, np.int32), {}
    for b in range(B):
        m, sig, pub = tiled[b]
        if b < len(zcash):
            sig, pub, passes = zcash[b]
            m = b"Zcash"
            zcash_pass[b] = passes
        elif b % 64 == 1:        # s + L: the same scalar, out of range
            s_int = int.from_bytes(sig[32:], "little") + oracle.L
            sig = sig[:32] + s_int.to_bytes(32, "little")
            expect_b[b] = oracle.FD_ED25519_ERR_SIG
        elif b % 64 == 2:
            pub = bad_pub
            expect_b[b] = oracle.FD_ED25519_ERR_PUBKEY
        elif b % 8 == 3:         # salted: one message byte flipped
            m = bytes([m[0] ^ 1]) + m[1:]
            expect_b[b] = oracle.FD_ED25519_ERR_MSG
        items_b.append((m, sig, pub))
    batch_b = corpus.to_arrays(items_b, MSG_LEN)

    mtu_lens = list(np.linspace(100, MTU_MSG, 64).astype(int))
    uniq_c = corpus.signed_items(64, mtu_lens, bench_rng)
    batch_c = corpus.to_arrays([uniq_c[b % 64] for b in range(B)], MTU_MSG)
    expect_c = np.zeros(B, np.int32)

    # The RLC torsion batch: (a) with an order-2 pair (lanes 4, 5) and four
    # order-8-offset lanes (6-9) of the RLC corpus; each fails per lane.
    rlc_cases = corpus.rlc_corpus()
    items_t = list(tiled)
    items_t[4:6] = rlc_cases["order2"][4:6]
    items_t[6:10] = rlc_cases["order8"][4:8]
    batch_t = corpus.to_arrays(items_t, MSG_LEN)
    say(f"traffic: {time.perf_counter() - t0:.1f} s of oracle signing")

    msm_parity(torch, gpu, parity, record, batch_a)

    # 4. Direct path.
    t0 = time.perf_counter()
    entry, warmed = registry().acquire(EngineSpec("direct", B))
    say(f"engine {entry.key} on {entry.device}: warmed={warmed} "
        f"in {time.perf_counter() - t0:.2f} s")
    batches = [("a bench", batch_a, expect_a), ("b mixed", batch_b, expect_b),
               ("c mtu", batch_c, expect_c)]
    inputs = [tuple(gpu(a) for a in arrs) for _, arrs, _ in batches]
    torch.cuda.synchronize()

    backend.reset_counts()
    outs = [entry.fn(*args) for args in inputs]
    torch.cuda.synchronize()
    launches = dict(backend.launches)
    plain = dict(backend.plain_calls)
    say(f"direct path: launches {launches}, plain calls {plain}")
    for name in DIRECT_KERNELS:
        if launches.get(name, 0) < 1:
            fail(f"{name} was not launched on the direct path")
        rows[name]["launches"] = launches[name]
    if any(plain.values()):
        fail(f"a plain version ran on the direct path: {plain}")

    for (name, _, expect), out, args in zip(batches, outs, inputs):
        got = out.cpu().numpy()
        ref = verify_batch_ref(*args).cpu().numpy()
        if not np.array_equal(got, ref):
            fail(f"batch {name}: statuses differ from the plain path on "
                 f"{int((got != ref).sum())} lanes")
        want = expect.copy()
        if name.startswith("b"):
            for b, passes in zcash_pass.items():
                if passes != (got[b] == 0):
                    fail(f"batch {name}: Zcash vector at lane {b} "
                         f"gave status {got[b]}")
                want[b] = got[b]
        if not np.array_equal(got, want):
            bad = np.nonzero(got != want)[0]
            fail(f"batch {name}: {len(bad)} lanes differ from the "
                 f"constructed statuses, first {bad[:8].tolist()}: "
                 f"{got[bad[:8]].tolist()} vs {want[bad[:8]].tolist()}")
        say(f"batch {name}: {B} lanes match (status counts "
            f"{dict(zip(*np.unique(got, return_counts=True)))})")

    a_args = inputs[0]
    ms = time_ms(torch, lambda: entry.fn(*a_args), TIMED_BATCHES)
    t0 = time.perf_counter()
    for _ in range(TIMED_BATCHES):
        entry.fn(*a_args)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TIMED_BATCHES
    entry.note_service(int(wall * 1e9))
    say(f"verify direct B={B} msg={MSG_LEN}: {ms:.3f} ms/batch (CUDA "
        f"events), {B / (ms / 1e3):.0f} verifies/s; host clock "
        f"{wall * 1e3:.3f} ms/batch, {B / wall:.0f} verifies/s "
        f"[{card}]")
    profile_batches(torch, lambda: entry.fn(*a_args), wall * 1e3)
    direct_b = outs[1].cpu().numpy()
    rlc_path(torch, gpu, rows, card, (batch_a, batch_b, batch_t),
             (expect_a, expect_b), direct_b, zcash_pass, entry)
    signing_path(torch, gpu, rows, card)

    # 7. Output.
    say(card_line())
    say(json.dumps({"kernels": list(rows.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
