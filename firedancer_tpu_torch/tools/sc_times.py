"""Time the kernels that run the shared reduction mod L (csrc/sha512.cuh
sc_reduce512) on one CUDA card: sc_reduce64 and sc_muladd (with an
addend and with c = 0) at 1, B and 2B lanes, and K1 (sha512_mod_l) and
frontend_rlc on the main path's 256-byte rows at B lanes.

Each launch is first held to its plain version (equal bytes), then timed
over 20 warm wrapper calls two ways: CUDA events around the calls (a
kernel shorter than its wrapper's host path reads the host there) and
the mean device time of a launch in torch.profiler's trace. At one lane
the device time is the launch's fixed cost.

    python3 firedancer_tpu_torch/tools/sc_times.py [--root DIR] [--sweep]

--root DIR  time the firedancer_tpu_torch of the checkout at DIR (default:
            this one; it builds into DIR/build/). Run it on two checkouts
            in turns to compare their kernels on one card.
--sweep     also build sc_reduce.cu at the other block sizes of
            SWEEP_THREADS (nvcc -DSC_THREADS=t on the root's sources, into
            its build/torch_kernels/sweep/), hold them to the built
            kernel's bytes and time them beside it.

Prints the card's name and power limit, ptxas's registers of the scalar
kernels, their SASS instruction counts and mixes (the whole kernels, and
the shared chains alone in chip_smoke.py's probe), a line per
measurement and one JSON line of all of them. Needs a CUDA card, nvcc
and cuobjdump.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
B = 8192
REPS = 20
LANES = (1, B, 2 * B)
SWEEP_THREADS = (32, 64, 128, 256)


def _chip_smoke():
    """This checkout's chip_smoke.py, for its timing and SASS helpers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def built_threads(build) -> int:
    """The block size sc_reduce.cu builds by default (SC_THREADS)."""
    src = (build.CSRC / "sc_reduce.cu").read_text()
    return int(re.search(r"#define SC_THREADS (\d+)", src).group(1))


def sweep_fns(torch, build, threads):
    """sc_reduce.cu built at each block size of threads, wrapped like
    sc_cuda's *_cuda: {(kernel, t): fn}."""
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for t in threads:
        lib = out_dir / f"libsc_reduce-t{t}-{build.stamp()}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, f"-DSC_THREADS={t}", "-I",
               str(build.CSRC), "-o", str(lib), str(build.CSRC / "sc_reduce.cu")]
        procs[t] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    v, ll = ctypes.c_void_p, ctypes.c_longlong
    fns = {}
    for t, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc sc_reduce.cu -DSC_THREADS={t}:\n{err}{out}")
        regs = [ln.strip() for ln in (err + out).splitlines()
                if "registers" in ln]
        print(f"ptxas sc_reduce at {t} threads a block: {' | '.join(regs)}",
              flush=True)
        cdll = ctypes.CDLL(str(lib))
        red, mad = cdll.fd_sc_reduce64, cdll.fd_sc_muladd
        red.argtypes, red.restype = [v, v, ll, v], ctypes.c_int
        mad.argtypes, mad.restype = [v, v, v, v, ll, v], ctypes.c_int

        def reduce64(x, red=red):
            out = torch.empty(x.shape[0], 32, dtype=torch.uint8, device=x.device)
            build.check_rc("fd_sc_reduce64", red(
                x.data_ptr(), out.data_ptr(), x.shape[0],
                torch.cuda.current_stream().cuda_stream))
            return out

        def muladd(a, b, c=None, mad=mad):
            out = torch.empty(a.shape[0], 32, dtype=torch.uint8, device=a.device)
            build.check_rc("fd_sc_muladd", mad(
                a.data_ptr(), b.data_ptr(), None if c is None else c.data_ptr(),
                out.data_ptr(), a.shape[0],
                torch.cuda.current_stream().cuda_stream))
            return out

        fns[("sc_reduce64", t)], fns[("sc_muladd", t)] = reduce64, muladd
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    from firedancer_tpu_torch.ops import build, frontend_cuda as fc, sc_cuda

    cs = _chip_smoke()
    print(cs.card_line(), flush=True)
    print(f"kernels of {root} (built into {build.BUILD_DIR})", flush=True)
    build.build_all()
    print(f"ptxas sc_reduce: {cs.ptxas_line(build, 'sc_reduce')}", flush=True)
    cs.scalar_sass(build)
    dev = torch.device("cuda")
    rng = np.random.RandomState(37)

    def gpu(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    x = gpu(rng.randint(0, 256, (2 * B, 64), dtype=np.uint8))
    a, b, c = (gpu(rng.randint(0, 256, (2 * B, 32), dtype=np.uint8))
               for _ in range(3))
    msgs = gpu(rng.randint(0, 256, (B, 256), dtype=np.uint8))
    lens = torch.full((B,), 256, dtype=torch.int32, device=dev)
    z_np = rng.randint(0, 256, (B, 32), dtype=np.uint8)
    z_np[:, 16:] = 0
    z = gpu(z_np)
    runs = []   # (kernel, label, lanes, symbol, args, fn, plain, sweep key)
    for n in LANES:
        runs += [
            ("sc_reduce64", "", n, "sc_reduce64_kernel", (x[:n],),
             sc_cuda.sc_reduce64_cuda, sc_cuda.sc_reduce64_ref, "sc_reduce64"),
            ("sc_muladd", "with c", n, "sc_muladd_kernel",
             (a[:n], b[:n], c[:n]), sc_cuda.sc_muladd_cuda,
             sc_cuda.sc_muladd_ref, "sc_muladd"),
            ("sc_muladd", "c = 0", n, "sc_muladd_kernel", (a[:n], b[:n]),
             sc_cuda.sc_muladd_cuda, sc_cuda.sc_muladd_ref, "sc_muladd")]
    runs += [
        ("sha512_mod_l", "256-byte rows", B, "sha512_mod_l_kernel",
         (msgs, lens), fc.sha512_mod_l_cuda, fc.sha512_mod_l_ref, None),
        ("frontend_rlc", "256-byte rows", B, "frontend_rlc_kernel",
         (msgs, lens, z, c[:B]), fc.frontend_rlc_cuda, fc.frontend_rlc_ref,
         None)]
    built = built_threads(build) if args.sweep else None
    others = [t for t in SWEEP_THREADS if t != built]
    variants = sweep_fns(torch, build, others) if args.sweep else {}
    results = []
    for name, label, n, sym, fargs, kern, plain, key in runs:
        got = kern(*fargs)
        want = plain(*fargs)
        for g, w in zip(*((got, want) if isinstance(got, tuple)
                          else ((got,), (want,)))):
            if not torch.equal(g, w):
                print(f"FAIL: {name} {label} ({n} lanes) differs from its "
                      f"plain version", flush=True)
                return 1
        timed = [(built if key else None,
                  lambda kern=kern, fargs=fargs: kern(*fargs))]
        for t in others:
            fn = variants.get((key, t))
            if fn is None:
                continue
            if not torch.equal(fn(*fargs), got):
                print(f"FAIL: {name} at {t} threads a block ({label}, {n} "
                      f"lanes) differs", flush=True)
                return 1
            timed.append((t, lambda fn=fn, fargs=fargs: fn(*fargs)))
        for t, run in timed:
            events = cs.time_ms(torch, run, REPS)
            traced = cs.traced_ms(torch, run, sym, REPS)
            results.append({"kernel": name, "shape": label, "lanes": n,
                            "threads": t, "events_ms": events,
                            "device_ms": traced})
            dev_s = "not measured" if traced is None else f"{traced:.4f} ms"
            tag = f", {t} threads a block" if args.sweep and key else ""
            print(f"{name} {label}, {n} lanes{tag}: events {events:.4f} ms, "
                  f"device {dev_s}", flush=True)
    print(json.dumps({"root": str(root), "times": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
