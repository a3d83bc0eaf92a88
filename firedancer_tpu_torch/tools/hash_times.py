"""Time the port's warp-staged hash kernels, K1 (sha512_mod_l),
frontend_rlc and sha512_batch, on one CUDA card, shape by shape.

Each kernel is first held to its plain version on each shape (equal
bytes), then timed over 20 warm wrapper calls two ways: CUDA events
around the calls, as chip_smoke.py times every kernel row (a kernel
shorter than its wrapper's host path reads the host there), and the mean
device time of a launch in torch.profiler's trace.

    python3 firedancer_tpu_torch/tools/hash_times.py [--root DIR] [--sweep]

--root DIR  time the firedancer_tpu_torch of the checkout at DIR (default:
            this one; it builds into DIR/build/). Run it on two checkouts
            in turns to compare their kernels on one card.
--sweep     also build the kernels at the other two of 1, 2 and 4
            warps a block (nvcc -DSW_WARPS=w on the root's sources, into
            its build/torch_kernels/sweep/), hold them to the built
            kernel's bytes and time them beside it.

Prints the card's name and power limit, a line per measurement and one
JSON line of all of them. Needs a CUDA card and nvcc.
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
WARPS = (1, 2, 4)
# The kernels on the core and the bytes a lane of their first output.
HASH_KERNELS = {"sha512_mod_l": 32, "frontend_rlc": 32, "sha512_batch": 64}


def _chip_smoke():
    """This checkout's chip_smoke.py, for its timing helpers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shapes(torch, dev):
    """(label, lanes, rows, lens): the main path's 256-byte rows at B and
    2B; the 0-1296-byte bucket; rows of stride 1299 (off every 4- and
    16-byte boundary but one in four); full rows of stride 1296 and 1299
    (11 blocks each, aligned against odd); rows of 0 and 239 bytes (1 and
    2 blocks) at stride 1296, which with the 256-byte rows (3) and the
    full rows (11) give the cost by blocks a row; and signing's
    R || pub || msg rows of the 1280-byte bucket (stride 1344, lengths
    0-1344)."""
    rng = np.random.RandomState(23)

    def rows(n, stride):
        return torch.from_numpy(rng.randint(0, 256, (n, stride),
                                            dtype=np.uint8)).to(dev)

    def lens(v):
        return torch.from_numpy(np.asarray(v, np.int32)).to(dev)

    r256, r1296, r1299 = rows(2 * B, 256), rows(B, 1296), rows(B, 1299)
    r1344 = rows(B, 1344)
    return [
        ("256-byte rows", B, r256[:B], lens(np.full(B, 256))),
        ("256-byte rows", 2 * B, r256, lens(np.full(2 * B, 256))),
        ("lengths 0-1296", B, r1296, lens(rng.randint(0, 1297, B))),
        ("stride 1299, lengths 0-1299", B, r1299,
         lens(rng.randint(0, 1300, B))),
        ("stride 1296, 1296-byte rows", B, r1296, lens(np.full(B, 1296))),
        ("stride 1299, 1299-byte rows", B, r1299, lens(np.full(B, 1299))),
        ("stride 1296, 0-byte rows", B, r1296, lens(np.zeros(B))),
        ("stride 1296, 239-byte rows", B, r1296, lens(np.full(B, 239))),
        ("stride 1344, lengths 0-1344", B, r1344,
         lens(rng.randint(0, 1345, B))),
    ]


def built_warps(build) -> int:
    """The warps a block the core builds by default (SW_WARPS)."""
    core = (build.CSRC / "sha512_warp.cuh").read_text()
    return int(re.search(r"#define SW_WARPS (\d+)", core).group(1))


def sweep_fns(torch, build, warps):
    """The kernels' C entries built at each of warps warps a block,
    wrapped like frontend_cuda's *_cuda: {(name, w): fn}."""
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for name in HASH_KERNELS:
        for w in warps:
            lib = out_dir / f"lib{name}-w{w}-{build.stamp()}.so"
            cmd = [nvcc, *build.NVCC_FLAGS, f"-DSW_WARPS={w}", "-I",
                   str(build.CSRC), "-o", str(lib),
                   str(build.CSRC / f"{name}.cu")]
            procs[(name, w)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
    v, ll = ctypes.c_void_p, ctypes.c_longlong
    fns = {}
    for (name, w), (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}.cu -DSW_WARPS={w}:\n{err}{out}")
        regs = [ln.strip() for ln in (err + out).splitlines()
                if "registers" in ln]
        print(f"ptxas {name} at {w} warps a block: {' | '.join(regs)}",
              flush=True)
        cdll = ctypes.CDLL(str(lib))
        if name != "frontend_rlc":
            c = getattr(cdll, f"fd_{name}")
            c.argtypes, c.restype = [v, ll, v, v, ll, v], ctypes.c_int

            def fn(m, ln, z, s, c=c, name=name):
                out = torch.empty(m.shape[0], HASH_KERNELS[name],
                                  dtype=torch.uint8, device=m.device)
                build.check_rc(f"fd_{name}", c(
                    m.data_ptr(), m.shape[1], ln.data_ptr(), out.data_ptr(),
                    m.shape[0], torch.cuda.current_stream().cuda_stream))
                return out
        else:
            c = cdll.fd_frontend_rlc
            c.argtypes = [v, ll, v, v, v, v, v, v, ll, v]
            c.restype = ctypes.c_int

            def fn(m, ln, z, s, c=c):
                h, mm, zs = (torch.empty(m.shape[0], 32, dtype=torch.uint8,
                                         device=m.device) for _ in range(3))
                build.check_rc("fd_frontend_rlc", c(
                    m.data_ptr(), m.shape[1], ln.data_ptr(), z.data_ptr(),
                    s.data_ptr(), h.data_ptr(), mm.data_ptr(), zs.data_ptr(),
                    m.shape[0], torch.cuda.current_stream().cuda_stream))
                return h, mm, zs
        fns[(name, w)] = fn
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
    from firedancer_tpu_torch.ops import build, frontend_cuda as fc

    cs = _chip_smoke()
    print(cs.card_line(), flush=True)
    print(f"kernels of {root} (built into {build.BUILD_DIR})", flush=True)
    dev = torch.device("cuda")
    rng = np.random.RandomState(29)
    z_np = rng.randint(0, 256, (2 * B, 32), dtype=np.uint8)
    z_np[:, 16:] = 0
    zz = torch.from_numpy(z_np).to(dev)
    ss = torch.from_numpy(rng.randint(0, 256, (2 * B, 32),
                                      dtype=np.uint8)).to(dev)
    kernels = {
        "sha512_mod_l": (lambda m, ln, z, s: fc.sha512_mod_l_cuda(m, ln),
                         lambda m, ln, z, s: fc.sha512_mod_l_ref(m, ln)),
        "frontend_rlc": (fc.frontend_rlc_cuda, fc.frontend_rlc_ref),
        "sha512_batch": (lambda m, ln, z, s: fc.sha512_batch_cuda(m, ln),
                         lambda m, ln, z, s: fc.sha512_batch_ref(m, ln))}
    built = built_warps(build) if args.sweep else None
    others = [w for w in WARPS if w != built]
    variants = sweep_fns(torch, build, others) if args.sweep else {}
    results = []
    for label, lanes, m, ln in shapes(torch, dev):
        z, s = zz[:lanes], ss[:lanes]
        for name, (kern, plain) in kernels.items():
            got = kern(m, ln, z, s)
            want = plain(m, ln, z, s)
            for a, b in zip(*((got, want) if isinstance(got, tuple)
                              else ((got,), (want,)))):
                if not torch.equal(a, b):
                    print(f"FAIL: {name} ({label}, {lanes} lanes) differs "
                          f"from its plain version", flush=True)
                    return 1
            runs = [(built, lambda: kern(m, ln, z, s))]
            for w in others:
                fn = variants.get((name, w))
                if fn is None:
                    continue
                alt = fn(m, ln, z, s)
                for a, b in zip(*((alt, got) if isinstance(got, tuple)
                                  else ((alt,), (got,)))):
                    if not torch.equal(a, b):
                        print(f"FAIL: {name} at {w} warps a block "
                              f"({label}) differs", flush=True)
                        return 1
                runs.append((w, lambda fn=fn: fn(m, ln, z, s)))
            for w, run in runs:
                events = cs.time_ms(torch, run, REPS)
                traced = cs.traced_ms(torch, run, f"{name}_kernel", REPS)
                res = {"kernel": name, "shape": label, "lanes": lanes,
                       "warps": w,
                       "events_ms": events, "device_ms": traced}
                results.append(res)
                dev_s = ("not measured" if traced is None
                         else f"{traced:.4f} ms")
                tag = f", {w} warps a block" if args.sweep else ""
                print(f"{name} {label}, {lanes} lanes{tag}: events "
                      f"{events:.4f} ms, device {dev_s}", flush=True)
    print(json.dumps({"root": str(root), "times": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
