"""Time fe_pow (both chains) and point_eq on one CUDA card, the two
kernels that run decompress_core.cuh's five-thread group outside the
decompress kernels and compress: fe_pow at 1, 128 (the JAX package's
root inversion at B = 8192, B / 64 lanes), B and 2B lanes, point_eq at 1,
B and 2B lanes.

Each launch is first held to its plain version (equal limbs or bytes),
then timed over 20 warm wrapper calls two ways: CUDA events around the
calls (a kernel shorter than its wrapper's host path reads the host
there) and the mean device time of a launch in torch.profiler's trace.
At one lane the device time is the launch's fixed cost.

    python3 firedancer_tpu_torch/tools/group_times.py [--root DIR]

--root DIR  time the firedancer_tpu_torch of the checkout at DIR (default:
            this one; it builds into DIR/build/). Run it on two checkouts
            in turns to compare their kernels on one card.

Prints the card's name and power limit, ptxas's registers, stack and
spills of both libraries, a line per measurement and one JSON line of
all of them. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
B = 8192
REPS = 20
POW_LANES = (1, 128, B, 2 * B)
EQ_LANES = (1, B, 2 * B)


def _chip_smoke():
    """This checkout's chip_smoke.py, for its timing helpers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    from firedancer_tpu_torch.ops import build, curve_cuda, pow_cuda
    from firedancer_tpu_torch.ops import fe25519 as fe

    cs = _chip_smoke()
    print(cs.card_line(), flush=True)
    print(f"kernels of {root} (built into {build.BUILD_DIR})", flush=True)
    build.build_all()
    for name in ("fe_pow", "point_eq"):
        print(f"ptxas {name}: {cs.ptxas_line(build, name)}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.RandomState(41)

    def field(n):
        b = rng.randint(0, 256, (n, 32), dtype=np.uint8)
        return fe.fe_from_bytes(torch.from_numpy(b).to(dev))

    n = 2 * B
    z = fe.fe_to_limbs51(field(n))
    ax, ay, lam = field(n), field(n), field(n)
    aff = torch.stack([fe.fe_to_limbs51(c) for c in (ax, ay)], dim=1)
    proj = torch.stack([fe.fe_to_limbs51(c) for c in (
        fe.fe_mul(ax, lam), fe.fe_mul(ay, lam), lam)], dim=1)
    swap = torch.from_numpy(rng.randint(0, 2, n).astype(bool)).to(dev)
    aff = torch.where(swap[:, None, None], aff.roll(1, 0), aff).contiguous()
    runs = [(f"fe_pow {name}", k, "fe_pow_kernel", (z[:k],), kern, plain)
            for name, kern, plain in (
                ("invert", pow_cuda.fe_invert_cuda, pow_cuda.fe_invert_ref),
                ("pow22523", pow_cuda.fe_pow22523_cuda,
                 pow_cuda.fe_pow22523_ref))
            for k in POW_LANES]
    runs += [("point_eq", k, "point_eq_kernel", (aff[:k], proj[:k]),
              curve_cuda.point_eq_affine_cuda,
              curve_cuda.point_eq_affine_ref) for k in EQ_LANES]
    results = []
    for name, lanes, sym, fargs, kern, plain in runs:
        if not torch.equal(kern(*fargs), plain(*fargs)):
            print(f"FAIL: {name} ({lanes} lanes) differs from its plain "
                  f"version", flush=True)
            return 1

        def run(kern=kern, fargs=fargs):
            return kern(*fargs)

        events = cs.time_ms(torch, run, REPS)
        traced = cs.traced_ms(torch, run, sym, REPS)
        results.append({"kernel": name, "lanes": lanes, "events_ms": events,
                        "device_ms": traced})
        dev_s = "not measured" if traced is None else f"{traced:.4f} ms"
        print(f"{name}, {lanes} lanes: events {events:.4f} ms, device "
              f"{dev_s}", flush=True)
    print(json.dumps({"root": str(root), "times": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
