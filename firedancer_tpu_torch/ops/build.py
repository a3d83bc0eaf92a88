"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` of ``KERNELS`` becomes its own shared library
(``msm_tails.cu`` includes ``msm_horner.cu`` and ``msm_order.cu``, its
two roles), compiled by ``nvcc``
for ``sm_90a`` into ``build/torch_kernels/`` at the repository root (a
directory git ignores). The sources are built on first use, one ``nvcc``
per source, all started together. A library's file name carries a stamp
hashed from every source and the flags, so an edited source is rebuilt
and a stale library is never loaded.

There is no fallback: when ``nvcc`` is missing or a build fails this
raises, with nvcc's own message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("sha512_mod_l", "decompress_so", "double_scalarmult", "point_eq",
           "msm_fill", "msm_aggregate", "msm_tails",
           "frontend_rlc", "decompress_niels", "sha512_batch", "sc_reduce",
           "fe_pow", "compress", "pack_gc", "dedup_filter")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def find_nvcc() -> str:
    """Path of nvcc: PATH first, then $CUDA_HOME/bin, /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the CUDA toolkit is needed to build firedancer_tpu_torch's kernels"
    )


def stamp() -> str:
    """Hash of every kernel source and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{stamp()}.so"


def ptxas_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{stamp()}.ptxas.txt"


def all_built() -> bool:
    """Every kernel's library of this source stamp is built."""
    return all(lib_path(k).exists() for k in KERNELS)


def build_all() -> dict[str, Path]:
    """Compile every kernel whose library is missing; returns the paths.
    Raises RuntimeError with nvcc's stderr when a build fails."""
    todo = [k for k in KERNELS if not lib_path(k).exists()]
    if todo:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for k in todo:
            tmp = lib_path(k).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{k}.cu")]
            procs[k] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        errors = []
        for k, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {k}.cu (rc "
                              f"{proc.returncode}):\n{err}{out}")
                continue
            ptxas_path(k).write_text(err + out)
            os.replace(tmp, lib_path(k))
        if errors:
            raise RuntimeError("\n".join(errors))
    return {k: lib_path(k) for k in KERNELS}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building all kernels first if
    needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _libs[name] = lib
        return lib


def bind(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point of a kernel's library with its argument types
    declared (c_void_p for every pointer and the stream) and an int
    return code (a cudaError_t, 0 on success)."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn


def check_rc(symbol: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{symbol} failed with cudaError_t {rc}")


def ptxas_report() -> dict[str, str]:
    """nvcc -Xptxas -v output (registers, spills) per built kernel."""
    return {k: ptxas_path(k).read_text() for k in KERNELS
            if ptxas_path(k).exists()}
