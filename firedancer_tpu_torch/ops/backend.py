"""Device policy of the port, the counterpart of
``firedancer_tpu/ops/backend.py:27-46``.

* Entry points run on the card: ``default_device()`` is a CUDA device of
  compute capability 9.x (Hopper), and raises when there is none. The
  CPU is used only when a caller asks for it.
* Each op dispatches on the device of its input tensor (``use_kernel``):
  a CPU tensor takes the plain PyTorch version, a CUDA tensor launches
  the hand-written kernel or raises. A CUDA tensor is never served by a
  plain version, and no flag changes that.
* Every kernel wrapper counts its launches and every plain version its
  calls, so a run can show which path it took.
"""

from __future__ import annotations

import threading

import torch

# kernel name -> launches / plain-version calls since reset_counts(),
# updated under _count_lock: the verify tiles of several lanes launch
# from their own threads, and a read-modify-write of a dict entry can
# lose a count between two threads.
launches: dict[str, int] = {}
plain_calls: dict[str, int] = {}
_count_lock = threading.Lock()


def hopper_available() -> bool:
    """A CUDA device of compute capability 9.x is attached."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0)[0] == 9)


def default_device() -> torch.device:
    """The device an entry point runs on when the caller names none."""
    if not hopper_available():
        found = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                 else "no CUDA device")
        raise RuntimeError(
            "firedancer_tpu_torch needs a CUDA device of compute "
            f"capability 9.x (Hopper); found {found}. Pass device='cpu' "
            "to run the plain PyTorch version on the CPU."
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device) -> torch.device:
    """'cuda' (or None) -> the Hopper device, raising without one;
    'cpu' -> the CPU. Anything else is refused."""
    if device is None or torch.device(device).type == "cuda":
        return default_device()
    dev = torch.device(device)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (want cuda|cpu)")
    return dev


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the op's tensors lie on a CUDA device (launch the
    kernel), False when they lie on the CPU (run the plain version).
    Mixed or other devices raise."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        return True
    if types == {"cpu"}:
        return False
    raise ValueError(f"op inputs on devices {sorted(types)}; "
                     "want all cuda or all cpu")


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple) -> None:
    """A kernel's input contract: CUDA, dtype, shape (None = any) and
    contiguity. Raises ValueError naming the argument."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: kernel input must be on CUDA, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: want dtype {dtype}, got {t.dtype}")
    if len(shape) != t.dim() or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: want shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel input must be contiguous")


def count_launch(name: str) -> None:
    with _count_lock:
        launches[name] = launches.get(name, 0) + 1


def count_plain(name: str) -> None:
    with _count_lock:
        plain_calls[name] = plain_calls.get(name, 0) + 1


def reset_counts() -> None:
    with _count_lock:
        launches.clear()
        plain_calls.clear()
