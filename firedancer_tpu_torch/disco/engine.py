"""Verify engines, the counterpart of ``firedancer_tpu/disco/engine.py``
(``EngineSpec``:83, ``drain_mode``:162, ``EngineEntry``:273,
``EngineRegistry.acquire``:519, the RLC build at :618-634, the drain
filter's warm at :677-687).

``registry().acquire(EngineSpec(mode, 8192))`` is the entry a user calls:
it resolves the device (the Hopper card unless the caller passes
``device="cpu"``; no card raises), builds the kernels, and warms the
engine with one zero batch. ``entry.fn(msgs, lens, sigs, pubs)`` returns
(B,) int32 statuses on the engine's device in ``direct`` mode, and an
``RlcAsyncResult`` in ``rlc`` mode: one RLC pass (MSM plan ``spec.msm``,
the baseline ``u7`` by default; front half ``spec.frontend``, "fused" by
default or "staged", the JAX package's ``FD_FRONTEND_IMPL`` auto and xla
on its accelerator, ``current_frontend``:77) whose per-lane fallback, the
direct path, runs only when the batch equation fails.
``np.asarray(result)`` gives the statuses. The fd_drain pre-filter
rides a verify tile's dispatches on the entry's device when the tile's
``drain`` mode (``resolve_drain_mode``) arms it: ``warm_drain`` runs it
once at the batch's shape and ``snapshot()["drain"]`` says so.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..msm_plan import parse_plan
from ..ops import backend, build
from ..ops.dedup_filter import dedup_filter, empty_banks
from ..ops.frontend_cuda import DEFAULT_FRONTEND, FRONTENDS
from ..ops.verify import verify_batch
from ..ops.verify_rlc import make_async_verifier

ENGINE_COLD = "cold"
ENGINE_WARM = "warm"
ENGINE_FAILED = "failed"


@dataclass(frozen=True)
class EngineSpec:
    """An engine's identity: verify mode, batch size, the MSM plan token
    of rlc mode (msm_plan.parse_plan; direct mode runs no MSM) and the
    front half of rlc mode (frontend_cuda.FRONTENDS; the direct path has
    one front half)."""

    mode: str        # "direct" | "rlc"
    batch: int
    msm: str = "u7"
    frontend: str = DEFAULT_FRONTEND

    @property
    def key(self) -> str:
        return f"{self.mode}:B{self.batch}:fe{self.frontend}:{self.msm}"

    @classmethod
    def for_tile(cls, backend: str, verify_mode: str,
                 batch: int) -> "EngineSpec":
        """The spec a VerifyTile's dispatches are keyed by: the resolved
        verify mode on the card's backend ("gpu"), the backend's name on
        a host backend ("oracle"), as the JAX package's
        ``EngineSpec.for_tile``:120 keys them."""
        return cls(verify_mode if backend == "gpu" else backend, batch)


# The verify tile's backends: "gpu" dispatches batches to an engine of
# this registry, "oracle" verifies each transaction on the host with the
# port's copy of the oracle.
TILE_BACKENDS = ("gpu", "oracle")


def default_verify_mode() -> str:
    """The verify mode "auto" resolves to on the card: "direct" at every
    batch size. At B = 8192 (H100 80GB HBM3, 700 W; chip_smoke.py
    phases 4-5, PERF.md section 5) a clean RLC pass keeps the device
    busy 2.71-2.72 ms, 2.2x a whole direct batch (1.24-1.25 ms by CUDA
    events), and its host clock with the read-back ran 20-27 ms against
    direct's 1.25. A batch-size sweep may revise this per B."""
    return "direct"


def resolve_verify_mode(backend: str, verify_mode: str) -> str:
    """A VerifyTile's verify mode. "auto" resolves to
    default_verify_mode() ("direct"); "direct" and "rlc" stand as given.
    Raises on an unknown mode or backend, and on "rlc" with the
    "oracle" backend, which has no batch engine for the RLC pass to run
    on: the one genuinely unsupported combination."""
    if verify_mode not in ("auto", "direct", "rlc"):
        raise ValueError(f"unknown verify_mode {verify_mode!r} "
                         "(want auto|direct|rlc)")
    if backend not in TILE_BACKENDS:
        raise ValueError(f"unknown verify backend {backend!r} "
                         f"(want {'|'.join(TILE_BACKENDS)})")
    if verify_mode == "auto":
        return default_verify_mode()
    if verify_mode == "rlc" and backend != "gpu":
        raise ValueError(
            "verify_mode='rlc' requires backend='gpu' (the host oracle "
            "has no batch engine for the RLC pass: the one genuinely "
            "unsupported combination)")
    return verify_mode


# The fd_drain modes: "auto" arms the dedup pre-filter behind every batch
# of the fd_feed runtime's verify tile, "off" disables it (the A/B hatch).
DRAIN_MODES = ("auto", "off")


def resolve_drain_mode(mode: str) -> str:
    """A verify tile's fd_drain mode, the counterpart of the JAX
    ``drain_mode``:162 (its FD_DRAIN flag; the port takes the mode as an
    argument). Raises on anything but "auto" and "off": a mistyped mode
    must not pass for a measurement of either arm."""
    if mode not in DRAIN_MODES:
        raise ValueError(f"unknown drain mode {mode!r} (want auto|off)")
    return mode


class EngineEntry:
    """One prepared verify engine on one device. ``fn`` is the verify
    callable; the dispatch counters and the service EMA are written by
    the one thread that dispatches on the engine."""

    def __init__(self, spec: EngineSpec, device: torch.device):
        self.spec = spec
        self.key = spec.key
        self.device = device
        self.state = ENGINE_COLD
        self.err: str | None = None
        self.warm_s = 0.0          # seconds of the last warm pass
        self.dispatches = 0
        self.lanes = 0
        self.service_ns = 0        # EMA of dispatch -> complete wall ns
        self._warmed: set = set()  # max_msg_len values warmed
        self._drain_warmed: set = set()  # h_bits values warmed
        self._lock = threading.Lock()
        self._verify = verify_batch
        if spec.mode == "rlc":
            self._verify = make_async_verifier(
                verify_batch, plan=parse_plan(spec.msm),
                frontend=spec.frontend)

    def fn(self, msgs, lens, sigs, pubs):
        """Verify one batch. Inputs are tensors or arrays; they are moved
        to the engine's device. Returns without waiting for the device:
        statuses (direct) or an RlcAsyncResult (rlc)."""
        dev = self.device
        args = [torch.as_tensor(a).to(dev, non_blocking=True)
                for a in (msgs, lens, sigs, pubs)]
        self.note_dispatch(args[0].shape[0])
        return self._verify(*args)

    def note_dispatch(self, lanes: int) -> None:
        self.dispatches += 1
        self.lanes += lanes

    def note_service(self, ns: int) -> None:
        """A measured dispatch -> complete time: EMA(1/8)."""
        self.service_ns = (ns if not self.service_ns
                           else (7 * self.service_ns + ns) // 8)

    def warm(self, max_msg_len: int = 1232) -> bool:
        """Build the kernels (on CUDA) and run one zero batch at
        (batch, max_msg_len): in rlc mode through the RLC pass (its
        front half in spec.frontend) and its direct fallback both.
        Returns True when this call warmed."""
        with self._lock:
            if max_msg_len in self._warmed:
                return False
            b = self.spec.batch
            t0 = time.perf_counter()
            try:
                if self.device.type == "cuda":
                    build.build_all()
                zeros = (
                    torch.zeros(b, max_msg_len, dtype=torch.uint8,
                                device=self.device),
                    torch.zeros(b, dtype=torch.int32, device=self.device),
                    torch.zeros(b, 64, dtype=torch.uint8, device=self.device),
                    torch.zeros(b, 32, dtype=torch.uint8, device=self.device))
                verify_batch(*zeros).cpu()
                if self.spec.mode == "rlc":
                    np.asarray(self._verify(*zeros))
            except Exception as exc:
                self.state = ENGINE_FAILED
                self.err = repr(exc)[:200]
                raise
            self.warm_s = time.perf_counter() - t0
            self._warmed.add(max_msg_len)
            self.state = ENGINE_WARM
            self.err = None
            return True

    @property
    def drain(self) -> bool:
        """The drain's pre-filter rides this engine (warm_drain ran)."""
        return bool(self._drain_warmed)

    def warm_drain(self, h_bits: int) -> bool:
        """Run the drain's pre-filter once on one lane and once on the
        batch's lanes, with an h_bits window, on the engine's device
        (building the kernels first on CUDA), so the first filter of a
        run loads nothing whichever launch its staged txns take. Returns
        True when this call warmed."""
        with self._lock:
            if h_bits in self._drain_warmed:
                return False
            if self.device.type == "cuda":
                build.build_all()
            for n in sorted({1, self.spec.batch}):
                zeros = torch.zeros(n, dtype=torch.int32, device=self.device)
                valid = torch.zeros(n, dtype=torch.bool, device=self.device)
                _, _, cnt = dedup_filter(zeros, zeros, valid,
                                         *empty_banks(h_bits, self.device))
                int(cnt)
            self._drain_warmed.add(h_bits)
            return True

    def snapshot(self) -> dict:
        return {"key": self.key, "mode": self.spec.mode,
                "batch": self.spec.batch, "msm": self.spec.msm,
                "frontend": self.spec.frontend,
                "device": str(self.device), "drain": self.drain,
                "state": self.state, "warm_s": round(self.warm_s, 3),
                "dispatches": self.dispatches, "lanes": self.lanes,
                "service_ns": self.service_ns, "err": self.err}


class EngineRegistry:
    """Process-wide map (spec, device) -> EngineEntry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[tuple[EngineSpec, torch.device], EngineEntry] = {}

    def acquire(self, spec: EngineSpec, warm: bool = True,
                device="cuda", max_msg_len: int = 1232):
        """Resolve an engine for dispatch: (entry, warmed_now). device
        'cuda' needs a card of compute capability 9.x and raises
        RuntimeError without one; the CPU runs only when asked for."""
        if spec.mode not in ("direct", "rlc"):
            raise ValueError(f"unknown verify mode {spec.mode!r} "
                             "(want direct|rlc)")
        parse_plan(spec.msm)
        if spec.frontend not in FRONTENDS:
            raise ValueError(f"unknown frontend {spec.frontend!r} (want "
                             f"{'|'.join(FRONTENDS)})")
        dev = backend.resolve_device(device)
        with self._lock:
            e = self._entries.get((spec, dev))
            if e is None:
                e = EngineEntry(spec, dev)
                self._entries[(spec, dev)] = e
        warmed_now = e.warm(max_msg_len) if warm else False
        return e, warmed_now

    def entries(self) -> list[EngineEntry]:
        with self._lock:
            return list(self._entries.values())

    def snapshot(self) -> list[dict]:
        return [e.snapshot() for e in self.entries()]


_REGISTRY = EngineRegistry()


def registry() -> EngineRegistry:
    return _REGISTRY
