"""Security / capability reporting (fdctl security.c analog), a copy of
``firedancer_tpu/app/security.py`` (``check``:160, ``report``:210). It
reads the host's limits and capabilities and changes nothing.

The reference's `fdctl` checks, per configure stage, which privileges
the current process holds vs needs (root or CAP_SYS_ADMIN for
hugepages, CAP_NET_RAW for XDP, ...) and prints an actionable report
(app/fdctl/security.c). The same shape here: each requirement knows how
to probe itself and what would need it, so `fdctl security` (or a
pre-run check) explains exactly what a non-root operator is missing —
and what this environment makes N/A (no XDP path, no hugepage mounts).
"""

from __future__ import annotations

import ctypes
import json
import os
import resource
from dataclasses import dataclass
from typing import List


@dataclass
class Requirement:
    name: str
    needed_for: str
    ok: bool
    detail: str


def _capget_bits() -> int | None:
    """Effective capability bits via capget(2) — needs no /proc.

    _LINUX_CAPABILITY_VERSION_3 uses two 32-bit data slots (low/high
    words of the 64-bit sets). Returns None if the call is unavailable.
    """
    import ctypes

    class _Hdr(ctypes.Structure):
        _fields_ = [("version", ctypes.c_uint32), ("pid", ctypes.c_int)]

    class _Data(ctypes.Structure):
        _fields_ = [
            ("effective", ctypes.c_uint32),
            ("permitted", ctypes.c_uint32),
            ("inheritable", ctypes.c_uint32),
        ]

    try:
        libc = ctypes.CDLL(None, use_errno=True)
        hdr = _Hdr(0x20080522, 0)
        data = (_Data * 2)()
        if libc.capget(ctypes.byref(hdr), ctypes.byref(data)) != 0:
            return None
        return data[0].effective | (data[1].effective << 32)
    except Exception:
        return None


def _cap_bits() -> int:
    """Effective capability bits of this process.

    When /proc is unavailable (chroot, minimal container) CapEff cannot
    be read; probe capget(2) directly instead. euid is deliberately
    NOT consulted: euid 0 is routine in capability-dropped containers
    and user namespaces, and inferring a full mask from it would let
    requirement checks pass for capabilities the process does not hold
    (round-2 ADVICE finding). If both probes fail, claim nothing — an
    under-claim fails loudly at the operation, an over-claim fails
    silently in production.
    """
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("CapEff:"):
                    return int(line.split()[1], 16)
    except OSError:
        bits = _capget_bits()
        if bits is not None:
            return bits
    return 0


CAP_NET_RAW = 13
CAP_SYS_ADMIN = 21
CAP_IPC_LOCK = 14


def _has_cap(bit: int) -> bool:
    # Trust CapEff, not euid: root in a capability-dropped container
    # (default Docker) lacks e.g. CAP_SYS_ADMIN even with euid 0 —
    # reporting by euid would be exactly the false positive a
    # capability report exists to prevent. Real root has full CapEff.
    return bool(_cap_bits() & (1 << bit))


def _can_unshare_user() -> bool:
    """Probe user-namespace availability by ACTUALLY unsharing in a
    forked child — distro knobs vary (Debian unprivileged_userns_clone,
    Ubuntu apparmor_restrict_unprivileged_userns, user.max_user_namespaces)
    and reading one of them misses the others."""
    CLONE_NEWUSER = 0x10000000
    # Load libc BEFORE forking: dlopen allocates, and doing that in the
    # child of a threaded process (JAX spins up threads) can deadlock on
    # a lock some other thread held at fork time.
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        pid = os.fork()
    except (OSError, MemoryError):
        # fork can fail under RLIMIT_NPROC / cgroup pids limits — the
        # very environments this report diagnoses. Report unavailable
        # rather than crash the whole report.
        return False
    if pid == 0:  # child: report via exit status
        try:
            os._exit(0 if libc.unshare(CLONE_NEWUSER) == 0 else 1)
        except BaseException:
            os._exit(1)
    _, status = os.waitpid(pid, 0)
    return os.waitstatus_to_exitcode(status) == 0


def _memlock_ok() -> bool:
    soft, _ = resource.getrlimit(resource.RLIMIT_MEMLOCK)
    return soft == resource.RLIM_INFINITY or soft >= (1 << 26) or \
        _has_cap(CAP_IPC_LOCK)


def _no_new_privs_settable() -> bool:
    PR_GET_NO_NEW_PRIVS = 39
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        return libc.prctl(PR_GET_NO_NEW_PRIVS, 0, 0, 0, 0) >= 0
    except OSError:
        return False


def _thp_page_size() -> int:
    """Transparent-hugepage size the wksp's MADV_HUGEPAGE can use
    (native/tango.cc fd_wksp_page_probe); 0 when THP is off. Falls back
    to reading /sys directly if the native library is unavailable."""
    try:
        from ..tango.rings import lib

        return int(lib().fd_wksp_page_probe())
    except Exception:
        try:
            with open(
                "/sys/kernel/mm/transparent_hugepage/enabled"
            ) as f:
                if "[never]" in f.read():
                    return 0
            with open(
                "/sys/kernel/mm/transparent_hugepage/hpage_pmd_size"
            ) as f:
                return int(f.read().strip())
        except OSError:
            return 0


def check() -> List[Requirement]:
    """Probe every privilege the configure/run stages can use."""
    reqs = [
        Requirement(
            "root-or-sys-admin",
            "hugetlbfs mounts + sysctl stages (reference fd_shmem ladder)",
            _has_cap(CAP_SYS_ADMIN),
            f"euid={os.geteuid()} capeff={_cap_bits():#x}",
        ),
        Requirement(
            "hugepages",
            "TLB relief for workspace mappings (wksp madvise(MADV_HUGEPAGE))",
            _thp_page_size() > 0,
            f"transparent_hugepage pmd size={_thp_page_size()} bytes"
            " (0 = THP disabled; wksp falls back to base pages)",
        ),
        Requirement(
            "net-raw",
            "XDP/AF_XDP kernel bypass (N/A here: recvmmsg batch backend)",
            _has_cap(CAP_NET_RAW),
            "needed only for the reference's fd_xsk path",
        ),
        Requirement(
            "memlock",
            "pinning ring/staging memory (large RLIMIT_MEMLOCK or ipc_lock)",
            _memlock_ok(),
            f"rlimit_memlock={resource.getrlimit(resource.RLIMIT_MEMLOCK)}",
        ),
        Requirement(
            "userns",
            "sandbox namespace isolation (utils/sandbox.unshare_namespaces)",
            _can_unshare_user(),
            "unprivileged user namespaces",
        ),
        Requirement(
            "no-new-privs",
            "sandbox privilege lock (utils/sandbox.no_new_privs)",
            _no_new_privs_settable(),
            "prctl(PR_SET_NO_NEW_PRIVS)",
        ),
        Requirement(
            "nofile",
            "QUIC socket fan-out + workspace files",
            resource.getrlimit(resource.RLIMIT_NOFILE)[0] >= 1024,
            f"rlimit_nofile={resource.getrlimit(resource.RLIMIT_NOFILE)}",
        ),
    ]
    return reqs


def report(as_json: bool = False) -> str:
    reqs = check()
    if as_json:
        return json.dumps([r.__dict__ for r in reqs])
    lines = []
    for r in reqs:
        lines.append(f"[{'ok' if r.ok else '--'}] {r.name:18s} {r.needed_for}")
        lines.append(f"     {r.detail}")
    return "\n".join(lines)
