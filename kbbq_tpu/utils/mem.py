"""Memory helpers: device routing budgets, and host buffers that fault
in 2 MB pages.

Device budgets (`device_budget`): the engines pick a route by how many
bytes a run would hold on one device.  Each budget is a fixed share of
the device's own `bytes_limit`; on the CPU backend, which reports no
device memory, the same shares of 16 GiB (`CPU_BUDGETS`) apply — the
sizes the CPU test suite routes by.

Host buffers (docs/KNOWN_ISSUES.md #2): first-touch minor faults on
fresh anonymous memory have been measured at ~375 us per fault-around
block on a loaded host (~40x normal), and glibc returns >=32 MB blocks
to the OS via munmap, so every large numpy temp can re-pay the fault
storm.  MADV_HUGEPAGE on the backing pages (THP in madvise mode) cuts
the fault count ~500x.  `hugepage_empty` is np.empty + that madvise;
use it for every large host buffer on a hot path.
"""

from __future__ import annotations

import ctypes

import numpy as np

_MADV_HUGEPAGE = 14
_HP = 2 << 20                     # THP size
try:
    _libc = ctypes.CDLL("libc.so.6", use_errno=True)
except OSError:                   # non-glibc platform: plain empty
    _libc = None


# sixteenths of device memory per routing budget
_BUDGET_SHARES = {
    "resident": 6,       # whole-dataset resident engine (~6 B/base)
    "replicated": 4,     # both filters' staging, per device (replicated)
    "dense_build": 3,    # sort-build k-mer triples (~9 B/k-mer)
    "window_cache": 2,   # streamed engine's packed device window cache
}
CPU_BUDGETS = {name: share << 30 for name, share in _BUDGET_SHARES.items()}


def _default_device():
    import jax
    return jax.devices()[0]


def device_budget(name: str, device=None) -> int:
    """Bytes the `name` route may hold on `device` (default: the first
    device).  An accelerator that reports no `bytes_limit` is an error:
    a guessed size would route runs the device cannot hold."""
    if device is None:
        device = _default_device()
    share = _BUDGET_SHARES[name]
    if device.platform == "cpu":
        return CPU_BUDGETS[name]
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"{device.platform} device {device.device_kind!r} reports no "
            f"bytes_limit; cannot size the {name!r} budget")
    return int(limit) * share // 16


def madvise_hugepage(arr: np.ndarray) -> None:
    """Best-effort MADV_HUGEPAGE over an array's backing pages."""
    if _libc is None or arr.nbytes < (4 << 20):
        return
    addr = arr.ctypes.data
    base = addr & ~(_HP - 1)
    _libc.madvise(ctypes.c_void_p(base),
                  ctypes.c_size_t(arr.nbytes + (addr - base)),
                  _MADV_HUGEPAGE)


def hugepage_empty(shape, dtype) -> np.ndarray:
    """np.empty whose first touch faults 2 MB pages instead of 4 KB."""
    a = np.empty(shape, dtype)
    madvise_hugepage(a)
    return a
