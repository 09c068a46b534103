"""Host allocator pooling for large-array precompute stages.

The host precompute path (SSP log marshalling, ELL staging,
Galerkin pattern builds) allocates and frees many multi-hundred-MB NumPy
temporaries. glibc serves those via mmap and returns the pages to the
kernel on free, so EVERY temporary pays first-touch page-fault cost.
On the sandboxed kernels this framework targets, that cost is extreme
(np.arange of 17.7M elements has cost seconds freshly mapped against
hundredths of a second from pooled pages). Keeping freed pages in the
process heap makes the cost a one-time warmup.

The reference implementation never hits this because Eigen's workspaces
live for the whole decimation (src/SSP_midpoint.cpp keeps V/F/E buffers
across all collapses); our staged array pipeline is the device-side
analog, so we restore the same "allocate once" economics at the
allocator level.

Trade-off: the heap grows to the high-water mark of host staging
(~10 GB at 2.6M-vertex scale) and is not returned until process exit.
Set SMC_TPU_NO_MALLOC_POOL=1 to opt out.
"""

from __future__ import annotations

import ctypes
import os

_M_TRIM_THRESHOLD = -1
_M_MMAP_MAX = -4

_applied = False


def pool_host_allocations() -> bool:
    """Keep freed large allocations in the process heap (glibc only).

    Idempotent, best-effort: returns True when both mallopt calls
    succeed, False on non-glibc platforms or opt-out.
    """
    global _applied
    if _applied:
        return True
    if os.environ.get("SMC_TPU_NO_MALLOC_POOL"):
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        ok = bool(libc.mallopt(_M_MMAP_MAX, 0))
        ok = bool(libc.mallopt(_M_TRIM_THRESHOLD, 2**31 - 1)) and ok
    except (OSError, AttributeError):
        return False
    _applied = ok
    return ok
