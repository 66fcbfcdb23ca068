"""glibc allocator tuning for the large-buffer host pipeline.

The chunked pipelines allocate and free many multi-MB numpy buffers. glibc
serves blocks above M_MMAP_THRESHOLD (default 128 KB, dynamically up to
32 MB) with mmap/munmap, so every chunk cycle pays a TLB shootdown plus
fresh page-zeroing — measured ~21 ms per 32 MB buffer on a 2-core VM,
i.e. several *seconds* of system time per 300 MB file. Raising the
threshold keeps big blocks on the heap where glibc reuses them.

Trade-off: freed heap pages are returned to the OS less eagerly. For a
codec process whose working set is O(chunk size) that is the right trade.

The port's copy of ``naf_tpu/utils/malloc.py``; the tests hold the two against each other.
"""

from __future__ import annotations

_done = False

# glibc malloc.h constants
_M_MMAP_THRESHOLD = -3


def tune_for_large_buffers(threshold: int = 1 << 30) -> None:
    """Raise glibc's mmap threshold (idempotent; no-op on non-glibc)."""
    global _done
    if _done:
        return
    _done = True
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        libc.mallopt(ctypes.c_int(_M_MMAP_THRESHOLD), ctypes.c_int(threshold))
    except Exception:
        pass
