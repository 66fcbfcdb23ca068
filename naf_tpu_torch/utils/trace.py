"""Lightweight stage tracing / profiling, the port's copy of
``naf_tpu/utils/trace.py``.

  * ``NAF_TPU_TRACE`` (any non-empty value, ``0`` included) — per-stage
    wall times + byte counts to stderr, in naf_tpu's line format: the
    section decompress (``seq-unzstd``, ``seq+qual-unzstd``), the host
    render (``render``) and each piece of a streamed encode (``scan``);
  * ``NAF_TPU_PROFILE=dir`` — ``tnaf``/``untnaf --device`` run their
    device work under ``torch.profiler`` (the CPU, and CUDA when a card is
    present) and write one Chrome/Perfetto JSON trace into ``dir``, named
    by the process id so that the two processes of a pipe keep theirs.

Usage::

    with trace_span("scan", bytes=len(piece)):
        ...

Zero overhead when disabled (module-level flag check).  Importing this
module loads no torch; ``device_profile`` imports it when it profiles.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

ENABLED = bool(os.environ.get("NAF_TPU_TRACE"))


@contextlib.contextmanager
def trace_span(stage: str, **fields):
    """Time a pipeline stage; prints '[naf-trace] stage 12.3ms k=v' when on."""
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = (time.perf_counter() - t0) * 1e3
        extra = " ".join(f"{k}={v}" for k, v in fields.items())
        mbs = ""
        if "bytes" in fields and dt > 0:
            mbs = f" ({fields['bytes'] / dt / 1048.576:.0f} MB/s)"
        print(f"[naf-trace] {stage:<16} {dt:9.2f} ms{mbs} {extra}",
              file=sys.stderr)


@contextlib.contextmanager
def device_profile():
    """A ``torch.profiler`` session around the body when NAF_TPU_PROFILE=dir
    is set, its trace written to ``dir/naf_tpu_torch.<pid>.trace.json`` when
    the body ends without an error.  A profiler that fails to start or to
    write raises.  The body's device work has ended when it returns: the
    CLI's outputs are on the host."""
    directory = os.environ.get("NAF_TPU_PROFILE")
    if not directory:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(directory, f"naf_tpu_torch.{os.getpid()}.trace.json"))
