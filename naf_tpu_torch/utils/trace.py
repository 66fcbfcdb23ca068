"""Stage tracing and profiling: naf_tpu's stderr lines, an in-memory span
tree, and ``torch.profiler`` ranges, from one ``trace_span``.

  * ``NAF_TPU_TRACE`` (any non-empty value, ``0`` included) turns tracing
    on.  Every span is then recorded in memory (``spans()``): its id, its
    parent's and its root's, its name, its start and end on
    ``time.perf_counter_ns()``, its thread and its fields.  Only the four
    stages naf_tpu prints (``PRINTED``: the section decompress
    ``seq-unzstd`` and ``seq+qual-unzstd``, the host ``render``, each
    piece of a streamed encode, ``scan``) write their line to stderr, in
    naf_tpu's format; every other span is silent there.  ``ENABLED`` takes
    its default from the variable at import and is read at each span's
    entry, so assigning ``trace.ENABLED`` later turns tracing on or off.
  * While a ``torch.profiler`` session records, each span is also a
    ``record_function`` range of its name, so a trace shows the program's
    stages beside the kernels and copies on one clock.  Nothing here
    imports torch: the check runs only where torch is already loaded.
  * ``NAF_TPU_PROFILE=dir`` — ``tnaf``/``untnaf --device`` run their
    device work under ``torch.profiler`` (the CPU, and CUDA when a card is
    present) and write one Chrome/Perfetto JSON trace into ``dir``, named
    by the process id so that the two processes of a pipe keep theirs.

Usage::

    with trace_span("upload", bytes=rows.nbytes):
        ...
    with trace_span("zstd", section=name):
        sec = job()
        note(out=len(sec.payload))       # a field known only at the end

A span's parent is the innermost span open in its context
(``contextvars``); work handed to another thread keeps it through
``bind``.  The record keeps the last ``CAP`` spans and counts the ones it
dropped.  With tracing off and no profiler recording, a span costs a flag
check: no field is formatted and no clock is read.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import itertools
import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional

ENABLED = bool(os.environ.get("NAF_TPU_TRACE"))

#: the stages whose line naf_tpu prints to stderr
PRINTED = frozenset({"seq-unzstd", "seq+qual-unzstd", "render", "scan"})
#: the most spans the record keeps; older ones are dropped and counted
CAP = 65536


@dataclass(frozen=True)
class Span:
    id: int
    parent: Optional[int]      # the enclosing span's id; None for a root
    root: int                  # the root's id (a root's own)
    name: str
    start_ns: int              # time.perf_counter_ns()
    end_ns: int
    thread: int                # threading.get_ident() of the thread it ran on
    fields: dict


class _Open:
    """A span while it is open: what its children and ``note`` need."""

    __slots__ = ("id", "root", "fields")

    def __init__(self, sid: int, root: "Optional[_Open]", fields: dict):
        self.id, self.root, self.fields = sid, root or self, fields


_CURRENT: contextvars.ContextVar = contextvars.ContextVar("naf_tpu_trace_span", default=None)
_LOCK = threading.Lock()
_SPANS: collections.deque = collections.deque(maxlen=CAP)
_IDS = itertools.count(1)
_dropped = 0


def _profiling() -> bool:
    """A ``torch.profiler`` session records; never imports torch."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd.profiler._is_profiler_enabled


@contextlib.contextmanager
def trace_span(stage: str, **fields):
    """Time a stage: recorded with ``fields`` when tracing is on (and, for
    ``PRINTED`` stages, '[naf-trace] stage 12.3ms k=v' on stderr), a
    profiler range while a profiler records."""
    on, profiling = ENABLED, _profiling()
    if not (on or profiling):
        yield
        return
    rf = None
    if profiling:
        rf = sys.modules["torch"].autograd.profiler.record_function(stage)
        rf.__enter__()
    opened = token = None
    if on:
        parent = _CURRENT.get()
        opened = _Open(next(_IDS), parent and parent.root, dict(fields))
        token = _CURRENT.set(opened)
        t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        if opened is not None:
            t1 = time.perf_counter_ns()
            _CURRENT.reset(token)
            _record(Span(opened.id, parent and parent.id, opened.root.id, stage, t0, t1,
                         threading.get_ident(), opened.fields))
            if stage in PRINTED:
                _print(stage, (t1 - t0) / 1e6, fields)
        if rf is not None:
            rf.__exit__(None, None, None)


def _print(stage: str, dt: float, fields: dict) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    mbs = ""
    if "bytes" in fields and dt > 0:
        mbs = f" ({fields['bytes'] / dt / 1048.576:.0f} MB/s)"
    print(f"[naf-trace] {stage:<16} {dt:9.2f} ms{mbs} {extra}", file=sys.stderr)


def _record(span: Span) -> None:
    global _dropped
    with _LOCK:
        if len(_SPANS) == CAP:
            _dropped += 1
        _SPANS.append(span)


def note(**fields) -> None:
    """Add fields known only at the end to the innermost open span."""
    if ENABLED:
        cur = _CURRENT.get()
        if cur is not None:
            cur.fields.update(fields)


def note_root(**fields) -> None:
    """Add fields to the root of the open spans (a call's route)."""
    if ENABLED:
        cur = _CURRENT.get()
        if cur is not None:
            cur.root.fields.update(fields)


def bind(fn):
    """``fn`` to run in a copy of the caller's context: the spans it opens
    on a worker thread name the caller's open span as their parent."""
    return functools.partial(contextvars.copy_context().run, fn)


def spans() -> list:
    """A copy of the recorded spans, in the order they closed."""
    with _LOCK:
        return list(_SPANS)


def dropped() -> int:
    """Spans dropped from the record since the last ``clear()``."""
    return _dropped


def clear() -> None:
    global _dropped
    with _LOCK:
        _SPANS.clear()
        _dropped = 0


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
