"""The benchmark's own spans around calls into the program's layers, and the
program's ``[naf-trace]`` lines, read in the traced run.

``Spans.wrap`` puts a timer around a module attribute of the program (a
function, or a method named ``Class.method``), so every call through that
name records its host-clock seconds under a span name; a name the program
no longer has is left out, and the metrics that read it find nothing.  With
``annotate`` on, each span is also a ``torch.profiler.record_function``
range, so the profiler's trace shows what the host did while the card
idled.  ``Spans.tap_stderr`` collects the lines the program's own
``utils/trace.py`` prints to stderr and passes every other line on.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import re
import sys
import time

_TRACE_LINE = re.compile(r"\[naf-trace\]\s+(\S+)\s+([0-9.]+) ms")


class Spans:
    def __init__(self):
        self.seconds: dict[str, list[float]] = {}
        self.program: dict[str, list[float]] = {}
        self.annotate = False
        self.on = False
        self._undo: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        rf = None
        if self.annotate:
            from torch.profiler import record_function

            rf = record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)

    def wrap(self, module: str, attr: str, name: str) -> bool:
        """Time every call of ``module.attr`` (``attr`` may be
        ``Class.method``) as span ``name``; False where it is gone."""
        owner = importlib.import_module(module)
        *path, last = attr.split(".")
        for part in path:
            owner = getattr(owner, part, None)
            if owner is None:
                return False
        fn = getattr(owner, last, None)
        if not callable(fn):
            return False

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        setattr(owner, last, timed)
        self._undo.append((owner, last, fn))
        return True

    def unwrap(self) -> None:
        while self._undo:
            owner, last, fn = self._undo.pop()
            setattr(owner, last, fn)

    def clear(self) -> None:
        self.seconds.clear()
        self.program.clear()

    @contextlib.contextmanager
    def tap_stderr(self):
        """Collect the program's ``[naf-trace]`` lines (stage, ms) while the
        body runs."""
        real = sys.stderr
        tap = _Tap(real, self.program)
        sys.stderr = tap
        try:
            yield
        finally:
            tap.flush_partial()
            sys.stderr = real


class _Tap:
    def __init__(self, real, sink: dict):
        self._real, self._sink, self._buf = real, sink, ""

    def write(self, s: str) -> int:
        self._buf += s
        *lines, self._buf = self._buf.split("\n")
        for line in lines:
            self._line(line)
        return len(s)

    def _line(self, line: str) -> None:
        m = _TRACE_LINE.search(line)
        if m:
            self._sink.setdefault(m.group(1), []).append(float(m.group(2)) / 1e3)
        else:
            self._real.write(line + "\n")

    def flush_partial(self) -> None:
        if self._buf:
            self._line(self._buf)
            self._buf = ""

    def flush(self) -> None:
        self._real.flush()

    def __getattr__(self, name):
        return getattr(self._real, name)
