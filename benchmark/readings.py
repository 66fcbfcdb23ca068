"""What a run measured, as the metric readers under ``metrics/`` take it.

Each reader is a file ``metrics/<metric name>.py`` with ``read(r:
Readings)``, which returns the metric's value or None where the run has
nothing to read for it (another direction, a span the program no longer
has, a trace without device operations); the harness leaves a None out of
the result line.  The helpers below are what several readers share.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .devtrace import DeviceTrace


@dataclass
class Readings:
    direction: str                    # "compress" or "decompress"
    setup_s: float                    # process start to the first timed call
    window_s: float                   # the window's first call's start to its last's end
    calls: int                        # calls in the window
    bytes_in: int                     # the window's calls' input bytes
    bytes_out: int                    # the window's calls' output bytes
    device_routes: int = 0            # the window's calls counted on a device route
    spans: dict = field(default_factory=dict)      # benchmark span -> [s], traced window
    program_spans: dict = field(default_factory=dict)  # the program's [naf-trace] stage -> [s]
    trace: Optional[DeviceTrace] = None            # profiled calls, traced run
    bound_s: Optional[float] = None   # least seconds of one call's work on one card


def span_ms_per_call(r: Readings, spans: dict, name: str):
    """A span's host-clock milliseconds per call of the window, or None
    where the span never ran."""
    s = spans.get(name)
    if not s or not r.calls:
        return None
    return sum(s) / r.calls * 1e3


def route_pct(r: Readings, direction: str):
    if r.direction != direction or not r.calls:
        return None
    return 100.0 * r.device_routes / r.calls


def copy_ms(r: Readings, direction: str):
    t = r.trace
    if r.direction != direction or t is None or not sum(t.copy_s.values()):
        return None
    return sum(t.copy_s.values()) / t.calls * 1e3


def kernels_roofline(r: Readings, direction: str):
    """The least time of one call's work over the kernel time per call,
    summed over the cards; memcpy and memset are not kernels."""
    t = r.trace
    if r.direction != direction or t is None or r.bound_s is None:
        return None
    kernel = sum(t.kernel_s.values()) / t.calls
    return 100.0 * r.bound_s / kernel if kernel > 0 else None


def device_idle_pct(r: Readings, direction: str):
    """The share of the profiled calls' wall time in which no operation
    ran on a card, the mean over the cell's cards."""
    t = r.trace
    if r.direction != direction or t is None or not t.busy_s or not sum(t.busy_s.values()):
        return None
    busy = sum(t.busy_s.values()) / len(t.busy_s)
    return 100.0 * (1 - busy / t.window_s)
