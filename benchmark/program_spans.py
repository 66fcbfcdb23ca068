"""The program's own spans of a traced run's window, from the in-memory
record of ``naf_tpu_torch/utils/trace.py`` (``trace.spans()``).

A traced run turns the program's tracing on before its import, so the
record holds the warm-up calls, the profiled calls and then the window's,
each call a tree under one root span (``encode`` or ``decode``).
``window`` keeps the trees of the last ``r.calls`` roots, the window's.  It
gives None where there are fewer roots (the control, which never calls the
program) or no record (a program without one), and the metrics that read
it then find nothing.
"""

from __future__ import annotations

ROOTS = ("encode", "decode")


def window(r):
    """The spans of the window's calls, or None."""
    from naf_tpu_torch.utils import trace

    record = getattr(trace, "spans", None)
    if record is None or not r.calls:
        return None
    spans = record()
    roots = [s.id for s in spans if s.parent is None and s.name in ROOTS]
    if len(roots) < r.calls:
        return None
    keep = set(roots[-r.calls:])
    return [s for s in spans if s.root in keep]


def ms_per_call(r, direction: str, names: tuple):
    """The summed host milliseconds of the window's spans named ``names``,
    per call; None where none ran."""
    spans = window(r) if r.direction == direction else None
    picked = [s for s in spans or () if s.name in names]
    if not picked:
        return None
    return sum(s.end_ns - s.start_ns for s in picked) / 1e6 / r.calls


def copy_mb_per_call(r, direction: str):
    """The bytes the window's uploads and fetches moved, in 10^6 B per
    call; None where none ran."""
    spans = window(r) if r.direction == direction else None
    picked = [s for s in spans or () if s.name in ("upload", "fetch")]
    if not picked:
        return None
    return sum(s.fields["bytes"] for s in picked) / 1e6 / r.calls
