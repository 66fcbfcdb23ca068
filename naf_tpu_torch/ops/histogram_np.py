"""Byte histograms on the host: --charcount and the unexpected-character
report.

The port's copy of the numpy half of ``naf_tpu/ops/histogram.py``.
Reference parity: unnaf/src/output.c:544-605 (charcount),
ennaf/src/process.c:75-96 (unexpected-char report).
"""

from __future__ import annotations

import numpy as np


def charcount_np(data: np.ndarray) -> np.ndarray:
    return np.bincount(data, minlength=256).astype(np.uint64)


def format_charcount(counts: np.ndarray) -> str:
    """Exact --charcount rendering (output.c:602-604)."""
    lines = []
    for i in range(0, 33):
        if counts[i]:
            lines.append("\\x%02X\t%d\n" % (i, counts[i]))
    for i in range(33, 127):
        if counts[i]:
            lines.append("%c\t%d\n" % (chr(i), counts[i]))
    for i in range(127, 256):
        if counts[i]:
            lines.append("\\x%02X\t%d\n" % (i, counts[i]))
    return "".join(lines)


def format_unexpected_report(counts: np.ndarray, kind_name: str) -> str:
    """Exact stderr report (process.c:75-87); counts has 257 bins (EOF last)."""
    total = int(counts.sum())
    if total == 0:
        return ""
    lines = [f"input has {total} unexpected {kind_name} characters:\n"]
    for i in range(0, 32):
        if counts[i]:
            lines.append("    '\\x%02X': %d\n" % (i, counts[i]))
    for i in range(32, 127):
        if counts[i]:
            lines.append("    '%c': %d\n" % (chr(i), counts[i]))
    for i in range(127, 256):
        if counts[i]:
            lines.append("    '\\x%02X': %d\n" % (i, counts[i]))
    if len(counts) > 256 and counts[256]:
        lines.append("    EOF: %d\n" % counts[256])
    return "".join(lines)
