"""Bytes per call, in 10^6 B, that the program's ``upload`` and ``fetch`` spans
count: every host-to-device and device-to-host copy."""

from benchmark.program_spans import copy_mb_per_call


def read(r):
    return copy_mb_per_call(r, "decompress")
