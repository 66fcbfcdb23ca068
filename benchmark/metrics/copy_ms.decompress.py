"""Memcpy milliseconds per call on the profiler's trace, summed over the
cell's cards: the uploads and the fetches."""

from benchmark.readings import copy_ms


def read(r):
    return copy_ms(r, "decompress")
