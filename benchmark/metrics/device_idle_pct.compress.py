"""The share of the profiled calls' wall time in which no operation ran
on a card: the union of kernel, memcpy and memset intervals, the mean over
the cell's cards."""

from benchmark.readings import device_idle_pct


def read(r):
    return device_idle_pct(r, "compress")
