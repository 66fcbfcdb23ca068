"""The share of the window's calls that took a device route of the decompress
entry point (``device.ROUTES``)."""

from benchmark.readings import route_pct


def read(r):
    return route_pct(r, "decompress")
