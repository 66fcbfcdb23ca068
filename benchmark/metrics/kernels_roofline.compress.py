"""The least time of one call's work (its text and the archive's
uncompressed sections, once each, at the card's memory bandwidth) over the
kernel time per call summed over the cards."""

from benchmark.readings import kernels_roofline


def read(r):
    return kernels_roofline(r, "compress")
