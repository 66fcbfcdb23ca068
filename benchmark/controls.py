"""The controls: the reference put in the program's place with one of the
configuration's guarantees broken.  Each takes a data set and returns the
records a lossy archiver would keep; the reference then archives or renders
those, and the run's comparison has to find them wrong.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def fold_case(ds):
    """The soft mask dropped: every base upper case (``--no-mask`` kept as
    if the case did not matter)."""
    seq = np.where((ds.seq >= 97) & (ds.seq <= 122), ds.seq - 32, ds.seq).astype(np.uint8)
    return dataclasses.replace(ds, seq=seq)


def rebin_quality(ds):
    """NovaSeq's ':' quality bin merged into 'F' (a coarser binning)."""
    qual = np.where(ds.qual == ord(":"), np.uint8(ord("F")), ds.qual)
    return dataclasses.replace(ds, qual=qual)


CONTROLS = {"fold_case": fold_case, "rebin_quality": rebin_quality}
