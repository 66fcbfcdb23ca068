"""Host milliseconds per call in the program's ``carry`` span: ``_stitch_and_build``
from its entry to the ``build_archive`` call (the carry stitch)."""

from benchmark.program_spans import ms_per_call


def read(r):
    return ms_per_call(r, "compress", ("carry",))
