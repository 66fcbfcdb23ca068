"""Host milliseconds per call in the program's ``unzstd`` and ``seq-unzstd``
spans, summed: every section's decompress."""

from benchmark.program_spans import ms_per_call


def read(r):
    return ms_per_call(r, "decompress", ("unzstd", "seq-unzstd"))
