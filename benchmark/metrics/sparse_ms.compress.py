"""Host milliseconds per call in the program's ``sparse`` spans: the fused
parses' host decode of the tagged sparse channel (comment and id bytes,
record starts, case changes) into the blocks' rows, after their fetches."""

from benchmark.program_spans import ms_per_call


def read(r):
    return ms_per_call(r, "compress", ("sparse",))
