"""Host milliseconds per call in the program's ``fetch`` spans, summed: every
device-to-host copy, with the wait for the work queued before it."""

from benchmark.program_spans import ms_per_call


def read(r):
    return ms_per_call(r, "compress", ("fetch",))
