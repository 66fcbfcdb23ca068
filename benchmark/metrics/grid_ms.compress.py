"""Host milliseconds per call in the program's ``grid`` spans: the FASTQ
grid check and block cuts inside ``make_blocks_fastq``'s ``split``, before
the block copy."""

from benchmark.program_spans import ms_per_call


def read(r):
    return ms_per_call(r, "compress", ("grid",))
