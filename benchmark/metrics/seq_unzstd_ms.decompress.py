"""Host milliseconds per call of the program's own ``seq-unzstd`` span
(``Decoder._load_seq_raw``), read from its ``[naf-trace]`` lines."""

from benchmark.readings import span_ms_per_call


def read(r):
    if r.direction != "decompress":
        return None
    return span_ms_per_call(r, r.program_spans, "seq-unzstd")
