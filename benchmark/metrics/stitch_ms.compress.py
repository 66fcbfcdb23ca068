"""Host milliseconds per call in ``parallel/pipeline.py:_stitch_and_build``
(the carry stitch, the sections' zstd, the container), from the benchmark's
span around that module attribute; nothing where the name is gone."""

from benchmark.readings import span_ms_per_call


def read(r):
    return span_ms_per_call(r, r.spans, "stitch") if r.direction == "compress" else None
