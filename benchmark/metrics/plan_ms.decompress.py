"""Host milliseconds per call in ``Decoder._plan`` (the metadata sections,
the sequence section's zstd, ``build_plan``), from the benchmark's span
around that method; nothing where the name is gone."""

from benchmark.readings import span_ms_per_call


def read(r):
    return span_ms_per_call(r, r.spans, "plan") if r.direction == "decompress" else None
