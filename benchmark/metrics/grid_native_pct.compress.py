"""Share of the window's ``grid`` spans, in %, whose FASTQ grid check ran
as the host library's one pass (their ``native`` field 1) and not as the
numpy fallback."""

from benchmark.program_spans import window


def read(r):
    spans = window(r) if r.direction == "compress" else None
    picked = [s for s in spans or () if s.name == "grid"]
    if not picked:
        return None
    return 100.0 * sum(s.fields["native"] for s in picked) / len(picked)
