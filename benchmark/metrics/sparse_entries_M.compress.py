"""Sparse-channel entries per call, in 10^6, that the program's ``sparse``
spans decode (their ``entries`` field, the blocks' summed ``n_sp``): the
work the fused route hands the host decode."""

from benchmark.program_spans import window


def read(r):
    spans = window(r) if r.direction == "compress" else None
    picked = [s for s in spans or () if s.name == "sparse"]
    if not picked:
        return None
    return sum(s.fields["entries"] for s in picked) / 1e6 / r.calls
