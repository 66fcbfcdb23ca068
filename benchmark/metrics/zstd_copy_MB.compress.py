"""Bytes a call, in 10^6 B, that the section compress copied on the host
outside libzstd: the ``copied`` field of the window's ``zstd`` spans
(staged pieces, joins, contiguity copies, the frame buffer's growth).  None
where no ``zstd`` span carries the field, as in a program without it."""

from benchmark.program_spans import window


def read(r):
    spans = window(r) if r.direction == "compress" else None
    picked = [s for s in spans or () if s.name == "zstd" and "copied" in s.fields]
    if not picked:
        return None
    return sum(s.fields["copied"] for s in picked) / 1e6 / r.calls
