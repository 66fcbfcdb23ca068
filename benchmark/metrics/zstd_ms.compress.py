"""Host milliseconds per call in the program's ``sections`` span: ``build_archive``
compressing every section (its thread pool's wall time)."""

from benchmark.program_spans import ms_per_call


def read(r):
    return ms_per_call(r, "compress", ("sections",))
