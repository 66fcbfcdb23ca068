"""Host milliseconds per call in the program's ``build-plan`` span
(``parallel/decode.py:build_plan``: the prefix sums and the header blob)."""

from benchmark.program_spans import ms_per_call


def read(r):
    return ms_per_call(r, "decompress", ("build-plan",))
