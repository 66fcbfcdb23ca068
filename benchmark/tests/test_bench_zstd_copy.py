"""The metric read from the ``copied`` field of the program's ``zstd``
spans, the bytes the section compress copies on the host outside libzstd,
on the CPU at small sizes: a traced compress run reports it, 0 where every
section is handed to libzstd whole; a program whose spans lack the field
(as one before it) and the control, which never calls the program, report
nothing."""

import pytest
from test_bench_program_spans import traced, traced_run  # noqa: F401  (fixture)

from benchmark import harness

METRIC = "zstd_copy_MB.compress"


@pytest.mark.parametrize("cell", ["chr1.compress", "reads.compress"])
def test_compress_run_reads_the_copied_bytes(cell, small_root, capsys, traced):
    m = traced_run(small_root, cell, capsys)
    assert m[METRIC] == 0.0
    assert m["zstd_ms.compress"] > 0


def test_no_metric_without_the_field(small_root, capsys, traced, monkeypatch):
    from naf_tpu_torch.pipeline import encoder
    from naf_tpu_torch.utils import trace

    monkeypatch.setattr(encoder, "note", lambda **f: trace.note(
        **{k: v for k, v in f.items() if k != "copied"}))
    m = traced_run(small_root, "chr1.compress", capsys)
    assert "zstd_ms.compress" in m
    assert METRIC not in m


def test_no_metric_in_the_control(small_root, capsys, traced):
    m = traced_run(small_root, "chr1.compress", capsys, wrap_op=harness.control_op)
    assert METRIC not in m
