"""The two metrics read from the program's ``grid`` span, the FASTQ grid
check inside ``split``, on the CPU at small sizes: a traced
``reads.compress`` run reports its milliseconds a call and the share of
its spans on the host library's pass; a FASTA cell and the control of a
FASTQ cell, where no grid check runs, report neither."""

import pytest
from test_bench_program_spans import traced, traced_run  # noqa: F401  (fixture)

from benchmark import harness

GRID = ("grid_ms.compress", "grid_native_pct.compress")


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_fastq_run_reads_the_grid_spans(path, small_root, capsys, traced, monkeypatch):
    """The grid check's milliseconds a call above 0, and its native share
    100 with the host library and 0 without it."""
    from naf_tpu_torch.native import host as native

    if path == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    m = traced_run(small_root, "reads.compress", capsys)
    assert set(GRID) <= set(m)
    assert m["grid_ms.compress"] > 0
    assert m["grid_native_pct.compress"] == (100.0 if path == "native" else 0.0)


@pytest.mark.parametrize("cell,wrap", [("chr1.compress", None),
                                       ("reads.compress", harness.control_op)])
def test_grid_metrics_absent_without_a_grid_check(cell, wrap, small_root, capsys, traced):
    """Nothing of the grid check where none ran: a FASTA cell, which does
    not list the metrics, and the control of a FASTQ cell, which never calls
    the program."""
    m = traced_run(small_root, cell, capsys, **({"wrap_op": wrap} if wrap else {}))
    assert not set(GRID) & set(m)
