"""The import guard, on top-level module names compared whole: nothing
under ``benchmark/`` imports ``jax`` or ``naf_tpu`` (``naf_tpu_torch``
begins with ``naf_tpu`` and is allowed), nothing under
``benchmark/reference/`` imports ``naf_tpu_torch``, and nothing reads the
repository's older benchmark scripts."""

import ast
import subprocess
import sys

import pytest
from bench_cases import REPO

BENCH = REPO / "benchmark"
OLD = ("bench", "stage_probe", "chip_smoke", "kernel_ab")


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_naf_tpu(path):
    tops = imported_tops(path)
    assert not tops & {"jax", "jaxlib", "flax", "naf_tpu", *OLD}
    if "reference" in path.parts:
        assert not tops & {"naf_tpu_torch", "torch", "benchmark"}


def test_whole_name_compare():
    from benchmark.harness import forbidden_modules

    sys.modules["naf_tpu_torch_like"] = sys.modules["sys"]
    try:
        assert "naf_tpu_torch_like" not in forbidden_modules()
    finally:
        del sys.modules["naf_tpu_torch_like"]


def test_no_old_files_read():
    names = ("bench.py", "stage_probe.py", "chip_smoke.py", "kernel_ab.py", "BENCH_r", "MULTICHIP_r")
    for p in BENCH.rglob("*"):
        if p.suffix == ".py" and "tests" not in p.parts:
            assert not any(n in p.read_text() for n in names), p


def test_reference_loads_no_program():
    """In a fresh process, the reference's encode and decode load neither
    torch nor naf_tpu_torch."""
    code = ("import sys, io; sys.path.insert(0, %r)\n"
            "from benchmark.reference import encoder as E, decoder as D, records\n"
            "a = E.encode(b'>x\\nACGT\\n', E.EncodeOptions())[0]\n"
            "D.Decoder(io.BytesIO(a)).fasta()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'naf_tpu_torch', 'naf_tpu', 'jax')]\n"
            "assert not bad, bad\n" % str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
