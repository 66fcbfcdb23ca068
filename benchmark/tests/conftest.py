"""Fixtures of the benchmark's CPU tests.  Run them from the root of the
repository: ``python -m pytest benchmark/tests -q``."""

import json

import pytest
from bench_cases import REPO, copy_benchmark


@pytest.fixture
def small_root(tmp_path):
    return copy_benchmark(tmp_path)


@pytest.fixture(scope="session")
def spec() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())
