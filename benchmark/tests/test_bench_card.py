"""The benchmark on the card: every cell once, one second, from a
subprocess, as a check of the benchmark runs it.  Skips without enough cards.

    python -m pytest benchmark/tests/test_bench_card.py -q -m cuda
"""

import json
import subprocess
import sys

import pytest
from bench_cases import REPO


@pytest.mark.cuda
@pytest.mark.parametrize("cell,chips", [("chr1.compress", 1), ("reads.decompress", 1),
                                        ("reads.compress", 1), ("chr1.compress.mesh4", 4)])
def test_cell_on_the_card(cell, chips):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                        str(2**31 + 31), "--seconds", "1", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == chips
