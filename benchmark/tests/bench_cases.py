"""What the benchmark's CPU tests share: a copy of the benchmark's data
files with the configurations cut to a size the CPU runs in seconds."""

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: the keys each configuration has replaced in the small copies
SMALL = {
    "hg38-chr1.l1": {"records": [{"id": "chr1", "comment": "", "length": 300_007}],
                     "bases": {"copy_unit": 65536, "copy_share": 0.35, "copy_divergence": 0.002},
                     "gaps": {"ends": 1000, "large": {"size": 20000, "at": 0.5},
                              "sizes": [124, 500, 3000]},
                     "threads": 2},
    "sra-novaseq-150.l1": {"spots": 1500, "threads": 2},
}


def copy_benchmark(dst: Path) -> Path:
    """The benchmark's files under ``dst``, with small configurations."""
    shutil.copytree(REPO / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dst)
    for name, cut in SMALL.items():
        path = dst / "benchmark" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(cut)
        path.write_text(json.dumps(cfg))
    return dst

