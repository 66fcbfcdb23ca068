"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for
(``BENCHMARK.json``).  It exits with another code than 0, and prints no
result, where there is no CUDA card or too few.  See ``harness.py``.
"""

import sys
import time

T0 = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark.harness import main

    sys.exit(main(sys.argv[1:], t0=T0))
