"""Run a cell with the control in the program's place and print the numbers
its check compares: the reference's output for the records with the
configuration's control applied (a guarantee broken, ``controls.py``).  The
check has to come out not correct.  The benchmark's own runs never run this.

    python3 benchmark/control.py --workload <cell> --seed <n> --seconds <s> --trace 0
"""

import sys
import time

T0 = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark.harness import control_op, main

    sys.exit(main(sys.argv[1:], t0=T0, wrap_op=control_op))
