#!/usr/bin/env python3
"""Time the FASTA emit and classify kernels of several checkouts of the port
on one CUDA card, in the order given and then in reverse (A B B A).

    python3 kernel_ab.py DIR DIR [DIR ...] [--reps 10]

Each DIR is the root of a checkout (the directory that holds
``naf_tpu_torch/``), for example an older commit unpacked with
``git archive`` into a directory that .gitignore lists.  All checkouts
build their kernels first, side by side; nvcc's resource log of each goes
to standard error.  Then each timing runs in a process of its own with its
checkout first on ``sys.path``.  The input is chip_smoke.py's phase-2 FASTA
block (bench.py's gen_fasta_single(128) as one block); each time is the
CUDA-event mean over --reps calls after a warm-up, and ``passes_ms`` the
device time of each CUDA kernel inside the emit call (torch.profiler, mean
over --reps calls).  One JSON line per timing, then the card's name and
power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent


def child(root: str, what: str, reps: int) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import naf_tpu_torch
    from naf_tpu_torch.native import build

    if not naf_tpu_torch.__file__.startswith(str(Path(root).resolve())):
        raise AssertionError(f"imported {naf_tpu_torch.__file__}, not the one under {root}")
    build.library()
    if what == "build":
        print(build.BUILD_INFO.get("log", ""), file=sys.stderr)
        return
    sys.path.insert(1, str(HERE))
    import bench
    from naf_tpu_torch.ops import emit_fused as EF
    from naf_tpu_torch.ops import scan_fused as SF
    from naf_tpu_torch.parallel.block import make_blocks
    from torch.profiler import ProfilerActivity, profile

    data = bench.gen_fasta_single(128)
    blk = make_blocks(np.frombuffer(data, np.uint8)[data.index(b">") + 1:], 1)
    x = torch.from_numpy(blk.data[0].copy()).to("cuda")
    prev = int(blk.prev[0])

    def cuda_time(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    emit = lambda: EF.emit_fasta_kernel(x, prev)  # noqa: E731
    row = {"root": root, "block": x.numel(), "emit_fasta_ms": cuda_time(emit),
           "classify_fasta_ms": cuda_time(lambda: SF.classify_fasta_kernel(x, prev))}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            emit()
        torch.cuda.synchronize()
    passes = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name if "naf" in e.name else "torch ops"
            passes[name] += e.device_time_total / 1e3 / reps
    row["passes_ms"] = dict(sorted(passes.items()))
    print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--child", choices=("build", "time"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.roots[0], args.child, args.reps)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2

    def run(root: str, what: str) -> str:
        r = subprocess.run([sys.executable, __file__, root, "--reps", str(args.reps),
                            "--child", what], capture_output=True, text=True, timeout=900)
        if r.returncode:
            raise RuntimeError(f"{what} of {root} failed:\n{r.stderr[-4000:]}")
        if what == "build":
            print(f"== {root}\n{r.stderr}", file=sys.stderr, flush=True)
        return r.stdout

    with ThreadPoolExecutor(len(args.roots)) as ex:
        list(ex.map(run, args.roots, ["build"] * len(args.roots)))
    for root in args.roots + args.roots[::-1]:
        sys.stdout.write(run(root, "time"))
        sys.stdout.flush()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
