#!/usr/bin/env python3
"""Time the FASTQ and FASTA emit kernels, the FASTA classify and the
compactions of several checkouts of the port on one CUDA card, in the
order given and then in reverse (A B B A).

    python3 kernel_ab.py DIR DIR [DIR ...] [--reps 10] [--fastq-only]

Each DIR is the root of a checkout (the directory that holds
``naf_tpu_torch/``), for example an older commit unpacked with
``git archive`` into a directory that .gitignore lists.  All checkouts
build their kernels first, side by side; nvcc's resource log of each goes
to standard error.  Then each timing runs in a process of its own with its
checkout first on ``sys.path``.  The inputs are chip_smoke.py's phase-2
shapes, made by this checkout's chip_smoke.py: the FASTQ block (bench.py's
gen_fastq(500_000, read_len=150) as make_blocks_fastq cuts it), the FASTA
block (bench.py's gen_fasta_single(128) as one block) and the three
compaction calls on the swissprot_like(160) block and its masks.  Each
time is the CUDA-event mean over --reps calls after a warm-up
(``classify_fastq_ms``: the standalone FASTQ classify on the FASTQ block);
``fastq_passes_ms``, ``passes_ms`` and ``<call>_launches_ms`` give the
device time of each launch inside one FASTQ emit, FASTA emit or compaction
call (torch.profiler, mean over --reps calls; the torch ops between the
launches summed as "torch ops").  One JSON line per timing, then the
card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent


def child(root: str, what: str, reps: int, fastq_only: bool) -> None:
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
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    from naf_tpu_torch.ops import compact as CP
    from naf_tpu_torch.ops import emit_fused as EF
    from naf_tpu_torch.ops import scan_fused as SF
    from naf_tpu_torch.parallel.block import make_blocks, make_blocks_fastq
    from torch.profiler import ProfilerActivity, profile

    def passes_ms(fn) -> dict:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        passes = defaultdict(float)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.split("(")[0].removeprefix("void ")
                name = name if "naf" in name else "torch ops"
                passes[name] += e.device_time_total / 1e3 / reps
        return dict(sorted(passes.items()))

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

    fq = bench.gen_fastq(500_000, read_len=150)
    qblocks, _ = make_blocks_fastq(np.frombuffer(fq, np.uint8)[1:], 1)
    xq = torch.from_numpy(qblocks.data[0].copy()).to("cuda")
    prev_q = int(qblocks.prev[0])
    emit_q = lambda: EF.emit_fastq_kernel(xq, prev_q)  # noqa: E731
    fastq_row = {"fastq_block": xq.numel(), "emit_fastq_ms": cuda_time(emit_q),
                 "classify_fastq_ms": cuda_time(lambda: SF.classify_fastq_kernel(xq, prev_q))}
    emit_q()
    fastq_row["fastq_passes_ms"] = passes_ms(emit_q)
    del xq, qblocks, fq
    torch.cuda.empty_cache()
    if fastq_only:
        print(json.dumps({"root": root, **fastq_row}), flush=True)
        return

    emit = lambda: EF.emit_fasta_kernel(x, prev)  # noqa: E731
    row = {"root": root, **fastq_row, "block": x.numel(), "emit_fasta_ms": cuda_time(emit),
           "classify_fasta_ms": cuda_time(lambda: SF.classify_fasta_kernel(x, prev))}
    row["passes_ms"] = passes_ms(emit)
    xp, sm, pos = CS.protein_masks(CS.swissprot_like(160), "cuda")
    for key, _, vals, kp, dense, *_ in CS.compactions(xp, sm, pos):
        call = lambda: CP.compact_kernel(vals, kp, dense=dense)  # noqa: E731
        row[f"{key}_ms"] = cuda_time(call)
        row[f"{key}_launches_ms"] = CS.launch_split(call, reps)
    print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--fastq-only", action="store_true")
    ap.add_argument("--child", choices=("build", "time"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.roots[0], args.child, args.reps, args.fastq_only)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2

    def run(root: str, what: str) -> str:
        r = subprocess.run([sys.executable, __file__, root, "--reps", str(args.reps),
                            "--child", what] + ["--fastq-only"] * args.fastq_only,
                           capture_output=True, text=True, timeout=900)
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
