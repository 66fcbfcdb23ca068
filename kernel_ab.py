#!/usr/bin/env python3
"""Time the port's kernels in several checkouts on one CUDA card, in the
order given and then in reverse (A B B A).

    python3 kernel_ab.py DIR DIR [DIR ...] [--reps 10]
                         [--only fastq|scans|classify|mask|ragged|match]

Each DIR is the root of a checkout (the directory that holds
``naf_tpu_torch/``), for example an older commit unpacked with
``git archive`` into a directory that .gitignore lists.  All checkouts
build their kernels first, side by side; nvcc's resource log of each goes
to standard error.  Then each timing runs in a process of its own with its
checkout first on ``sys.path``.  The inputs are chip_smoke.py's phase-2
shapes, made by this checkout's chip_smoke.py: the FASTQ emit and classify
on the FASTQ block (bench.py's gen_fastq(500_000, read_len=150) as
make_blocks_fastq cuts it); the FASTA emit and classify on the FASTA block
(bench.py's gen_fasta_single(128) as one block), and pack, unpack and mask
parity on that emit's sequence stream; the add and max scans and the three
compactions on the swissprot_like(160) block and its masks.  Each time is
the CUDA-event mean over --reps calls after a warm-up.
``fastq_passes_ms``, ``passes_ms``, ``scan_launches_ms`` and
``<call>_launches_ms`` give the device time of each launch inside one FASTQ
emit, FASTA emit, scan or compaction call (torch.profiler, mean over --reps
calls; the wrapper's zeroing of its scratch as "scratch memset" or as
torch's fill kernel, any other torch op as "torch ops" or by its name).
``two_pass_ms`` gives the device-resident two-pass encode (the two passes
on one block) and one ragged render batch of swissprot_like(160),
illumina_reads_fasta(750_000) and sra_fastq(400_000), whose archives each
checkout's host encode() writes (chip_smoke.py's two_pass_device_ms).
--only fastq times the FASTQ emit and classify alone; --only scans the two
scans alone, beside a plain copy of the same bytes (``bool_to_i32_ms``,
``i32_clone_ms``: torch's conversion and clone, what moving them costs
without a scan); --only classify the FASTA classify alone on the FASTA
block and on the swissprot_like(160) block (as protein), and the FASTQ
classify alone on the FASTQ block and on the sra_fastq(400_000) block as
its two-pass path cuts it (keys ``fastq`` and ``sra``), each with its
launch split, beside a copy that reads each byte once and writes it twice
(``copy_1to2_ms``: torch's contiguous copy of the block broadcast to
[n, 2], what moving the bytes costs without a classify); --only mask the
mask parity alone on the FASTA block's chars and toggles (key ``fasta``)
and on the same chars under a toggle every 1-3 bytes (``dense``,
chip_smoke.py's dense_toggles), each with its launch split and the
host's time a call when nothing waits for the card (``host_enqueue_ms``),
beside a pass that reads two bytes and writes one (``copy_2to1_ms``:
torch's bitwise_xor of chars and toggles, what moving the bytes costs
without a parity); --only ragged the one-card device decode
(``fasta_device`` / ``fastq_device``, which both render ragged) of the three
two-pass inputs' archives, end to end, the best wall seconds of --reps
calls with the routes and launches of one call; --only match the device
engine's two kernels (csrc/matchfind.cu) at chip_smoke.py's phase-9
shapes (``engine_windows``: the last span of gen_fasta_single(252)'s
packed SEQ in a window padded to 2^27 positions, depth 16, and its anchor
pass over the raw FASTA, 2^28 bytes, depth 1), the keys and the chain of
each (key ``window`` / ``anchor``), the chain also over the span's last
position alone (``match_chain_one_row_ms``: the pass over order with
next to no rows) and at depth 1 (``match_chain_k1_ms``), beside
``torch.sort(stable=True)`` of the same keys (``sort_ms``) and torch's
``index_copy_`` of the span's [rows, k] int32 rows in the order the chain
writes them (``rows_scatter_ms``: what scattering them costs without a
chain).  One JSON line per timing, then the card's name and
power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import importlib.util
import io
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent


def child(root: str, what: str, reps: int, only: str | None) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import naf_tpu_torch
    from naf_tpu_torch.native import build

    if not Path(naf_tpu_torch.__file__).resolve().is_relative_to(Path(root).resolve()):
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
    from naf_tpu_torch.format import constants as C
    from naf_tpu_torch.ops import compact as CP
    from naf_tpu_torch.ops import emit_fused as EF
    from naf_tpu_torch.ops import pack as PK
    from naf_tpu_torch.ops import scan_fused as SF
    from naf_tpu_torch.ops import unpack as UP
    from naf_tpu_torch.parallel.block import make_blocks, make_blocks_fastq
    from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode
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
                if "naf" not in name:
                    name = "scratch memset" if "FillFunctor" in name else "torch ops"
                passes[name] += e.device_time_total / 1e3 / reps
        return dict(sorted(passes.items()))

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

    def enqueue_time(fn) -> float:
        """Host ms per call of reps calls made without waiting for the card."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return ms

    def scans(keep, code) -> dict:
        row = {"scan_launches_ms": {}}
        for key, inp, op in (("cumsum_i32", keep, "add"), ("maxscan_i32", code, "max")):
            call = lambda: SF.scan_i32_kernel(inp, op)  # noqa: E731
            row[f"{key}_ms"] = cuda_time(call)
            row["scan_launches_ms"][key] = CS.launch_split(call, reps)
        return row

    def two_pass_inputs(protein: bytes) -> list:
        return [("swissprot_like(160)", protein, C.SEQ_TYPE_PROTEIN, False),
                ("illumina_reads_fasta(750000)", CS.illumina_reads_fasta(750_000),
                 C.SEQ_TYPE_DNA, False),
                ("sra_fastq(400000)", CS.sra_fastq(400_000), C.SEQ_TYPE_DNA, True)]

    if only == "ragged":
        from naf_tpu_torch import device as D
        from naf_tpu_torch.pipeline.decoder import Decoder, fasta_device, fastq_device

        row = {"root": root, "ragged_decode": {}}
        for name, data, seq_type, fastq in two_pass_inputs(CS.swissprot_like(160)):
            o = EncodeOptions(level=1, threads=os.cpu_count() or 0, seq_type=seq_type)
            blob = encode(data, o)[0]

            def decode():
                d = Decoder(io.BytesIO(blob))
                out = fastq_device(d, device="cuda") if fastq else fasta_device(d, device="cuda")
                torch.cuda.synchronize()
                return out

            decode()
            D.reset_counts()
            n_out = len(decode())
            counted = {"routes": dict(D.ROUTES),
                       "launches": {k: v for k, v in D.LAUNCHES.items() if v}}
            times = []
            for _ in range(reps):
                t = time.perf_counter()
                decode()
                times.append(time.perf_counter() - t)
            row["ragged_decode"][name] = {"seconds": min(times), "output_bytes": n_out,
                                          **counted}
        print(json.dumps(row), flush=True)
        return

    if only == "match":
        from naf_tpu_torch.ops import matchfind as MF

        big = bench.gen_fasta_single(252)
        seq, _ = CS.sections(big)
        row = {"root": root}
        for label, anchor, k, n, lo, wlo, win, cap in CS.engine_windows(seq, big, "cuda"):
            keys = MF.match_keys_kernel(win, cap, anchor=anchor)
            sk, order = torch.sort(keys, stable=True)
            stride = 8 if anchor else 1
            # the span's rows in the order the chain writes them (sorted
            # entries), what scattering them costs without a chain
            sel = order[((order + 1) * stride > lo - wlo) & (order * stride < n - wlo)]
            q = (sel[:, None] * stride + torch.arange(stride, device="cuda")).reshape(-1)
            q = q[(q >= lo - wlo) & (q < n - wlo)] - (lo - wlo)
            rows = torch.empty((n - lo, k), dtype=torch.int32, device="cuda")
            vals = torch.zeros((q.numel(), k), dtype=torch.int32, device="cuda")
            row[label] = {
                "window": win.numel(), "cap": cap, "span": [lo - wlo, n - wlo], "k": k,
                "match_keys_ms": cuda_time(lambda: MF.match_keys_kernel(win, cap, anchor=anchor)),
                "match_chain_ms": cuda_time(lambda: MF.match_chain_kernel(
                    sk, order, k, lo - wlo, n - wlo, stride=stride, wlo=wlo)),
                "match_chain_one_row_ms": cuda_time(lambda: MF.match_chain_kernel(
                    sk, order, k, n - wlo - 1, n - wlo, stride=stride, wlo=wlo)),
                "match_chain_k1_ms": cuda_time(lambda: MF.match_chain_kernel(
                    sk, order, 1, lo - wlo, n - wlo, stride=stride, wlo=wlo)),
                "rows_scatter_ms": cuda_time(lambda: rows.index_copy_(0, q, vals)),
                "sort_ms": cuda_time(lambda: torch.sort(keys, stable=True))}
            del win, keys, sk, order, sel, q, rows, vals
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        return

    if only == "classify":
        row = {"root": root}
        for key, data, seq_type in (
                ("fasta", bench.gen_fasta_single(128), C.SEQ_TYPE_DNA),
                ("protein", CS.swissprot_like(160), C.SEQ_TYPE_PROTEIN)):
            x, prev = CS.fasta_block(data, "cuda")
            call = lambda: SF.classify_fasta_kernel(x, prev, seq_type=seq_type)  # noqa: E731
            row[key] = {"block": x.numel(), "classify_fasta_ms": cuda_time(call),
                        "launches_ms": CS.launch_split(call, reps),
                        "copy_1to2_ms": cuda_time(
                            lambda: x.unsqueeze(1).expand(-1, 2).contiguous())}
            del x
            torch.cuda.empty_cache()
        for key, data in (("fastq", bench.gen_fastq(500_000, read_len=150)),
                          ("sra", CS.sra_fastq(400_000))):
            x, prev = CS.fastq_block(data, "cuda")
            call = lambda: SF.classify_fastq_kernel(x, prev)  # noqa: E731
            row[key] = {"block": x.numel(), "classify_fastq_ms": cuda_time(call),
                        "launches_ms": CS.launch_split(call, reps),
                        "copy_1to2_ms": cuda_time(
                            lambda: x.unsqueeze(1).expand(-1, 2).contiguous())}
            del x
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        return

    if only == "mask":
        x, prev = CS.fasta_block(bench.gen_fasta_single(128), "cuda")
        _, _, _, chars, tog = CS.render_inputs(EF.emit_fasta_kernel(x, prev))
        del x
        torch.cuda.empty_cache()
        row = {"root": root, "chars": chars.numel()}
        for key, t in (("fasta", tog), ("dense", CS.dense_toggles(chars.numel(), "cuda"))):
            call = lambda: EF.apply_mask_parity_kernel(chars, t)  # noqa: E731
            row[key] = {"apply_mask_parity_ms": cuda_time(call),
                        "host_enqueue_ms": enqueue_time(call),
                        "launches_ms": CS.launch_split(call, reps),
                        "copy_2to1_ms": cuda_time(lambda: torch.bitwise_xor(chars, t))}
        print(json.dumps(row), flush=True)
        return

    if only == "scans":
        xp, sm, pos = CS.protein_masks(CS.swissprot_like(160), "cuda")
        keep, code = CS.scan_inputs(xp, sm, pos)
        print(json.dumps({"root": root, **scans(keep, code),
                          "bool_to_i32_ms": cuda_time(lambda: keep.to(torch.int32)),
                          "i32_clone_ms": cuda_time(lambda: code.clone())}), flush=True)
        return

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
    if only == "fastq":
        print(json.dumps({"root": root, **fastq_row}), flush=True)
        return

    x, prev = CS.fasta_block(bench.gen_fasta_single(128), "cuda")
    emit = lambda: EF.emit_fasta_kernel(x, prev)  # noqa: E731
    row = {"root": root, **fastq_row, "block": x.numel(), "emit_fasta_ms": cuda_time(emit),
           "classify_fasta_ms": cuda_time(lambda: SF.classify_fasta_kernel(x, prev))}
    row["passes_ms"] = passes_ms(emit)
    sv, out_len, packed, chars, tog = CS.render_inputs(emit())
    row["pack_4bit_ms"] = cuda_time(lambda: PK.pack_4bit_kernel(sv, out_len=out_len))
    row["unpack_4bit_ms"] = cuda_time(lambda: UP.unpack_4bit_kernel(packed))
    row["apply_mask_parity_ms"] = cuda_time(lambda: EF.apply_mask_parity_kernel(chars, tog))
    del x, sv, packed, chars, tog
    torch.cuda.empty_cache()
    protein = CS.swissprot_like(160)
    xp, sm, pos = CS.protein_masks(protein, "cuda")
    row.update(scans(*CS.scan_inputs(xp, sm, pos)))
    for key, _, vals, kp, dense, *_ in CS.compactions(xp, sm, pos):
        call = lambda: CP.compact_kernel(vals, kp, dense=dense)  # noqa: E731
        row[f"{key}_ms"] = cuda_time(call)
        row[f"{key}_launches_ms"] = CS.launch_split(call, reps)
    del xp, sm, pos
    torch.cuda.empty_cache()
    row["two_pass_ms"] = {}
    for name, data, seq_type, fastq in two_pass_inputs(protein):
        o = EncodeOptions(level=1, threads=os.cpu_count() or 0, seq_type=seq_type)
        row["two_pass_ms"][name] = CS.two_pass_device_ms(data, o, encode(data, o)[0], fastq,
                                                         "cuda", reps)
    print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", choices=("fastq", "scans", "classify", "mask", "ragged", "match"))
    ap.add_argument("--child", choices=("build", "time"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.roots[0], args.child, args.reps, args.only)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2

    def run(root: str, what: str) -> str:
        r = subprocess.run([sys.executable, __file__, root, "--reps", str(args.reps),
                            "--child", what] + (["--only", args.only] if args.only else []),
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
