#!/usr/bin/env python3
"""Drive naf_tpu_torch's device FASTA and FASTQ round trips once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. environment: card, power limit, CUDA and nvcc versions, kernel build;
  2. kernels: every kernel against its plain PyTorch version at the shapes
     of the main paths, byte for byte, with CUDA-event times and the bound
     (bytes the kernel must move over 3.35 TB/s: for an emit, the block,
     the kept prefix of each output stream and the used sparse entries;
     ``bound_padded_ms`` adds the zero fill up to the allocated sizes);
  3. encode: encode_device on bench.py's gen_fasta(64), gen_fasta_single(128),
     gen_masked_iupac_fasta(32), gen_fastq(250_000), gen_fastq(500_000,
     read_len=150) and a soft-masked FASTQ made here must equal the port's
     host encode() byte for byte;
  4. decode: fasta_device / fastq_device on those archives must equal the
     port's host Decoder and, for the unmasked FASTQ and the first two
     FASTA inputs, the input bytes; the third FASTA input (ragged) prints
     the route it took;
  5. rates: encode and decode MB/s, end to end and device-resident.
The FASTA path (phases 3-4 on the FASTA inputs) and the FASTQ path (on the
FASTQ inputs) each run with the launch counts set to 0 just before and read
just after; every kernel of a path must have launched in it, and the
kernels line sums the two.  The main paths never launch a standalone
classify: each emit runs its classify as device code inside its passes, so
a classify's row in the kernels line carries the emit's launches, says so
(``fused_into``), and gives its own count as ``standalone_launches``.  The
last line is the result.  Any failure
raises and exits non-zero.  nvcc's log (registers, shared memory and
spills of each kernel) goes to standard error.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time

#: the card's memory rate (H100 SXM data sheet): the bound of a kernel that
#: moves bytes
HBM_BYTES_PER_S = 3.35e12


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_time(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_time(fn, reps: int) -> float:
    """Best seconds of `reps` host-clocked calls, each ending synchronized."""
    import torch

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def tensors(x) -> list:
    if isinstance(x, dict):
        return [t for v in x.values() for t in tensors(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors(v)]
    return [x]


def bound_ms(inputs, outputs) -> float:
    """Least time to read every input once and write every output once."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors(inputs) + tensors(outputs))
    return nbytes / HBM_BYTES_PER_S * 1e3


def emit_bound_ms(block, out: dict, counts: tuple) -> float:
    """Least time for an emit's work as its consumer sees it: read the
    block, write each dense stream up to its count (``counts``), the used
    sparse entries (n_sp rows of every ``sp_*`` column) and the scalars."""
    n_sp = int(out["n_sp"])
    nbytes = block.numel() + sum(int(out[c]) for c in counts)
    nbytes += sum(n_sp * v.element_size() for k, v in out.items() if k.startswith("sp_")
                  and v.dim())
    nbytes += sum(v.element_size() for v in out.values() if v.dim() == 0)
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(a, b) -> int:
    """Largest absolute difference of two integer tensors (or dicts of them)."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"keys {sorted(a)} != {sorted(b)}")
        return max(max_abs_err(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{a.dtype}{tuple(a.shape)} != {b.dtype}{tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def masked_fastq(n_reads: int = 106_000, read_len: int = 150, seed: int = 7) -> bytes:
    """A soft-masked FASTQ of fixed-width reads (about 33 MB): lowercase
    runs of 20-3000 bases that cross read ends, so the emit's 32 KiB tile
    edges fall inside headers and quality lines between changes of case."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(n_reads, read_len))
    flat = seq.reshape(-1)
    for s, ln in zip(rng.integers(0, flat.size, size=n_reads // 6),
                     rng.integers(20, 3000, size=n_reads // 6)):
        flat[s:s + ln] |= 32
    qual = rng.integers(35, 74, size=(n_reads, read_len), dtype=np.uint8)
    ids = np.arange(n_reads)
    digits = np.stack([(ids // 10 ** k) % 10 + 48 for k in range(7, -1, -1)], 1)
    lf = np.full((n_reads, 1), 10, np.uint8)
    rows = np.concatenate([np.full((n_reads, 1), ord("@"), np.uint8),
                           np.full((n_reads, 1), ord("m"), np.uint8),
                           digits.astype(np.uint8), lf, seq, lf,
                           np.full((n_reads, 1), ord("+"), np.uint8), lf, qual, lf], 1)
    return rows.tobytes()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    import bench
    from naf_tpu_torch import device as D
    from naf_tpu_torch.native import build
    from naf_tpu_torch.ops import emit_fused as EF
    from naf_tpu_torch.ops import pack as PK
    from naf_tpu_torch.ops import scan_fused as SF
    from naf_tpu_torch.ops import unpack as UP
    from naf_tpu_torch.parallel import decode as PD
    from naf_tpu_torch.parallel.block import (fused_block, fused_block_fastq, make_blocks,
                                              make_blocks_fastq)
    from naf_tpu_torch.parallel.pipeline import encode_device
    from naf_tpu_torch.pipeline.decoder import DecodeOptions, Decoder, fasta_device, fastq_device
    from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode

    dev = D.cuda_device()
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # ---- 1. environment and build ---------------------------------------
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    print(build.BUILD_INFO.get("log", ""), file=sys.stderr, flush=True)
    try:
        import zstandard
        zstd_pkg = zstandard.__version__
    except ImportError:
        zstd_pkg = None
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc, "build_s": build_s,
          "zstandard_package": zstd_pkg, "library": build.BUILD_INFO["path"]})

    # ---- inputs (bench.py generators, and one made here) ------------------
    fasta_inputs = [("gen_fasta(64)", bench.gen_fasta(64)),
                    ("gen_fasta_single(128)", bench.gen_fasta_single(128)),
                    ("gen_masked_iupac_fasta(32)", bench.gen_masked_iupac_fasta(32))]
    fastq_inputs = [("gen_fastq(250000)", bench.gen_fastq(250_000)),
                    ("gen_fastq(500000,read_len=150)", bench.gen_fastq(500_000, read_len=150)),
                    ("masked_fastq(106000)", masked_fastq())]
    opts = EncodeOptions(level=1, threads=os.cpu_count() or 0)

    # ---- 2. kernels against their plain versions -----------------------
    kernel_rows = {}

    def check(kname, kfn, pfn, src, repl, shape, inputs, kout=None, pout=None, counts=None):
        kout = kfn() if kout is None else kout
        pout = pfn() if pout is None else pout
        torch.cuda.synchronize()
        err = max_abs_err(kout, pout)
        bound = bound_ms(inputs, kout)
        extra = {}
        if counts is not None:
            extra["bound_padded_ms"] = bound
            bound = emit_bound_ms(inputs[0], kout, counts)
        del kout, pout
        torch.cuda.empty_cache()
        ms = cuda_time(kfn, 10)
        plain_ms = cuda_time(pfn, 3)
        torch.cuda.empty_cache()
        row = {"name": kname, "route": "cuda", "source": src, "replaces": repl,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": "bytes", "library_ms": None, **extra}
        emit({"phase": "kernel", "shape": shape, "card": card, **row})
        if err != 0:
            raise AssertionError(f"{kname}: kernel differs from its plain version ({err})")
        kernel_rows[kname] = row

    # FASTQ: the full block of the 500,000-read input
    name, data = fastq_inputs[1]
    blocks, _ = make_blocks_fastq(np.frombuffer(data, np.uint8)[1:], 1)
    xq = torch.from_numpy(blocks.data[0].copy()).to(dev)
    prev_q = int(blocks.prev[0])
    shape = f"{name} block u8[{xq.numel()}]"
    check("emit_fastq", lambda: EF.emit_fastq_kernel(xq, prev_q),
          lambda: EF.emit_fastq_plain(xq, prev_q), "naf_tpu_torch/csrc/emit_fastq.cu",
          "naf_tpu/ops/emit_fused.py:515", shape, [xq], counts=("cnt", "cnt_qual", "cnt_id"))
    check("classify_fastq", lambda: SF.classify_fastq_kernel(xq, prev_q),
          lambda: SF.classify_fastq_plain(xq, prev_q),
          "naf_tpu_torch/csrc/classify_fastq.cu", "naf_tpu/ops/scan_fused.py:364", shape, [xq])
    del xq

    # FASTA: the block of the one-record input
    name, data = fasta_inputs[1]
    body = np.frombuffer(data, np.uint8)[data.index(b">") + 1:]
    blk = make_blocks(body, 1)
    x = torch.from_numpy(blk.data[0].copy()).to(dev)
    prev = int(blk.prev[0])
    shape = f"{name} block u8[{x.numel()}]"
    kern = EF.emit_fasta_kernel(x, prev)
    sv = kern["sv"]
    cnt = int(kern["cnt"])
    check("emit_fasta", lambda: EF.emit_fasta_kernel(x, prev), lambda: EF.emit_fasta_plain(x, prev),
          "naf_tpu_torch/csrc/emit_fasta.cu", "naf_tpu/ops/emit_fused.py:242", shape, [x],
          kout=kern, counts=("cnt",))
    del kern
    check("classify_fasta", lambda: SF.classify_fasta_kernel(x, prev),
          lambda: SF.classify_fasta_plain(x, prev), "naf_tpu_torch/csrc/classify.cu",
          "naf_tpu/ops/scan_fused.py:138", shape, [x])
    out_len = sv.numel() // 2 + 1
    check("pack_4bit", lambda: PK.pack_4bit_kernel(sv, out_len=out_len),
          lambda: PK.pack_4bit_plain(sv, out_len=out_len), "naf_tpu_torch/csrc/pack.cu",
          "naf_tpu/ops/pack.py:78", f"sv u8[{sv.numel()}]", [sv])
    seq_packed = PK.pack_4bit_kernel(sv, out_len=out_len)[: (cnt + 1) // 2].clone()
    check("unpack_4bit", lambda: UP.unpack_4bit_kernel(seq_packed),
          lambda: UP.unpack_4bit_plain(seq_packed), "naf_tpu_torch/csrc/unpack.cu",
          "naf_tpu/ops/unpack.py:59", f"packed u8[{seq_packed.numel()}]", [seq_packed])
    chars = UP.unpack_4bit_kernel(seq_packed)
    lower = sv[:cnt] >= 96
    bounds = torch.nonzero(lower[1:] != lower[:-1]).flatten() + 1
    if bool(lower[0]):
        bounds = torch.cat([bounds.new_zeros(1), bounds])
    tog = torch.zeros_like(chars)
    tog.index_add_(0, bounds, torch.ones_like(bounds, dtype=torch.uint8))
    check("apply_mask_parity", lambda: EF.apply_mask_parity_kernel(chars, tog),
          lambda: EF.apply_mask_parity_plain(chars, tog), "naf_tpu_torch/csrc/mask_parity.cu",
          "naf_tpu/ops/emit_fused.py:757", f"chars u8[{chars.numel()}]", [chars, tog])
    del x, sv, seq_packed, chars, tog, lower, bounds
    torch.cuda.empty_cache()

    # ---- 3. encode, 4. decode: each path, counted -----------------------
    def delta(before: dict, after: dict) -> dict:
        return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}

    def run_path(inputs, fastq: bool) -> tuple[list, dict]:
        D.reset_counts()
        archives = []
        for name, data in inputs:
            before, routes_before = dict(D.LAUNCHES), dict(D.ROUTES)
            t0 = time.perf_counter()
            blob, _ = encode_device(data, opts, device=dev)
            enc_s = time.perf_counter() - t0
            if blob != encode(data, opts)[0]:
                raise AssertionError(f"{name}: device archive != host encode() archive")
            routes = delta(routes_before, D.ROUTES)
            if routes != {"encode_device": 1}:
                raise AssertionError(f"{name}: encode took route {routes}")
            for k in ("emit_fastq" if fastq else "emit_fasta", "pack_4bit"):
                if D.LAUNCHES[k] <= before[k]:
                    raise AssertionError(f"{name}: {k} did not launch")
            archives.append(blob)
            emit({"phase": "encode", "input": name, "card": card, "bytes": len(data),
                  "archive": len(blob), "equal_host": True, "routes": routes,
                  "seconds": enc_s})
        for i, (name, data) in enumerate(inputs):
            before, routes_before = dict(D.LAUNCHES), dict(D.ROUTES)
            t0 = time.perf_counter()
            if fastq:
                out = fastq_device(Decoder(io.BytesIO(archives[i]), DecodeOptions()), device=dev)
            else:
                out = fasta_device(Decoder(io.BytesIO(archives[i]), DecodeOptions()), device=dev)
            dec_s = time.perf_counter() - t0
            routes = delta(routes_before, D.ROUTES)
            row = {"phase": "decode", "input": name, "card": card, "routes": routes,
                   "seconds": dec_s}
            host = Decoder(io.BytesIO(archives[i]), DecodeOptions())
            if out != (host.fastq() if fastq else host.fasta()):
                raise AssertionError(f"{name}: decoded bytes != host Decoder's")
            row["equal_host"] = True
            on_device = i < 2 or fastq        # the third FASTA input is ragged
            if on_device:
                if routes != {"decode_device": 1}:
                    raise AssertionError(f"{name}: decode took route {routes}")
                for k in ("unpack_4bit",) if fastq else ("unpack_4bit", "apply_mask_parity"):
                    if D.LAUNCHES[k] <= before[k]:
                        raise AssertionError(f"{name}: {k} did not launch")
            if i < 2:
                if out != data:
                    raise AssertionError(f"{name}: decoded bytes != input bytes")
                row["equal_input"] = True
            emit(row)
        return archives, dict(D.LAUNCHES)

    fasta_archives, fasta_launches = run_path(fasta_inputs, fastq=False)
    fastq_archives, fastq_launches = run_path(fastq_inputs, fastq=True)
    emit({"phase": "launches", "fasta_path": fasta_launches, "fastq_path": fastq_launches})
    paths = {"fasta": (fasta_launches, ("emit_fasta", "pack_4bit", "unpack_4bit",
                                        "apply_mask_parity")),
             "fastq": (fastq_launches, ("emit_fastq", "pack_4bit", "unpack_4bit"))}
    for pname, (counts, needed) in paths.items():
        for k in needed:
            if counts[k] <= 0:
                raise AssertionError(f"{k} was not launched on the {pname} path")

    # ---- 5. rates ----------------------------------------------------------
    def rates(name, data, blob, fastq: bool) -> None:
        mb = len(data) / 1e6
        e2e_enc = wall_time(lambda: encode_device(data, opts, device=dev), 2)
        if fastq:
            e2e_dec = wall_time(lambda: fastq_device(
                Decoder(io.BytesIO(blob), DecodeOptions()), device=dev), 2)
            blocks, _ = make_blocks_fastq(np.frombuffer(data, np.uint8)[1:], 1)
            xb = torch.from_numpy(blocks.data[0].copy()).to(dev)
            enc_ms = cuda_time(lambda: fused_block_fastq(xb, int(blocks.prev[0]), 0, seq_type=0,
                                                         device=dev), 5)
            d = Decoder(io.BytesIO(blob), DecodeOptions())
            plan, raw = d._plan(PD.MODE_FASTQ, False)
            run = PD.regular_session(plan, raw, d._load_qual(), device=dev)
        else:
            e2e_dec = wall_time(lambda: fasta_device(
                Decoder(io.BytesIO(blob), DecodeOptions()), device=dev), 2)
            blk = make_blocks(np.frombuffer(data, np.uint8)[data.index(b">") + 1:], 1)
            xb = torch.from_numpy(blk.data[0].copy()).to(dev)
            enc_ms = cuda_time(lambda: fused_block(xb, int(blk.prev[0]), False, 0, seq_type=0,
                                                   device=dev), 5)
            d = Decoder(io.BytesIO(blob), DecodeOptions())
            plan, raw = d._fasta_plan(d.masking)
            run = PD.regular_session(plan, raw, device=dev)
        dec_ms = cuda_time(run, 5)
        emit({"phase": "rates", "input": name, "card": card,
              "encode_e2e_MBps": mb / e2e_enc, "decode_e2e_MBps": mb / e2e_dec,
              "encode_device_resident_MBps": mb / (enc_ms / 1e3),
              "decode_device_resident_MBps": plan.total_out / 1e6 / (dec_ms / 1e3),
              "encode_device_resident_ms": enc_ms, "decode_device_resident_ms": dec_ms})
        del xb, run
        torch.cuda.empty_cache()

    for i in range(2):
        rates(*fasta_inputs[i], fasta_archives[i], fastq=False)
    for i in range(3):
        rates(*fastq_inputs[i], fastq_archives[i], fastq=True)

    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "naf_tpu"))
    if bad:
        raise AssertionError(f"the port's path imported {bad[:5]}")

    order = ("emit_fasta", "classify_fasta", "pack_4bit", "unpack_4bit", "apply_mask_parity",
             "emit_fastq", "classify_fastq")
    total = {k: fasta_launches[k] + fastq_launches[k] for k in order}
    fused = {"classify_fasta": "emit_fasta", "classify_fastq": "emit_fastq"}
    kernels = []
    for k in order:
        row = dict(kernel_rows[k], launches=total[k])
        if k in fused:
            row.update(launches=total[fused[k]], fused_into=fused[k],
                       standalone_launches=total[k])
        kernels.append(row)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
