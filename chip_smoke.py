#!/usr/bin/env python3
"""Drive naf_tpu_torch's device FASTA round trip once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. environment: card, power limit, CUDA and nvcc versions, kernel build;
  2. kernels: every kernel against its plain PyTorch version at the shapes
     of the main path, byte for byte, with CUDA-event times;
  3. encode: encode_device on bench.py's gen_fasta(64), gen_fasta_single(128)
     and gen_masked_iupac_fasta(32) must equal host encode() byte for byte;
  4. decode: fasta_device on the first two archives must give back the
     input bytes; the third (ragged) prints the route it took;
  5. rates: encode and decode MB/s, end to end and device-resident.
The launch counts of the main path (phases 3 and 4) go into the kernels
line; the last line is the result.  Any failure raises and exits non-zero.
nvcc's log (registers, shared memory and spills of each kernel) goes to
standard error.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time

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


def max_abs_err(a, b) -> int:
    """Largest absolute difference of two integer tensors (or dicts of them)."""
    if isinstance(a, dict):
        return max(max_abs_err(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    # the port first: it stands in for the zstandard package where only the
    # system libzstd exists, before naf_tpu's codec is imported
    from naf_tpu_torch import device as D
    from naf_tpu_torch.native import build
    from naf_tpu_torch.ops import emit_fused as EF
    from naf_tpu_torch.ops import pack as PK
    from naf_tpu_torch.ops import scan_fused as SF
    from naf_tpu_torch.ops import unpack as UP
    from naf_tpu_torch.parallel import decode as PD
    from naf_tpu_torch.parallel.block import fused_block, make_blocks
    from naf_tpu_torch.parallel.pipeline import encode_device
    from naf_tpu_torch.pipeline.decoder import fasta_device

    import bench
    from naf_tpu.pipeline.decoder import DecodeOptions, Decoder
    from naf_tpu.pipeline.encoder import EncodeOptions, encode

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
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc, "build_s": build_s,
          "zstandard": getattr(sys.modules["zstandard"], "__version__",
                               "stand-in over the system libzstd"),
          "library": build.BUILD_INFO["path"]})

    # ---- inputs (bench.py generators) ----------------------------------
    inputs = [("gen_fasta(64)", bench.gen_fasta(64)),
              ("gen_fasta_single(128)", bench.gen_fasta_single(128)),
              ("gen_masked_iupac_fasta(32)", bench.gen_masked_iupac_fasta(32))]
    opts = EncodeOptions(level=1, threads=os.cpu_count() or 0)

    # ---- 2. kernels against their plain versions -----------------------
    name, data = inputs[1]
    body = np.frombuffer(data, np.uint8)[data.index(b">") + 1:]
    blk = make_blocks(body, 1)
    x = torch.from_numpy(blk.data[0].copy()).to(dev)
    prev = int(blk.prev[0])
    kern = EF.emit_fasta_kernel(x, prev)
    plain = EF.emit_fasta_plain(x, prev)
    sv = kern["sv"]
    cnt = int(kern["cnt"])
    packed = PK.pack_4bit_kernel(sv, out_len=sv.numel() // 2 + 1)
    seq_packed = packed[: (cnt + 1) // 2].clone()
    chars = UP.unpack_4bit_kernel(seq_packed)
    lower = sv[:cnt] >= 96
    bounds = torch.nonzero(lower[1:] != lower[:-1]).flatten() + 1
    if bool(lower[0]):
        bounds = torch.cat([bounds.new_zeros(1), bounds])
    tog = torch.zeros_like(chars)
    tog.index_add_(0, bounds, torch.ones_like(bounds, dtype=torch.uint8))
    checks = {
        "emit_fasta": (lambda: EF.emit_fasta_kernel(x, prev),
                       lambda: EF.emit_fasta_plain(x, prev), kern, plain,
                       "naf_tpu_torch/csrc/emit_fasta.cu", "naf_tpu/ops/emit_fused.py:242",
                       f"{name} block u8[{x.numel()}]"),
        "classify_fasta": (lambda: SF.classify_fasta_kernel(x, prev),
                           lambda: SF.classify_fasta_plain(x, prev), None, None,
                           "naf_tpu_torch/csrc/classify.cu", "naf_tpu/ops/scan_fused.py:138",
                           f"{name} block u8[{x.numel()}]"),
        "pack_4bit": (lambda: PK.pack_4bit_kernel(sv, out_len=sv.numel() // 2 + 1),
                      lambda: PK.pack_4bit_plain(sv, out_len=sv.numel() // 2 + 1), None, None,
                      "naf_tpu_torch/csrc/pack.cu", "naf_tpu/ops/pack.py:78",
                      f"sv u8[{sv.numel()}]"),
        "unpack_4bit": (lambda: UP.unpack_4bit_kernel(seq_packed),
                        lambda: UP.unpack_4bit_plain(seq_packed), None, None,
                        "naf_tpu_torch/csrc/unpack.cu", "naf_tpu/ops/unpack.py:59",
                        f"packed u8[{seq_packed.numel()}]"),
        "apply_mask_parity": (lambda: EF.apply_mask_parity_kernel(chars, tog),
                              lambda: EF.apply_mask_parity_plain(chars, tog), None, None,
                              "naf_tpu_torch/csrc/mask_parity.cu",
                              "naf_tpu/ops/emit_fused.py:757", f"chars u8[{chars.numel()}]"),
    }
    kernel_rows = {}
    for kname, (kfn, pfn, kout, pout, src, repl, shape) in checks.items():
        kout = kfn() if kout is None else kout
        pout = pfn() if pout is None else pout
        torch.cuda.synchronize()
        err = max_abs_err(kout, pout)
        del kout, pout
        ms = cuda_time(kfn, 10)
        plain_ms = cuda_time(pfn, 3)
        row = {"name": kname, "route": "cuda", "source": src, "replaces": repl,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        emit({"phase": "kernel", "shape": shape, "card": card, **row})
        if err != 0:
            raise AssertionError(f"{kname}: kernel differs from its plain version ({err})")
        kernel_rows[kname] = row
    # the plain emit at full size holds several GiB of temporaries
    del plain, kern, chars, tog
    torch.cuda.empty_cache()

    # ---- 3. encode, 4. decode: the main path, counted -------------------
    D.reset_counts()
    archives = []
    for name, data in inputs:
        before = dict(D.LAUNCHES)
        routes_before = dict(D.ROUTES)
        t0 = time.perf_counter()
        blob, _ = encode_device(data, opts, device=dev)
        enc_s = time.perf_counter() - t0
        host, _ = encode(data, opts)
        if blob != host:
            raise AssertionError(f"{name}: device archive != host encode() archive")
        routes = {k: v - routes_before.get(k, 0) for k, v in D.ROUTES.items()
                  if v != routes_before.get(k, 0)}
        if routes != {"encode_device": 1}:
            raise AssertionError(f"{name}: encode took route {routes}")
        for k in ("emit_fasta", "pack_4bit"):
            if D.LAUNCHES[k] <= before[k]:
                raise AssertionError(f"{name}: {k} did not launch")
        archives.append(blob)
        emit({"phase": "encode", "input": name, "card": card, "bytes": len(data),
              "archive": len(blob), "equal_host": True, "routes": routes, "seconds": enc_s})
    for i, (name, data) in enumerate(inputs):
        before = dict(D.LAUNCHES)
        routes_before = dict(D.ROUTES)
        t0 = time.perf_counter()
        out = fasta_device(Decoder(io.BytesIO(archives[i]), DecodeOptions()), device=dev)
        dec_s = time.perf_counter() - t0
        routes = {k: v - routes_before.get(k, 0) for k, v in D.ROUTES.items()
                  if v != routes_before.get(k, 0)}
        row = {"phase": "decode", "input": name, "card": card, "routes": routes,
               "seconds": dec_s}
        if i < 2:
            if out != data:
                raise AssertionError(f"{name}: decoded bytes != input bytes")
            if routes != {"decode_device": 1}:
                raise AssertionError(f"{name}: decode took route {routes}")
            for k in ("unpack_4bit", "apply_mask_parity"):
                if D.LAUNCHES[k] <= before[k]:
                    raise AssertionError(f"{name}: {k} did not launch")
            row["equal_input"] = True
        emit(row)
    launches = dict(D.LAUNCHES)
    path = ("emit_fasta", "pack_4bit", "unpack_4bit", "apply_mask_parity")
    for k in path:
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on the main path")

    # ---- 5. rates ----------------------------------------------------------
    for i, (name, data) in enumerate(inputs[:2]):
        mb = len(data) / 1e6
        e2e_enc = wall_time(lambda: encode_device(data, opts, device=dev), 2)
        d = Decoder(io.BytesIO(archives[i]), DecodeOptions())
        e2e_dec = wall_time(lambda: fasta_device(
            Decoder(io.BytesIO(archives[i]), DecodeOptions()), device=dev), 2)
        body = np.frombuffer(data, np.uint8)[data.index(b">") + 1:]
        blk = make_blocks(body, 1)
        xb = torch.from_numpy(blk.data[0].copy()).to(dev)
        enc_ms = cuda_time(lambda: fused_block(xb, int(blk.prev[0]), False, 0, seq_type=0,
                                               device=dev), 5)
        plan, raw = d._fasta_plan(d.masking)
        run = PD.regular_session(plan, raw, device=dev)
        dec_ms = cuda_time(run, 5)
        emit({"phase": "rates", "input": name, "card": card,
              "encode_e2e_MBps": mb / e2e_enc, "decode_e2e_MBps": mb / e2e_dec,
              "encode_device_resident_MBps": mb / (enc_ms / 1e3),
              "decode_device_resident_MBps": plan.total_out / 1e6 / (dec_ms / 1e3),
              "encode_device_resident_ms": enc_ms, "decode_device_resident_ms": dec_ms})

    jax_modules = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    if jax_modules:
        raise AssertionError(f"the port's path imported jax: {jax_modules[:5]}")

    kernels = [dict(kernel_rows[k], launches=launches[k]) for k in path]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
