#!/usr/bin/env python3
"""Where a device encode and decode spend their time, stage by stage, on one
CUDA card.

    python3 stage_probe.py [--reps 5] [--inputs fused|two_pass|stream]

``fused`` (the default): bench.py's gen_fastq(500_000, read_len=150),
gen_fastq(250_000) and gen_fasta_single(128), whose encodes take the fused
emit and whose decodes the uniform render.  ``two_pass``: chip_smoke.py's
swissprot_like(160), illumina_reads_fasta(750_000) and sra_fastq(400_000),
whose encodes take the two-pass protocol and whose decodes the ragged
render.  Times each stage of ``encode_device`` and of ``fasta_device`` /
``fastq_device`` with the host clock (each stage ends synchronised; median
of --reps), the whole calls, and the host encode() and Decoder for
comparison.  Then traces one whole encode and one whole decode with
``torch.profiler`` and prints the device's busy time (kernels and copies)
over the wall time of the call.  ``stream``: bench.py's
gen_fasta_single(1024) and gen_fastq(1_600_000, read_len=150) through
``encode_stream`` with ``DeviceScanEngine`` in 64 MiB chunks, and with the
host scanner at its default chunk: the whole streams (median of --reps),
then one staged run of each, whose stages are summed over the pieces
(each ends synchronised), and the device's busy share over one stream.
One JSON line per input and direction; the last line says which card, as
nvidia-smi names it.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import time


def busy_share(fn) -> dict:
    """Device time of kernels and copies over the wall time of one call of
    ``fn``, after a warm-up call (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = sum(e.device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if dev_us <= 0:
        return {"device_busy_s": None, "wall_s": wall, "idle_share": None}
    return {"device_busy_s": dev_us / 1e6, "wall_s": wall,
            "idle_share": max(0.0, 1 - dev_us / 1e6 / wall)}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("stage_probe: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--inputs", choices=("fused", "two_pass", "stream"), default="fused")
    args = ap.parse_args()

    import bench
    from naf_tpu_torch import device as D
    from naf_tpu_torch.format import constants as C
    from naf_tpu_torch.parallel import decode as PD
    from naf_tpu_torch.parallel import pipeline as PP
    from naf_tpu_torch.parallel.block import (emit_blocks_sharded, fused_blocks_fastq_sharded,
                                              fused_blocks_sharded, make_blocks,
                                              make_blocks_fastq, stats_blocks_sharded)
    from naf_tpu_torch.parallel.mesh import all_gather, block_mesh
    from naf_tpu_torch.pipeline.decoder import Decoder, fasta_device, fastq_device
    from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode

    dev = D.cuda_device()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    opts = EncodeOptions(level=1, threads=os.cpu_count() or 0)

    def med(fn) -> float:
        fn()                                  # warm-up
        torch.cuda.synchronize()
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    def probe_two_pass(name, data, o) -> None:
        """The stages of a two-pass encode and of a ragged decode."""
        fastq = data[:1] == b"@"
        body = np.frombuffer(data, np.uint8)[1:]
        st = {}
        split = (lambda: make_blocks_fastq(body, 1)[0]) if fastq else (lambda: make_blocks(body, 1))
        st["make_blocks"] = med(split)
        blocks = split()
        host_block = blocks.data[0]
        st["upload"] = med(lambda: torch.from_numpy(host_block).to(dev))
        x = torch.from_numpy(host_block).to(dev)
        prev, sis = int(blocks.prev[0]), bool(blocks.starts_in_seq[0])
        if o.seq_type < C.SEQ_TYPE_PROTEIN:
            st["fused_attempt"] = med(
                (lambda: all_gather(fused_blocks_fastq_sharded([x], [prev], 0, seq_type=0)[3]))
                if fastq else (lambda: all_gather(fused_blocks_sharded([x], [prev], [sis], 0,
                                                                       seq_type=0)[1])))

        def stats_pass():
            return stats_blocks_sharded([x], [prev], [sis], seq_type=o.seq_type, fastq=fastq)
        st["stats_block"] = med(stats_pass)
        stats, masks = stats_pass()

        def emit():
            return emit_blocks_sharded([x], masks, stats, seq_type=o.seq_type, fastq=fastq,
                                       pack_nibbles=o.seq_type < C.SEQ_TYPE_PROTEIN)
        st["emit_block_with_fetch"] = med(emit)
        em = emit()
        del masks
        fmt = C.IN_FORMAT_FASTQ if fastq else C.IN_FORMAT_FASTA
        st["stitch_and_build"] = med(lambda: PP.build_two_pass(fmt, o, stats, em, fallback=None))
        st["encode_device"] = med(lambda: PP.encode_device(data, o, device=dev))
        st["host_encode"] = med(lambda: encode(data, o))
        enc_busy = busy_share(lambda: PP.encode_device(data, o, device=dev))
        print(json.dumps({"input": name, "direction": "encode", "bytes": len(data),
                          "seconds": st, **enc_busy, "card": card}), flush=True)
        del x
        torch.cuda.empty_cache()

        blob = encode(data, o)[0]
        sd = {}

        def plan():
            d = Decoder(io.BytesIO(blob))
            if fastq:
                return d._plan(PD.MODE_FASTQ, False) + (d._load_qual(),)
            return d._fasta_plan(d.masking) + (None,)
        sd["container_zstd_plan"] = med(plan)
        pl, raw, qual = plan()
        one = block_mesh(devices=[dev])
        sd["batches_and_upload"] = med(lambda: PD.ragged_session(pl, raw, qual, mesh=one))
        batches, render = PD.ragged_session(pl, raw, qual, mesh=one)
        sd["render_on_card"] = med(lambda: [render(b) for b in batches])
        outs = [t for b in batches for t in render(b)]
        sd["fetch_output"] = med(lambda: b"".join(t.cpu().numpy().tobytes() for t in outs))
        device_decode = ((lambda: fastq_device(Decoder(io.BytesIO(blob)), device=dev)) if fastq
                         else (lambda: fasta_device(Decoder(io.BytesIO(blob)), device=dev)))
        sd["decode_device"] = med(device_decode)
        sd["host_decode"] = med(lambda: (Decoder(io.BytesIO(blob)).fastq() if fastq
                                         else Decoder(io.BytesIO(blob)).fasta()))
        dec_busy = busy_share(device_decode)
        print(json.dumps({"input": name, "direction": "decode", "bytes": pl.total_out,
                          "batches": len(batches), "seconds": sd, **dec_busy, "card": card}),
              flush=True)
        del outs, render
        torch.cuda.empty_cache()

    def probe_stream(name, data) -> None:
        """The whole device and host streams, then the stages of one of
        each, summed over its pieces."""
        from naf_tpu_torch.codec import zstd_backend as ZB
        from naf_tpu_torch.native import host as NH
        from naf_tpu_torch.parallel import stream as PS
        from naf_tpu_torch.pipeline.stream import encode_stream

        fastq = data[:1] == b"@"
        engines = []

        def device_stream():
            engines.append(PS.DeviceScanEngine(device=dev))
            encode_stream(io.BytesIO(data), io.BytesIO(), opts, chunk_size=64 << 20,
                          engine=engines[-1])

        def host_stream():
            encode_stream(io.BytesIO(data), io.BytesIO(), opts)

        whole = {"device_stream": med(device_stream), "host_stream": med(host_stream)}
        acc: dict = {}

        def timed(key, fn, sync=True):
            def w(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    if sync:
                        torch.cuda.synchronize()
                    acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
            return w

        def staged(run, patches) -> dict:
            acc.clear()
            saved = [(owner, attr, owner.__dict__[attr]) for owner, attr, _, _ in patches]
            try:
                for owner, attr, key, sync in patches:
                    raw = owner.__dict__[attr]
                    fn = timed(key, raw.__func__ if isinstance(raw, staticmethod) else raw, sync)
                    setattr(owner, attr, staticmethod(fn) if isinstance(raw, staticmethod)
                            else fn)
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                for owner, attr, raw in saved:
                    setattr(owner, attr, raw)
            return {"wall": wall, **acc}

        zstd = (ZB.SectionCompressor, "write", "zstd_write_behind", False)
        dev_st = staged(device_stream, [
            (PS, "make_blocks_fastq" if fastq else "make_blocks", "make_blocks", True),
            (PS, "fused_blocks_fastq_sharded" if fastq else "fused_blocks_sharded", "kernels",
             True),
            (PS, "parse_fused_fastq" if fastq else "parse_fused_fasta", "fetch_and_parse", True),
            (PS.DeviceScanEngine, "_passes", "passes", True),
            (PS.DeviceScanEngine, "_build", "build", True),
            (PS.DeviceScanEngine, "scan", "scan", True), zstd])
        dev_st["upload_and_scalars"] = (dev_st["passes"] - dev_st["kernels"]
                                        - dev_st["fetch_and_parse"])
        dev_st["scan_other"] = (dev_st["scan"] - dev_st["make_blocks"] - dev_st["passes"]
                                - dev_st["build"])
        dev_st["outside_scan"] = dev_st["wall"] - dev_st["scan"]
        host_st = staged(host_stream, [(NH, "scan", "scan", False), zstd])
        host_st["outside_scan"] = host_st["wall"] - host_st["scan"]
        busy = busy_share(device_stream)
        print(json.dumps({"input": name, "direction": "stream", "bytes": len(data),
                          "pieces": engines[-1].device_chunks,
                          "host_pieces": engines[-1].native_chunks, "seconds": whole,
                          "device_stream_stages": dev_st, "host_stream_stages": host_st,
                          **busy, "card": card}), flush=True)

    if args.inputs == "stream":
        for name, make in (("gen_fasta_single(1024)", lambda: bench.gen_fasta_single(1024)),
                           ("gen_fastq(1600000,read_len=150)",
                            lambda: bench.gen_fastq(1_600_000, read_len=150))):
            probe_stream(name, make())
        print(card)
        return 0

    if args.inputs == "two_pass":
        import chip_smoke as CS

        protein = EncodeOptions(level=1, threads=os.cpu_count() or 0,
                                seq_type=C.SEQ_TYPE_PROTEIN)
        for name, data, o in (("swissprot_like(160)", CS.swissprot_like(160), protein),
                              ("illumina_reads_fasta(750000)", CS.illumina_reads_fasta(750_000),
                               opts),
                              ("sra_fastq(400000)", CS.sra_fastq(400_000), opts)):
            probe_two_pass(name, data, o)
        print(card)
        return 0

    inputs = [("gen_fastq(500000,read_len=150)", bench.gen_fastq(500_000, read_len=150)),
              ("gen_fastq(250000)", bench.gen_fastq(250_000)),
              ("gen_fasta_single(128)", bench.gen_fasta_single(128))]
    for name, data in inputs:
        fastq = data[:1] == b"@"
        body = np.frombuffer(data, np.uint8)[(1 if fastq else data.index(b">") + 1):]
        st = {}
        if fastq:
            st["make_blocks"] = med(lambda: make_blocks_fastq(body, 1))
            blocks, _ = make_blocks_fastq(body, 1)
        else:
            st["make_blocks"] = med(lambda: make_blocks(body, 1))
            blocks = make_blocks(body, 1)
        host_block = blocks.data[0]
        st["upload"] = med(lambda: torch.from_numpy(host_block).to(dev))
        x = torch.from_numpy(host_block).to(dev)
        if fastq:
            st["kernels"] = med(lambda: fused_blocks_fastq_sharded([x], blocks.prev, 0,
                                                                   seq_type=0))
            outs = fused_blocks_fastq_sharded([x], blocks.prev, 0, seq_type=0)

            def parse():
                return PP.parse_fused_fastq(1, all_gather(outs[3]), outs)
        else:
            st["kernels"] = med(lambda: fused_blocks_sharded([x], blocks.prev, [False], 0,
                                                             seq_type=0))
            outs = fused_blocks_sharded([x], blocks.prev, [False], 0, seq_type=0)

            def parse():
                packed, scal, tv, a = outs
                return PP.parse_fused_fasta(1, all_gather(scal), packed, tv, a)
        st["fetch_and_parse"] = med(parse)
        p = parse()
        zero = [np.zeros(257, np.uint64) for _ in range(4)]
        fmt = C.IN_FORMAT_FASTQ if fastq else C.IN_FORMAT_FASTA
        qual_bytes = p.get("qual_bytes", np.zeros(1, np.int64))
        st["stitch_and_build"] = med(lambda: PP._stitch_and_build(
            1, fmt, opts, p["counts"], p["id_bytes"], p["com_bytes"], qual_bytes, p["n_rec"],
            p["n_runs"], p["first_lower"], p["longest"], zero, p["em_np"], fallback=None))
        st["encode_device"] = med(lambda: PP.encode_device(data, opts, device=dev))
        st["host_encode"] = med(lambda: encode(data, opts))
        enc_busy = busy_share(lambda: PP.encode_device(data, opts, device=dev))
        print(json.dumps({"input": name, "direction": "encode", "bytes": len(data),
                          "seconds": st, **enc_busy, "card": card}), flush=True)
        del x, outs
        torch.cuda.empty_cache()

        blob = encode(data, opts)[0]
        sd = {}

        def plan():
            d = Decoder(io.BytesIO(blob))
            if fastq:
                return d._plan(PD.MODE_FASTQ, False) + (d._load_qual(),)
            return d._fasta_plan(d.masking) + (None,)
        sd["container_zstd_plan"] = med(plan)
        pl, raw, qual = plan()
        sd["upload_session"] = med(lambda: PD.regular_session(pl, raw, qual, device=dev))
        run = PD.regular_session(pl, raw, qual, device=dev)
        sd["render_on_card"] = med(run)
        out = run()
        sd["fetch_output"] = med(lambda: out.cpu().numpy().tobytes())
        device_decode = ((lambda: fastq_device(Decoder(io.BytesIO(blob)), device=dev)) if fastq
                         else (lambda: fasta_device(Decoder(io.BytesIO(blob)), device=dev)))
        sd["decode_device"] = med(device_decode)
        sd["host_decode"] = med(lambda: (Decoder(io.BytesIO(blob)).fastq() if fastq
                                         else Decoder(io.BytesIO(blob)).fasta()))
        dec_busy = busy_share(device_decode)
        print(json.dumps({"input": name, "direction": "decode", "bytes": pl.total_out,
                          "seconds": sd, **dec_busy, "card": card}), flush=True)
        del run, out
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
