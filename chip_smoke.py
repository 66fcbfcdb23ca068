#!/usr/bin/env python3
"""Drive naf_tpu_torch's device encodes and decodes once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. environment: card, power limit, CUDA and nvcc versions, kernel build;
  2. kernels: every kernel against its plain PyTorch version at the shapes
     of the main paths, byte for byte, with CUDA-event times, the plain
     version's and one library call's time where one computes the same
     function, and the bound (bytes the kernel must move over 3.35 TB/s:
     for an emit, the input and the kept prefix of each output stream and
     its used sparse entries; for a compaction, the keep flags, the 32-byte
     sectors of the values that hold a kept element and the kept prefix;
     ``bound_padded_ms`` reads every input whole and adds the zero fill up
     to the allocated sizes; a compaction's ``tail_bytes`` is the zero fill
     its contract writes past the count), the device time of each launch
     within one call of each emit, each classify, each scan and the mask
     parity (its row's ``launch_split``), and one line with the same for
     each compaction (torch.profiler).  The FASTA classify's row nests a
     ``protein`` entry: the same kernel on the protein input's two-pass
     block, the shape its main path gives it; the FASTQ classify's row an
     ``sra`` entry, the same on the SRA FASTQ input's two-pass block; the
     mask parity's row a ``dense`` entry, the same chars under a toggle
     every 1-3 bytes;
  3. encode: encode_device on bench.py's gen_fasta(64), gen_fasta_single(128),
     gen_masked_iupac_fasta(32), gen_fastq(250_000), gen_fastq(500_000,
     read_len=150) and a soft-masked FASTQ made here (the fused paths), and
     on four inputs made here that take the two-pass protocol: a
     Swiss-Prot-shaped protein FASTA, Illumina reads as FASTA, SRA FASTQ as
     fastq-dump writes it, and gen_fasta(16) with unexpected bytes; each
     archive must equal the port's host encode() byte for byte, by its
     named route;
  4. decode: fasta_device / fastq_device on those archives must equal the
     port's host Decoder and, where the format round-trips, the input
     bytes; the ragged archives (all but gen_fasta(16)'s, whose records
     have two shapes) must take the ragged device render, whose peak device
     memory is printed;
  5. rates: encode and decode MB/s, end to end and device-resident.
Four paths run with the launch counts set to 0 just before and read just
after each: the fused FASTA path and the fused FASTQ path (phases 3-4 on
their inputs), the two-pass encodes, and the ragged decodes.  Every kernel
of a path must have launched in it; the kernels line sums the four.  The
classifies launch standalone on the two-pass path and as device code inside
each fused emit: a classify's row counts its standalone launches and gives
the emit's as ``fused_launches``.  The last line is the result.  Any
failure raises and exits non-zero.  nvcc's log (registers, shared memory
and spills of each kernel) goes to standard error.
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
#: the card's memory access granule: a load reads whole 32-byte sectors
SECTOR_BYTES = 32


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


def value_sectors(vals, keep) -> int:
    """The 32-byte sectors of ``vals`` that hold at least one element where
    ``keep`` is set: what a compaction must read of its values."""
    import torch

    per = SECTOR_BYTES // vals.element_size()
    lead = vals.data_ptr() % SECTOR_BYTES // vals.element_size()
    k = keep.bool()
    k = torch.cat([k.new_zeros(lead), k, k.new_zeros(-(lead + k.numel()) % per)])
    return int(k.view(-1, per).any(1).sum())


def launch_split(fn, reps: int) -> dict:
    """Device ms of each launch (by kernel name, template arguments cut)
    within one call of fn: torch.profiler's device events over `reps`
    calls after a warm-up, divided by `reps`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    split: dict = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("(")[0].split("<")[0].removeprefix("void ")
            split[name] = split.get(name, 0.0) + e.device_time_total / 1e3 / reps
    return dict(sorted(split.items()))


def fasta_block(data: bytes, dev) -> tuple:
    """(block, byte before it) of a FASTA input cut as one block past its
    first '>', on dev: what the encodes' make_blocks gives."""
    import numpy as np
    import torch

    from naf_tpu_torch.parallel.block import make_blocks

    blk = make_blocks(np.frombuffer(data, np.uint8)[data.index(b">") + 1:], 1)
    return torch.from_numpy(blk.data[0].copy()).to(dev), int(blk.prev[0])


def fastq_block(data: bytes, dev) -> tuple:
    """(block, byte before it) of a FASTQ input cut as one block past its
    leading '@', on dev: what the encodes' make_blocks_fastq gives."""
    import numpy as np
    import torch

    from naf_tpu_torch.parallel.block import make_blocks_fastq

    blocks, _ = make_blocks_fastq(np.frombuffer(data, np.uint8)[1:], 1)
    return torch.from_numpy(blocks.data[0].copy()).to(dev), int(blocks.prev[0])


def protein_masks(data: bytes, dev):
    """(block, masks, positions) of phase 2's scans and compactions: the
    protein input's two-pass block on the card, its masks from the
    standalone classify as stats_block and emit_block pass them, and
    i32 positions."""
    import torch

    from naf_tpu_torch.format import constants as C
    from naf_tpu_torch.ops import scan_fused as SF

    xp, prev = fasta_block(data, dev)
    sm = SF.scan_fasta_fused(xp, prev, C.SEQ_TYPE_PROTEIN, False)
    return xp, sm, torch.arange(xp.numel(), dtype=torch.int32, device=dev)


def compactions(xp, sm, pos) -> tuple:
    """(row key, launch counter, values, keep, dense, TPU kernel, what) of
    each compaction call that phase 2 times."""
    return (("compact", "compact", xp, sm["id_keep"], False, "naf_tpu/ops/compact.py:81",
             "id bytes u8"),
            ("compact:i32", "compact", pos, sm["rec_start"], False,
             "naf_tpu/ops/compact.py:81", "record starts i32"),
            ("compact_dense", "compact_dense", sm["stream_val"], sm["stream_keep"], True,
             "naf_tpu/ops/compact.py:175", "sequence stream u8"))


def scan_inputs(xp, sm, pos) -> tuple:
    """(keep, code) of phase 2's scans: the sequence keep mask (bool), as
    stats_block's add scan takes it, and the run-start code (i32) that
    emit_block's max scan takes."""
    import torch

    keep, val = sm["stream_keep"], sm["stream_val"]
    return keep, torch.where(keep, pos * 2 + (keep & (val >= 96)).to(torch.int32), -(1 << 30))


def render_inputs(kern: dict) -> tuple:
    """(sv, out_len, packed, chars, tog) of phase 2's pack, unpack and mask
    parity, from a FASTA emit's output: its sequence stream, the packed
    length, the stream packed to 4 bits, unpacked again, and the case
    toggles of its soft mask."""
    import torch

    from naf_tpu_torch.ops import pack as PK
    from naf_tpu_torch.ops import unpack as UP

    sv, cnt = kern["sv"], int(kern["cnt"])
    out_len = sv.numel() // 2 + 1
    packed = PK.pack_4bit_kernel(sv, out_len=out_len)[: (cnt + 1) // 2].clone()
    chars = UP.unpack_4bit_kernel(packed)
    lower = sv[:cnt] >= 96
    bounds = torch.nonzero(lower[1:] != lower[:-1]).flatten() + 1
    if bool(lower[0]):
        bounds = torch.cat([bounds.new_zeros(1), bounds])
    tog = torch.zeros_like(chars)
    tog.index_add_(0, bounds, torch.ones_like(bounds, dtype=torch.uint8))
    return sv, out_len, packed, chars, tog


def dense_toggles(n: int, dev, seed: int = 15):
    """u8[n] mask toggles on dev: a bound every 1-3 bytes, 1-3 bounds at
    each (seeded, made on the card)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    at = torch.cumsum(torch.randint(1, 4, (n,), device=dev, generator=g), 0)
    at = at[at < n]
    tog = torch.zeros(n, dtype=torch.uint8, device=dev)
    tog[at] = torch.randint(1, 4, (at.numel(),), device=dev, generator=g, dtype=torch.uint8)
    return tog


def two_pass_device_ms(data: bytes, o, blob: bytes, fastq: bool, dev, reps: int = 3) -> dict:
    """Device-resident ms of a two-pass input, CUDA events: stats_block +
    emit_block on its uploaded block, and the first batch of the ragged
    render of its archive."""
    import numpy as np
    import torch

    from naf_tpu_torch.format import constants as C
    from naf_tpu_torch.parallel import decode as PD
    from naf_tpu_torch.parallel.block import (emit_block, make_blocks, make_blocks_fastq,
                                              stats_block)
    from naf_tpu_torch.pipeline.decoder import DecodeOptions, Decoder

    body = np.frombuffer(data, np.uint8)[1:]
    blocks = make_blocks_fastq(body, 1)[0] if fastq else make_blocks(body, 1)
    xb = torch.from_numpy(blocks.data[0].copy()).to(dev)
    prev, sis = int(blocks.prev[0]), bool(blocks.starts_in_seq[0])

    def passes():
        stats, masks = stats_block(xb, prev, sis, seq_type=o.seq_type, fastq=fastq)
        emit_block(xb, masks, stats, seq_type=o.seq_type, fastq=fastq,
                   pack_nibbles=o.seq_type < C.SEQ_TYPE_PROTEIN)

    passes_ms = cuda_time(passes, reps)
    del xb
    d = Decoder(io.BytesIO(blob), DecodeOptions())
    plan, raw = d._plan(PD.MODE_FASTQ, False) if fastq else d._fasta_plan(d.masking)
    batches, render = PD.ragged_session(plan, raw, d._load_qual() if fastq else None, device=dev)
    batch_ms = cuda_time(lambda: render(batches[0]), reps)
    out = {"stats_emit_device_resident_ms": passes_ms, "ragged_batches": len(batches),
           "ragged_batch_bytes": batches[0].p1 - batches[0].p0, "ragged_batch_ms": batch_ms}
    del batches, render
    torch.cuda.empty_cache()
    return out


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


# ---- the two-pass inputs -------------------------------------------------------

#: UniProtKB/Swiss-Prot amino-acid composition (release statistics), percent
_AA = b"ACDEFGHIKLMNPQRSTVWY"
_AA_PCT = [8.25, 1.38, 5.46, 6.72, 3.86, 7.07, 2.27, 5.91, 5.80, 9.64, 2.41, 4.06, 4.74, 3.93,
           5.53, 6.65, 5.36, 6.86, 1.10, 2.92]
_ORGS = [(b"HUMAN", b"Homo sapiens", 9606), (b"MOUSE", b"Mus musculus", 10090),
         (b"RAT", b"Rattus norvegicus", 10116), (b"BOVIN", b"Bos taurus", 9913),
         (b"YEAST", b"Saccharomyces cerevisiae (strain ATCC 204508 / S288c)", 559292),
         (b"ECOLI", b"Escherichia coli (strain K12)", 83333),
         (b"ARATH", b"Arabidopsis thaliana", 3702), (b"DROME", b"Drosophila melanogaster", 7227)]
_WORDS = (b"protein kinase receptor subunit alpha beta domain-containing transporter factor "
          b"ribosomal mitochondrial putative uncharacterized zinc finger homolog dehydrogenase "
          b"synthase binding membrane transcription regulator").split()


def swissprot_like(total_mb: int, seed: int = 11) -> bytes:
    """Protein FASTA in the UniProtKB/Swiss-Prot format (uniprot_sprot.fasta):
    headers '>sp|<accession>|<NAME>_<SPECIES> <description> OS=... OX=...
    GN=... PE=1 SV=1' of 60-160 bytes, lengths drawn around Swiss-Prot's
    mean of about 360 residues, residues by its amino-acid composition,
    60-column lines.  160 MB is about 340,000 records, 60% of a release."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(total_mb * 1e6 / 476)
    lens = np.clip(rng.gamma(2.0, 180.0, n), 2, 35_000).astype(np.int64)
    p = np.asarray(_AA_PCT) / sum(_AA_PCT)
    res = rng.choice(np.frombuffer(_AA, np.uint8), size=int(lens.sum()), p=p).tobytes()
    letters = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ", np.uint8)
    acc = (rng.integers(0, 10, size=(n, 6)) + 48).astype(np.uint8)   # [OPQ][0-9][A-Z0-9]{3}[0-9]
    acc[:, 0] = np.frombuffer(b"OPQ", np.uint8)[rng.integers(0, 3, n)]
    acc[:, 2:5] = np.where(rng.random((n, 3)) < 0.5, letters[rng.integers(0, 26, (n, 3))],
                           acc[:, 2:5])
    gene = letters[rng.integers(0, 26, (n, 4))]
    org = rng.integers(0, len(_ORGS), n)
    n_words = rng.integers(1, 7, n)
    words = rng.integers(0, len(_WORDS), (n, 6))
    ends = np.cumsum(lens)
    out = []
    for i in range(n):
        code, name, taxid = _ORGS[org[i]]
        g = gene[i].tobytes()
        desc = b" ".join(_WORDS[w] for w in words[i, :n_words[i]])
        out.append(b">sp|%s|%s%d_%s %s OS=%s OX=%d GN=%s%d PE=1 SV=1\n" % (
            acc[i].tobytes(), g, i % 10, code, desc, name, taxid, g, i % 10))
        seq = res[ends[i] - lens[i]:ends[i]]
        out.append(b"\n".join([seq[j:j + 60] for j in range(0, len(seq), 60)]) + b"\n")
    return b"".join(out)


def _reads(rng, n_reads: int, read_len: int = 150):
    import numpy as np

    return rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(n_reads, read_len),
                      p=[0.2495, 0.2495, 0.2495, 0.2495, 0.002])


def illumina_reads_fasta(n_reads: int, seed: int = 12) -> bytes:
    """150-base reads as FASTA, as `seqtk seq -a` writes them from a CASAVA
    1.8 FASTQ: '>A00123:8:H5KJ3DSXX:1:<tile>:<x>:<y> 1:N:0:<index>'; the
    coordinates vary in digit count, so the archive is ragged."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seq = _reads(rng, n_reads)
    tile = rng.integers(1101, 2679, n_reads)
    xy = rng.integers(1, 37_000, (n_reads, 2))
    return b"".join(b">A00123:8:H5KJ3DSXX:1:%d:%d:%d 1:N:0:GATCAG+AGATCTCG\n%s\n" % (
        tile[i], xy[i, 0], xy[i, 1], seq[i].tobytes()) for i in range(n_reads))


def sra_fastq(n_reads: int, seed: int = 13) -> bytes:
    """150-base reads as `fastq-dump` writes them by default:
    '@SRR<run>.<n> <instrument name> length=150', the '+' line repeating the
    defline, NovaSeq's four binned quality values."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seq = _reads(rng, n_reads)
    qual = rng.choice(np.frombuffer(b"F:,#", np.uint8), size=(n_reads, 150),
                      p=[0.85, 0.1, 0.04, 0.01])
    tile = rng.integers(1101, 2679, n_reads)
    xy = rng.integers(1, 37_000, (n_reads, 2))
    out = []
    for i in range(n_reads):
        d = b"SRR6821753.%d A00123:8:H5KJ3DSXX:1:%d:%d:%d length=150" % (
            i + 1, tile[i], xy[i, 0], xy[i, 1])
        out.append(b"@%s\n%s\n+%s\n%s\n" % (d, seq[i].tobytes(), d, qual[i].tobytes()))
    return b"".join(out)


def with_unexpected(data: bytes, rate: float = 1e-5, seed: int = 14) -> bytes:
    """data with about one sequence byte in 1/rate replaced by a byte that
    UNEXPECTED_BY_TYPE[SEQ_TYPE_DNA] marks."""
    import numpy as np

    from naf_tpu_torch.format import constants as C

    rng = np.random.default_rng(seed)
    a = np.frombuffer(data, np.uint8).copy()
    is_seq = np.isin(a, np.frombuffer(b"ACGTNacgtn", np.uint8))
    pos = np.flatnonzero(is_seq & (rng.random(a.size) < rate))
    bad = np.frombuffer(b"!*#0123456789JOXZjoxz", np.uint8)
    bad = bad[np.asarray(C.UNEXPECTED_BY_TYPE[C.SEQ_TYPE_DNA])[bad].astype(bool)]
    a[pos] = rng.choice(bad, size=pos.size)
    return a.tobytes()


def max_sparse_per_tile(data: bytes, fastq: bool) -> int:
    """The most sparse-channel entries in one tile of the fused emit, counted
    on the host from the header lines, each line's bytes given to the tile
    where the line starts: for FASTA every header byte (64 KiB tiles), for
    FASTQ every comment byte (32 KiB tiles; the id has a dense stream)."""
    import numpy as np

    lines = data.split(b"\n")
    starts = np.cumsum([0] + [len(line) + 1 for line in lines[:-1]])
    if fastq:
        idx = list(range(0, len(lines) - 1, 4))
        counts = [len(lines[i]) - lines[i].find(b" ") - 1 if b" " in lines[i] else 0
                  for i in idx]
    else:
        idx = [i for i, line in enumerate(lines) if line[:1] == b">"]
        counts = [len(lines[i]) for i in idx]
    tile = 1 << (15 if fastq else 16)
    return int(np.bincount(starts[idx] // tile, weights=counts).max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    import bench
    from naf_tpu_torch import device as D
    from naf_tpu_torch.format import constants as C
    from naf_tpu_torch.native import build
    from naf_tpu_torch.ops import compact as CP
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

    # ---- inputs (bench.py generators, and those made here) -----------------
    t0 = time.perf_counter()
    fasta_inputs = [("gen_fasta(64)", bench.gen_fasta(64)),
                    ("gen_fasta_single(128)", bench.gen_fasta_single(128)),
                    ("gen_masked_iupac_fasta(32)", bench.gen_masked_iupac_fasta(32))]
    fastq_inputs = [("gen_fastq(250000)", bench.gen_fastq(250_000)),
                    ("gen_fastq(500000,read_len=150)", bench.gen_fastq(500_000, read_len=150)),
                    ("masked_fastq(106000)", masked_fastq())]
    opts = EncodeOptions(level=1, threads=os.cpu_count() or 0)
    protein = EncodeOptions(level=1, threads=os.cpu_count() or 0, seq_type=C.SEQ_TYPE_PROTEIN)
    # (name, data, options, why the fused path does not take it, FASTQ)
    two_pass_inputs = [
        ("swissprot_like(160)", swissprot_like(160), protein, "text_like", False),
        ("illumina_reads_fasta(750000)", illumina_reads_fasta(750_000), opts, "sparse_overflow",
         False),
        ("sra_fastq(400000)", sra_fastq(400_000), opts, "sparse_overflow", True),
        ("gen_fasta(16)+unexpected", with_unexpected(bench.gen_fasta(16)), opts,
         "unexpected_chars", False)]
    emit({"phase": "inputs", "seconds": time.perf_counter() - t0,
          "bytes": {n: len(d) for n, d in fasta_inputs + fastq_inputs}
          | {i[0]: len(i[1]) for i in two_pass_inputs}})

    # ---- 2. kernels against their plain versions -----------------------
    kernel_rows = {}

    def check(kname, kfn, pfn, src, repl, shape, inputs, kout=None, pout=None, counts=None,
              kept=None, library=None, library_name=None, row_key=None, split=False):
        kout = kfn() if kout is None else kout
        pout = pfn() if pout is None else pout
        torch.cuda.synchronize()
        err = max_abs_err(kout, pout)
        bound = bound_ms(inputs, kout)
        extra = {}
        if counts is not None:
            extra["bound_padded_ms"] = bound
            bound = emit_bound_ms(inputs[0], kout, counts)
        if kept is not None:        # a compaction: see the module docstring
            extra["bound_padded_ms"] = bound
            vals, kp = inputs
            n_kept, sectors = int(kout[1]), value_sectors(vals, kp)
            nbytes = (kp.numel() * kp.element_size() + sectors * SECTOR_BYTES
                      + n_kept * vals.element_size() + 4)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            extra.update(kept=n_kept, value_sectors=sectors,
                         tail_bytes=(vals.numel() - n_kept) * vals.element_size())
        del kout, pout
        torch.cuda.empty_cache()
        ms = cuda_time(kfn, 10)
        plain_ms = cuda_time(pfn, 3)
        lib_ms = cuda_time(library, 10) if library is not None else None
        if library_name:
            extra["library_call"] = library_name
        if split:                   # device ms of each launch inside one call
            extra["launch_split"] = launch_split(kfn, 10)
        torch.cuda.empty_cache()
        row = {"name": kname, "route": "cuda", "source": src, "replaces": repl,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": "bytes", "library_ms": lib_ms, **extra}
        emit({"phase": "kernel", "shape": shape, "card": card, **row})
        if err != 0:
            raise AssertionError(f"{kname}: kernel differs from its plain version ({err})")
        kernel_rows[row_key or kname] = row

    # FASTQ: the full block of the 500,000-read input
    name, data = fastq_inputs[1]
    xq, prev_q = fastq_block(data, dev)
    shape = f"{name} block u8[{xq.numel()}]"
    check("emit_fastq", lambda: EF.emit_fastq_kernel(xq, prev_q),
          lambda: EF.emit_fastq_plain(xq, prev_q), "naf_tpu_torch/csrc/emit_fastq.cu",
          "naf_tpu/ops/emit_fused.py:515", shape, [xq], counts=("cnt", "cnt_qual", "cnt_id"),
          split=True)
    check("classify_fastq", lambda: SF.classify_fastq_kernel(xq, prev_q),
          lambda: SF.classify_fastq_plain(xq, prev_q),
          "naf_tpu_torch/csrc/classify_fastq.cu", "naf_tpu/ops/scan_fused.py:364", shape, [xq],
          split=True)
    del xq
    # the standalone classify on the block the SRA input's two-pass path gives it
    name, data = two_pass_inputs[2][:2]
    xs, prev_s = fastq_block(data, dev)
    check("classify_fastq", lambda: SF.classify_fastq_kernel(xs, prev_s),
          lambda: SF.classify_fastq_plain(xs, prev_s),
          "naf_tpu_torch/csrc/classify_fastq.cu", "naf_tpu/ops/scan_fused.py:364",
          f"{name} block u8[{xs.numel()}]", [xs], row_key="classify_fastq:sra", split=True)
    del xs

    # FASTA: the block of the one-record input
    name, data = fasta_inputs[1]
    x, prev = fasta_block(data, dev)
    shape = f"{name} block u8[{x.numel()}]"
    kern = EF.emit_fasta_kernel(x, prev)
    sv, out_len, seq_packed, chars, tog = render_inputs(kern)
    check("emit_fasta", lambda: EF.emit_fasta_kernel(x, prev), lambda: EF.emit_fasta_plain(x, prev),
          "naf_tpu_torch/csrc/emit_fasta.cu", "naf_tpu/ops/emit_fused.py:242", shape, [x],
          kout=kern, counts=("cnt",), split=True)
    del kern
    check("classify_fasta", lambda: SF.classify_fasta_kernel(x, prev),
          lambda: SF.classify_fasta_plain(x, prev), "naf_tpu_torch/csrc/classify.cu",
          "naf_tpu/ops/scan_fused.py:138", shape, [x], split=True)
    check("pack_4bit", lambda: PK.pack_4bit_kernel(sv, out_len=out_len),
          lambda: PK.pack_4bit_plain(sv, out_len=out_len), "naf_tpu_torch/csrc/pack.cu",
          "naf_tpu/ops/pack.py:78", f"sv u8[{sv.numel()}]", [sv])
    check("unpack_4bit", lambda: UP.unpack_4bit_kernel(seq_packed),
          lambda: UP.unpack_4bit_plain(seq_packed), "naf_tpu_torch/csrc/unpack.cu",
          "naf_tpu/ops/unpack.py:59", f"packed u8[{seq_packed.numel()}]", [seq_packed])
    check("apply_mask_parity", lambda: EF.apply_mask_parity_kernel(chars, tog),
          lambda: EF.apply_mask_parity_plain(chars, tog), "naf_tpu_torch/csrc/mask_parity.cu",
          "naf_tpu/ops/emit_fused.py:757", f"chars u8[{chars.numel()}]", [chars, tog],
          split=True)
    # the same chars under a bound every 1-3 bytes
    tog = dense_toggles(chars.numel(), dev)
    check("apply_mask_parity", lambda: EF.apply_mask_parity_kernel(chars, tog),
          lambda: EF.apply_mask_parity_plain(chars, tog), "naf_tpu_torch/csrc/mask_parity.cu",
          "naf_tpu/ops/emit_fused.py:757", f"chars u8[{chars.numel()}] dense toggles",
          [chars, tog], row_key="apply_mask_parity:dense", split=True)
    del x, sv, seq_packed, chars, tog

    # scans and compactions: the protein input's two-pass block, its masks
    # from the standalone classify, as stats_block and emit_block pass them
    name, data = two_pass_inputs[0][:2]
    xp, prev_p = fasta_block(data, dev)
    shape = f"{name} block [{xp.numel()}]"
    # the standalone classify on the block its two-pass path gives it
    check("classify_fasta",
          lambda: SF.classify_fasta_kernel(xp, prev_p, seq_type=C.SEQ_TYPE_PROTEIN),
          lambda: SF.classify_fasta_plain(xp, prev_p, seq_type=C.SEQ_TYPE_PROTEIN),
          "naf_tpu_torch/csrc/classify.cu", "naf_tpu/ops/scan_fused.py:138",
          f"{shape} protein", [xp], row_key="classify_fasta:protein", split=True)
    del xp
    xp, sm, pos = protein_masks(data, dev)
    keep, enc = scan_inputs(xp, sm, pos)
    check("cumsum_i32", lambda: SF.scan_i32_kernel(keep, "add"),
          lambda: SF.cumsum_i32_plain(keep), "naf_tpu_torch/csrc/scan.cu",
          "naf_tpu/ops/scan_fused.py:283", f"{shape} stream_keep bool -> i32", [keep],
          library=lambda: torch.cumsum(keep, 0, dtype=torch.int32), library_name="torch.cumsum",
          split=True)
    check("maxscan_i32", lambda: SF.scan_i32_kernel(enc, "max"),
          lambda: SF.maxscan_i32_plain(enc), "naf_tpu_torch/csrc/scan.cu",
          "naf_tpu/ops/scan_fused.py:283", f"{shape} run-start code i32 -> i32", [enc],
          library=lambda: torch.cummax(enc, 0),
          library_name="torch.cummax (values and indices, no floor)", split=True)
    split = {}
    for key, kname, vals, kp, dense, repl, what in compactions(xp, sm, pos):
        check(kname, lambda: CP.compact_kernel(vals, kp, dense=dense),
              lambda: CP.compact_plain(vals, kp), "naf_tpu_torch/csrc/compact.cu", repl,
              f"{shape} {what}", [vals, kp], kept=True,
              library=lambda: torch.masked_select(vals, kp),
              library_name="torch.masked_select (the kept prefix only: no zero tail, no "
                           "count tensor)", row_key=key)
        split[key] = launch_split(lambda: CP.compact_kernel(vals, kp, dense=dense), 10)
    emit({"phase": "compact_launches", "card": card, "shape": shape,
          "device_ms_per_call": split})
    del xp, sm, keep, pos, enc
    torch.cuda.empty_cache()

    # ---- 3. encode, 4. decode: each path, counted -----------------------
    def delta(before: dict, after: dict) -> dict:
        return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}

    def decode(blob: bytes, fastq: bool) -> bytes:
        d = Decoder(io.BytesIO(blob), DecodeOptions())
        return fastq_device(d, device=dev) if fastq else fasta_device(d, device=dev)

    def host_decode(blob: bytes, fastq: bool) -> bytes:
        d = Decoder(io.BytesIO(blob), DecodeOptions())
        return d.fastq() if fastq else d.fasta()

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
            out = decode(archives[i], fastq)
            dec_s = time.perf_counter() - t0
            routes = delta(routes_before, D.ROUTES)
            row = {"phase": "decode", "input": name, "card": card, "routes": routes,
                   "seconds": dec_s}
            if out != host_decode(archives[i], fastq):
                raise AssertionError(f"{name}: decoded bytes != host Decoder's")
            row["equal_host"] = True
            if i < 2 or fastq:
                if routes != {"decode_device": 1}:
                    raise AssertionError(f"{name}: decode took route {routes}")
                for k in ("unpack_4bit",) if fastq else ("unpack_4bit", "apply_mask_parity"):
                    if D.LAUNCHES[k] <= before[k]:
                        raise AssertionError(f"{name}: {k} did not launch")
            elif list(routes) != ["decode_device:ragged:too_many_groups"]:
                raise AssertionError(f"{name}: decode took route {routes}")  # the ragged input
            if i < 2:
                if out != data:
                    raise AssertionError(f"{name}: decoded bytes != input bytes")
                row["equal_input"] = True
            emit(row)
        return archives, dict(D.LAUNCHES)

    def run_two_pass(inputs) -> tuple[list, dict, dict]:
        """The two-pass encodes, counted from 0; (archives, launches, host
        encode seconds)."""
        D.reset_counts()
        archives, host_s = [], {}
        for name, data, o, why, fastq in inputs:
            before, routes_before = dict(D.LAUNCHES), dict(D.ROUTES)
            t0 = time.perf_counter()
            blob, stats = encode_device(data, o, device=dev)
            enc_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            host_blob, host_stats = encode(data, o)
            host_s[name] = time.perf_counter() - t0
            if blob != host_blob:
                raise AssertionError(f"{name}: device archive != host encode() archive")
            for f in ("n_sequences", "longest_line", "seq_size_original", "unexpected_id",
                      "unexpected_comment", "unexpected_seq", "unexpected_qual"):
                if not np.array_equal(getattr(stats, f), getattr(host_stats, f)):
                    raise AssertionError(f"{name}: EncodeStats.{f} differs from host encode()'s")
            routes = delta(routes_before, D.ROUTES)
            if routes != {f"encode_device:two_pass:{why}": 1}:
                raise AssertionError(f"{name}: encode took route {routes}")
            needed = ["classify_fastq" if fastq else "classify_fasta", "cumsum_i32",
                      "maxscan_i32", "compact", "compact_dense"]
            if o.seq_type < C.SEQ_TYPE_PROTEIN:
                needed.append("pack_4bit")
            for k in needed:
                if D.LAUNCHES[k] <= before[k]:
                    raise AssertionError(f"{name}: {k} did not launch")
            archives.append(blob)
            emit({"phase": "encode", "input": name, "card": card, "bytes": len(data),
                  "archive": len(blob), "equal_host": True, "equal_stats": True,
                  "unexpected_seq_total": int(stats.unexpected_seq.sum()), "routes": routes,
                  "seconds": enc_s, "host_encode_seconds": host_s[name]})
        return archives, dict(D.LAUNCHES), host_s

    def run_ragged(items) -> tuple[dict, dict]:
        """The ragged decodes, counted from 0; (launches, host decode seconds)."""
        D.reset_counts()
        host_s = {}
        for name, data, blob, fastq, round_trips, ragged in items:
            before, routes_before = dict(D.LAUNCHES), dict(D.ROUTES)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = decode(blob, fastq)
            dec_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            routes = delta(routes_before, D.ROUTES)
            if ragged:
                if len(routes) != 1 or not next(iter(routes)).startswith("decode_device:ragged:"):
                    raise AssertionError(f"{name}: decode took route {routes}")
                if D.LAUNCHES["maxscan_i32"] <= before["maxscan_i32"]:
                    raise AssertionError(f"{name}: maxscan_i32 did not launch")
            elif routes != {"decode_device": 1}:
                raise AssertionError(f"{name}: decode took route {routes}")
            t0 = time.perf_counter()
            host = host_decode(blob, fastq)
            host_s[name] = time.perf_counter() - t0
            if out != host:
                raise AssertionError(f"{name}: decoded bytes != host Decoder's")
            row = {"phase": "decode", "input": name, "card": card, "routes": routes,
                   "equal_host": True, "seconds": dec_s, "host_decode_seconds": host_s[name],
                   "launches": delta(before, D.LAUNCHES), "peak_device_bytes": peak,
                   "peak_above_start_bytes": peak - base, "output_bytes": len(out)}
            if round_trips:
                if out != data:
                    raise AssertionError(f"{name}: decoded bytes != input bytes")
                row["equal_input"] = True
            emit(row)
        return dict(D.LAUNCHES), host_s

    fasta_archives, fasta_launches = run_path(fasta_inputs, fastq=False)
    fastq_archives, fastq_launches = run_path(fastq_inputs, fastq=True)
    for name, data, _, why, fastq in two_pass_inputs:
        if why == "sparse_overflow":       # the counts behind the route
            most = max_sparse_per_tile(data, fastq)
            emit({"phase": "overflow_check", "input": name, "max_sparse_entries_per_tile": most,
                  "cap": EF.CS_CAP})
            if most <= EF.CS_CAP:
                raise AssertionError(f"{name}: no tile past the sparse cap ({most})")
    two_pass_archives, two_pass_launches, host_enc_s = run_two_pass(two_pass_inputs)
    # (name, input, archive, FASTQ, decodes to the input, ragged): gen_fasta(16)'s
    # 16 records have two shapes, so the uniform render takes its archive
    ragged_items = [(n, d, blob, fq, i < 2, i < 3) for i, ((n, d, _, _, fq), blob)
                    in enumerate(zip(two_pass_inputs, two_pass_archives))]
    ragged_items.append((fasta_inputs[2][0], fasta_inputs[2][1], fasta_archives[2], False, False,
                         True))
    ragged_launches, host_dec_s = run_ragged(ragged_items)
    path_launches = {"fasta": fasta_launches, "fastq": fastq_launches,
                     "two_pass": two_pass_launches, "ragged": ragged_launches}
    emit({"phase": "launches", **{f"{k}_path": v for k, v in path_launches.items()}})
    needed = {"fasta": ("emit_fasta", "pack_4bit", "unpack_4bit", "apply_mask_parity"),
              "fastq": ("emit_fastq", "pack_4bit", "unpack_4bit"),
              "two_pass": ("classify_fasta", "classify_fastq", "cumsum_i32", "maxscan_i32",
                           "compact", "compact_dense", "pack_4bit"),
              "ragged": ("cumsum_i32", "maxscan_i32")}
    for pname, ks in needed.items():
        for k in ks:
            if path_launches[pname][k] <= 0:
                raise AssertionError(f"{k} was not launched on the {pname} path")

    # ---- 5. rates ----------------------------------------------------------
    def rates(name, data, blob, fastq: bool) -> None:
        mb = len(data) / 1e6
        e2e_enc = wall_time(lambda: encode_device(data, opts, device=dev), 2)
        e2e_dec = wall_time(lambda: decode(blob, fastq), 2)
        if fastq:
            blocks, _ = make_blocks_fastq(np.frombuffer(data, np.uint8)[1:], 1)
            xb = torch.from_numpy(blocks.data[0].copy()).to(dev)
            enc_ms = cuda_time(lambda: fused_block_fastq(xb, int(blocks.prev[0]), 0, seq_type=0,
                                                         device=dev), 5)
            d = Decoder(io.BytesIO(blob), DecodeOptions())
            plan, raw = d._plan(PD.MODE_FASTQ, False)
            run = PD.regular_session(plan, raw, d._load_qual(), device=dev)
        else:
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

    def rates_two_pass(name, data, o, blob, fastq: bool) -> None:
        """End to end, and device-resident: stats_block + emit_block on the
        uploaded block, and the first batch of the ragged render."""
        mb = len(data) / 1e6
        e2e_enc = wall_time(lambda: encode_device(data, o, device=dev), 2)
        e2e_dec = wall_time(lambda: decode(blob, fastq), 2)
        dr = two_pass_device_ms(data, o, blob, fastq, dev)
        emit({"phase": "rates", "input": name, "card": card,
              "encode_e2e_MBps": mb / e2e_enc, "decode_e2e_MBps": mb / e2e_dec,
              "host_encode_MBps": mb / host_enc_s[name],
              "host_decode_MBps": mb / host_dec_s[name] if name in host_dec_s else None,
              **dr,
              "stats_emit_device_resident_MBps": mb / (dr["stats_emit_device_resident_ms"] / 1e3),
              "ragged_batch_MBps": dr["ragged_batch_bytes"] / 1e6 / (dr["ragged_batch_ms"] / 1e3)})

    for i in range(2):
        rates(*fasta_inputs[i], fasta_archives[i], fastq=False)
    for i in range(3):
        rates(*fastq_inputs[i], fastq_archives[i], fastq=True)
    for (name, data, o, _, fastq), blob in zip(two_pass_inputs, two_pass_archives):
        rates_two_pass(name, data, o, blob, fastq)

    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "naf_tpu"))
    if bad:
        raise AssertionError(f"the port's path imported {bad[:5]}")

    order = ("emit_fasta", "classify_fasta", "pack_4bit", "unpack_4bit", "apply_mask_parity",
             "emit_fastq", "classify_fastq", "cumsum_i32", "maxscan_i32", "compact",
             "compact_dense")
    total = {k: sum(p[k] for p in path_launches.values()) for k in order}
    fused = {"classify_fasta": "emit_fasta", "classify_fastq": "emit_fastq"}
    kernels = []
    for k in order:
        row = dict(kernel_rows[k], launches=total[k])
        if k in fused:
            row.update(fused_into=fused[k], fused_launches=total[fused[k]])
        for nested, key in (("protein", "classify_fasta"), ("sra", "classify_fastq"),
                            ("dense", "apply_mask_parity")):
            if k == key:
                p = kernel_rows[f"{key}:{nested}"]
                row[nested] = {f: p[f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "library_ms", "launch_split")}
        if k == "compact":
            i32 = kernel_rows["compact:i32"]
            row["i32"] = {f: i32[f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_padded_ms", "tail_bytes", "library_ms",
                                              "kept", "value_sectors")}
        kernels.append(row)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
