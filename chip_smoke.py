#!/usr/bin/env python3
"""Drive naf_tpu_torch's device encodes and decodes once on one CUDA card.

    python3 chip_smoke.py [--mesh]

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
  5. rates: encode and decode MB/s, end to end and device-resident;
  6. the CLI: the port's ``tnaf --device`` and ``untnaf --device`` through
     their ``main`` in this process, with ``-o`` files, on
     gen_fasta_single(128) (fused FASTA), gen_fastq(500_000, read_len=150)
     (fused FASTQ) and swissprot_like(160) (two-pass encode, ragged decode):
     each archive must equal the host ``tnaf``'s, each decode the input and
     the host ``untnaf``'s, by the expected routes, each wall time printed
     beside the in-process ``encode_device`` / ``fasta_device`` time; one
     ``tnaf --device -c < gen_fasta(64) | untnaf --device -c`` pipe of two
     processes, whose stderr must be empty, whose output must be the input,
     and whose encode streams on the card (``encode_device:stream``, every
     piece ``stream_device``); the peak device memory of ``tnaf --device``
     on gen_fasta_single(252), just under the 256 MiB in-memory threshold;
     ``tnaf --device`` on gen_fasta(300), a file over the threshold, which
     streams on the card (its archive equal to the host ``tnaf``'s, its
     peak device memory printed); and ``tnaf --device --engine native`` /
     ``untnaf --device --engine native`` on gen_fasta_single(128), equal to
     the host CLI with the same engine and to the input, host times beside.
     Traced, each in a process of its own: ``tnaf --device`` and ``untnaf
     --device`` on gen_fasta_single(128) and gen_fastq(500_000,
     read_len=150) under NAF_TPU_TRACE=1, and the host ``untnaf`` of the
     FASTQ archive (whole-buffer), each giving the untraced bytes and
     exactly naf_tpu's spans of its path (none on the in-memory encode,
     ``seq-unzstd`` on a device decode, ``seq+qual-unzstd`` and ``render``
     on the host FASTQ decode), their times printed; ``tnaf --device`` on
     gen_fasta(300), one ``scan`` span a streamed piece; ``tnaf --device``
     and ``untnaf --device`` on gen_fasta_single(128) under
     NAF_TPU_PROFILE=build/profile, one torch.profiler trace a process
     holding a CUDA kernel event of every kernel its run launched, with the
     device busy share the trace gives beside ``stage_probe.busy_share``'s
     of the same calls in a process of its own; and the host ``untnaf`` of the
     FASTQ archive in this process with the two-thread decompress and with
     the serial loads, in turns.  The traced and profiled processes'
     launches join the CLI path's counts;
  7. the stream: ``encode_stream`` with ``DeviceScanEngine`` on the card in
     64 MiB chunks against the host ``encode_stream`` (its default chunk),
     on gen_fasta_single(1024) (1.07 GB, one record continued across
     chunks) and gen_fastq(1_600_000, read_len=150) (0.51 GB): each archive
     equal to the host stream's, every piece on the fused device path, the
     emit and pack launched once a piece, the peak device memory above the
     start under 738,199,040 bytes (the in-memory encode's of a 4x smaller
     input), both rates printed;
  8. the mesh: four blocks, all on the card (``block_mesh(devices=[card]
     * 4)``), or one block a card when several cards are visible
     (``block_mesh()``): ``encode_device`` on gen_fasta_single(128),
     gen_fastq(500_000, read_len=150), swissprot_like(160) and
     illumina_reads_fasta(750_000), each archive equal to host encode()'s
     by its route, its wall time, device-resident time (the passes on
     blocks already uploaded) and peak memory on each card beside the
     one-block encode's; the mesh render of the FASTQ and the protein
     archive (``decode_device:ragged:mesh``) equal to the host Decoder,
     beside the one-block render's time; ``DeviceScanEngine`` over the mesh
     on gen_fasta_single(1024) equal to the host stream; the multihost
     encodes (plain, parts, extended) on gen_fasta(64) and
     gen_fastq(250_000), first NCCL in this process (world size 1, four
     blocks on the first card), then two processes on gloo, two blocks
     each, which share the card when there is one (NCCL takes one rank a
     card), and with several cards one NCCL process a card: the plain archive equal to host
     encode()'s, the others decoding to its decode, the ranks' archives
     the same, each with its bytes gathered and wall time; and
     ``dryrun_multichip``, the checks of ``__graft_entry__.py``'s dry run
     over the mesh.  ``--mesh`` runs phase 1 and this phase only;
  9. the device zstd engine (``compress_section_device``): the keys and
     chain kernels of ``csrc/matchfind.cu`` against their plain versions
     at a level-19 ``--long 27`` span's shapes (a window padded to 2^27
     positions, depth 16; the anchor pass over a window padded to 2^28
     bytes), with ``torch.sort(stable=True)``'s time beside them; then the
     packed SEQ section of gen_fasta_single(252) at level 19, window log 27
     (cut to the prefix whose serializer time a one-span probe puts inside
     ``ENGINE_BUDGET_S``), that of gen_fasta_single(128) and the quality
     section of gen_fastq(500_000, read_len=150) at level 1, and
     ``encode(engine="device")`` of gen_fasta_single(128): every frame
     must decode to its input, the first, a middle and the last span's
     candidates must equal the plain versions' on the card, the archive
     must decode to the input; each call's per-span device ms (keys, sort,
     chain, fetch), serializer seconds, MB/s, payload and peak device
     memory are printed beside ``compress_section_native``'s.
Eight paths run with the launch counts set to 0 just before and read just
after each: the fused FASTA path and the fused FASTQ path (phases 3-4 on
their inputs), the two-pass encodes, the ragged decodes, the CLI (its
in-process calls and the pipe's two processes), the stream, the mesh
(the spawned ranks' launches added) and the device engine.  Every kernel
of a path must have launched in it; the kernels line sums the eight.  The
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
#: the chunk of the streamed device encode, as ``tnaf --device`` streams
STREAM_CHUNK = 64 << 20
#: the blocks of the mesh phase on a one-card machine, all on that card
MESH_BLOCKS = 4
#: seconds a rank of the two-process multihost run may take, rendezvous
#: included
MULTIHOST_TIMEOUT = 300
#: files from this size on stream in ``tnaf`` (NAF_TPU_STREAM_THRESHOLD)
STREAM_THRESHOLD = 256 << 20
#: a stream's peak device memory above its start must stay under the peak of
#: the in-memory encode of gen_fasta_single(252) (267.5 MB; PERF.md section 5),
#: four times smaller than the 1 GB stream input
PEAK_LIMIT = 738_199_040
#: seconds the level-19 device-engine call may spend in the host serializer;
#: a probe of one span sets the prefix of the section it compresses
ENGINE_BUDGET_S = 150
#: the prefix of the level-19 section both engines compress as a yardstick
YARDSTICK_BYTES = 8 << 20
#: the level and --long window log of the device engine's high-level call
ENGINE_LEVEL, ENGINE_WINDOW_LOG = 19, 27


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


def chain_key_sectors(sk, order, k: int, r0: int, r1: int, stride: int) -> int:
    """The 32-byte sectors of ``sk`` that a depth-``k`` chain over the span
    [r0, r1) must read: each span entry's key and its earlier neighbours in
    the sort down to the first unequal one, at most k (a run ends there)."""
    import torch

    m = sk.numel()
    i = torch.arange(m, device=sk.device)
    new = torch.ones(m, dtype=torch.bool, device=sk.device)
    new[1:] = sk[1:] != sk[:-1]
    start = torch.cummax(torch.where(new, i, 0), 0).values
    idx = torch.nonzero(((order + 1) * stride > r0) & (order * stride < r1)).squeeze(1)
    first = (idx - torch.clamp(idx - start[idx] + 1, max=k)).clamp(min=0)
    del new, start
    # sk[first:idx + 1] for every span entry, as a difference array
    diff = torch.zeros(m + 1, dtype=torch.int32, device=sk.device)
    ones = torch.ones_like(idx, dtype=torch.int32)
    diff.index_add_(0, first, ones)
    diff.index_add_(0, idx + 1, -ones)
    return value_sectors(sk, diff.cumsum(0, dtype=torch.int32)[:m] > 0)


def kernel_name(event_name: str) -> str:
    """A profiler's kernel name, template arguments and parameters cut."""
    return event_name.split("(")[0].split("<")[0].removeprefix("void ")


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
            name = kernel_name(e.name)
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
    from naf_tpu_torch.parallel.block import (emit_blocks_sharded, make_blocks, make_blocks_fastq,
                                              stats_blocks_sharded)
    from naf_tpu_torch.parallel.mesh import block_mesh
    from naf_tpu_torch.pipeline.decoder import DecodeOptions, Decoder

    body = np.frombuffer(data, np.uint8)[1:]
    blocks = make_blocks_fastq(body, 1)[0] if fastq else make_blocks(body, 1)
    xb = torch.from_numpy(blocks.data[0].copy()).to(dev)
    prev, sis = int(blocks.prev[0]), bool(blocks.starts_in_seq[0])

    def passes():
        stats, masks = stats_blocks_sharded([xb], [prev], [sis], seq_type=o.seq_type,
                                            fastq=fastq)
        emit_blocks_sharded([xb], masks, stats, seq_type=o.seq_type, fastq=fastq,
                            pack_nibbles=o.seq_type < C.SEQ_TYPE_PROTEIN)

    passes_ms = cuda_time(passes, reps)
    del xb
    d = Decoder(io.BytesIO(blob), DecodeOptions())
    plan, raw = d._plan(PD.MODE_FASTQ, False) if fastq else d._fasta_plan(d.masking)
    batches, render = PD.ragged_session(plan, raw, d._load_qual() if fastq else None,
                                        mesh=block_mesh(devices=[dev]))
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


def run_cli(tool: str, argv: list) -> float:
    """Wall seconds of the port's ``tool`` run through its ``main`` in this
    process; raises when it exits non-zero."""
    import importlib

    import torch

    main = importlib.import_module(f"naf_tpu_torch.cli.{tool}").main
    t0 = time.perf_counter()
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"{tool} {' '.join(argv)} exited {rc}")
    return time.perf_counter() - t0


#: the port's CLI in a process of its own, which writes the run's counts
#: (``device.ROUTES``, ``device.LAUNCHES``) to argv[1] as JSON when it ends
_COUNTED_CLI = """import json, sys
from naf_tpu_torch.cli import {tool}
try:
    rc = {tool}.main(sys.argv[2:])
except SystemExit as e:
    rc = e.code
from naf_tpu_torch import device
json.dump({{"routes": device.ROUTES, "launches": device.LAUNCHES}}, open(sys.argv[1], "w"))
sys.exit(rc)
"""


#: the CUDA kernel of each launch count of ``device.LAUNCHES``, as a profiler
#: trace names it (``kernel_name``: template arguments and parameters cut)
KERNEL_NAMES = {k: f"naf::{v}_kernel" for k, v in (
    ("emit_fasta", "emit_fasta"), ("classify_fasta", "classify_fasta"), ("pack_4bit", "pack"),
    ("unpack_4bit", "unpack"), ("apply_mask_parity", "mask_parity"),
    ("emit_fastq", "emit_fastq"), ("classify_fastq", "classify_fastq"),
    ("cumsum_i32", "scan"), ("maxscan_i32", "scan"), ("compact", "compact"),
    ("compact_dense", "compact"), ("match_keys", "match_keys"), ("match_chain", "match_chain"))}


def span_rows(stderr: bytes) -> list:
    """Each ``[naf-trace]`` line of ``stderr``: its stage, ms and fields."""
    rows = []
    for line in stderr.decode().splitlines():
        if line.startswith("[naf-trace] "):
            parts = line.split()
            rows.append({"stage": parts[1], "ms": float(parts[2]),
                         **dict(f.split("=", 1) for f in parts[4:] if "=" in f)})
    return rows


def trace_summary(path: str, launches: dict) -> dict:
    """The kernel events by name and the device busy share of one
    torch.profiler trace: kernels, copies and memsets summed over the span
    of every event, as ``stage_probe.busy_share`` sums them over a call's
    wall time.  Raises unless every kernel ``launches`` counts has an
    event."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels: dict = {}
    busy_us = 0.0
    for e in events:
        cat = str(e.get("cat", "")).lower()
        if cat == "kernel":
            name = kernel_name(e["name"])
            kernels[name] = kernels.get(name, 0) + 1
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy_us += e.get("dur", 0)
    span_us = max(e["ts"] + e.get("dur", 0) for e in events) - min(e["ts"] for e in events)
    ours = {KERNEL_NAMES[k] for k, v in launches.items() if v}
    missing = sorted(n for n in ours if not kernels.get(n))
    if missing:
        raise AssertionError(f"{path}: no CUDA kernel event of {missing}; kernels {kernels}")
    return {"kernel_events": {n: kernels[n] for n in sorted(ours)},
            "launches": {k: v for k, v in launches.items() if v},
            "trace_bytes": os.path.getsize(path), "events": len(events),
            "device_busy_s": busy_us / 1e6, "trace_span_s": span_us / 1e6,
            "idle_share": max(0.0, 1 - busy_us / span_us)}


#: ``stage_probe.busy_share`` of ``encode_device`` on the FASTA file argv[1]
#: and of ``fasta_device`` on its archive argv[2], in a process of its own
#: (in this one, after the earlier phases' profiles, it found no device event)
_BUSY_SHARE = """import io, json, os, sys
from stage_probe import busy_share
from naf_tpu_torch.device import cuda_device
from naf_tpu_torch.parallel.pipeline import encode_device
from naf_tpu_torch.pipeline.decoder import Decoder, fasta_device
from naf_tpu_torch.pipeline.encoder import EncodeOptions
data, blob = open(sys.argv[1], "rb").read(), open(sys.argv[2], "rb").read()
dev, o = cuda_device(), EncodeOptions(level=1, threads=os.cpu_count() or 0)
print(json.dumps({"encode": busy_share(lambda: encode_device(data, o, device=dev)),
                  "decode": busy_share(lambda: fasta_device(Decoder(io.BytesIO(blob)),
                                                            device=dev))}))
"""


def stream_routes_ok(routes: dict) -> bool:
    """One streamed ``tnaf --device`` whose every piece took the fused
    device path."""
    return (set(routes) == {"encode_device:stream", "stream_device"}
            and routes["encode_device:stream"] == 1 and routes["stream_device"] > 0)


def cli_phase(card: str, dev, cases: list, pipe_input: tuple, threshold_input: tuple,
              stream_input: tuple, native_input: tuple, opts) -> dict:
    """Phase 6 (see the module docstring); returns the CLI path's launch
    counts, counted from 0, the pipe's processes added in."""
    import shutil
    import tempfile

    import torch

    from naf_tpu_torch import device as D
    from naf_tpu_torch.codec import set_decode_engine
    from naf_tpu_torch.parallel.pipeline import encode_device
    from naf_tpu_torch.pipeline.decoder import Decoder, fasta_device, fastq_device
    from naf_tpu_torch.pipeline.encoder import encode

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=os.path.join(here, "build"))

    def path(name: str) -> str:
        return os.path.join(work, name)

    def read(name: str) -> bytes:
        with open(path(name), "rb") as f:
            return f.read()

    def routes_of(fn) -> dict:
        before = dict(D.ROUTES)
        fn()
        return {k: v - before.get(k, 0) for k, v in D.ROUTES.items() if v != before.get(k, 0)}

    def took(got: dict, route: str) -> bool:
        """One call by ``route``; a route ending in ':' names a prefix."""
        return (list(got.values()) == [1]
                and (next(iter(got)).startswith(route) if route.endswith(":")
                     else route in got))

    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    sub_launches = dict.fromkeys(D.LAUNCHES, 0)

    def counted(tool: str, argv: list, **env_extra) -> dict:
        """The port's ``tool`` in a process of its own under ``env_extra``:
        its seconds (the process start included), stderr, pid and counts,
        whose launches join ``sub_launches``; raises when it exits
        non-zero."""
        t0 = time.perf_counter()
        with open(path("counted.err"), "wb") as err:
            p = subprocess.Popen([sys.executable, "-c", _COUNTED_CLI.format(tool=tool),
                                  path("counted.json"), *argv], stdout=subprocess.DEVNULL,
                                 stderr=err, env=dict(env, **env_extra), cwd=here)
            rc = p.wait(timeout=600)
        seconds = time.perf_counter() - t0
        stderr = read("counted.err")
        if rc != 0:
            raise AssertionError(f"{tool} {' '.join(argv)} exited {rc}: {stderr[-2000:]!r}")
        with open(path("counted.json")) as f:
            counts = json.load(f)
        for k, v in counts["launches"].items():
            sub_launches[k] += v
        return {"seconds": seconds, "stderr": stderr, "pid": p.pid, **counts}

    def spans_of(run: dict, stages: list) -> dict:
        """A traced run's seconds and spans; raises unless its stderr holds
        exactly the trace lines of ``stages``."""
        spans = span_rows(run["stderr"])
        lines = run["stderr"].splitlines()
        if [sp["stage"] for sp in spans] != stages or len(lines) != len(spans):
            raise AssertionError(f"spans {[sp['stage'] for sp in spans]} != {stages}; "
                                 f"stderr {run['stderr'][-2000:]!r}")
        return {"seconds": run["seconds"], "spans": spans}

    def traced(src: str, data: bytes, fastq: bool) -> dict:
        """``tnaf --device`` and ``untnaf --device``, and on FASTQ the host
        ``untnaf`` (whole-buffer: the archive is over the stream threshold's
        quarter), under NAF_TPU_TRACE=1: the untraced bytes, naf_tpu's spans
        of each path (none on an in-memory encode)."""
        out = {"tnaf_device": spans_of(counted(
            "tnaf", ["--device", "-o", path("traced.naf"), src], NAF_TPU_TRACE="1"), [])}
        if read("traced.naf") != read("dev.naf"):
            raise AssertionError("traced tnaf --device archive != untraced")
        out["untnaf_device"] = spans_of(counted(
            "untnaf", ["--device", "-o", path("traced.out"), path("traced.naf")],
            NAF_TPU_TRACE="1"), ["seq-unzstd"])
        if read("traced.out") != data:
            raise AssertionError("traced untnaf --device output != the input")
        if fastq:
            out["untnaf_host"] = spans_of(counted(
                "untnaf", ["-o", path("traced.out"), path("traced.naf")], NAF_TPU_TRACE="1",
                NAF_TPU_STREAM_THRESHOLD=str(1 << 40)), ["seq+qual-unzstd", "render"])
            if read("traced.out") != data:
                raise AssertionError("traced host untnaf output != the input")
        return out

    def profiled(src: str, data: bytes) -> dict:
        """``tnaf --device`` and ``untnaf --device`` under
        NAF_TPU_PROFILE=build/profile: one trace a process holding a CUDA
        kernel event of every kernel its run launched; then
        ``stage_probe.busy_share`` of the same encode and decode."""
        prof = os.path.join(here, "build", "profile")
        shutil.rmtree(prof, ignore_errors=True)
        out = {}
        for tool, argv, result, want in (
                ("tnaf", ["--device", "-o", path("prof.naf"), src], "prof.naf", read("dev.naf")),
                ("untnaf", ["--device", "-o", path("prof.out"), path("prof.naf")], "prof.out",
                 data)):
            before = set(os.listdir(prof)) if os.path.isdir(prof) else set()
            run = counted(tool, argv, NAF_TPU_PROFILE=prof)
            if read(result) != want:
                raise AssertionError(f"profiled {tool} --device output != untraced")
            new = sorted(set(os.listdir(prof)) - before)
            if len(new) != 1 or str(run["pid"]) not in new[0]:
                raise AssertionError(f"profiled {tool} --device wrote {new}")
            out[tool] = {"seconds": run["seconds"], "trace": os.path.join("build", "profile",
                                                                          new[0]),
                         **trace_summary(os.path.join(prof, new[0]), run["launches"])}
        r = subprocess.run([sys.executable, "-c", _BUSY_SHARE, src, path("dev.naf")],
                           capture_output=True, env=env, cwd=here, timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"busy share exited {r.returncode}: {r.stderr[-2000:]!r}")
        out["stage_probe_busy"] = json.loads(r.stdout.splitlines()[-1])
        return out

    def host_fastq_untnaf(archive: str, data: bytes) -> dict:
        """Best wall seconds of 2 host ``untnaf`` runs of a FASTQ archive in
        this process, whole-buffer, with the two-thread decompress and with
        serial loads, the sequence then the quality (``_load_seq_and_qual``
        replaced by the sequence load alone), in turns serial, two threads,
        two threads, serial."""
        two_threads = Decoder._load_seq_and_qual
        threshold = os.environ.get("NAF_TPU_STREAM_THRESHOLD")
        os.environ["NAF_TPU_STREAM_THRESHOLD"] = str(1 << 40)
        times: dict = {"serial": [], "two_threads": []}
        try:
            for how in ("serial", "two_threads", "two_threads", "serial"):
                Decoder._load_seq_and_qual = (two_threads if how == "two_threads"
                                              else Decoder._load_seq_raw)
                times[how].append(run_cli("untnaf", ["-o", path("host_fq.out"), archive]))
                if read("host_fq.out") != data:
                    raise AssertionError(f"host untnaf ({how}) output != the input")
        finally:
            Decoder._load_seq_and_qual = two_threads
            if threshold is None:
                del os.environ["NAF_TPU_STREAM_THRESHOLD"]
            else:
                os.environ["NAF_TPU_STREAM_THRESHOLD"] = threshold
        return {f"{k}_s": min(v) for k, v in times.items()} | {"runs": times}

    try:
        D.reset_counts()
        rows = []
        for i, (name, data, flags, _, fastq, enc_route, dec_route) in enumerate(cases):
            src = path("in.fq" if fastq else "in.fa")
            with open(src, "wb") as f:
                f.write(data)
            row = {"phase": "cli", "input": name, "card": card, "bytes": len(data)}
            enc_s = []
            got = routes_of(lambda: enc_s.append(
                run_cli("tnaf", ["--device", *flags, "-o", path("dev.naf"), src])))
            if not took(got, enc_route):
                raise AssertionError(f"{name}: tnaf --device took route {got}")
            row.update(tnaf_device_s=enc_s[0], encode_routes=got)
            row["tnaf_host_s"] = run_cli("tnaf", [*flags, "-o", path("host.naf"), src])
            if read("dev.naf") != read("host.naf"):
                raise AssertionError(f"{name}: tnaf --device archive != host tnaf archive")
            dec_s = []
            got = routes_of(lambda: dec_s.append(
                run_cli("untnaf", ["--device", "-o", path("dev.out"), path("dev.naf")])))
            if not took(got, dec_route):
                raise AssertionError(f"{name}: untnaf --device took route {got}")
            row.update(untnaf_device_s=dec_s[0], decode_routes=got)
            row["untnaf_host_s"] = run_cli("untnaf", ["-o", path("host.out"), path("dev.naf")])
            out = read("dev.out")
            if out != read("host.out"):
                raise AssertionError(f"{name}: untnaf --device output != host untnaf output")
            if out != data:
                raise AssertionError(f"{name}: untnaf --device output != the input")
            row.update(archive=os.path.getsize(path("dev.naf")), equal_host=True,
                       equal_input=True)
            if i < 2:               # the fused FASTA and FASTQ cases
                row["traced"] = traced(src, data, fastq)
            if i == 0:
                row["profile"] = profiled(src, data)
            if fastq:
                row["host_fastq_untnaf"] = host_fastq_untnaf(path("dev.naf"), data)
            rows.append(row)

        # a file over the in-memory threshold: tnaf --device streams it on the card
        name, data = stream_input
        if len(data) < STREAM_THRESHOLD:
            raise AssertionError(f"{name}: {len(data)} bytes is under the stream threshold")
        with open(path("stream.fa"), "wb") as f:
            f.write(data)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        seconds = []
        got = routes_of(lambda: seconds.append(
            run_cli("tnaf", ["--device", "-o", path("stream_dev.naf"), path("stream.fa")])))
        peak = torch.cuda.max_memory_allocated() - base
        if not stream_routes_ok(got):
            raise AssertionError(f"{name}: tnaf --device took route {got}")
        host_s = run_cli("tnaf", ["-o", path("stream_host.naf"), path("stream.fa")])
        if read("stream_dev.naf") != read("stream_host.naf"):
            raise AssertionError(f"{name}: streamed tnaf --device archive != host tnaf archive")
        if peak >= PEAK_LIMIT:
            raise AssertionError(f"{name}: peak device memory {peak} is not under {PEAK_LIMIT}")
        run = counted("tnaf", ["--device", "-o", path("stream_traced.naf"), path("stream.fa")],
                      NAF_TPU_TRACE="1")
        if not stream_routes_ok(run["routes"]):
            raise AssertionError(f"{name}: traced tnaf --device took route {run['routes']}")
        if read("stream_traced.naf") != read("stream_host.naf"):
            raise AssertionError(f"{name}: traced streamed tnaf --device archive != host's")
        traced_stream = spans_of(run, ["scan"] * run["routes"]["stream_device"])
        emit({"phase": "cli_stream", "input": name, "card": card, "bytes": len(data),
              "tnaf_device_s": seconds[0], "tnaf_host_s": host_s, "routes": got,
              "archive": os.path.getsize(path("stream_dev.naf")), "equal_host": True,
              "peak_above_start_bytes": peak, "traced": traced_stream})
        for f in ("stream.fa", "stream_dev.naf", "stream_host.naf", "stream_traced.naf"):
            os.unlink(path(f))

        # the native entropy engine, with and without --device
        name, data = native_input
        with open(path("native.fa"), "wb") as f:
            f.write(data)
        row = {"phase": "cli_native_engine", "input": name, "card": card, "bytes": len(data)}
        enc_s = []
        got = routes_of(lambda: enc_s.append(run_cli(
            "tnaf", ["--device", "--engine", "native", "-o", path("ndev.naf"),
                     path("native.fa")])))
        if got != {"encode_device": 1}:
            raise AssertionError(f"{name}: tnaf --device --engine native took route {got}")
        row["tnaf_device_s"] = enc_s[0]
        row["tnaf_host_s"] = run_cli("tnaf", ["--engine", "native", "-o", path("nhost.naf"),
                                              path("native.fa")])
        if read("ndev.naf") != read("nhost.naf"):
            raise AssertionError(f"{name}: tnaf --device --engine native archive != host's")
        try:
            dec_s = []
            got = routes_of(lambda: dec_s.append(run_cli(
                "untnaf", ["--device", "--engine", "native", "-o", path("ndev.out"),
                           path("ndev.naf")])))
            if got != {"decode_device": 1}:
                raise AssertionError(f"{name}: untnaf --device --engine native took {got}")
            row["untnaf_device_s"] = dec_s[0]
            row["untnaf_host_s"] = run_cli("untnaf", ["--engine", "native", "-o",
                                                      path("nhost.out"), path("ndev.naf")])
        finally:
            set_decode_engine("zstd")
        row["untnaf_host_zstd_engine_s"] = run_cli("untnaf", ["-o", path("nlib.out"),
                                                              path("ndev.naf")])
        out = read("ndev.out")
        if out != read("nhost.out") or out != read("nlib.out") or out != data:
            raise AssertionError(f"{name}: untnaf --engine native output != host's or input")
        row.update(archive=os.path.getsize(path("ndev.naf")), equal_host=True, equal_input=True)
        emit(row)
        launches = {k: v + sub_launches[k] for k, v in D.LAUNCHES.items()}

        # the same work in this process, outside the counted path
        for row, (name, data, _, o, fastq, _, _) in zip(rows, cases):
            t0 = time.perf_counter()
            blob, _ = encode_device(data, o, device=dev)
            torch.cuda.synchronize()
            row["encode_device_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            d = Decoder(io.BytesIO(blob))
            fastq_device(d, device=dev) if fastq else fasta_device(d, device=dev)
            torch.cuda.synchronize()
            row["decode_device_s"] = time.perf_counter() - t0
            emit(row)

        # a pipe of two processes: the encode reads a pipe, so it streams
        name, data = pipe_input
        with open(path("pipe.fa"), "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        with open(path("pipe.fa"), "rb") as fin, open(path("pipe.err1"), "wb") as e1, \
                open(path("pipe.err2"), "wb") as e2, open(path("pipe.out"), "wb") as fout:
            enc = subprocess.Popen([sys.executable, "-c", _COUNTED_CLI.format(tool="tnaf"),
                                    path("enc.json"), "--device", "-c"],
                                   stdin=fin, stdout=subprocess.PIPE, stderr=e1, env=env,
                                   cwd=here)
            dec = subprocess.Popen([sys.executable, "-c", _COUNTED_CLI.format(tool="untnaf"),
                                    path("dec.json"), "--device", "-c"],
                                   stdin=enc.stdout, stdout=fout, stderr=e2, env=env, cwd=here)
            enc.stdout.close()
            rc = (enc.wait(timeout=600), dec.wait(timeout=600))
        pipe_s = time.perf_counter() - t0
        errs = (read("pipe.err1"), read("pipe.err2"))
        if rc != (0, 0) or errs != (b"", b""):
            raise AssertionError(f"pipe exited {rc}, stderr {errs[0][-2000:]!r} "
                                 f"{errs[1][-2000:]!r}")
        if read("pipe.out") != data:
            raise AssertionError(f"{name}: the pipe's output != the input")
        with open(path("enc.json")) as f:
            enc_counts = json.load(f)
        with open(path("dec.json")) as f:
            dec_counts = json.load(f)
        if not stream_routes_ok(enc_counts["routes"]):
            raise AssertionError(f"pipe: tnaf --device took route {enc_counts['routes']}")
        for k in ("emit_fasta", "pack_4bit"):
            if enc_counts["launches"][k] <= 0:
                raise AssertionError(f"pipe: {k} did not launch in tnaf --device")
        if dec_counts["routes"] != {"decode_device": 1}:
            raise AssertionError(f"pipe: untnaf --device took route {dec_counts['routes']}")
        for k in ("unpack_4bit", "apply_mask_parity"):
            if dec_counts["launches"][k] <= 0:
                raise AssertionError(f"pipe: {k} did not launch in untnaf --device")
        for k, v in enc_counts["launches"].items():
            launches[k] += v + dec_counts["launches"][k]
        emit({"phase": "cli_pipe", "input": name, "card": card, "bytes": len(data),
              "seconds": pipe_s, "stderr_empty": True, "equal_input": True,
              "routes": [enc_counts["routes"], dec_counts["routes"]],
              "launches": {k: v + dec_counts["launches"][k]
                           for k, v in enc_counts["launches"].items()
                           if v + dec_counts["launches"][k]}})

        # the peak device memory of the in-memory encode just under the threshold
        name, data = threshold_input
        if len(data) >= STREAM_THRESHOLD:
            raise AssertionError(f"{name}: {len(data)} bytes is not under the stream threshold")
        with open(path("big.fa"), "wb") as f:
            f.write(data)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        seconds = []
        routes = routes_of(lambda: seconds.append(
            run_cli("tnaf", ["--device", "-o", path("big.naf"), path("big.fa")])))
        peak = torch.cuda.max_memory_allocated()
        if routes != {"encode_device": 1}:
            raise AssertionError(f"{name}: tnaf --device took route {routes}")
        if read("big.naf") != encode(data, opts)[0]:
            raise AssertionError(f"{name}: tnaf --device archive != host encode() archive")
        emit({"phase": "cli_peak_memory", "input": name, "card": card, "bytes": len(data),
              "tnaf_device_s": seconds[0], "peak_device_bytes": peak,
              "peak_above_start_bytes": peak - base, "equal_host": True, "routes": routes})
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def stream_phase(card: str, dev, inputs: list, opts) -> dict:
    """Phase 7 (see the module docstring); returns the stream path's launch
    counts, counted from 0."""
    import torch

    from naf_tpu_torch import device as D
    from naf_tpu_torch.parallel.stream import DeviceScanEngine
    from naf_tpu_torch.pipeline.stream import DEFAULT_CHUNK, encode_stream

    D.reset_counts()
    for name, data, fastq in inputs:
        t0 = time.perf_counter()
        host = io.BytesIO()
        encode_stream(io.BytesIO(data), host, opts)
        host_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before, routes_before = dict(D.LAUNCHES), dict(D.ROUTES)
        eng = DeviceScanEngine(device=dev)
        out = io.BytesIO()
        t0 = time.perf_counter()
        encode_stream(io.BytesIO(data), out, opts, chunk_size=STREAM_CHUNK, engine=eng)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        routes = {k: v - routes_before.get(k, 0) for k, v in D.ROUTES.items()
                  if v != routes_before.get(k, 0)}
        launches = {k: v - before[k] for k, v in D.LAUNCHES.items() if v != before[k]}
        if out.getvalue() != host.getvalue():
            raise AssertionError(f"{name}: device stream archive != host encode_stream archive")
        if eng.device_chunks <= 0 or eng.native_chunks != 0 or routes != {
                "stream_device": eng.device_chunks}:
            raise AssertionError(f"{name}: stream pieces took routes {routes}")
        for k in ("emit_fastq" if fastq else "emit_fasta", "pack_4bit"):
            if launches.get(k, 0) < eng.device_chunks:
                raise AssertionError(f"{name}: {k} launched {launches.get(k, 0)} times for "
                                     f"{eng.device_chunks} pieces")
        if peak >= PEAK_LIMIT:
            raise AssertionError(f"{name}: the stream's peak device memory {peak} is not under "
                                 f"{PEAK_LIMIT}")
        mb = len(data) / 1e6
        emit({"phase": "stream", "input": name, "card": card, "bytes": len(data),
              "archive": len(out.getvalue()), "equal_host_stream": True,
              "chunk_bytes": STREAM_CHUNK, "host_chunk_bytes": DEFAULT_CHUNK,
              "device_chunks": eng.device_chunks, "native_chunks": eng.native_chunks,
              "routes": routes, "launches": launches, "device_stream_s": dev_s,
              "host_stream_s": host_s, "device_stream_MBps": mb / dev_s,
              "host_stream_MBps": mb / host_s, "peak_above_start_bytes": peak})
        del host, out
    return dict(D.LAUNCHES)


#: one rank of a multi-process multihost run: argv is (rank, world, port,
#: output JSON path, backend, blocks); the rank writes what it saw there,
#: and its launch and route counts
_MULTIHOST_WORKER = """import json, sys
import chip_smoke
rank, world, port, out, backend, blocks = sys.argv[1:7]
json.dump(chip_smoke.multihost_rank(int(rank), int(world), int(port), backend=backend,
                                    blocks=int(blocks)), open(out, "w"))
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_inputs() -> list:
    """(name, data) of the multihost checks: bench.py's gen_fasta(64) and
    gen_fastq(250_000)."""
    import bench

    return [("gen_fasta(64)", bench.gen_fasta(64)), ("gen_fastq(250000)", bench.gen_fastq(250_000))]


def multihost_rank(rank: int, world: int, port: int, *, backend: str, blocks: int,
                   inputs=None) -> dict:
    """This process's part of a multi-process encode:
    ``encode_multihost``, ``encode_multihost_parts`` and
    ``encode_multihost_extended`` on each multihost input, with ``blocks``
    blocks on card ``rank`` mod the visible cards.  Checks the
    plain archive against host ``encode()`` and the decodes of the other
    two against the host ``Decoder``'s of it; returns, per input and
    encode, the archive's size and digest, the bytes gathered and the wall
    seconds, with this process's launch and route counts."""
    import hashlib

    import torch
    import torch.distributed as dist

    from naf_tpu_torch import device as D
    from naf_tpu_torch.parallel import multihost as MH
    from naf_tpu_torch.parallel.mesh import block_mesh
    from naf_tpu_torch.pipeline.decoder import DecodeOptions, Decoder
    from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    mesh = block_mesh(devices=[dev] * blocks)
    opts = EncodeOptions(level=1, threads=os.cpu_count() or 0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, device_id=dev if backend == "nccl" else None)
    try:
        rows = {}
        for name, data in inputs or multihost_inputs():
            host = encode(data, opts)[0]
            fastq = data[:1] == b"@"
            hd = Decoder(io.BytesIO(host), DecodeOptions())
            want = hd.fastq() if fastq else hd.fasta()
            for fn, route in ((MH.encode_multihost, "encode_multihost"),
                              (MH.encode_multihost_parts, "encode_multihost:parts"),
                              (MH.encode_multihost_extended, "encode_multihost:extended")):
                traffic = {}
                routes = dict(D.ROUTES)
                dist.barrier()
                t0 = time.perf_counter()
                blob = fn(data, opts, traffic=traffic, mesh=mesh)[0]
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                got = {k: v - routes.get(k, 0) for k, v in D.ROUTES.items()
                       if v != routes.get(k, 0)}
                if got != {route: 1}:
                    raise AssertionError(f"{name}: {fn.__name__} took route {got}")
                if fn is MH.encode_multihost:
                    if blob != host:
                        raise AssertionError(f"{name}: encode_multihost != host encode()")
                else:
                    d = Decoder(io.BytesIO(blob), DecodeOptions())
                    if (d.fastq() if fastq else d.fasta()) != want:
                        raise AssertionError(f"{name}: {fn.__name__} decodes differently")
                rows[f"{name} {fn.__name__}"] = {
                    "archive": len(blob), "md5": hashlib.md5(blob).hexdigest(),
                    "gathered_bytes": traffic["gathered_bytes"], "seconds": secs}
    finally:
        dist.destroy_process_group()
    return {"rank": rank, "world": world, "backend": backend, "blocks": mesh.size,
            "rows": rows, "routes": dict(D.ROUTES), "launches": dict(D.LAUNCHES)}


def spawn_ranks(world: int, backend: str, blocks: int) -> tuple[list, float]:
    """(each rank's ``multihost_rank`` result, wall seconds) of ``world``
    processes of this script's multihost worker, each under
    ``MULTIHOST_TIMEOUT``; raises when one fails or the ranks' archives
    differ.  Each rank writes its output and errors to files, so no rank
    blocks on a full pipe while another waits for it in a collective."""
    import shutil
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_ranks_", dir=os.path.join(here, "build"))
    port = free_port()
    outs = [os.path.join(work, f"rank{r}.json") for r in range(world)]
    logs = [open(os.path.join(work, f"rank{r}.log"), "wb") for r in range(world)]
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", _MULTIHOST_WORKER, str(r), str(world),
                               str(port), outs[r], backend, str(blocks)], env=env, cwd=here,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        for r, p in enumerate(procs):
            rc = p.wait(timeout=max(MULTIHOST_TIMEOUT - (time.perf_counter() - t0), 1))
            if rc != 0:
                logs[r].close()
                with open(logs[r].name, "rb") as f:
                    log = f.read().decode(errors="replace")
                raise AssertionError(f"{backend} rank {r} exited {rc}: {log[-3000:]}")
        secs = time.perf_counter() - t0
        results = []
        for o in outs:
            with open(o) as f:
                results.append(json.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        shutil.rmtree(work, ignore_errors=True)
    for r in results[1:]:
        if r["rows"].keys() != results[0]["rows"].keys() or any(
                r["rows"][k]["md5"] != results[0]["rows"][k]["md5"] for k in r["rows"]):
            raise AssertionError(f"the {backend} ranks returned different archives")
    return results, secs


def resident_seconds(mesh, data: bytes, o, route: str, reps: int = 3) -> float:
    """The best of ``reps`` wall seconds of an encode's device passes on
    blocks already on their devices: the fused passes and the gather of
    their scalars, or the two-pass stats and emit with their fetches; every
    card of the mesh synchronised at both ends.  What the cards' overlap
    can give, without the host's cut, upload and archive build."""
    import numpy as np
    import torch

    from naf_tpu_torch.format import constants as C
    from naf_tpu_torch.parallel.block import (emit_blocks_sharded, fused_blocks_fastq_sharded,
                                              fused_blocks_sharded, make_blocks,
                                              make_blocks_fastq, stats_blocks_sharded)
    from naf_tpu_torch.parallel.mesh import all_gather

    fastq = data[:1] == b"@"
    body = np.frombuffer(data, np.uint8)[1:]
    blocks = make_blocks_fastq(body, mesh.size)[0] if fastq else make_blocks(body, mesh.size)
    xs = mesh.upload(blocks.data)
    cards = sorted(set(mesh.devices), key=str)

    def run():
        if route == "encode_device" and fastq:
            all_gather(fused_blocks_fastq_sharded(xs, blocks.prev, 0, seq_type=0)[3])
        elif route == "encode_device":
            all_gather(fused_blocks_sharded(xs, blocks.prev, blocks.starts_in_seq, 0,
                                            seq_type=0)[1])
        else:
            stats, masks = stats_blocks_sharded(xs, blocks.prev, blocks.starts_in_seq,
                                                seq_type=o.seq_type, fastq=fastq)
            emit_blocks_sharded(xs, masks, stats, seq_type=o.seq_type, fastq=fastq,
                                pack_nibbles=o.seq_type < C.SEQ_TYPE_PROTEIN)

    run()
    times = []
    for _ in range(reps):
        for c in cards:
            torch.cuda.synchronize(c)
        t = time.perf_counter()
        run()
        for c in cards:
            torch.cuda.synchronize(c)
        times.append(time.perf_counter() - t)
    return min(times)


def phase_mesh(n_cards: int):
    """The mesh of phase 8: ``MESH_BLOCKS`` blocks on the one card, or one
    block a card when several are visible."""
    from naf_tpu_torch.device import cuda_device
    from naf_tpu_torch.parallel.mesh import block_mesh

    return block_mesh() if n_cards > 1 else block_mesh(devices=[cuda_device()] * MESH_BLOCKS)


def mesh_phase(card: str, mesh, opts, protein) -> dict:
    """Phase 8 (see the module docstring) over ``mesh``; returns the mesh
    path's launch counts, counted from 0, the spawned ranks' added in, and
    raises when a kernel of the path was not launched."""
    import torch

    import bench
    from naf_tpu_torch import device as D
    from naf_tpu_torch.parallel.mesh import block_mesh, dryrun_multichip
    from naf_tpu_torch.parallel.pipeline import encode_device
    from naf_tpu_torch.parallel.stream import DeviceScanEngine
    from naf_tpu_torch.pipeline.decoder import DecodeOptions, Decoder, fasta_device, fastq_device
    from naf_tpu_torch.pipeline.encoder import encode
    from naf_tpu_torch.pipeline.stream import encode_stream

    cards = sorted(set(mesh.devices), key=str)
    for c in cards:                 # each card's allocator, for its memory stats
        torch.empty(1, device=c)
    one = block_mesh(devices=[mesh.devices[0]])
    t0 = time.perf_counter()
    # (name, input, options, FASTQ, encode route)
    cases = [("gen_fasta_single(128)", bench.gen_fasta_single(128), opts, False, "encode_device"),
             ("gen_fastq(500000,read_len=150)", bench.gen_fastq(500_000, read_len=150), opts,
              True, "encode_device"),
             ("swissprot_like(160)", swissprot_like(160), protein, False,
              "encode_device:two_pass:text_like"),
             ("illumina_reads_fasta(750000)", illumina_reads_fasta(750_000), opts, False,
              "encode_device:two_pass:sparse_overflow")]
    stream_input = ("gen_fasta_single(1024)", bench.gen_fasta_single(1024))
    mh_inputs = multihost_inputs()
    emit({"phase": "inputs", "seconds": time.perf_counter() - t0,
          "bytes": {c[0]: len(c[1]) for c in cases + [stream_input] + mh_inputs}})

    def encode_peak(data, o, m) -> tuple:
        """(archive, wall seconds, peak bytes above the start on each card)."""
        torch.cuda.empty_cache()
        base = [torch.cuda.memory_allocated(c) for c in cards]
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        t0 = time.perf_counter()
        blob = encode_device(data, o, mesh=m)[0]
        for c in cards:
            torch.cuda.synchronize(c)
        secs = time.perf_counter() - t0
        return blob, secs, [torch.cuda.max_memory_allocated(c) - b for c, b in zip(cards, base)]

    def decode(blob: bytes, fastq: bool, m) -> tuple:
        d = Decoder(io.BytesIO(blob), DecodeOptions())
        t0 = time.perf_counter()
        out = fastq_device(d, mesh=m) if fastq else fasta_device(d, mesh=m)
        return out, time.perf_counter() - t0

    # the references, the one-block encode and decode of each input beside
    # the mesh's, and the device-resident passes, none of them counted
    host, one_block = [], []
    for name, data, o, fastq, route in cases:
        host.append(encode(data, o)[0])
        _, secs, peak = encode_peak(data, o, one)
        one_block.append({"one_block_seconds": secs, "one_block_peak_above_start_bytes": peak,
                          "resident_seconds": resident_seconds(mesh, data, o, route),
                          "one_block_resident_seconds": resident_seconds(one, data, o, route),
                          "one_block_decode_seconds": decode(host[-1], fastq, one)[1]})
    host_stream = io.BytesIO()
    encode_stream(io.BytesIO(stream_input[1]), host_stream, opts)

    def delta(before: dict, after: dict) -> dict:
        return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}

    D.reset_counts()
    # encode over the mesh
    archives = []
    for (name, data, o, fastq, route), want, beside in zip(cases, host, one_block):
        routes_before = dict(D.ROUTES)
        blob, secs, peak = encode_peak(data, o, mesh)
        routes = delta(routes_before, D.ROUTES)
        if blob != want:
            raise AssertionError(f"{name}: the {mesh.size}-block archive != host encode()'s")
        if routes != {route: 1}:
            raise AssertionError(f"{name}: the {mesh.size}-block encode took route {routes}")
        archives.append(blob)
        emit({"phase": "mesh_encode", "input": name, "card": card, "blocks": mesh.size,
              "cards": len(cards), "bytes": len(data), "equal_host": True, "routes": routes,
              "seconds": secs, "peak_above_start_bytes": peak,
              **{k: v for k, v in beside.items() if k != "one_block_decode_seconds"}})
    # the mesh render of the FASTQ and the protein archive
    for i in (1, 2):
        name, _, _, fastq, _ = cases[i]
        hd = Decoder(io.BytesIO(archives[i]), DecodeOptions())
        want = hd.fastq() if fastq else hd.fasta()
        routes_before = dict(D.ROUTES)
        out, secs = decode(archives[i], fastq, mesh)
        routes = delta(routes_before, D.ROUTES)
        if out != want:
            raise AssertionError(f"{name}: the mesh decode != host Decoder's")
        if routes != {"decode_device:ragged:mesh": 1}:
            raise AssertionError(f"{name}: the mesh decode took route {routes}")
        emit({"phase": "mesh_decode", "input": name, "card": card, "blocks": mesh.size,
              "cards": len(cards), "equal_host": True, "routes": routes, "seconds": secs,
              "one_block_seconds": one_block[i]["one_block_decode_seconds"],
              "output_bytes": len(out)})
    del cases, host, archives
    # the stream engine over the mesh
    name, data = stream_input
    eng = DeviceScanEngine(mesh=mesh)
    routes_before = dict(D.ROUTES)
    out = io.BytesIO()
    t0 = time.perf_counter()
    encode_stream(io.BytesIO(data), out, opts, chunk_size=STREAM_CHUNK, engine=eng)
    secs = time.perf_counter() - t0
    routes = delta(routes_before, D.ROUTES)
    if out.getvalue() != host_stream.getvalue():
        raise AssertionError(f"{name}: the {mesh.size}-block stream != host encode_stream's")
    if eng.native_chunks or routes != {"stream_device": eng.device_chunks}:
        raise AssertionError(f"{name}: the {mesh.size}-block stream took routes {routes}")
    emit({"phase": "mesh_stream", "input": name, "card": card, "blocks": mesh.size,
          "cards": len(cards), "bytes": len(data), "equal_host_stream": True, "routes": routes,
          "seconds": secs, "MBps": len(data) / 1e6 / secs})
    del stream_input, data, out, host_stream
    # multihost: NCCL in this process, four blocks on the first card (NCCL
    # takes one rank a card); then two processes on gloo (sharing the card
    # when there is one); and, with several cards, one NCCL rank a card
    got = multihost_rank(0, 1, free_port(), backend="nccl", blocks=MESH_BLOCKS,
                         inputs=mh_inputs)
    emit({"phase": "mesh_multihost", "card": card, "backend": "nccl", "world": 1,
          "blocks": got["blocks"], "rows": got["rows"]})
    spawned = []
    results, secs = spawn_ranks(2, "gloo", 2)
    spawned += results
    emit({"phase": "mesh_multihost", "card": card, "backend": "gloo", "world": 2,
          "blocks": results[0]["blocks"], "note": "two ranks over gloo, rank r on card r mod "
          "the cards: with one card both share it, which NCCL refuses", "seconds_with_process_start": secs,
          "rows": results[0]["rows"], "routes": [r["routes"] for r in results]})
    if len(cards) > 1:
        results, secs = spawn_ranks(len(cards), "nccl", 1)
        spawned += results
        emit({"phase": "mesh_multihost", "card": card, "backend": "nccl", "world": len(cards),
              "blocks": results[0]["blocks"], "note": "one rank a card",
              "seconds_with_process_start": secs, "rows": results[0]["rows"],
              "routes": [r["routes"] for r in results]})
    # the dry run of __graft_entry__.py
    t0 = time.perf_counter()
    dry = dryrun_multichip(mesh.size, list(mesh.devices))
    emit({"phase": "mesh_dryrun", "card": card, "blocks": mesh.size, "cards": len(cards),
          "cases": dry, "seconds": time.perf_counter() - t0})
    launches = dict(D.LAUNCHES)
    for r in spawned:
        for k, v in r["launches"].items():
            launches[k] += v
    emit({"phase": "launches", "mesh_path": launches})
    for k in ("emit_fasta", "emit_fastq", "pack_4bit", "classify_fasta", "classify_fastq",
              "cumsum_i32", "maxscan_i32", "compact", "compact_dense"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on the mesh path")
    return launches


def sections(data: bytes) -> tuple[bytes, bytes]:
    """(packed SEQ, QUAL) payloads of an input, as the host encode
    compresses them."""
    import numpy as np

    from naf_tpu_torch.format import constants as C
    from naf_tpu_torch.ops.nibble_np import pack_4bit_np
    from naf_tpu_torch.pipeline import parser as P

    fmt, marker = P.detect_format(data)
    fastq = fmt == C.IN_FORMAT_FASTQ
    res = (P.parse_fastq if fastq else P.parse_fasta)(data, marker_pos=marker)
    packed = res.packed
    if packed is None:
        packed, carry = pack_4bit_np(res.seq)
        if carry is not None:
            packed = np.concatenate([packed, np.asarray([carry], np.uint8)])
    return np.ascontiguousarray(packed).tobytes(), res.qual.tobytes() if fastq else b""


def engine_windows(seq: bytes, raw: bytes, dev):
    """Phase 9's two kernel shapes, one at a time: (label, anchor, depth k,
    section bytes n, span start lo, window start wlo, the window on the
    card, its padded size cap) of the last span of ``seq`` in its
    level-19 ``--long 27`` history (positions, depth 16) and of ``raw`` in
    its anchor history (anchors, depth 1)."""
    from naf_tpu_torch.codec import zstd_backend as Z
    from naf_tpu_torch.ops import matchfind as MF

    hist, ldm_hist = Z._device_histories(ENGINE_WINDOW_LOG, MF.SPAN)
    depth = Z._device_chain_depth(ENGINE_LEVEL)
    for label, data, hist, anchor, k in (("window", seq, hist, False, depth),
                                         ("anchor", raw, ldm_hist, True, 1)):
        sec = MF.upload(data, dev)
        n, span = sec.numel(), MF.SPAN
        lo = (n - 1) // span * span
        wlo = max(0, lo - hist) & ~7
        win, cap = sec[wlo:n], MF._pow2(n - wlo)
        if cap != MF._pow2(hist + span):
            raise AssertionError(f"{label}: a window of {n - wlo} bytes pads to {cap}")
        yield label, anchor, k, n, lo, wlo, win, cap
        del sec, win


def engine_kernel_rows(card: str, seq: bytes, raw: bytes, dev) -> dict:
    """Phase 9's kernel rows: the keys and chain kernels against their plain
    versions on the card at a level-19 ``--long 27`` span's shapes: the last
    span of ``seq`` in its 64 MiB history (a window padded to 2^27
    positions, depth 16), and the anchor pass (depth 1) over the last span
    of ``raw`` in its 128 MiB history (a window padded to 2^28 bytes);
    ``sort_ms`` is ``torch.sort(stable=True)`` of the same keys."""
    import torch

    from naf_tpu_torch.ops import matchfind as MF

    rows: dict = {}
    for label, anchor, k, n, lo, wlo, win, cap in engine_windows(seq, raw, dev):
        stride = 8 if anchor else 1
        kkeys = MF.match_keys_kernel(win, cap, anchor=anchor)
        pkeys = MF.match_keys_plain(win, cap, anchor=anchor)
        torch.cuda.synchronize()
        err_keys = max_abs_err(kkeys, pkeys)
        del pkeys
        sk, order = torch.sort(kkeys, stable=True)
        kch = MF.match_chain_kernel(sk, order, k, lo - wlo, n - wlo, stride=stride, wlo=wlo)
        pch = MF.match_chain_plain(sk, order, k, lo - wlo, n - wlo, stride=stride, wlo=wlo)
        torch.cuda.synchronize()
        err_chain = max_abs_err(kch, pch)
        out_bytes = kch.numel() * 4
        del pch, kch
        torch.cuda.empty_cache()
        # the chain reads all of order, the span entries' keys and their
        # neighbours (chain_key_sectors), and writes the span's rows
        sk_sectors = chain_key_sectors(sk, order, k, lo - wlo, n - wlo, stride)
        torch.cuda.empty_cache()
        sort_ms = cuda_time(lambda: torch.sort(kkeys, stable=True), 5)
        shape = (f"u8[{n - wlo}] padded to {cap}" + (" (anchors)" if anchor else "")
                 + f", span [{lo - wlo}, {n - wlo}), k {k}")
        for name, err, fn, pfn, nbytes, extra, repl in (
                ("match_keys", err_keys, lambda: MF.match_keys_kernel(win, cap, anchor=anchor),
                 lambda: MF.match_keys_plain(win, cap, anchor=anchor),
                 win.numel() + kkeys.numel() * 4, {},
                 "naf_tpu/ops/matchfind.py:108" if anchor else "naf_tpu/ops/matchfind.py:34"),
                ("match_chain", err_chain,
                 lambda: MF.match_chain_kernel(sk, order, k, lo - wlo, n - wlo, stride=stride,
                                               wlo=wlo),
                 lambda: MF.match_chain_plain(sk, order, k, lo - wlo, n - wlo, stride=stride,
                                              wlo=wlo),
                 order.numel() * 8 + sk_sectors * SECTOR_BYTES + out_bytes,
                 {"sk_sectors": sk_sectors},
                 "naf_tpu/ops/matchfind.py:108" if anchor else "naf_tpu/ops/matchfind.py:34")):
            row = {"name": name, "route": "cuda", "source": "naf_tpu_torch/csrc/matchfind.cu",
                   "replaces": repl, "max_abs_err": err, "ms": cuda_time(fn, 10),
                   "plain_ms": cuda_time(pfn, 3), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes", "library_ms": None, "sort_ms": sort_ms, **extra}
            emit({"phase": "kernel", "shape": f"{label}: {shape}", "card": card, **row})
            if err != 0:
                raise AssertionError(f"{name} ({label}): kernel differs from its plain version "
                                     f"({err})")
            if anchor:
                rows[name]["anchor"] = {f: row[f] for f in ("max_abs_err", "ms", "plain_ms",
                                                            "bound_ms", "sort_ms", "replaces",
                                                            *extra)}
            else:
                rows[name] = row
            torch.cuda.empty_cache()
        del win, kkeys, sk, order
        torch.cuda.empty_cache()
    return rows


def device_engine_phase(card: str, dev, kernel_rows: dict) -> dict:
    """Phase 9, the device zstd engine (``compress_section_device``): its
    kernels at a level-19 ``--long 27`` span's shapes (``engine_kernel_rows``),
    then the counted path: the packed SEQ section of gen_fasta_single(252)
    at level 19, window log 27 (BASELINE config 4, cut to the prefix whose
    serializer time a one-span probe puts inside ``ENGINE_BUDGET_S``), of
    gen_fasta_single(128) at level 1 and the quality section of
    gen_fastq(500_000, read_len=150) at level 1, and ``encode(engine=
    "device")`` of gen_fasta_single(128).  Each frame must decode to its
    input, the first, a middle and the last span's candidates must equal the
    plain versions' on the card, and the archive must decode to the input.
    Each call's spans, per-span device ms of keys, sort, chain and fetch,
    serializer seconds, total seconds, MB/s, payload bytes and peak device
    memory are printed beside ``compress_section_native``'s seconds and
    bytes (the level-19 one on the first ``YARDSTICK_BYTES``, both
    engines).  Returns the path's launch counts."""
    import io

    import torch

    import bench
    from naf_tpu_torch import device as D
    from naf_tpu_torch.codec import zstd_backend as Z
    from naf_tpu_torch.ops import matchfind as MF
    from naf_tpu_torch.pipeline.decoder import DecodeOptions, Decoder
    from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode

    t0 = time.perf_counter()
    big = bench.gen_fasta_single(252)
    seq19, _ = sections(big)
    emit({"phase": "inputs", "seconds": time.perf_counter() - t0,
          "bytes": {"gen_fasta_single(252)": len(big), "its packed SEQ": len(seq19)}})
    rows = engine_kernel_rows(card, seq19, big, dev)
    del big
    t0 = time.perf_counter()
    fa = bench.gen_fasta_single(128)
    seq1, _ = sections(fa)
    _, qual = sections(bench.gen_fastq(500_000, read_len=150))
    emit({"phase": "inputs", "seconds": time.perf_counter() - t0,
          "bytes": {"gen_fasta_single(128) packed SEQ": len(seq1),
                    "gen_fastq(500000,read_len=150) QUAL": len(qual)}})

    span = MF.SPAN
    probe: dict = {}
    Z.compress_section_device(seq19[:span], level=ENGINE_LEVEL, window_log=ENGINE_WINDOW_LOG,
                              device=dev, timing=probe)
    probe_s = probe["spans"][0]["serialize_s"]
    # later spans search a 64 MiB history: allow twice the first span's time
    fit = max(1, int(ENGINE_BUDGET_S / (2 * probe_s)))
    n19 = min(len(seq19), fit * span)
    emit({"phase": "device_engine_probe", "card": card, "span_bytes": span,
          "serialize_s": probe_s, "budget_s": ENGINE_BUDGET_S, "bytes": n19,
          "section_bytes": len(seq19), "cut": n19 < len(seq19)})
    calls = [("gen_fasta_single(252) SEQ", seq19[:n19], ENGINE_LEVEL, ENGINE_WINDOW_LOG),
             ("gen_fasta_single(128) SEQ", seq1, 1, 0),
             ("gen_fastq(500000,read_len=150) QUAL", qual, 1, 0)]
    eopts = EncodeOptions(level=1, engine="device", threads=os.cpu_count() or 0)

    D.reset_counts()
    results = []
    for name, sec, level, wl in calls:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        timing: dict = {}
        t0 = time.perf_counter()
        payload = Z.compress_section_device(sec, level=level, window_log=wl, device=dev,
                                            timing=timing)
        total = time.perf_counter() - t0
        results.append((payload, total, timing["spans"],
                        torch.cuda.max_memory_allocated(dev) - base))
    t0 = time.perf_counter()
    blob, _ = encode(fa, eopts, device=dev)
    encode_s = time.perf_counter() - t0
    launches, routes = dict(D.LAUNCHES), dict(D.ROUTES)

    for k in ("match_keys", "match_chain"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on the device_engine path")
    if Decoder(io.BytesIO(blob), DecodeOptions()).fasta() != fa:
        raise AssertionError("encode(engine='device') does not decode to its input")
    emit({"phase": "device_engine_encode", "input": "gen_fasta_single(128)", "card": card,
          "seconds": encode_s, "archive": len(blob), "decodes_to_input": True, "routes": routes})
    for (name, sec, level, wl), (payload, total, spans, peak) in zip(calls, results):
        if Z.decompress_section(payload, len(sec)) != sec:
            raise AssertionError(f"{name}: the device engine's frame does not decode")
        k = Z._device_chain_depth(level)
        hist, ldm = Z._device_histories(wl, span)
        on_card = MF.upload(sec, dev)
        n_spans = -(-len(sec) // span)
        for i in sorted({0, n_spans // 2, n_spans - 1}):
            lo, hi = i * span, min((i + 1) * span, len(sec))
            got = MF.span_candidates(on_card, lo, hi, k, hist, ldm)
            want = MF.span_candidates(on_card, lo, hi, k, hist, ldm, plain=True)
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: span {i}'s candidates differ from the plain "
                                     "versions'")
        del on_card, got, want
        torch.cuda.empty_cache()
        stages = {stage: [round(sp.get(stage, 0.0), 4) for sp in spans]
                  for stage in ("keys", "sort", "chain", "fetch")}
        row = {"phase": "device_engine", "input": name, "card": card, "level": level,
               "window_log": wl, "k": k, "bytes": len(sec), "spans": len(spans),
               "device_ms": {stage: sum(v) for stage, v in stages.items()},
               "per_span_device_ms": stages,
               "serialize_s": sum(sp["serialize_s"] for sp in spans),
               "per_span_serialize_s": [round(sp["serialize_s"], 4) for sp in spans],
               "total_s": total, "MBps": len(sec) / 1e6 / total, "payload": len(payload),
               "peak_device_bytes": peak, "decodes": True, "spans_equal_plain": True}
        ysec = sec if level < ENGINE_LEVEL else sec[:YARDSTICK_BYTES]
        t0 = time.perf_counter()
        native = Z.compress_section_native(ysec, level=level, window_log=wl)
        row["native"] = {"bytes": len(ysec), "seconds": time.perf_counter() - t0,
                         "payload": len(native)}
        if level >= ENGINE_LEVEL:
            t0 = time.perf_counter()
            dpay = Z.compress_section_device(ysec, level=level, window_log=wl, device=dev)
            row["device_on_yardstick"] = {"bytes": len(ysec),
                                             "seconds": time.perf_counter() - t0,
                                             "payload": len(dpay)}
        emit(row)
    kernel_rows.update(rows)
    return launches


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive naf_tpu_torch on the card (see the module "
                                 "docstring).")
    ap.add_argument("--mesh", action="store_true",
                    help="phase 1 and the mesh phase only, over every visible card when there "
                         "are several")
    args = ap.parse_args()
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
    from naf_tpu_torch.parallel.block import (fused_blocks_fastq_sharded, fused_blocks_sharded,
                                              make_blocks, make_blocks_fastq)
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
    opts = EncodeOptions(level=1, threads=os.cpu_count() or 0)
    protein = EncodeOptions(level=1, threads=os.cpu_count() or 0, seq_type=C.SEQ_TYPE_PROTEIN)
    ok_line = json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}})
    if args.mesh:
        mesh_phase(card, phase_mesh(torch.cuda.device_count()), opts, protein)
        print(card)
        print(ok_line)
        return 0

    # ---- inputs (bench.py generators, and those made here) -----------------
    t0 = time.perf_counter()
    fasta_inputs = [("gen_fasta(64)", bench.gen_fasta(64)),
                    ("gen_fasta_single(128)", bench.gen_fasta_single(128)),
                    ("gen_masked_iupac_fasta(32)", bench.gen_masked_iupac_fasta(32))]
    fastq_inputs = [("gen_fastq(250000)", bench.gen_fastq(250_000)),
                    ("gen_fastq(500000,read_len=150)", bench.gen_fastq(500_000, read_len=150)),
                    ("masked_fastq(106000)", masked_fastq())]
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
            enc_ms = cuda_time(lambda: fused_blocks_fastq_sharded([xb], blocks.prev, 0,
                                                                  seq_type=0), 5)
            d = Decoder(io.BytesIO(blob), DecodeOptions())
            plan, raw = d._plan(PD.MODE_FASTQ, False)
            run = PD.regular_session(plan, raw, d._load_qual(), device=dev)
        else:
            blk = make_blocks(np.frombuffer(data, np.uint8)[data.index(b">") + 1:], 1)
            xb = torch.from_numpy(blk.data[0].copy()).to(dev)
            enc_ms = cuda_time(lambda: fused_blocks_sharded([xb], blk.prev, [False], 0,
                                                            seq_type=0), 5)
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

    # ---- 6. the CLI ------------------------------------------------------
    t0 = time.perf_counter()
    big = ("gen_fasta_single(252)", bench.gen_fasta_single(252))
    emit({"phase": "inputs", "seconds": time.perf_counter() - t0, "bytes": {big[0]: len(big[1])}})
    # (name, input, tnaf flags, the options they give, FASTQ, encode route, decode route)
    cli_cases = [(*fasta_inputs[1], [], opts, False, "encode_device", "decode_device"),
                 (*fastq_inputs[1], [], opts, True, "encode_device", "decode_device"),
                 (*two_pass_inputs[0][:2], ["--protein"], two_pass_inputs[0][2], False,
                  "encode_device:two_pass:text_like", "decode_device:ragged:")]
    path_launches["cli"] = cli_phase(card, dev, cli_cases, fasta_inputs[0], big,
                                     ("gen_fasta(300)", bench.gen_fasta(300)), fasta_inputs[1],
                                     opts)
    del big
    emit({"phase": "launches", "cli_path": path_launches["cli"]})
    for k in ("emit_fasta", "emit_fastq", "pack_4bit", "unpack_4bit", "apply_mask_parity",
              "classify_fasta", "cumsum_i32", "maxscan_i32", "compact", "compact_dense"):
        if path_launches["cli"][k] <= 0:
            raise AssertionError(f"{k} was not launched on the cli path")

    # ---- 7. the streamed device encode ----------------------------------
    del fasta_inputs, fastq_inputs, two_pass_inputs, fasta_archives, fastq_archives
    del two_pass_archives, ragged_items
    t0 = time.perf_counter()
    stream_inputs = [("gen_fasta_single(1024)", bench.gen_fasta_single(1024), False),
                     ("gen_fastq(1600000,read_len=150)",
                      bench.gen_fastq(1_600_000, read_len=150), True)]
    emit({"phase": "inputs", "seconds": time.perf_counter() - t0,
          "bytes": {n: len(d) for n, d, _ in stream_inputs}})
    path_launches["stream"] = stream_phase(card, dev, stream_inputs, opts)
    del stream_inputs
    emit({"phase": "launches", "stream_path": path_launches["stream"]})
    for k in ("emit_fasta", "emit_fastq", "pack_4bit"):
        if path_launches["stream"][k] <= 0:
            raise AssertionError(f"{k} was not launched on the stream path")

    # ---- 8. the mesh -------------------------------------------------------
    path_launches["mesh"] = mesh_phase(card, phase_mesh(torch.cuda.device_count()), opts,
                                       protein)

    # ---- 9. the device zstd engine -----------------------------------------
    path_launches["device_engine"] = device_engine_phase(card, dev, kernel_rows)
    emit({"phase": "launches", "device_engine_path": path_launches["device_engine"]})

    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "naf_tpu"))
    if bad:
        raise AssertionError(f"the port's path imported {bad[:5]}")

    order = ("emit_fasta", "classify_fasta", "pack_4bit", "unpack_4bit", "apply_mask_parity",
             "emit_fastq", "classify_fastq", "cumsum_i32", "maxscan_i32", "compact",
             "compact_dense", "match_keys", "match_chain")
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
    print(ok_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
