"""NAF encoder pipeline: parse -> sections -> container (host).

The port's copy of ``naf_tpu/pipeline/encoder.py``: ``encode`` parses an
input held in memory (``pipeline.parser``) and ``build_archive`` writes the
zstd sections and the container; the device encode
(``parallel.pipeline.encode_device``) shares ``build_archive``, so both give
the same archive bytes.  ``engine="native"`` compresses every section with
the native entropy engine (``codec.compress_section_native``), a large SEQ
section in thread-parallel parts stitched into one frame
(``codec.compress_section_parts``); ``engine="device"`` compresses the
SEQ and QUAL sections with the device match finder
(``codec.compress_section_device`` on ``device=``) and the metadata
sections with the native engine, as naf_tpu's does.  ``build_archive``'s
section compress is a ``sections`` span (``utils/trace.py``) over one
``zstd`` span a section, on the pool's threads, and the container write a
``container`` span.

Every archive produced here is decodable by the reference `unnaf`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..codec import (SectionCompressor, check_engine, compress_section_blocked,
                     compress_section_device, compress_section_native, compress_section_parts)
from ..format import constants as C
from ..format.container import NafArchive, NafHeader, Section, naf_bytes
from ..ops.mask import mask_units_from_bytes
from ..ops.nibble_np import pack_4bit_np
from ..utils.trace import bind, note, trace_span
from . import parser as P

#: native-engine SEQ payloads at least this large split into thread-parallel
#: single-frame parts (history-free block chains; codec.zstd_backend)
PARTS_MIN_BYTES = 16 << 20


@dataclass
class EncodeOptions:
    seq_type: int = C.SEQ_TYPE_DNA
    in_format: int = C.IN_FORMAT_UNKNOWN   # from CLI; autodetected if unknown
    level: int = 1
    long_window_log: int = 0               # --long N (SEQ stream only)
    no_mask: bool = False
    strict: bool = False
    well_formed: bool = False
    title: Optional[str] = None
    line_length: Optional[int] = None      # --line-length override
    threads: int = 0                       # zstd worker threads per section
    extended: bool = False                 # tnaf extended format (blocked SEQ)
    block_bytes: int = 4 << 20             # extended: block size (packed bytes)
    engine: str = "zstd"                   # "zstd" (library) | "native" | "device"
    temp_dir: Optional[str] = None         # spill compressed sections here
    temp_name: str = "tnaf"                # temp file prefix (--name)
    keep_temp_files: bool = False


@dataclass
class EncodeStats:
    n_sequences: int = 0
    longest_line: int = 0
    seq_size_original: int = 0
    unexpected_id: np.ndarray = None
    unexpected_comment: np.ndarray = None
    unexpected_seq: np.ndarray = None
    unexpected_qual: np.ndarray = None
    in_format: int = C.IN_FORMAT_UNKNOWN


def split_lengths(lengths: np.ndarray) -> np.ndarray:
    """Per-record lengths -> u32 unit stream with 0xFFFFFFFF continuation.

    Parity: ennaf/src/encoders.c:72-95.
    """
    lengths = np.asarray(lengths, dtype=np.uint64)
    n_full = (lengths // C.LENGTH_UNIT_MAX).astype(np.int64)
    rem = (lengths % C.LENGTH_UNIT_MAX).astype(np.uint32)
    if not n_full.any():
        return rem.astype("<u4")
    total = int(n_full.sum()) + lengths.size
    out = np.full(total, C.LENGTH_UNIT_MAX, dtype="<u4")
    ends = np.cumsum(n_full + 1) - 1
    out[ends] = rem
    return out


def encode(data: bytes, opts: EncodeOptions, *, device="cuda") -> tuple[bytes, EncodeStats]:
    """Compress one FASTA/FASTQ input held in memory into a NAF archive;
    ``device`` is where ``engine="device"`` proposes match candidates."""
    from ..utils.malloc import tune_for_large_buffers

    tune_for_large_buffers()
    stats = EncodeStats()

    fmt, marker = P.detect_format(data)   # raises on junk input (process.c:561)
    if (
        opts.in_format != C.IN_FORMAT_UNKNOWN
        and fmt != C.IN_FORMAT_UNKNOWN
        and opts.in_format != fmt
    ):
        raise P.InputError("input format is different from format specified in the command line")
    stats.in_format = fmt

    is_fastq = fmt == C.IN_FORMAT_FASTQ
    text_like = opts.seq_type >= C.SEQ_TYPE_PROTEIN
    store_mask = not opts.no_mask and not text_like
    store_qual = is_fastq

    if fmt == C.IN_FORMAT_UNKNOWN:
        res = P.ParseResult()   # empty input -> empty archive (ennaf does this)
    elif is_fastq:
        res = P.parse_fastq(data, opts.seq_type, strict=opts.strict,
                            well_formed=opts.well_formed, marker_pos=marker,
                            want_mask=store_mask)
    else:
        res = P.parse_fasta(data, opts.seq_type, strict=opts.strict,
                            well_formed=opts.well_formed, marker_pos=marker,
                            want_mask=store_mask)

    stats.n_sequences = res.n_sequences
    stats.longest_line = res.longest_line
    stats.seq_size_original = int(res.seq.size)
    stats.unexpected_id = res.unexpected_id
    stats.unexpected_comment = res.unexpected_comment
    stats.unexpected_seq = res.unexpected_seq
    stats.unexpected_qual = res.unexpected_qual

    return build_archive(res, opts, stats, device=device)


def build_archive(res: "P.ParseResult", opts: EncodeOptions,
                  stats: EncodeStats, *,
                  prebuilt: "Optional[dict]" = None,
                  device="cuda") -> tuple[bytes, EncodeStats]:
    """Sections + container from a parse result (host or device produced).

    Shared tail of the host pipeline and the device pipeline
    (parallel/pipeline.py); both produce byte-identical archives for
    the same input because section payload construction is identical.
    ``prebuilt`` maps section names to ready ``Section`` objects (the
    multi-process paths of parallel/multihost.py compress SEQ/QUAL on the
    processes that own the blocks and inject the assembled payloads here).
    ``device`` is read only by ``engine="device"``.
    """
    check_engine(opts.engine)
    is_fastq = stats.in_format == C.IN_FORMAT_FASTQ
    text_like = opts.seq_type >= C.SEQ_TYPE_PROTEIN
    store_mask = not opts.no_mask and not text_like
    store_qual = is_fastq

    # --- section payload construction (independent sections compress on a
    # thread pool; zstandard releases the GIL) ------------------------------
    level, threads = opts.level, opts.threads

    def library_section(buf, window_log: int = 0):
        """One frame through the library engine, read in place; the zstd
        span notes the bytes it copied on the host outside libzstd."""
        sc = SectionCompressor(level=level, window_log=window_log, threads=threads)
        payload = sc.finish(buf)
        note(copied=sc.copied)
        return payload

    def compress_bytes(buf) -> Section:
        mv = memoryview(buf)
        if opts.engine in ("native", "device"):
            # the device engine takes the SEQ and QUAL payloads; the small
            # metadata sections go through the native serializer
            return Section(uncompressed_size=mv.nbytes,
                           payload=compress_section_native(mv, level=level))
        return Section(uncompressed_size=mv.nbytes, payload=library_section(mv))

    def seq_payload(buf):
        if opts.extended:
            return compress_section_blocked(
                buf, level=level, window_log=opts.long_window_log,
                threads=threads, block_bytes=opts.block_bytes, engine=opts.engine,
                device=device)
        # --long widens the SEQ window only (compressor.c:7-21)
        if opts.engine == "device":
            return compress_section_device(buf, level=level, window_log=opts.long_window_log,
                                           device=device)
        if opts.engine == "native":
            n = memoryview(buf).nbytes
            if threads > 1 and n >= PARTS_MIN_BYTES:
                # history-free parts of at least 8 MB stitched into one
                # standard frame: the job split libzstd's own MT mode makes
                part = max(8 << 20, -(-n // threads))
                parts = [memoryview(buf)[i:i + part] for i in range(0, n, part)]
                return compress_section_parts(parts, level=level,
                                              window_log=opts.long_window_log,
                                              threads=threads)
            return compress_section_native(buf, level=level, window_log=opts.long_window_log)
        return library_section(buf, opts.long_window_log)

    jobs: dict[str, "object"] = {}
    jobs["ids"] = lambda: compress_bytes(res.ids_blob)
    jobs["comments"] = lambda: compress_bytes(res.comments_blob)
    jobs["lengths"] = lambda: compress_bytes(split_lengths(res.lengths))

    if store_mask:
        units = (res.mask_units if res.mask_units is not None
                 else mask_units_from_bytes(res.seq))
        jobs["mask"] = lambda: compress_bytes(units)

    # the bytes each job hands to zstd, where they are not the section's
    # uncompressed size (the packed sequence)
    zstd_in: dict[str, int] = {}
    if text_like:
        seq_bytes = res.seq
        if opts.no_mask:
            seq_bytes = C.TOUPPER[seq_bytes]
        jobs["sequence"] = lambda: Section(
            uncompressed_size=res.seq.size,
            payload=seq_payload(seq_bytes))
    else:
        if res.packed is not None:
            packed = res.packed          # fused native scan already packed
        else:
            packed, carry = pack_4bit_np(res.seq)
            if carry is not None:
                packed = np.concatenate([packed, np.asarray([carry], dtype=np.uint8)])
        zstd_in["sequence"] = packed.nbytes
        jobs["sequence"] = lambda: Section(
            uncompressed_size=int(res.seq.size),
            payload=seq_payload(packed))

    if store_qual:
        if opts.extended:
            jobs["quality"] = lambda: Section(
                uncompressed_size=int(res.qual.size),
                payload=compress_section_blocked(
                    res.qual, level=level, threads=threads,
                    block_bytes=opts.block_bytes, engine=opts.engine, device=device))
        elif opts.engine == "device":
            jobs["quality"] = lambda: Section(
                uncompressed_size=int(res.qual.size),
                payload=compress_section_device(res.qual, level=level,
                                                device=device))
        else:
            jobs["quality"] = lambda: compress_bytes(res.qual)

    if prebuilt:
        for name, sec in prebuilt.items():
            jobs[name] = (lambda s=sec: s)

    def run(name: str) -> Section:
        with trace_span("zstd", section=name):
            sec = jobs[name]()
            note(bytes=zstd_in.get(name, sec.uncompressed_size), out=sec.compressed_size)
        return sec

    sections: dict[str, Section] = {}
    big = sum(s for s in (res.seq.size, res.qual.size) if s) > (1 << 22)
    with trace_span("sections"):
        if big and len(jobs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(len(jobs), 4)) as ex:
                futs = {k: ex.submit(bind(run), k) for k in jobs}
                sections = {k: f.result() for k, f in futs.items()}
        else:
            sections = {k: run(k) for k in jobs}

    header = NafHeader(
        format_version=1 if opts.seq_type == C.SEQ_TYPE_DNA else 2,
        seq_type=opts.seq_type,
        extended=opts.extended,
        has_title=opts.title is not None,
        has_ids=True,
        has_comments=True,
        has_lengths=True,
        has_mask=store_mask,
        has_sequence=True,
        has_quality=store_qual,
        line_length=opts.line_length if opts.line_length is not None else res.longest_line,
        n_sequences=res.n_sequences,
    )
    archive = NafArchive(
        header=header,
        title=opts.title.encode() if opts.title is not None else None,
        sections=sections,
    )
    with trace_span("container"):
        blob = naf_bytes(archive)
        note(out=len(blob))
    return blob, stats
