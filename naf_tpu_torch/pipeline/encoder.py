"""NAF encoder pipeline: parse -> sections -> container (host).

The port's copy of ``naf_tpu/pipeline/encoder.py``: ``encode`` parses an
input held in memory (``pipeline.parser``) and ``build_archive`` writes the
zstd sections and the container; the device encode
(``parallel.pipeline.encode_device``) shares ``build_archive``, so both give
the same archive bytes.  Only the library zstd engine is ported:
``engine="native"`` and ``engine="device"`` raise ``NotImplementedError``.

Every archive produced here is decodable by the reference `unnaf`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..codec import SectionCompressor, check_engine, compress_section_blocked
from ..format import constants as C
from ..format.container import NafArchive, NafHeader, Section, naf_bytes
from ..ops.mask import mask_units_from_bytes
from ..ops.nibble_np import pack_4bit_np
from . import parser as P


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
    engine: str = "zstd"                   # "zstd" (library); no other is ported


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


def encode(data: bytes, opts: EncodeOptions) -> tuple[bytes, EncodeStats]:
    """Compress one FASTA/FASTQ input held in memory into a NAF archive."""
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

    return build_archive(res, opts, stats)


def build_archive(res: "P.ParseResult", opts: EncodeOptions,
                  stats: EncodeStats) -> tuple[bytes, EncodeStats]:
    """Sections + container from a parse result (host or device produced).

    Shared tail of the host pipeline and the device pipeline
    (parallel/pipeline.py); both produce byte-identical archives for
    the same input because section payload construction is identical.
    """
    check_engine(opts.engine)
    is_fastq = stats.in_format == C.IN_FORMAT_FASTQ
    text_like = opts.seq_type >= C.SEQ_TYPE_PROTEIN
    store_mask = not opts.no_mask and not text_like
    store_qual = is_fastq

    # --- section payload construction (independent sections compress on a
    # thread pool; zstandard releases the GIL) ------------------------------
    level, threads = opts.level, opts.threads

    def compress_bytes(buf, window_log: int = 0) -> Section:
        sc = SectionCompressor(level=level, window_log=window_log, threads=threads)
        sc.write(buf)
        return Section(uncompressed_size=sc.uncompressed_size, payload=sc.finish())

    def seq_payload(buf: bytes) -> bytes:
        if opts.extended:
            return compress_section_blocked(
                buf, level=level, window_log=opts.long_window_log,
                threads=threads, block_bytes=opts.block_bytes)
        # --long widens the SEQ window only (compressor.c:7-21)
        sc = SectionCompressor(level=level, window_log=opts.long_window_log,
                               threads=threads)
        sc.write(buf)
        return sc.finish()

    jobs: dict[str, "object"] = {}
    jobs["ids"] = lambda: compress_bytes(res.ids_blob)
    jobs["comments"] = lambda: compress_bytes(res.comments_blob)
    jobs["lengths"] = lambda: compress_bytes(split_lengths(res.lengths).tobytes())

    if store_mask:
        units = (res.mask_units if res.mask_units is not None
                 else mask_units_from_bytes(res.seq))
        jobs["mask"] = lambda: compress_bytes(units.tobytes())

    if text_like:
        seq_bytes = res.seq
        if opts.no_mask:
            seq_bytes = C.TOUPPER[seq_bytes]
        jobs["sequence"] = lambda: Section(
            uncompressed_size=res.seq.size,
            payload=seq_payload(seq_bytes.tobytes()))
    else:
        if res.packed is not None:
            packed = res.packed          # fused native scan already packed
        else:
            packed, carry = pack_4bit_np(res.seq)
            if carry is not None:
                packed = np.concatenate([packed, np.asarray([carry], dtype=np.uint8)])
        jobs["sequence"] = lambda: Section(
            uncompressed_size=int(res.seq.size),
            payload=seq_payload(packed.tobytes()))

    if store_qual:
        if opts.extended:
            jobs["quality"] = lambda: Section(
                uncompressed_size=int(res.qual.size),
                payload=compress_section_blocked(
                    res.qual.tobytes(), level=level, threads=threads,
                    block_bytes=opts.block_bytes))
        else:
            jobs["quality"] = lambda: compress_bytes(res.qual.tobytes())

    sections: dict[str, Section] = {}
    big = sum(s for s in (res.seq.size, res.qual.size) if s) > (1 << 22)
    if big and len(jobs) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(len(jobs), 4)) as ex:
            futs = {k: ex.submit(fn) for k, fn in jobs.items()}
            sections = {k: f.result() for k, f in futs.items()}
    else:
        sections = {k: fn() for k, fn in jobs.items()}

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
    return naf_bytes(archive), stats
