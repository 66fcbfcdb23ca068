"""NAF decoder: container -> sections -> output, on the host or on the
device.

``Decoder`` is the port's copy of ``naf_tpu/pipeline/decoder.py``'s: the
container and section loads, every output mode ``untnaf`` calls (format,
part list and sizes, title, number, ids, names, lengths, total length,
mask, total mask length, 4-bit, ``seq_concat``, ``sequences``,
``charcount``, ``fasta()``, ``fastq()``, the record ranges) and the
bounded-memory ``stream_fasta`` / ``stream_fastq``, which render record
batches while a background thread decompresses ahead (``_Prefetcher``).
Every render goes through the native one-thread render (the original's
multithreaded render, F1 in ROADMAP.md, is not copied), or numpy where the
native library is off.  A FASTQ render that finds neither the sequence nor
the quality loaded decompresses the two sections on two threads
(``_load_seq_and_qual``), as the original does.  ``NAF_TPU_TRACE`` times
the original's three spans here (``utils/trace.py``): ``seq-unzstd``,
``seq+qual-unzstd`` and ``render``; it also records, silent on stderr, an
``unzstd`` span a section decompress, and under the ``decode`` root of a
device output ``build-plan`` and ``device-render``.

``fasta_device`` and ``fastq_device`` render the sequence (and qualities) on
the device through ``parallel.decode``: the uniform-group render
(``decode_device``), or, where ``parallel.decode.decline_reason`` says it
does not take the archive, the ragged render
(``decode_device:ragged:<reason>``).  Over a mesh of several devices the
render is the ragged one, each batch cut into one chunk a device
(``decode_device:ragged:mesh``): the uniform render is for one device
only, as in the reference.  Routes counted in ``device.ROUTES`` send the
rest to ``fasta()`` / ``fastq()``: spill quirks (chars beyond the sum of
the lengths), as the reference does, and a record too large for the
ragged render's i32 batches (``render_overflow``).

Importing this module, and every host output, load no torch: the device
half (``device``, ``parallel.decode``) is imported inside ``_plan`` and the
two device entry points.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import BinaryIO, Optional

import numpy as np

from ..codec import (SectionDecompressor, decompress_section, decompress_section_blocked,
                     parse_blocked_index)
from ..format import constants as C
from ..format.container import NafFormatError, NafReader
from ..native import host as native
from ..ops.assemble import Column, const_column, ragged_concat, split_blob
from ..ops.histogram_np import charcount_np, format_charcount
from ..ops.mask import apply_mask_np, expand_mask_np, merge_units, runs_to_units
from ..ops.nibble_np import unpack_4bit_np
from ..ops.render import body_length, wrap_records_np
from ..utils.trace import bind, trace_span


class DecodeError(ValueError):
    """Fatal decode error; message mirrors unnaf's die() text."""


@dataclass
class DecodeOptions:
    use_mask: bool = True
    line_length: Optional[int] = None


_MAXU32 = np.uint32(C.LENGTH_UNIT_MAX)


def merge_u32_lengths(units: np.ndarray) -> np.ndarray:
    """u32 length units -> u64 per-record lengths (0xFFFFFFFF continuation).

    Parity: unnaf/src/output.c:185-197.
    """
    units = np.ascontiguousarray(units, dtype=np.uint32)
    if units.size == 0:
        return np.zeros(0, dtype=np.uint64)
    u = units.astype(np.uint64)
    terminal = units != _MAXU32
    csum = np.concatenate([np.zeros(1, np.uint64), np.cumsum(u)])
    term_idx = np.flatnonzero(terminal)
    ends = csum[term_idx + 1]
    starts = np.concatenate([np.zeros(1, np.uint64), ends[:-1]])
    out = ends - starts
    if term_idx.size == 0 or term_idx[-1] != units.size - 1:
        tail_start = ends[-1] if term_idx.size else 0
        out = np.concatenate([out, np.asarray([csum[-1] - tail_start], np.uint64)])
    return out


class _ChunkWindow:
    """Sliding window over a stream of decompressed chunks.

    Chunks append at the tail; ``take(a, b)`` assembles the absolute byte
    range [a, b) into one contiguous array; ``drop_to(a)`` releases whole
    chunks that end at or before ``a``.  Retained data is never
    reallocated or moved.
    """

    __slots__ = ("_chunks", "end")

    def __init__(self):
        self._chunks: "deque[tuple[int, bytes]]" = deque()   # (abs_start, data)
        self.end = 0          # absolute offset one past the last byte appended

    def append(self, data: bytes) -> None:
        if data:
            self._chunks.append((self.end, data))
            self.end += len(data)

    def overlapping(self, a: int, b: int) -> list:
        """Chunk refs overlapping [a, b) (cheap; for snapshot-under-lock)."""
        return [(s, d) for s, d in self._chunks
                if s < b and s + len(d) > a]

    @staticmethod
    def assemble(chunks: list, a: int, b: int) -> np.ndarray:
        out = np.empty(b - a, np.uint8)
        for s, d in chunks:
            lo, hi = max(a, s), min(b, s + len(d))
            if lo < hi:
                out[lo - a:hi - a] = np.frombuffer(d, np.uint8,
                                                   count=hi - lo, offset=lo - s)
        return out

    def take(self, a: int, b: int) -> np.ndarray:
        return self.assemble(self.overlapping(a, b), a, b)

    def drop_to(self, a: int) -> None:
        ch = self._chunks
        while ch and ch[0][0] + len(ch[0][1]) <= a:
            ch.popleft()


class _Prefetcher:
    """Background zstd-decompress of a section: overlaps with rendering.

    A producer thread reads the compressed payload and appends decompressed
    chunks to a window; the consumer waits for absolute coverage, assembles
    the batch it needs, then releases what it has written out.  The
    high-water mark bounds memory.
    """

    def __init__(self, f: BinaryIO, csize: int, high_water: int,
                 total_out: Optional[int] = None):
        self._win = _ChunkWindow()
        self._dropped = 0
        self._lock = threading.Lock()
        self._can_consume = threading.Condition(self._lock)
        self._can_produce = threading.Condition(self._lock)
        self._done = False
        self._err: Optional[BaseException] = None
        self._high = max(high_water, 8 << 20)

        def run():
            d = SectionDecompressor(csize, total_out)
            left = csize
            try:
                while left > 0:
                    chunk = f.read(min(left, 4 << 20))
                    if not chunk:
                        raise NafFormatError("incomplete or truncated input")
                    left -= len(chunk)
                    out = d.feed(chunk)
                    with self._lock:
                        while (self._win.end - self._dropped > self._high
                               and not self._done):
                            self._can_produce.wait(0.1)
                        self._win.append(out)
                        self._can_consume.notify_all()
            except BaseException as e:
                self._err = e
            finally:
                with self._lock:
                    self._done = True
                    self._can_consume.notify_all()

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def wait_until(self, abs_bytes: int) -> None:
        """Block until the window covers absolute offset `abs_bytes`."""
        with self._lock:
            while self._win.end < abs_bytes:
                if self._err is not None:
                    raise self._err
                if self._done:
                    raise NafFormatError("incomplete or truncated input")
                self._can_consume.wait()
            if self._err is not None:
                raise self._err

    def take(self, a: int, b: int) -> np.ndarray:
        """Assemble absolute range [a, b); caller must have waited for b."""
        with self._lock:
            chunks = self._win.overlapping(a, b)   # refs only; bytes immutable
        return _ChunkWindow.assemble(chunks, a, b)

    def drop_to(self, abs_bytes: int) -> None:
        with self._lock:
            self._win.drop_to(abs_bytes)
            self._dropped = abs_bytes
            self._can_produce.notify_all()

    def close(self) -> None:
        with self._lock:
            self._done = True
            self._can_produce.notify_all()
        self._t.join(timeout=10)


class Decoder:
    """One NAF archive opened for reading."""

    def __init__(self, f: BinaryIO, opts: DecodeOptions | None = None):
        from ..utils.malloc import tune_for_large_buffers

        tune_for_large_buffers()
        self.r = NafReader(f)
        self.h = self.r.header
        self.opts = opts or DecodeOptions()
        self._lengths_units: Optional[np.ndarray] = None
        self._ids_blob: Optional[bytes] = None
        self._comments_blob: Optional[bytes] = None
        self._mask_units: Optional[np.ndarray] = None
        self._seq_raw: Optional[np.ndarray] = None      # section bytes as stored
        self._total_seq_len: Optional[int] = None
        self._qual: Optional[np.ndarray] = None

    @property
    def is_nucleotide(self) -> bool:
        return self.h.seq_type <= C.SEQ_TYPE_RNA

    @property
    def masking(self) -> bool:
        return self.opts.use_mask and self.h.has_mask

    @property
    def line_length(self) -> int:
        if self.opts.line_length is not None:
            return self.opts.line_length
        return self.r.line_length

    # ---- section loads ----------------------------------------------------

    def _decode_payload(self, payload: bytes, expect: int) -> bytes:
        """SEQ/QUAL payload decode; extended archives decode blocks in
        parallel (the plain format's single frame is inherently serial)."""
        if self.h.extended:
            return decompress_section_blocked(payload, expect)
        return decompress_section(payload, expect)

    def _unzstd_meta(self, name: str) -> bytes:
        """A metadata section read and decompressed: an ``unzstd`` span."""
        u, payload = self.r.load_section(name)
        with trace_span("unzstd", section=name, bytes=u):
            return decompress_section(payload, u)

    def _load_ids(self) -> bytes:
        if self._ids_blob is None:
            self._ids_blob = self._unzstd_meta("ids")
        return self._ids_blob

    def _load_comments(self) -> bytes:
        if self._comments_blob is None:
            self._comments_blob = self._unzstd_meta("comments")
        return self._comments_blob

    def _load_length_units(self) -> np.ndarray:
        if self._lengths_units is None:
            self._lengths_units = np.frombuffer(self._unzstd_meta("lengths"), dtype="<u4")
        return self._lengths_units

    def _load_mask_units(self) -> np.ndarray:
        if self._mask_units is None:
            self._mask_units = np.frombuffer(self._unzstd_meta("mask"), dtype=np.uint8)
        return self._mask_units

    def _load_seq_raw(self) -> tuple[int, np.ndarray]:
        """Decompress the sequence section as stored (packed nibbles / raw)."""
        if self._seq_raw is None:
            total, payload = self.r.load_section("sequence")
            self._total_seq_len = total
            expect = (total + 1) // 2 if self.is_nucleotide else total
            with trace_span("seq-unzstd", bytes=expect):
                self._seq_raw = np.frombuffer(self._decode_payload(payload, expect), np.uint8)
        return self._total_seq_len, self._seq_raw  # type: ignore[return-value]

    def _unzstd(self, name: str, payload: bytes, expect: int) -> bytes:
        """``_decode_payload`` of the SEQ or QUAL section ``name``: an
        ``unzstd`` span."""
        with trace_span("unzstd", section=name, bytes=expect):
            return self._decode_payload(payload, expect)

    def _load_qual(self) -> np.ndarray:
        if self._qual is None:
            qu, qpayload = self.r.load_section("quality")
            self._qual = np.frombuffer(self._unzstd("quality", qpayload, qu), np.uint8)
        return self._qual

    # ---- container-level info ------------------------------------------

    def format_name(self) -> bytes:
        q = " with qualities" if self.h.has_quality else ""
        return f"{self.h.seq_type_name} sequences{q} in NAF format version {self.h.format_version}\n".encode()

    def part_list(self) -> bytes:
        names = [
            ("Title", self.h.has_title), ("IDs", self.h.has_ids),
            ("Names", self.h.has_comments), ("Lengths", self.h.has_lengths),
            ("Mask", self.h.has_mask), ("Data", self.h.has_sequence),
            ("Quality", self.h.has_quality),
        ]
        present = [n for n, p in names if p]
        return (", ".join(present) + "\n").encode()

    def part_sizes(self) -> bytes:
        self.r.read_counters()
        out = []
        if self.h.has_title:
            title = self.r.load_title()
            out.append(f"Title: {len(title)}\n")
        labels = [("ids", "IDs"), ("comments", "Names"), ("lengths", "Lengths"),
                  ("mask", "Mask"), ("sequence", "Data"), ("quality", "Quality")]
        for key, label in labels:
            if getattr(self.h, self.r._FLAG_ATTR[key]):
                u, c = self.r.section_sizes(key)
                self.r._skip_ahead(c)
                # match C's printf %.3f for the u == 0 case (prints inf/-nan)
                if u:
                    out.append(f"{label}: {c} / {u} ({c / u * 100:.3f}%)\n")
                else:
                    out.append(f"{label}: {c} / {u} ({'inf' if c else '-nan'}%)\n")
        return "".join(out).encode()

    # ---- host render ---------------------------------------------------------

    def _native_render(self, mode: int, masking: bool, *, with_names: bool,
                       with_lengths: bool, with_qual: bool = False,
                       resize_lengths: bool = False):
        """Load sections in container order and run the C++ renderer."""
        h = self.h
        n = self.r.n_sequences
        line_len = self.line_length
        ids_blob = com_blob = None
        if with_names:
            ids_blob = self._load_ids() if h.has_ids else None
            com_blob = self._load_comments() if h.has_comments else None
        merged = None
        if with_lengths and h.has_lengths:
            merged = merge_u32_lengths(self._load_length_units())
            if resize_lengths and merged.size != n:
                merged = (np.resize(merged, n) if merged.size
                          else np.zeros(n, np.uint64))
        mask_units = self._load_mask_units() if masking else None
        if with_qual and self._seq_raw is None and self._qual is None:
            self._load_seq_and_qual()
        total, raw = self._load_seq_raw()
        qual = self._load_qual() if with_qual else None
        nuc = self.is_nucleotide
        do_upper = (not nuc) and (not self.opts.use_mask) and mode != native.MODE_FASTQ
        with trace_span("render", bytes=total, mode=mode):
            return native.render(
                mode, seq_data=raw, total_chars=total, is_packed=nuc,
                is_rna=h.seq_type == C.SEQ_TYPE_RNA, do_upper=do_upper,
                mask_units=mask_units, lengths=merged,
                ids_blob=ids_blob, comments_blob=com_blob, qual=qual,
                name_sep=ord(h.name_separator), line_len=line_len,
                out_capacity=total + 64)

    def _load_seq_and_qual(self) -> None:
        """Fill both section caches: the sequence and quality payloads read
        in container order, then decompressed on two threads (they are
        independent zstd frames, and zstd releases the GIL)."""
        from concurrent.futures import ThreadPoolExecutor

        total, spayload = self.r.load_section("sequence")
        self._total_seq_len = total
        qu, qpayload = self.r.load_section("quality")
        expect = (total + 1) // 2 if self.is_nucleotide else total
        with trace_span("seq+qual-unzstd", bytes=expect + qu):
            with ThreadPoolExecutor(2) as ex:
                f_seq = ex.submit(bind(self._unzstd), "sequence", spayload, expect)
                f_qual = ex.submit(bind(self._unzstd), "quality", qpayload, qu)
                self._seq_raw = np.frombuffer(f_seq.result(), np.uint8)
                self._qual = np.frombuffer(f_qual.result(), np.uint8)

    def _load_seq_chars(self, masking: bool, text_toupper: bool | None = None) -> np.ndarray:
        """Decode the sequence section to rendered characters.

        For nucleotide archives: 4-bit unpack (+32 in masked runs).
        For text/protein: raw bytes; uppercased when mask is ignored
        (unnaf/src/output.c:363-366,500).
        """
        mask_runs = merge_units(self._load_mask_units()) if masking else None
        total, raw = self._load_seq_raw()
        if self.is_nucleotide:
            chars = unpack_4bit_np(raw, total, rna=self.h.seq_type == C.SEQ_TYPE_RNA)
        else:
            chars = raw.copy()
            upper = (not self.opts.use_mask) if text_toupper is None else text_toupper
            if upper:
                chars = C.TOUPPER[chars]
        if masking and total:
            chars = apply_mask_np(chars, expand_mask_np(mask_runs, total))
        return chars

    # ---- metadata outputs ---------------------------------------------------

    def title(self) -> bytes:
        self.r.read_counters()
        t = self.r.load_title() if self.h.has_title else b""
        return t + b"\n"

    def number(self) -> bytes:
        return f"{self.r.n_sequences}\n".encode()

    def ids(self) -> bytes:
        if not self.h.has_ids:
            return b""
        n = self.r.n_sequences
        col = split_blob(self._load_ids(), n)
        return ragged_concat([col, const_column(b"\n", n)], n).tobytes()

    def names(self) -> bytes:
        n = self.r.n_sequences
        if not (self.h.has_ids or self.h.has_comments):
            return b""
        cols = self._name_columns(n)
        return ragged_concat(cols + [const_column(b"\n", n)], n).tobytes()

    def _name_columns(self, n: int) -> list[Column]:
        """Columns rendering id[sep]comment per record (output.c:105-124)."""
        if self.h.has_ids and not self.h.has_comments:
            return [split_blob(self._load_ids(), n)]
        if self.h.has_comments and not self.h.has_ids:
            self.r.skip_section("ids")
            return [split_blob(self._load_comments(), n, "names")]
        idc = split_blob(self._load_ids(), n)
        com = split_blob(self._load_comments(), n, "names")
        sep = const_column(self.h.name_separator.encode(), n, present=com.length > 0)
        return [idc, sep, com]

    def lengths(self) -> bytes:
        if not self.h.has_lengths:
            return b""
        self.r.skip_through("lengths")
        merged = merge_u32_lengths(self._load_length_units())
        return ("".join(f"{v}\n" for v in merged.tolist())).encode()

    def total_length(self) -> bytes:
        if not self.h.has_lengths:
            return b""
        self.r.skip_through("sequence")
        total, _ = self.r.section_sizes("sequence")
        return f"{total}\n".encode()

    def mask(self) -> bytes:
        if not self.h.has_mask:
            return b""
        self.r.skip_through("mask")
        merged = merge_units(self._load_mask_units())
        return ("".join(f"{v}\n" for v in merged.tolist())).encode()

    def total_mask_length(self) -> bytes:
        if not self.h.has_mask:
            return b"0\n"
        self.r.skip_through("mask")
        units = self._load_mask_units()
        return f"{int(units.astype(np.uint64).sum())}\n".encode()

    # ---- record ranges --------------------------------------------------------

    def _range_chars(self, merged: np.ndarray, r0: int, r1: int
                     ) -> tuple[int, int, int, int]:
        """(csize, total, c0, c1): the sequence section's compressed size, its
        char count and the char range of records [r0, r1), the file at the
        section's payload."""
        total, csize = self.r.section_sizes("sequence")
        rec_ends = np.cumsum(merged.astype(np.int64))
        if int(rec_ends[-1]) != total or not self.is_nucleotide:
            raise DecodeError("range decode requires a regular nucleotide archive")
        return csize, total, int(rec_ends[r0 - 1]) if r0 > 0 else 0, int(rec_ends[r1 - 1])

    def _render_batch(self, mode: int, r0: int, r1: int, c0: int, c1: int, meta,
                      seq_slice: np.ndarray, *, mask_units=None,
                      qual: Optional[np.ndarray] = None) -> bytes:
        """The one-thread native render of records [r0, r1), chars [c0, c1)
        (``seq_slice`` the packed bytes from ``c0 // 2``)."""
        ids, com, merged, _, nul_ids, nul_com = meta
        return native.render(
            mode, seq_data=seq_slice, total_chars=c1 - c0, is_packed=True,
            is_rna=self.h.seq_type == C.SEQ_TYPE_RNA, do_upper=False,
            nibble_off=c0 & 1, mask_units=mask_units, lengths=merged[r0:r1],
            ids_blob=self._blob_slice(ids, nul_ids, r0, r1),
            comments_blob=self._blob_slice(com, nul_com, r0, r1),
            qual=qual, name_sep=ord(self.h.name_separator),
            line_len=0 if mode == native.MODE_FASTQ else self.line_length)

    def fasta_range(self, r0: int, r1: int) -> bytes:
        """Decode records [r0, r1) only.

        On extended-format archives (flag bit 0x80) this touches only the
        sequence blocks overlapping the requested char range; plain archives
        decompress the prefix.
        """
        if not self.h.has_sequence:
            return b""
        n = self.r.n_sequences
        r0, r1 = max(0, r0), min(n, r1)
        if r1 <= r0:
            return b""
        meta = self._range_metadata(self.masking)
        csize, total, c0, c1 = self._range_chars(meta[2], r0, r1)
        seq_slice = self._section_byte_slice(csize, (total + 1) // 2, c0 // 2, (c1 + 1) // 2)
        return self._render_batch(native.MODE_FASTA, r0, r1, c0, c1, meta, seq_slice,
                                  mask_units=self._batch_mask_units(meta[3], c0, c1))

    def _section_byte_slice(self, csize: int, total_out: int, s0: int, s1: int,
                            drain: bool = False) -> np.ndarray:
        """Decompressed bytes [s0, s1) of the section at the current file
        position.  Extended archives touch only the blocks overlapping the
        range (random access via the block index); plain archives
        decompress the prefix.  ``drain`` consumes the rest of the
        section's compressed bytes (pipe-friendly skip to the next
        section)."""
        if self.h.extended:
            payload = self.r.f.read(csize)
            entries, off = parse_blocked_index(payload)
            # walk the index; decompress only blocks covering [s0, s1)
            pieces = []
            pos = 0
            for raw_len, comp_len in entries:
                if pos + raw_len > s0 and pos < s1:
                    blk = decompress_section(payload[off:off + comp_len], raw_len)
                    pieces.append(blk[max(s0 - pos, 0):min(s1 - pos, raw_len)])
                off += comp_len
                pos += raw_len
                if pos >= s1:
                    break
            return np.frombuffer(b"".join(pieces), np.uint8)
        # a prefix read keeps the library's incremental decode even under
        # the native engine, whose one-shot decoder would decode the whole
        # section for a small prefix
        d = SectionDecompressor(csize, total_out, force_library=s1 < total_out)
        left = csize
        out = bytearray()
        while len(out) < s1 and left > 0:
            chunk = self.r.f.read(min(left, 4 << 20))
            if not chunk:
                raise NafFormatError("incomplete or truncated input")
            left -= len(chunk)
            out.extend(d.feed(chunk))
        if drain:
            while left > 0:
                chunk = self.r.f.read(min(left, 4 << 20))
                if not chunk:
                    raise NafFormatError("incomplete or truncated input")
                left -= len(chunk)
        return np.frombuffer(bytes(out[s0:s1]), np.uint8)

    def fastq_range(self, r0: int, r1: int) -> bytes:
        """Decode FASTQ records [r0, r1) only: ``fasta_range`` with the
        quality section sliced over the same char range; the output equals
        that slice of ``fastq()`` (the mask is never applied, unnaf.c:443)."""
        if not self.h.has_sequence:
            return b""
        if not self.h.has_quality:
            raise DecodeError("FASTQ output requested, but input has no qualities")
        n = self.r.n_sequences
        r0, r1 = max(0, r0), min(n, r1)
        if r1 <= r0:
            return b""
        meta = self._range_metadata(False)
        csize, total, c0, c1 = self._range_chars(meta[2], r0, r1)
        seq_slice = self._section_byte_slice(csize, (total + 1) // 2, c0 // 2, (c1 + 1) // 2,
                                             drain=True)
        qtotal, qcsize = self.r.section_sizes("quality")
        qual_slice = self._section_byte_slice(qcsize, qtotal, c0, c1)
        return self._render_batch(native.MODE_FASTQ, r0, r1, c0, c1, meta, seq_slice,
                                  qual=qual_slice)

    def four_bit(self) -> bytes:
        if not self.h.has_sequence:
            return b""
        total, payload = self.r.load_section("sequence")
        return self._decode_payload(payload, (total + 1) // 2)

    # ---- sequence outputs -----------------------------------------------------

    def seq_concat(self, masking: Optional[bool] = None) -> bytes:
        """--seq: the concatenated sequence stream, no separators."""
        if not self.h.has_sequence:
            return b""
        masking = self.masking if masking is None else masking
        if native.available():
            return self._native_render(native.MODE_SEQ, masking,
                                       with_names=False, with_lengths=False)
        return self._load_seq_chars(masking).tobytes()

    def sequences(self, masking: Optional[bool] = None) -> bytes:
        """--sequences: one sequence per line, no names."""
        if not self.h.has_sequence:
            return b""
        masking = self.masking if masking is None else masking
        if native.available():
            return self._native_render(native.MODE_SEQUENCES, masking,
                                       with_names=False, with_lengths=True)
        merged = merge_u32_lengths(self._load_length_units())
        chars = self._load_seq_chars(masking)
        if self._total_seq_len == 0:
            # reference prints nothing when there are no sequence bp
            # (output-sequences.c:82: loop gated on total_seq_n_bp_remaining)
            return b""
        n = merged.size
        ends = np.cumsum(merged.astype(np.int64))
        starts = ends - merged.astype(np.int64)
        col = Column(chars, starts, merged.astype(np.int64))
        out = ragged_concat([col, const_column(b"\n", n)], n).tobytes()
        # bytes beyond sum(lengths) spill after the last record, raw
        # (output-sequences.c:38-43; can occur with quirky archives)
        if int(ends[-1]) < chars.size:
            out += chars[int(ends[-1]):].tobytes()
        return out

    def charcount(self, masking: Optional[bool] = None) -> bytes:
        if not self.h.has_sequence:
            return b""
        masking = self.masking if masking is None else masking
        if native.available():
            counts = self._native_render(native.MODE_CHARCOUNT, masking,
                                         with_names=False, with_lengths=False)
            return format_charcount(counts).encode()
        return format_charcount(charcount_np(self._load_seq_chars(masking))).encode()

    def fasta(self, masking: Optional[bool] = None) -> bytes:
        if not self.h.has_sequence:
            return b""
        masking = self.masking if masking is None else masking
        if native.available():
            return self._native_render(native.MODE_FASTA, masking, with_names=True,
                                       with_lengths=True, resize_lengths=True)
        n = self.r.n_sequences
        line_len = self.line_length
        name_cols = self._name_columns(n)
        merged = merge_u32_lengths(self._load_length_units())
        chars = self._load_seq_chars(masking)
        if merged.size != n:
            merged = np.resize(merged, n) if merged.size else np.zeros(n, np.uint64)
        slens = merged.astype(np.int64)
        bodies = wrap_records_np(chars[: int(slens.sum())], slens, line_len)
        blens = body_length(slens, line_len)
        body_starts = np.concatenate([[0], np.cumsum(blens)[:-1]])
        cols = (
            [const_column(b">", n)] + name_cols + [const_column(b"\n", n)]
            + [Column(bodies, body_starts, blens)]
        )
        out = ragged_concat(cols, n).tobytes()
        # Spill bytes beyond sum(lengths) after the last record, continuing
        # its line-wrap state (print_dna_buffer_as_fasta tail, output.c:420).
        used = int(slens.sum())
        if used < chars.size:
            out += self._wrap_tail(chars[used:], slens, line_len)
        return out

    @staticmethod
    def _wrap_tail(extra: np.ndarray, slens: np.ndarray, line_len: int) -> bytes:
        nz = np.flatnonzero(slens)
        if nz.size == 0:
            # all records empty: reference returns before decompressing
            # (print_fasta early return, output.c:629) — no spill
            return b""
        if line_len <= 0:
            return extra.tobytes()
        # line-wrap state continues from the last record with data; a record
        # ending exactly at a line boundary leaves 0 bp in the current line
        last = int(slens[nz[-1]])
        rem = last % line_len
        cur = line_len - rem if rem else 0
        pieces = []
        pos = 0
        rem = extra.size
        while rem > cur:
            pieces.append(extra[pos:pos + cur].tobytes())
            pieces.append(b"\n")
            pos += cur
            rem -= cur
            cur = line_len
        pieces.append(extra[pos:].tobytes())
        return b"".join(pieces)

    def fastq(self) -> bytes:
        if not self.h.has_sequence:
            return b""
        if self.r.n_sequences == 0:
            return b""
        if not self.h.has_quality:
            raise DecodeError("FASTQ output requested, but input has no qualities")
        if native.available():
            return self._native_render(native.MODE_FASTQ, False, with_names=True,
                                       with_lengths=True, with_qual=True)
        n = self.r.n_sequences
        name_cols = self._name_columns(n)
        merged = merge_u32_lengths(self._load_length_units())
        # FASTQ output never applies the mask and never uppercases
        # (unnaf.c:443 print_fastq(0); output-fastq.c memory path)
        chars = self._load_seq_chars(False, text_toupper=False)
        qual = self._load_qual()
        slens = merged.astype(np.int64)
        ends = np.cumsum(slens)
        starts = ends - slens
        cols = (
            [const_column(b"@", n)] + name_cols + [const_column(b"\n", n)]
            + [Column(chars, starts, slens), const_column(b"\n+\n", n),
               Column(qual, starts, slens), const_column(b"\n", n)]
        )
        return ragged_concat(cols, n).tobytes()

    # ---- streaming (bounded-memory) outputs -------------------------------

    def _range_metadata(self, masking: bool):
        """``_batch_metadata`` and the NUL positions of the two blobs, by
        which ``_blob_slice`` cuts out the names of a record range."""
        ids, com, merged, spans = self._batch_metadata(masking)
        nuls = [None if b is None else np.flatnonzero(b == 0) for b in (ids, com)]
        return ids, com, merged, spans, *nuls

    @staticmethod
    def _batch_mask_units(spans, c0: int, c1: int) -> Optional[np.ndarray]:
        """Alternating RLE units for chars [c0, c1) from global masked spans."""
        if spans is None:
            return None
        starts, ends = spans
        lo = np.searchsorted(ends, c0, side="right")
        hi = np.searchsorted(starts, c1, side="left")
        s = np.clip(starts[lo:hi], c0, c1)
        e = np.clip(ends[lo:hi], c0, c1)
        keep = e > s
        s, e = s[keep], e[keep]
        if s.size == 0:
            return np.zeros(0, np.uint8)
        # runs: [gap, masked, gap, masked, ..., trailing-gap] — the trailing
        # unmasked run matters: exhausted units extend the LAST run's state
        gaps = np.concatenate([[s[0] - c0], s[1:] - e[:-1]])
        tail = c1 - int(e[-1])
        runs = np.empty(2 * s.size + (1 if tail > 0 else 0), np.int64)
        runs[0:2 * s.size:2] = gaps
        runs[1:2 * s.size:2] = e - s
        if tail > 0:
            runs[-1] = tail
        return runs_to_units(runs)

    @staticmethod
    def _blob_slice(blob, nuls, r0: int, r1: int):
        if blob is None:
            return None
        a = 0 if r0 == 0 else int(nuls[r0 - 1]) + 1
        b = int(nuls[r1 - 1]) + 1
        return blob[a:b].tobytes()

    @staticmethod
    def _batches(rec_ends: np.ndarray, batch_chars: int):
        """(r0, r1, c0, c1) of each record batch: whole records, at least
        one, about ``batch_chars`` chars."""
        n, total = rec_ends.size, int(rec_ends[-1]) if rec_ends.size else 0
        r0 = 0
        while r0 < n:
            c0 = int(rec_ends[r0 - 1]) if r0 > 0 else 0
            target = min(c0 + batch_chars, total)
            r1 = min(max(int(np.searchsorted(rec_ends, target, side="right")), r0 + 1), n)
            yield r0, r1, c0, int(rec_ends[r1 - 1])
            r0 = r1

    def stream_fasta(self, outf: BinaryIO, masking: Optional[bool] = None,
                     batch_chars: int = 32 << 20) -> None:
        """Decode to FASTA in record batches with bounded memory.

        Peak RAM is O(batch + largest record + compressed tail) instead of
        the whole-archive O(3x output) of ``fasta()``.
        """
        if not self.h.has_sequence or not native.available() or self.h.extended:
            outf.write(self.fasta(masking))
            return
        masking = self.masking if masking is None else masking
        meta = self._range_metadata(masking)
        total, csize = self.r.section_sizes("sequence")
        rec_ends = np.cumsum(meta[2].astype(np.int64))
        if (int(rec_ends[-1]) if rec_ends.size else 0) != total or not self.is_nucleotide:
            # spill-quirk archives & text: whole-buffer path (exact semantics)
            self._total_seq_len = total
            expect = (total + 1) // 2 if self.is_nucleotide else total
            self._seq_raw = np.frombuffer(
                self._decode_payload(self.r.f.read(csize), expect), np.uint8)
            outf.write(self.fasta(masking))
            return
        pf = _Prefetcher(self.r.f, csize, high_water=4 * (batch_chars // 2),
                         total_out=(total + 1) // 2)
        try:
            for r0, r1, c0, c1 in self._batches(rec_ends, batch_chars):
                pf.wait_until((c1 + 1) // 2)
                outf.write(self._render_batch(
                    native.MODE_FASTA, r0, r1, c0, c1, meta, pf.take(c0 // 2, (c1 + 1) // 2),
                    mask_units=self._batch_mask_units(meta[3], c0, c1)))
                # drop consumed bytes (keep the byte shared with the next batch)
                pf.drop_to(c1 // 2)
        finally:
            pf.close()

    def stream_fastq(self, outf: BinaryIO, batch_chars: int = 32 << 20) -> None:
        """Decode to FASTQ in record batches (seq section preloaded
        compressed, quality streamed from the file — input.c:295-341)."""
        if (not self.h.has_sequence or not native.available()
                or self.r.n_sequences == 0 or self.h.extended):
            outf.write(self.fastq())
            return
        if not self.h.has_quality:
            raise DecodeError("FASTQ output requested, but input has no qualities")
        meta = self._range_metadata(False)
        total, csize = self.r.section_sizes("sequence")
        rec_ends = np.cumsum(meta[2].astype(np.int64))
        if int(rec_ends[-1]) != total or not self.is_nucleotide:
            self._seq_raw = np.frombuffer(
                self._decode_payload(self.r.f.read(csize), (total + 1) // 2
                                     if self.is_nucleotide else total), np.uint8)
            self._total_seq_len = total
            outf.write(self.fastq())
            return
        seq_payload = self.r.f.read(csize)   # compressed seq stays in RAM
        qtotal, qcsize = self.r.section_sizes("quality")
        ds = SectionDecompressor(csize, (total + 1) // 2)
        dq = SectionDecompressor(qcsize, qtotal)
        swin, qwin = _ChunkWindow(), _ChunkWindow()
        s_off = 0          # compressed seq consumed
        q_left = qcsize
        for r0, r1, c0, c1 in self._batches(rec_ends, batch_chars):
            need_bytes = (c1 + 1) // 2
            while swin.end < need_bytes and s_off < len(seq_payload):
                take = seq_payload[s_off:s_off + (4 << 20)]
                s_off += len(take)
                swin.append(ds.feed(take))
            while qwin.end < c1 and q_left > 0:
                chunk = self.r.f.read(min(q_left, 4 << 20))
                if not chunk:
                    raise NafFormatError("incomplete or truncated input")
                q_left -= len(chunk)
                qwin.append(dq.feed(chunk))
            if swin.end < need_bytes or qwin.end < c1:
                raise NafFormatError("incomplete or truncated input")
            outf.write(self._render_batch(native.MODE_FASTQ, r0, r1, c0, c1, meta,
                                          swin.take(c0 // 2, need_bytes),
                                          qual=qwin.take(c0, c1)))
            swin.drop_to(c1 // 2)
            qwin.drop_to(c1)

    # ---- render-plan inputs of the device outputs ---------------------------

    def _batch_metadata(self, masking: bool):
        """Blobs, per-record lengths and masked spans for a render plan."""
        h = self.h
        n = self.r.n_sequences
        ids = np.frombuffer(self._load_ids(), np.uint8) if h.has_ids else None
        com = (np.frombuffer(self._load_comments(), np.uint8)
               if h.has_comments else None)
        merged = (merge_u32_lengths(self._load_length_units())
                  if h.has_lengths else np.zeros(0, np.uint64))
        if merged.size != n:
            merged = np.resize(merged, n) if merged.size else np.zeros(n, np.uint64)
        spans = None
        if masking and h.has_mask:
            runs = merge_units(self._load_mask_units()).astype(np.int64)
            ends = np.cumsum(runs)
            starts = ends - runs
            spans = (starts[1::2], ends[1::2])    # masked runs (odd index)
        elif h.has_mask:
            self.r.skip_section("mask")
        return ids, com, merged, spans

    def _plan(self, mode: int, masking: bool):
        """(RenderPlan, raw section bytes) for device render, or None when
        the archive has spill quirks only the host renderer reproduces."""
        from ..parallel import decode as DV

        n = self.r.n_sequences
        ids, com, merged, spans = self._batch_metadata(masking)
        total, raw = self._load_seq_raw()
        if int(merged.astype(np.int64).sum()) != total or n == 0:
            return None
        fastq = mode == DV.MODE_FASTQ
        plan = DV.build_plan(
            mode=mode, line_len=0 if fastq else self.line_length,
            rna=self.h.seq_type == C.SEQ_TYPE_RNA,
            packed=self.is_nucleotide,
            upper=(not fastq) and (not self.is_nucleotide) and (not self.opts.use_mask),
            slens=merged,
            ids_blob=ids.tobytes() if ids is not None else None,
            comments_blob=com.tobytes() if com is not None else None,
            name_sep=self.h.name_separator.encode(), mask_spans=spans)
        return plan, raw

    def _fasta_plan(self, masking: bool):
        from ..parallel.decode import MODE_FASTA

        return self._plan(MODE_FASTA, masking)


#: decline reasons of the uniform render that the ragged render takes, and
#: "mesh": a render over several devices
_RAGGED = ("too_many_groups", "too_large", "spill", "mesh")


def _render(plan, raw, qual, mesh, host) -> bytes:
    """The device render of a plan: uniform, ragged, or ``host()`` by a
    named route; over several devices, the ragged render of every batch
    in one chunk a device."""
    from ..device import count_route
    from ..parallel import decode as DV

    reason = DV.decline_reason(plan)
    if mesh.size > 1 and reason != "empty":
        reason = "mesh"
    if reason is not None and reason not in _RAGGED:
        count_route(f"decode_host:{reason}")
        return host()
    try:
        with trace_span("device-render", bytes=plan.total_out):
            out = (DV.render_regular(plan, raw, qual, device=mesh.devices[0]) if reason is None
                   else DV.render_batched(plan, raw, qual, mesh=mesh))
    except DV.RenderOverflow:
        count_route("decode_host:render_overflow")
        return host()
    count_route("decode_device" if reason is None else f"decode_device:ragged:{reason}")
    return out


def _mesh(device, mesh):
    """The caller's mesh, or one block on ``device``."""
    from ..parallel.mesh import block_mesh

    return mesh if mesh is not None else block_mesh(devices=[device])


def fasta_device(decoder: Decoder, masking: Optional[bool] = None, *, device="cuda",
                 mesh=None) -> bytes:
    """FASTA output of an open archive, rendered on ``device`` (the current
    card by default) or over the devices of ``mesh``; the same bytes as
    ``decoder.fasta(masking)``."""
    from ..device import count_route

    mesh = _mesh(device, mesh)
    with trace_span("decode"):
        if not decoder.h.has_sequence:
            count_route("decode_host:no_sequence")
            return b""
        masking = decoder.masking if masking is None else masking
        built = decoder._fasta_plan(masking)
        if built is None:
            count_route("decode_host:spill_quirk")
            return decoder.fasta(masking)
        plan, raw = built
        return _render(plan, raw, None, mesh, lambda: decoder.fasta(masking))


def fastq_device(decoder: Decoder, *, device="cuda", mesh=None) -> bytes:
    """FASTQ output of an open archive, rendered on ``device`` (the current
    card by default) or over the devices of ``mesh``; the same bytes as
    ``decoder.fastq()``.  The mask is never applied (unnaf.c:443)."""
    from ..device import count_route
    from ..parallel.decode import MODE_FASTQ

    mesh = _mesh(device, mesh)
    with trace_span("decode"):
        if not decoder.h.has_sequence or decoder.r.n_sequences == 0:
            count_route("decode_host:no_sequence")
            return b""
        if not decoder.h.has_quality:
            raise DecodeError("FASTQ output requested, but input has no qualities")
        built = decoder._plan(MODE_FASTQ, False)
        if built is None:
            count_route("decode_host:spill_quirk")
            return decoder.fastq()
        plan, raw = built
        return _render(plan, raw, decoder._load_qual(), mesh, decoder.fastq)
