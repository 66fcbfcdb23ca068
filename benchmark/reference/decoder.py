"""NAF decoder of the reference: container -> sections -> FASTA or FASTQ.

A copy, frozen, of the numpy path of ``naf_tpu_torch/pipeline/decoder.py``
(``Decoder.fasta()`` and ``Decoder.fastq()`` with the loads they make; no
native render, no streaming, no device render, plain format only).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, Optional

import numpy as np

from . import constants as C
from .assemble import Column, const_column, ragged_concat, split_blob
from .codec import decompress_section
from .container import NafFormatError, NafReader
from .mask import apply_mask_np, expand_mask_np, merge_units
from .nibble import unpack_4bit_np
from .render import body_length, wrap_records_np


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


class Decoder:
    """One NAF archive opened for reading."""

    def __init__(self, f: BinaryIO, opts: DecodeOptions | None = None):
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
        """SEQ/QUAL payload decode (the plain format's single frame)."""
        if self.h.extended:
            raise NafFormatError("the reference reads the plain format only")
        return decompress_section(payload, expect)

    def _load_ids(self) -> bytes:
        if self._ids_blob is None:
            u, payload = self.r.load_section("ids")
            self._ids_blob = decompress_section(payload, u)
        return self._ids_blob

    def _load_comments(self) -> bytes:
        if self._comments_blob is None:
            u, payload = self.r.load_section("comments")
            self._comments_blob = decompress_section(payload, u)
        return self._comments_blob

    def _load_length_units(self) -> np.ndarray:
        if self._lengths_units is None:
            u, payload = self.r.load_section("lengths")
            raw = decompress_section(payload, u)
            self._lengths_units = np.frombuffer(raw, dtype="<u4")
        return self._lengths_units

    def _load_mask_units(self) -> np.ndarray:
        if self._mask_units is None:
            u, payload = self.r.load_section("mask")
            raw = decompress_section(payload, u)
            self._mask_units = np.frombuffer(raw, dtype=np.uint8)
        return self._mask_units

    def _load_seq_raw(self) -> tuple[int, np.ndarray]:
        """Decompress the sequence section as stored (packed nibbles / raw)."""
        if self._seq_raw is None:
            total, payload = self.r.load_section("sequence")
            self._total_seq_len = total
            expect = (total + 1) // 2 if self.is_nucleotide else total
            self._seq_raw = np.frombuffer(self._decode_payload(payload, expect), np.uint8)
        return self._total_seq_len, self._seq_raw  # type: ignore[return-value]

    def _load_qual(self) -> np.ndarray:
        if self._qual is None:
            qu, qpayload = self.r.load_section("quality")
            self._qual = np.frombuffer(self._decode_payload(qpayload, qu), np.uint8)
        return self._qual

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

    def fasta(self, masking: Optional[bool] = None) -> bytes:
        if not self.h.has_sequence:
            return b""
        masking = self.masking if masking is None else masking
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
