"""Vectorized FASTA/FASTQ parsing.

The reference parser (ennaf/src/process.c:314-544) is a byte-at-a-time pull
state machine.  Here parsing is an array program over the whole input byte
tensor:

  * record markers   = positions where '>' follows an EOL byte,
  * region intervals = (id, comment, sequence) spans found with
    searchsorted over EOL/space positions,
  * per-byte actions = LUT classification + masked replacement,
  * per-record stats = bincount segment reductions.

Bug-for-bug parity notes (verified against the alphabet suite):
  * unexpected bytes inside an ID are counted as id-errors but their '?'
    replacement is appended to the *sequence* stream, not the ID
    (process.c:366 writes to `seq`), and they are not included in any
    record's length;
  * mid-line '>' is data for text sequences but a replaced unexpected
    character otherwise; '>' preceded by an EOL always starts a new record;
  * line lengths count kept sequence characters between EOLs.

A copy, frozen, of the numpy path of ``naf_tpu_torch/pipeline/parser.py``
(the native scan taken out); the benchmark's tests hold its archives against
that package's host ``encode()``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import constants as C


class InputError(ValueError):
    """Fatal input error; message matches the reference's die() text."""


@dataclass
class ParseResult:
    n_sequences: int = 0
    ids_blob: bytes = b""          # '\0'-terminated ids
    comments_blob: bytes = b""     # '\0'-terminated comments
    seq: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    qual: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    lengths: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint64))
    longest_line: int = 0
    # 257-bin histograms (bin 256 = EOF, never hit in practice)
    unexpected_id: np.ndarray = field(default_factory=lambda: np.zeros(257, np.uint64))
    unexpected_comment: np.ndarray = field(default_factory=lambda: np.zeros(257, np.uint64))
    unexpected_seq: np.ndarray = field(default_factory=lambda: np.zeros(257, np.uint64))
    unexpected_qual: np.ndarray = field(default_factory=lambda: np.zeros(257, np.uint64))
    # set where the caller packed or masked already (records.py); else the
    # encoder computes them from seq
    packed: Optional[np.ndarray] = None       # 4-bit codes incl. parity byte
    mask_units: Optional[np.ndarray] = None   # case-mask RLE u8 units


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

_EOL = C.IS_EOL[:256]
_SPACE = C.IS_SPACE[:256]
_WF_SPACE = C.IS_WELL_FORMED_SPACE[:256]
_UNEX_TEXT = C.IS_UNEXPECTED_TEXT[:256]
_UNEX_COMMENT = C.IS_UNEXPECTED_COMMENT[:256]
_UNEX_QUAL = C.IS_UNEXPECTED_QUAL[:256]
_LF = ord("\n")
_GT = ord(">")
_AT = ord("@")


def _first_at_or_after(sorted_pos: np.ndarray, query: np.ndarray, n: int) -> np.ndarray:
    """For each query q: the smallest element of sorted_pos >= q, else n."""
    idx = np.searchsorted(sorted_pos, query, side="left")
    padded = np.concatenate([sorted_pos, [n]])
    return padded[np.minimum(idx, sorted_pos.size)]


def _intervals_to_mask(starts: np.ndarray, ends: np.ndarray, n: int) -> np.ndarray:
    """Non-overlapping half-open intervals -> bool mask of length n."""
    delta = np.zeros(n + 1, dtype=np.int8)
    s = np.clip(starts, 0, n)
    e = np.clip(ends, 0, n)
    np.add.at(delta, s, 1)
    np.add.at(delta, e, -1)
    # dtype=int32 forces numpy's fast accumulate path (same-dtype int cumsum
    # is ~100x slower in this numpy build)
    return np.cumsum(delta[:-1], dtype=np.int32) > 0


def _blob_with_terminators(data: np.ndarray, keep: np.ndarray,
                           rec_id: np.ndarray, n_rec: int) -> bytes:
    """Kept bytes grouped by record, '\0' appended after each record."""
    vals = data[keep]
    per_rec = np.bincount(rec_id[keep], minlength=n_rec).astype(np.int64)
    total = int(vals.size) + n_rec
    out = np.zeros(total, dtype=np.uint8)
    ends = np.cumsum(per_rec + 1) - 1      # positions of '\0'
    fill = np.ones(total, dtype=bool)
    fill[ends] = False
    out[fill] = vals
    return out.tobytes()


def _hist257(values: np.ndarray) -> np.ndarray:
    h = np.zeros(257, dtype=np.uint64)
    if values.size:
        h[:256] = np.bincount(values, minlength=256).astype(np.uint64)
    return h


def _strict_fail(kind: str, byte: int, seq_index: int, seq_type_name: str) -> None:
    ch = chr(byte)
    if kind == "id":
        raise InputError(f"unexpected character '{ch}' in ID of sequence {seq_index}")
    if kind == "comment":
        raise InputError(f"unexpected character '{ch}' in comment of sequence {seq_index}")
    if kind == "qual":
        raise InputError(f"unexpected quality code '{ch}' in sequence {seq_index}")
    raise InputError(f"unexpected {seq_type_name} code '{ch}' in sequence {seq_index}")


# ---------------------------------------------------------------------------
# format detection (parity: process.c:547-583)
# ---------------------------------------------------------------------------

def detect_format(data: bytes) -> tuple[int, int]:
    """Returns (format, index of the first marker byte).

    Skips leading space-class bytes; the first non-space byte must be '>' or
    '@' at the beginning of a line.
    """
    a = np.frombuffer(data, dtype=np.uint8)
    # chunked scan: only the first non-space byte matters
    p = -1
    for off in range(0, a.size, 1 << 16):
        chunk = a[off:off + (1 << 16)]
        hit = np.flatnonzero(~_SPACE[chunk])
        if hit.size:
            p = off + int(hit[0])
            break
    if p < 0:
        return C.IN_FORMAT_UNKNOWN, -1
    c = int(a[p])
    last = int(a[p - 1]) if p > 0 else _LF
    at_line_start = bool(_EOL[last]) if p > 0 else True
    if c == _GT and at_line_start:
        return C.IN_FORMAT_FASTA, p
    if c == _AT and at_line_start:
        return C.IN_FORMAT_FASTQ, p
    if c in (_GT, _AT):
        raise InputError(
            f"invalid input - first '{chr(c)}' is not at the beginning of the line"
        )
    raise InputError("input data is in unknown format - first non-space character is neither '>' nor '@'")


# ---------------------------------------------------------------------------
# FASTA
# ---------------------------------------------------------------------------

def parse_fasta(data: bytes, seq_type: int = C.SEQ_TYPE_DNA, *,
                strict: bool = False, well_formed: bool = False,
                marker_pos: Optional[int] = None,
                want_mask: bool = False) -> ParseResult:
    if marker_pos is None:
        fmt, marker_pos = detect_format(data)
        if fmt == C.IN_FORMAT_UNKNOWN:
            return ParseResult()
        if fmt != C.IN_FORMAT_FASTA:
            raise InputError("input format is different from format specified in the command line")

    b = np.frombuffer(data, dtype=np.uint8)[marker_pos + 1:]
    n = b.size
    res = ParseResult()

    if well_formed:
        is_eol = b == _LF
        id_break = _WF_SPACE[b]          # LF or space
    else:
        is_eol = _EOL[b]
        id_break = _SPACE[b]             # any space class ends the ID

    prev_is_eol = np.empty(n, dtype=bool)
    if n:
        prev_is_eol[0] = False           # byte before start is the marker '>'
        prev_is_eol[1:] = is_eol[:-1]
    rec_start = (b == _GT) & prev_is_eol

    starts = np.flatnonzero(rec_start)
    n_rec = starts.size + 1
    s = np.concatenate([[-1], starts]).astype(np.int64)

    rec_id = np.cumsum(rec_start, dtype=np.int32)   # inclusive; marker byte -> its record

    eol_pos = np.flatnonzero(is_eol)
    break_pos = np.flatnonzero(id_break)
    header_end = _first_at_or_after(eol_pos, s + 1, n)
    id_end = _first_at_or_after(break_pos, s + 1, n)

    id_mask = _intervals_to_mask(s + 1, id_end, n)
    has_comment = id_end < header_end
    com_mask = _intervals_to_mask((id_end + 1)[has_comment], header_end[has_comment], n)
    seq_end = np.concatenate([starts, [n]]).astype(np.int64)
    seq_mask = _intervals_to_mask(header_end + 1, seq_end, n)

    if well_formed:
        # no validation: every non-break byte is data
        id_keep = id_mask
        id_unex = np.zeros(n, dtype=bool)
        com_keep = com_mask
        com_unex = np.zeros(n, dtype=bool)
        seq_keep = seq_mask & ~is_eol
        seq_val = b
    else:
        unex_seq_tab = C.UNEXPECTED_BY_TYPE[seq_type][:256].copy()
        if seq_type == C.SEQ_TYPE_TEXT:
            unex_seq_tab[_GT] = True     # '>' breaks the scan... (ennaf.c:478)
        unex_text_b = _UNEX_TEXT[b]
        unex_com_b = _UNEX_COMMENT[b]
        unex_seq_b = unex_seq_tab[b]
        is_space = _SPACE[b]

        id_unex = id_mask & unex_text_b
        id_keep = id_mask & ~unex_text_b
        com_unex = com_mask & unex_com_b
        com_keep = com_mask                       # '?' replaces in place
        keep_gt = (b == _GT) if seq_type == C.SEQ_TYPE_TEXT else np.zeros(n, bool)
        seq_unex = seq_mask & ~is_space & unex_seq_b & ~keep_gt
        seq_keep = seq_mask & ~is_space
        repl = np.uint8(C.REPLACEMENT_SEQ[seq_type])
        seq_val = np.where(seq_unex, repl, b)

        if strict:
            cand = np.flatnonzero(id_unex | com_unex | seq_unex)
            if cand.size:
                p = int(cand[0])
                kind = "id" if id_unex[p] else ("comment" if com_unex[p] else "seq")
                _strict_fail(kind, int(b[p]), int(rec_id[p]) + 1, C.SEQ_TYPE_NAMES[seq_type])

        res.unexpected_id = _hist257(b[id_unex])
        res.unexpected_comment = _hist257(b[com_unex])
        res.unexpected_seq = _hist257(b[seq_unex])

    # blobs
    res.ids_blob = _blob_with_terminators(b, id_keep, rec_id, n_rec)
    if well_formed:
        com_vals = b
    else:
        com_vals = np.where(com_unex, np.uint8(C.REPLACEMENT_NAME), b)
    res.comments_blob = _blob_with_terminators(com_vals, com_keep, rec_id, n_rec)

    # sequence stream: kept seq bytes plus the id-quirk '?' bytes, in order
    stream_keep = seq_keep | id_unex
    stream_val = seq_val if not well_formed else b
    if not well_formed and id_unex.any():
        stream_val = np.where(id_unex, np.uint8(C.REPLACEMENT_NAME), stream_val)
    res.seq = stream_val[stream_keep].astype(np.uint8)

    res.lengths = np.bincount(rec_id[seq_keep], minlength=n_rec).astype(np.uint64)
    res.n_sequences = n_rec

    line_id = np.cumsum(is_eol, dtype=np.int32)
    if seq_keep.any():
        line_counts = np.bincount(line_id[seq_keep])
        res.longest_line = int(line_counts.max())
    return res


# ---------------------------------------------------------------------------
# FASTQ
# ---------------------------------------------------------------------------

def parse_fastq(data: bytes, seq_type: int = C.SEQ_TYPE_DNA, *,
                strict: bool = False, well_formed: bool = False,
                marker_pos: Optional[int] = None,
                want_mask: bool = False) -> ParseResult:
    if marker_pos is None:
        fmt, marker_pos = detect_format(data)
        if fmt == C.IN_FORMAT_UNKNOWN:
            return ParseResult()
        if fmt != C.IN_FORMAT_FASTQ:
            raise InputError("input format is different from format specified in the command line")

    b = np.frombuffer(data, dtype=np.uint8)[marker_pos + 1:]
    if well_formed:
        return _parse_fastq_lines(b, seq_type, strict=False, well_formed=True)
    return _parse_fastq_lines(b, seq_type, strict=strict, well_formed=False)


def _parse_fastq_lines(b: np.ndarray, seq_type: int, *, strict: bool,
                       well_formed: bool) -> ParseResult:
    """Line-structured FASTQ parse.

    Raw lines are split at every EOL byte.  Record structure (parity with
    process.c:477-544): header line; the *immediately following* raw line is
    the sequence (may be empty); then empty lines are skipped to the '+'
    line; empty lines skipped to the quality line whose first byte is taken
    verbatim; empty lines skipped to the next '@' header.

    Well-formed mode (process.c:430-474) is stricter: only LF terminates
    lines, the '+' and '@' must follow immediately, nothing is dropped.
    """
    n = b.size
    res = ParseResult()

    is_eol = (b == _LF) if well_formed else _EOL[b]
    eol_pos = np.flatnonzero(is_eol)
    # raw line i spans [line_start[i], line_end[i]) ; last line may lack EOL
    line_start = np.concatenate([[0], eol_pos + 1]).astype(np.int64)
    line_end = np.concatenate([eol_pos, [n]]).astype(np.int64)
    if line_start[-1] >= n and line_start.size > 1:
        line_start = line_start[:-1]
        line_end = line_end[:-1]
    n_lines = line_start.size
    line_len = line_end - line_start

    nonempty = np.flatnonzero(line_len > 0)

    def next_nonempty(i: int) -> int:
        j = np.searchsorted(nonempty, i, side="left")
        return int(nonempty[j]) if j < nonempty.size else -1

    # --- structural scan: assign roles to lines -----------------------------
    # Errors are *deferred* with their byte position: the reference parser is
    # sequential, so e.g. a length mismatch in record k fires before the scan
    # would notice record k+1's structural problem.  We collect candidates and
    # raise the earliest one after the vectorized checks run.
    header_lines: list[int] = []
    seq_lines: list[int] = []
    plus_lines: list[int] = []
    qual_lines: list[int] = []
    err_candidates: list[tuple[int, str]] = []

    # fast path: perfectly regular 4-line records (LF-only, no empty lines)
    regular = (
        n_lines % 4 == 0
        and n_lines > 0
        and bool((line_len > 0).all())
        and bool((b[line_start[2::4]] == ord("+")).all())
        # well-formed mode requires the '+' line to be exactly "+"
        # (process.c:448-456: next char after '+' must be '\n')
        and (not well_formed or bool((line_len[2::4] == 1).all()))
        and bool((b[line_start[4::4]] == _AT).all() if n_lines > 4 else True)
        and bool(is_eol[-1]) if n else False
    )
    if regular:
        header_lines = list(range(0, n_lines, 4))
        seq_lines = list(range(1, n_lines, 4))
        plus_lines = list(range(2, n_lines, 4))
        qual_lines = list(range(3, n_lines, 4))
    else:
        li = 0  # current header line (first line: after the consumed '@')
        rec = 0
        while True:
            header_lines.append(li)
            rec += 1
            # sequence line is the immediately-following raw line
            sq = li + 1
            if sq >= n_lines:
                err_candidates.append((n, "truncated FASTQ input: last sequence has no sequence data")
                                      if line_end[li] >= n else
                                      (n, "truncated FASTQ input: last sequence has no quality"))
                break
            seq_lines.append(sq)
            if well_formed:
                pl_ = sq + 1
                if pl_ >= n_lines:
                    err_candidates.append((n, "truncated FASTQ input: last sequence has no quality"))
                    break
                if line_len[pl_] < 1 or b[line_start[pl_]] != ord("+"):
                    if line_len[pl_] == 0 and line_end[pl_] >= n:
                        err_candidates.append((n, "truncated FASTQ input: last sequence has no quality"))
                    else:
                        err_candidates.append((int(line_start[pl_]), "not well-formed FASTQ input"))
                    break
                if line_len[pl_] != 1 or line_end[pl_] >= n:
                    err_candidates.append((int(line_start[pl_]) + 1, "not well-formed FASTQ input"))
                    break
                plus_lines.append(pl_)
                ql = pl_ + 1
                if ql >= n_lines:
                    err_candidates.append((n, "truncated FASTQ input: last sequence has no quality"))
                    break
                qual_lines.append(ql)
                nxt = ql + 1
                if nxt >= n_lines:
                    break
                if line_len[nxt] == 0 or b[line_start[nxt]] != _AT:
                    err_candidates.append((int(line_start[nxt]), "not well-formed FASTQ input"))
                    break
                li = nxt
                continue
            # robust mode: skip empty lines between components
            pl_ = next_nonempty(sq + 1)
            if pl_ < 0:
                err_candidates.append((n, "truncated FASTQ input: last sequence has no quality"))
                break
            if b[line_start[pl_]] != ord("+"):
                err_candidates.append((int(line_start[pl_]),
                                       f"invalid FASTQ input: can't find '+' line of sequence {rec}"))
                break
            plus_lines.append(pl_)
            ql = next_nonempty(pl_ + 1)
            if ql < 0:
                err_candidates.append((n, "truncated FASTQ input: last sequence has no quality"))
                break
            qual_lines.append(ql)
            nxt = next_nonempty(ql + 1)
            if nxt < 0:
                break
            if b[line_start[nxt]] != _AT:
                err_candidates.append((int(line_start[nxt]),
                                       f"invalid FASTQ input: Can't find '@' after sequence {rec}"))
                break
            li = nxt

    n_rec = len(header_lines)
    res.n_sequences = n_rec

    hl = np.asarray(header_lines, dtype=np.int64)
    sl = np.asarray(seq_lines, dtype=np.int64)
    ql_arr = np.asarray(qual_lines, dtype=np.int64)

    # header byte ranges: record 0 starts right at b[0] (marker consumed);
    # others start one past the '@'
    h_start = line_start[hl].copy()
    h_start[1:] += 1
    h_end = line_end[hl]

    # --- header: id / comment ----------------------------------------------
    id_break_tab = _WF_SPACE if well_formed else _SPACE
    id_break = id_break_tab[b]
    break_pos = np.flatnonzero(id_break)
    id_end = np.minimum(_first_at_or_after(break_pos, h_start, n), h_end)
    id_mask = _intervals_to_mask(h_start, id_end, n)
    # comment present iff the id delimiter is a space that is not an EOL
    delim_ok = (id_end < h_end)
    com_mask = _intervals_to_mask((id_end + 1)[delim_ok], h_end[delim_ok], n)

    # record id per byte for header/seq/qual grouping
    rec_of_line = np.zeros(n_lines, dtype=np.int64)
    rec_of_line[hl] = np.arange(n_rec)
    # bytes' line index:
    byte_line = np.searchsorted(eol_pos, np.arange(n), side="left")

    seq_line_mask = np.zeros(n_lines, dtype=bool)
    seq_line_mask[sl] = True
    qual_line_mask = np.zeros(n_lines, dtype=bool)
    qual_line_mask[ql_arr] = True
    rec_of_seq_line = np.zeros(n_lines, dtype=np.int64)
    rec_of_seq_line[sl] = np.arange(sl.size)
    rec_of_qual_line = np.zeros(n_lines, dtype=np.int64)
    rec_of_qual_line[ql_arr] = np.arange(ql_arr.size)

    in_line = np.zeros(n, dtype=bool)
    bl_clip = np.minimum(byte_line, n_lines - 1) if n_lines else byte_line
    if n:
        in_line = ~is_eol
    seq_byte = in_line & seq_line_mask[bl_clip] if n else np.zeros(0, bool)
    qual_byte = in_line & qual_line_mask[bl_clip] if n else np.zeros(0, bool)

    rec_id_hdr = rec_of_line[bl_clip] if n else np.zeros(0, np.int64)
    rec_id_seq = rec_of_seq_line[bl_clip] if n else np.zeros(0, np.int64)
    rec_id_qual = rec_of_qual_line[bl_clip] if n else np.zeros(0, np.int64)

    if well_formed:
        id_keep = id_mask
        id_unex = np.zeros(n, dtype=bool)
        com_keep = com_mask
        com_unex = np.zeros(n, dtype=bool)
        seq_keep = seq_byte
        seq_val = b
        qual_keep = qual_byte
        qual_val = b
    else:
        unex_seq_tab = C.UNEXPECTED_BY_TYPE[seq_type][:256]
        unex_text_b = _UNEX_TEXT[b]
        unex_com_b = _UNEX_COMMENT[b]
        unex_seq_b = unex_seq_tab[b]
        unex_qual_b = _UNEX_QUAL[b]
        is_space = _SPACE[b]

        id_unex = id_mask & unex_text_b
        id_keep = id_mask & ~unex_text_b
        com_unex = com_mask & unex_com_b
        com_keep = com_mask
        seq_unex = seq_byte & ~is_space & unex_seq_b
        seq_keep = seq_byte & ~is_space
        seq_val = np.where(seq_unex, np.uint8(C.REPLACEMENT_SEQ[seq_type]), b)

        # quality: first byte of each qual line is taken verbatim
        qual_first = np.zeros(n, dtype=bool)
        if ql_arr.size:
            qf = line_start[ql_arr]
            qf_valid = qf < np.minimum(line_end[ql_arr], n)
            qual_first[qf[qf_valid]] = True
        qual_rest = qual_byte & ~qual_first
        qual_unex = qual_rest & ~is_space & unex_qual_b
        qual_keep = (qual_rest & ~is_space) | qual_first
        qual_val = np.where(qual_unex, np.uint8(C.REPLACEMENT_QUAL), b)

        if strict:
            cand = np.flatnonzero(id_unex | com_unex | seq_unex | qual_unex)
            if cand.size:
                p = int(cand[0])
                if id_unex[p]:
                    kind, rid = "id", rec_id_hdr[p]
                elif com_unex[p]:
                    kind, rid = "comment", rec_id_hdr[p]
                elif seq_unex[p]:
                    kind, rid = "seq", rec_id_seq[p]
                else:
                    kind, rid = "qual", rec_id_qual[p]
                try:
                    _strict_fail(kind, int(b[p]), int(rid) + 1, C.SEQ_TYPE_NAMES[seq_type])
                except InputError as e:
                    err_candidates.insert(0, (p, str(e)))

        res.unexpected_id = _hist257(b[id_unex])
        res.unexpected_comment = _hist257(b[com_unex])
        res.unexpected_seq = _hist257(b[seq_unex])
        res.unexpected_qual = _hist257(b[qual_unex])

    res.ids_blob = _blob_with_terminators(b, id_keep, rec_id_hdr, n_rec)
    com_vals = b if well_formed else np.where(com_unex, np.uint8(C.REPLACEMENT_NAME), b)
    res.comments_blob = _blob_with_terminators(com_vals, com_keep, rec_id_hdr, n_rec)

    # seq stream with the id-quirk bytes interleaved in input order
    stream_keep = seq_keep | id_unex
    stream_val = seq_val if not well_formed else b
    if not well_formed and id_unex.any():
        stream_val = np.where(id_unex, np.uint8(C.REPLACEMENT_NAME), stream_val)
    res.seq = stream_val[stream_keep].astype(np.uint8)
    res.qual = qual_val[qual_keep].astype(np.uint8)

    read_lengths = np.bincount(rec_id_seq[seq_keep], minlength=n_rec).astype(np.uint64)
    qual_lengths = np.bincount(rec_id_qual[qual_keep], minlength=n_rec).astype(np.uint64)
    # length mismatches only exist for records whose quality line was reached;
    # the reference detects them right after parsing that quality line
    n_q = ql_arr.size
    bad = np.flatnonzero(read_lengths[:n_q] != qual_lengths[:n_q])
    if bad.size:
        k = int(bad[0])
        pos = int(line_end[ql_arr[k]])
        if well_formed:
            msg = f"quality length of sequence {k + 1} doesn't match sequence length"
        else:
            msg = (f"quality length of sequence {k + 1} ({qual_lengths[k]}) "
                   f"doesn't match sequence length ({read_lengths[k]})")
        err_candidates.append((pos, msg))

    if err_candidates:
        pos, msg = min(err_candidates, key=lambda t: t[0])
        raise InputError(msg)

    res.lengths = read_lengths
    res.longest_line = int(read_lengths.max()) if n_rec else 0
    return res
