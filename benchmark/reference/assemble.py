"""Vectorized ragged record assembly.

Builds large outputs (FASTA/FASTQ text) as a single numpy scatter instead of
per-record Python string concatenation: each output record is the
concatenation of several "columns" (header marker, id, separator, comment,
newline, body, ...), where every column contributes a per-record slice of
some source buffer (possibly empty, possibly a broadcast constant).

A frozen copy of ``naf_tpu_torch/ops/assemble.py``, for the benchmark's reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Column:
    """Per-record slices src[start[k] : start[k]+length[k]]."""
    src: np.ndarray          # uint8 source buffer
    start: np.ndarray        # int64[n_records]
    length: np.ndarray       # int64[n_records]


def const_column(byte_seq: bytes, n_records: int,
                 present: np.ndarray | None = None) -> Column:
    """A constant byte string per record (optionally masked by `present`)."""
    src = np.frombuffer(byte_seq, dtype=np.uint8)
    ln = np.full(n_records, len(byte_seq), dtype=np.int64)
    if present is not None:
        ln = np.where(present, ln, 0)
    return Column(src=src, start=np.zeros(n_records, dtype=np.int64), length=ln)


def ragged_ranges(offsets: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Indices [offsets[k] .. offsets[k]+lengths[k]) concatenated over k."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    reps = np.repeat(offsets, lengths)
    base = np.repeat(np.concatenate([[0], np.cumsum(lengths)[:-1]]), lengths)
    return reps + (np.arange(total, dtype=np.int64) - base)


def ragged_concat(columns: list[Column], n_records: int) -> np.ndarray:
    """Concatenate per-record slices across columns into one uint8 buffer."""
    if n_records == 0:
        return np.zeros(0, dtype=np.uint8)
    col_lens = np.stack([c.length for c in columns], axis=1)  # (R, C)
    rec_lens = col_lens.sum(axis=1)
    total = int(rec_lens.sum())
    out = np.empty(total, dtype=np.uint8)
    rec_off = np.concatenate([[0], np.cumsum(rec_lens)[:-1]])
    col_off = np.concatenate(
        [np.zeros((n_records, 1), dtype=np.int64), np.cumsum(col_lens, axis=1)[:, :-1]],
        axis=1,
    )
    for ci, col in enumerate(columns):
        dst = ragged_ranges(rec_off + col_off[:, ci], col.length)
        src = ragged_ranges(col.start, col.length)
        out[dst] = col.src[src]
    return out


def split_blob(blob: bytes, n_records: int, what: str = "ids") -> Column:
    """'\0'-separated blob -> Column of the items (terminators excluded)."""
    arr = np.frombuffer(blob, dtype=np.uint8)
    if n_records == 0:
        return Column(arr, np.zeros(0, np.int64), np.zeros(0, np.int64))
    if arr.size == 0 or arr[-1] != 0:
        raise ValueError(f"corrupted {what} - not 0-terminated")
    zeros = np.flatnonzero(arr == 0)
    if zeros.size < n_records:
        raise ValueError(f"corrupted {what} - can't read {what[:-1]} {zeros.size}")
    ends = zeros[:n_records]
    starts = np.concatenate([[0], ends[:-1] + 1])
    return Column(arr, starts.astype(np.int64), (ends - starts).astype(np.int64))
