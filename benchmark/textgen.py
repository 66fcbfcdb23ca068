"""Vectorised text making for the generators: the records of a data set and
the file that holds them, written without a Python loop per record.

A ``Dataset`` is what a generator returns: the file's bytes as users hold
it (``text``) and the same records as arrays (``ids_blob``,
``comments_blob``, ``seq``, ``lengths``, ``qual``, ``longest_line``), which
the reference turns into an archive and a rendered text of its own
(``reference/records.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

LF = 10


@dataclass
class Dataset:
    fmt: str                         # "fasta" or "fastq"
    text: bytes                      # the file, as users hold it
    ids_blob: bytes                  # each record's id, NUL-terminated
    comments_blob: bytes             # each record's comment, NUL-terminated
    seq: np.ndarray                  # every record's sequence chars, u8, in order
    lengths: np.ndarray              # u64 per record
    qual: Optional[np.ndarray]       # FASTQ: the quality chars, u8, as seq
    longest_line: int                # the longest sequence line


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """The generator of one independent stream of a run's seed (any whole
    number, negative ones too)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def digits(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Decimal digits of non-negative integers as a right-aligned matrix
    [n, w] of ASCII bytes, and the mask of the digits that are written (no
    leading zeros; 0 writes one digit)."""
    v = np.asarray(values, np.int64)
    w = len(str(int(v.max()))) if v.size else 1
    powers = 10 ** np.arange(w - 1, -1, -1, dtype=np.int64)
    mat = (v[:, None] // powers % 10 + 48).astype(np.uint8)
    ndig = 1 + (v[:, None] >= 10 ** np.arange(1, w, dtype=np.int64)).sum(1)
    keep = np.arange(w)[None, :] >= (w - ndig)[:, None]
    return mat, keep


def rows(n: int, pieces: list) -> bytes:
    """Row i of the result is the concatenation of each piece's row i, and
    the rows follow each other.  A piece is ``bytes`` (the same in every
    row), an integer array (written in decimal) or a u8 matrix [n, w] (every
    byte written)."""
    mats, keeps = [], []
    for p in pieces:
        if isinstance(p, (bytes, bytearray)):
            a = np.frombuffer(bytes(p), np.uint8)
            mats.append(np.broadcast_to(a, (n, a.size)))
            keeps.append(np.ones((n, a.size), bool))
        elif p.ndim == 1:
            m, k = digits(p)
            mats.append(m)
            keeps.append(k)
        else:
            mats.append(p)
            keeps.append(np.ones(p.shape, bool))
    return np.concatenate(mats, axis=1)[np.concatenate(keeps, axis=1)].tobytes()


def wrap(seq: np.ndarray, width: int) -> np.ndarray:
    """One record's sequence in lines of ``width`` chars, each ended by LF."""
    full, rest = divmod(seq.size, width)
    out = np.empty(full * (width + 1) + (rest + 1 if rest else 0), np.uint8)
    body = out[:full * (width + 1)].reshape(full, width + 1)
    body[:, :width] = seq[:full * width].reshape(full, width)
    body[:, width] = LF
    if rest:
        out[full * (width + 1):-1] = seq[full * width:]
        out[-1] = LF
    return out
