"""Archives and rendered text made from records, not from a parse.

A generator knows the records it wrote: each id, comment, sequence and
quality.  ``archive`` builds the NAF archive of those records with the
reference encoder's ``build_archive``, and ``render`` writes the text that
``unnaf`` writes for them: FASTA with the archive's line length, FASTQ with
a bare ``+`` line (unnaf.c:443).  Neither reads the file the generator
wrote, so each checks the program's parse of it.
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .assemble import Column, const_column, ragged_concat, split_blob
from .encoder import EncodeOptions, EncodeStats, build_archive
from .parser import ParseResult
from .render import body_length, wrap_records_np


def archive(recs, opts: EncodeOptions) -> bytes:
    """The archive of ``recs`` (``fmt``, ``ids_blob``, ``comments_blob``,
    ``seq``, ``lengths``, ``qual``, ``longest_line``, as the generators'
    ``Dataset`` has them), as ``encode`` gives it for their file."""
    fastq = recs.fmt == "fastq"
    res = ParseResult()
    res.n_sequences = int(recs.lengths.size)
    res.ids_blob = recs.ids_blob
    res.comments_blob = recs.comments_blob
    res.seq = recs.seq
    res.lengths = np.asarray(recs.lengths, np.uint64)
    res.longest_line = recs.longest_line
    if fastq:
        res.qual = recs.qual
    stats = EncodeStats(n_sequences=res.n_sequences, longest_line=recs.longest_line,
                        seq_size_original=int(recs.seq.size),
                        in_format=C.IN_FORMAT_FASTQ if fastq else C.IN_FORMAT_FASTA)
    return build_archive(res, opts, stats)[0]


def render(recs) -> bytes:
    """The text unnaf writes for ``recs``: FASTQ, or FASTA in lines of the
    longest line (the archive's line length) with the case as stored."""
    fastq, seq, qual = recs.fmt == "fastq", recs.seq, recs.qual
    n = int(recs.lengths.size)
    ids = split_blob(recs.ids_blob, n)
    com = split_blob(recs.comments_blob, n, "names")
    names = [ids, const_column(b" ", n, present=com.length > 0), com]
    slens = np.asarray(recs.lengths, np.int64)
    starts = np.concatenate([[0], np.cumsum(slens)[:-1]])
    if fastq:
        cols = ([const_column(b"@", n)] + names + [const_column(b"\n", n)]
                + [Column(seq, starts, slens), const_column(b"\n+\n", n),
                   Column(qual, starts, slens), const_column(b"\n", n)])
    else:
        blens = body_length(slens, recs.longest_line)
        bodies = wrap_records_np(seq, slens, recs.longest_line)
        cols = ([const_column(b">", n)] + names + [const_column(b"\n", n)]
                + [Column(bodies, np.concatenate([[0], np.cumsum(blens)[:-1]]), blens)])
    return ragged_concat(cols, n).tobytes()
