"""Output rendering: line wrapping for decode (host numpy).

The reference streams bytes through small buffers with per-record state
(unnaf/src/output.c:339-430).  Here rendering is a single vectorized
scatter/gather over the whole output buffer: for every output byte position
we compute whether it is a newline or which sequence byte it copies.

A frozen copy of ``naf_tpu_torch/ops/render.py``, for the benchmark's reference.
"""

from __future__ import annotations

import numpy as np


def body_length(seq_len: np.ndarray, line_len: int) -> np.ndarray:
    """Output body size per record: seq plus newlines (incl. final one).

    line_len == 0 means no wrapping (raw + final newline).  Empty sequences
    produce empty bodies (header-only records print no blank line).
    """
    seq_len = np.asarray(seq_len, dtype=np.int64)
    if line_len <= 0:
        return np.where(seq_len > 0, seq_len + 1, 0)
    n_lines = -(-seq_len // line_len)  # ceil
    return np.where(seq_len > 0, seq_len + n_lines, 0)


def wrap_records_np(seq: np.ndarray, seq_lens: np.ndarray, line_len: int) -> np.ndarray:
    """Concatenated seq bytes + per-record lengths -> wrapped body stream.

    Returns the concatenation over records of: record bytes with '\n'
    inserted after every `line_len` chars, plus a final '\n' per non-empty
    record.  (Headers are interleaved separately by the decoder.)
    """
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    seq_lens = np.asarray(seq_lens, dtype=np.int64)
    body_lens = body_length(seq_lens, line_len)
    total_out = int(body_lens.sum())
    if total_out == 0:
        return np.zeros(0, dtype=np.uint8)

    nonzero = seq_lens > 0
    blens = body_lens[nonzero]
    slens = seq_lens[nonzero]
    out_base = np.concatenate([[0], np.cumsum(blens)[:-1]])
    seq_base = np.concatenate([[0], np.cumsum(seq_lens)[:-1]])[nonzero]

    rec = np.repeat(np.arange(blens.size), blens)     # record per out byte
    off = np.arange(total_out, dtype=np.int64) - out_base[rec]

    if line_len > 0:
        is_nl = ((off + 1) % (line_len + 1) == 0) | (off == blens[rec] - 1)
        src = off - off // (line_len + 1)
    else:
        is_nl = off == blens[rec] - 1
        src = off
    out = np.empty(total_out, dtype=np.uint8)
    out[is_nl] = ord("\n")
    take = ~is_nl
    out[take] = seq[(seq_base[rec] + src)[take]]
    return out
