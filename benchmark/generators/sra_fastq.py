"""Sequencing reads in FASTQ as ``fastq-dump`` writes an SRA run by default:
``@<run>.<spot> <instrument>:<tile>:<x>:<y> length=<L>``, the ``+`` line
repeating the defline, then the qualities.

Parameters (the ``data`` object of a configuration):

- ``spots``, ``read_length``: the number of reads and their one length;
- ``run``, ``instrument``: the accession and the instrument, run id,
  flowcell and lane of the deflines;
- ``tile``, ``xy``: the ranges [lo, hi) the tile and the x and y
  coordinates are drawn from (they vary in digit count, so the deflines
  are ragged);
- ``bases``, ``base_p``: the base alphabet and each letter's share;
- ``quality``, ``quality_p``: the quality alphabet (NovaSeq's four bins)
  and each value's share;
- ``plus_repeats_defline``: whether the ``+`` line repeats the defline.
"""

from __future__ import annotations

import numpy as np

from benchmark.textgen import Dataset, rng_of, rows


def _draw(rng: np.random.Generator, alphabet: str, p: list, shape) -> np.ndarray:
    """Letters of ``alphabet`` with shares ``p``, by a table of 2,000
    entries (each share a multiple of 1/2,000)."""
    counts = np.rint(np.asarray(p) * 2000).astype(np.int64)
    if counts.sum() != 2000:
        raise ValueError(f"shares {p} are not multiples of 1/2000 summing to 1")
    table = np.repeat(np.frombuffer(alphabet.encode(), np.uint8), counts)
    return table[rng.integers(0, 2000, shape, dtype=np.int16)]


def generate(p: dict, seed: int) -> Dataset:
    n, L = int(p["spots"]), int(p["read_length"])
    seq = _draw(rng_of(seed, 0), p["bases"], p["base_p"], (n, L))
    qual = _draw(rng_of(seed, 1), p["quality"], p["quality_p"], (n, L))
    rng = rng_of(seed, 2)
    tile = rng.integers(*p["tile"], n)
    x, y = rng.integers(*p["xy"], (2, n))
    spot = np.arange(1, n + 1)
    run, inst = p["run"].encode(), p["instrument"].encode()
    ident = [run + b".", spot]
    comment = [inst + b":", tile, b":", x, b":", y, b" length=%d" % L]
    defline = ident + [b" "] + comment
    plus = [b"\n+"] + (defline if p["plus_repeats_defline"] else []) + [b"\n"]
    text = rows(n, [b"@"] + defline + [b"\n", seq] + plus + [qual, b"\n"])
    return Dataset(fmt="fastq", text=text, ids_blob=rows(n, ident + [b"\0"]),
                   comments_blob=rows(n, comment + [b"\0"]), seq=seq.reshape(-1),
                   lengths=np.full(n, L, np.uint64), qual=qual.reshape(-1), longest_line=L)
