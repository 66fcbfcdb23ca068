"""Nanopore reads in FASTQ as ``fastq-dump`` writes an SRA run by default:
``@<run>.<spot> <read uuid> length=<L>``, the ``+`` line repeating the
defline, then unbinned Phred+33 qualities.  Reads vary in length, so a
read's sequence and quality lines may run over many 32 KiB tiles.

Parameters (the ``data`` object of a configuration):

- ``reads``: the number of reads;
- ``read_length``: a lognormal law of the read lengths (``median``,
  ``sigma``), clipped to [``min``, ``max``];
- ``bases``: the base alphabet, each letter drawn with the same share;
- ``quality``: each read's mean Phred, drawn from a normal law
  (``read_mean``: ``mean``, ``sd``, clipped to [``min``, ``max``]) and
  rounded; each base's Phred from a normal law about that mean
  (``base_sd``), rounded and clipped to [``min``, ``max``], written plus
  ``offset``;
- ``run``: the accession of the deflines;
- ``plus_repeats_defline``: whether the ``+`` line repeats the defline.

Each integer read mean has one table of 2,000 Phred values, whose shares
are those of the rounded, clipped normal law to 1/2,000, so a base's
quality is one table look-up.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.textgen import LF, Dataset, digits, rng_of, rows

TABLE = 2000
HEX = np.frombuffer(b"0123456789abcdef", np.uint8)


def _phi(x: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0)))


def _quality_tables(q: dict) -> tuple[int, np.ndarray]:
    """The smallest read mean and the tables, u8 [means, TABLE] of Phred
    values: row m holds each value v in [min, max] about
    TABLE * P(round(N(lo + m, base_sd)) clipped = v) times."""
    lo, hi = int(q["read_mean"]["min"]), int(q["read_mean"]["max"])
    vmin, vmax, sd = int(q["min"]), int(q["max"]), float(q["base_sd"])
    values = np.arange(vmin, vmax + 1)
    edges = np.concatenate([[-np.inf], values[1:] - 0.5, [np.inf]])
    tables = []
    for mean in range(lo, hi + 1):
        cdf = _phi((edges - mean) / sd)
        counts = _largest_remainder(np.diff(cdf) * TABLE)
        tables.append(np.repeat(values, counts).astype(np.uint8))
    return lo, np.stack(tables)


def _largest_remainder(shares: np.ndarray) -> np.ndarray:
    """Whole counts summing to TABLE, each within 1 of its share."""
    counts = np.floor(shares).astype(np.int64)
    short = TABLE - int(counts.sum())
    counts[np.argsort(counts - shares)[:short]] += 1
    return counts


def _uuids(rng: np.random.Generator, n: int) -> np.ndarray:
    """Version-4 UUIDs as a u8 matrix [n, 36] of lower-case hex and dashes."""
    nib = rng.integers(0, 16, (n, 32), dtype=np.uint8)
    nib[:, 12] = 4
    nib[:, 16] = 8 | (nib[:, 16] & 3)
    out = np.full((n, 36), ord("-"), np.uint8)
    keep = np.ones(36, bool)
    keep[[8, 13, 18, 23]] = False
    out[:, keep] = HEX[nib]
    return out


def _place(out: np.ndarray, starts: np.ndarray, lens: np.ndarray, flat: np.ndarray) -> None:
    """Write the consecutive pieces of ``flat`` (lengths ``lens``) at
    ``starts`` in ``out``."""
    index = np.int32 if out.size < 2**31 else np.int64
    src = np.concatenate([[0], np.cumsum(lens)[:-1]])
    pos = np.repeat((starts - src).astype(index), lens)
    pos += np.arange(flat.size, dtype=index)
    out[pos] = flat


def generate(p: dict, seed: int) -> Dataset:
    n = int(p["reads"])
    rl = p["read_length"]
    lengths = np.exp(rng_of(seed, 0).normal(math.log(rl["median"]), rl["sigma"], n))
    lengths = np.clip(np.rint(lengths), rl["min"], rl["max"]).astype(np.int64)
    total = int(lengths.sum())

    alphabet = np.frombuffer(p["bases"].encode(), np.uint8)
    seq = alphabet[rng_of(seed, 1).integers(0, alphabet.size, total, dtype=np.uint8)]

    q = p["quality"]
    rm = q["read_mean"]
    lo, tables = _quality_tables(q)
    means = np.clip(np.rint(rng_of(seed, 2).normal(rm["mean"], rm["sd"], n)),
                    rm["min"], rm["max"]).astype(np.int64)
    pick = rng_of(seed, 3).integers(0, TABLE, total, dtype=np.int32)
    pick += np.repeat(((means - lo) * TABLE).astype(np.int32), lengths)
    qual = tables.reshape(-1)[pick] + np.uint8(q["offset"])
    del pick

    uuid = _uuids(rng_of(seed, 4), n)
    spot = np.arange(1, n + 1)
    ident = [p["run"].encode() + b".", spot]
    comment = [uuid, b" length=", lengths]
    defline = ident + [b" "] + comment
    repeat = bool(p["plus_repeats_defline"])
    head = rows(n, [b"@"] + defline + [b"\n"])
    plus = rows(n, [b"\n+"] + (defline if repeat else []) + [b"\n"])
    dlen = (len(ident[0]) + 1 + uuid.shape[1] + len(comment[1])
            + digits(spot)[1].sum(1) + digits(lengths)[1].sum(1))
    hlen = dlen + 2
    plen = 3 + (dlen if repeat else 0)

    rec = hlen + plen + 2 * lengths + 1
    start = np.concatenate([[0], np.cumsum(rec)[:-1]])
    text = np.empty(int(rec.sum()), np.uint8)
    _place(text, start, hlen, np.frombuffer(head, np.uint8))
    _place(text, start + hlen, lengths, seq)
    _place(text, start + hlen + lengths, plen, np.frombuffer(plus, np.uint8))
    _place(text, start + hlen + lengths + plen, lengths, qual)
    text[start + rec - 1] = LF
    return Dataset(fmt="fastq", text=text.tobytes(), ids_blob=rows(n, ident + [b"\0"]),
                   comments_blob=rows(n, comment + [b"\0"]), seq=seq,
                   lengths=lengths.astype(np.uint64), qual=qual,
                   longest_line=int(lengths.max()))
