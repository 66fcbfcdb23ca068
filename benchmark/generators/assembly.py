"""A genome assembly in FASTA: a few long records, soft-masked repeats, N
gaps, lines of a fixed width.

Parameters (the ``data`` object of a configuration):

- ``records``: ``[{"id", "comment", "length"}]``, one FASTA record each;
- ``line_width``: bases a line;
- ``bases``: uniform ACGT, in units of ``copy_unit`` bases of which a share
  ``copy_share`` are copies of an earlier unit with a share
  ``copy_divergence`` of their bases redrawn (segmental duplications);
- ``soft_mask``: lower-case runs alternating with upper-case ones, each
  length drawn lognormal (``median``, ``sigma``), starting upper-case;
- ``gaps``: runs of upper-case N: ``ends`` bases at both ends of a record,
  one ``large`` gap of ``size`` at the fraction ``at`` of the record, and
  the ``sizes`` listed at places drawn from the seed.  The sizes are fixed,
  so every seed has the same number of N.
"""

from __future__ import annotations

import numpy as np

from benchmark.textgen import Dataset, rng_of, wrap

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _bases(rng: np.random.Generator, n: int, p: dict) -> np.ndarray:
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    unit = int(p["copy_unit"])
    for u in range(1, -(-n // unit)):
        if rng.random() >= p["copy_share"]:
            continue
        src = int(rng.integers(0, u))
        dst = codes[u * unit:(u + 1) * unit]
        dst[:] = codes[src * unit:src * unit + dst.size]
        flips = rng.integers(0, dst.size, rng.binomial(dst.size, p["copy_divergence"]))
        dst[flips] = rng.integers(0, 4, flips.size, dtype=np.uint8)
    return ACGT[codes]


def _mask(rng: np.random.Generator, n: int, p: dict) -> np.ndarray:
    """0 or 32 per base: the case bit of alternating upper and lower runs."""
    m, u = p["masked_run"], p["unmasked_run"]
    runs = np.zeros(0, np.int64)
    while runs.sum() < n:
        k = max(16, int(n / (m["median"] + u["median"])))
        pair = np.empty(2 * k, np.int64)
        pair[0::2] = np.ceil(rng.lognormal(np.log(u["median"]), u["sigma"], k))
        pair[1::2] = np.ceil(rng.lognormal(np.log(m["median"]), m["sigma"], k))
        runs = np.concatenate([runs, pair])
    case = np.tile(np.array([0, 32], np.uint8), runs.size // 2)
    return np.repeat(case, runs)[:n]


def _gaps(rng: np.random.Generator, n: int, p: dict) -> list[tuple[int, int]]:
    """(start, size) of each N run, in order, none overlapping."""
    ends, large = int(p["ends"]), p["large"]
    small = rng.permutation(np.asarray(p["sizes"], np.int64))
    free = n - 2 * ends - int(large["size"]) - int(small.sum())
    if free < 0:
        raise ValueError("the gaps are longer than the record")
    cuts = [(0, ends), (free, ends), (int(large["at"] * free), int(large["size"]))]
    cuts += zip(np.sort(rng.integers(0, free + 1, small.size)).tolist(), small.tolist())
    out, before = [], 0
    for at, size in sorted(cuts, key=lambda c: c[0]):
        out.append((at + before, size))
        before += size
    return out


def generate(p: dict, seed: int) -> Dataset:
    text, seqs, ids, coms = [], [], [], []
    width = int(p["line_width"])
    for i, rec in enumerate(p["records"]):
        n = int(rec["length"])
        seq = _bases(rng_of(seed, 4 * i), n, p["bases"])
        seq |= _mask(rng_of(seed, 4 * i + 1), n, p["soft_mask"])
        for start, size in _gaps(rng_of(seed, 4 * i + 2), n, p["gaps"]):
            seq[start:start + size] = ord("N")
        name = rec["id"].encode()
        com = rec.get("comment", "").encode()
        text += [b">" + name + (b" " + com if com else b"") + b"\n", wrap(seq, width).tobytes()]
        seqs.append(seq)
        ids.append(name + b"\0")
        coms.append(com + b"\0")
    lengths = np.asarray([r["length"] for r in p["records"]], np.uint64)
    return Dataset(fmt="fasta", text=b"".join(text), ids_blob=b"".join(ids),
                   comments_blob=b"".join(coms), seq=np.concatenate(seqs), lengths=lengths,
                   qual=None, longest_line=min(width, int(lengths.max())))
