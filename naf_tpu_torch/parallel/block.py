"""Block splitting, the fused and two-pass passes over the blocks of a
mesh, the rows they hand the host (``BlockRows``) and the host stitch.

The numpy helpers are jax-free copies of ``naf_tpu/parallel/block.py``
(``make_blocks``, ``make_blocks_fastq``, ``stitch_packed``,
``stitch_packed_range``, ``stitch_lengths``, ``stitch_runs``,
``blob_from_lens``), whose module imports jax at load time; the tests hold
each copy against its original.

The sharded functions take one tensor a block, each on its own device (a
``mesh.BlockMesh`` uploads them), and run a phase's launches on every block
before the collective that ends it (``mesh.all_gather``), so the cards of
a mesh overlap:

- ``fused_blocks_sharded`` / ``fused_blocks_fastq_sharded``: every block's
  fused emit, one gather of the char counts (``mesh.parities``), then every
  block's pack at its parity (naf_tpu's ``fused_blocks*_sharded`` with
  ``_pack_block``);
- ``stats_blocks_sharded``: pass 1 (``_stats_fn``): every block's counts,
  one gather of them, the prefix that gives each block's ``odd``, ``pmax``
  of the longest line and ``psum`` of the unexpected-byte histograms;
- ``emit_blocks_sharded``: pass 2 (``_emit_fn``), each block packed at its
  ``odd``, fetched as a ``BlockRows``.

``stitch_rows`` turns a ``BlockRows`` into the records of the whole input
or stream piece: lengths, header blobs, qualities, mask runs and the
nibble stream.

One block is a mesh of one.  naf_tpu's packed-row layouts
(``stats_blocks_packed``, ``emit_blocks_packed``) are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..format import constants as C
from ..ops import scan as S
from ..ops.emit_fused import emit_fasta_fused, emit_fastq_fused
from ..ops.pack import pack_4bit
from ..ops.scan_fused import scan_fasta_fused, scan_fastq_fused
from ..ops.tables import device_tables
from ..native import host as native
from ..utils.trace import note, trace_span
from .mesh import all_gather, fetch, parities, pmax, psum

_GT = ord(">")
_AT = ord("@")
_LF = ord("\n")

#: the scalars of a fused FASTA block, in the order of naf_tpu's scal rows
FASTA_SCALARS = ("cnt", "cnt_seq", "n_sp", "sp_ok", "unex_id", "unex_com", "unex_seq", "longest",
                 "first_lower", "first_sval")
#: those of a fused FASTQ block
FASTQ_SCALARS = FASTA_SCALARS + ("cnt_qual", "cnt_id", "unex_qual")


@dataclass(kw_only=True)
class BlockRows:
    """What the device passes over D blocks hand the host stitch: a column
    of D values, and a zero-padded [D, w] row a block of which only the
    used prefix counts (``counts`` nibbles or bytes, ``*_bytes`` values,
    ``n_rec + 1`` record segments, ``n_runs`` case runs)."""

    counts: np.ndarray        # chars of each block's sequence stream
    id_bytes: np.ndarray
    com_bytes: np.ndarray
    qual_bytes: np.ndarray
    n_rec: np.ndarray         # record starts inside each block
    n_runs: np.ndarray        # case runs of each block's stream
    first_lower: np.ndarray   # whether that stream starts lower case
    longest: np.ndarray       # the longest line of all blocks, in each
    first_codes: np.ndarray   # nibble code of each block's first char
    #: the id, comment, sequence and quality histograms of unexpected bytes
    hists: list = field(default_factory=lambda: [np.zeros(257, np.uint64) for _ in range(4)])
    packed: np.ndarray        # nibbles at the block's parity; protein, text: bytes
    id_vals: np.ndarray
    com_vals: np.ndarray
    qual_vals: np.ndarray
    seq_lens: np.ndarray      # each record segment's length in the block
    id_lens: np.ndarray
    com_lens: np.ndarray
    qual_lens: np.ndarray
    run_lens: np.ndarray      # each case run's length


#: the [D, w] row fields of a ``BlockRows``
ROW_FIELDS = ("packed", "id_vals", "com_vals", "qual_vals", "seq_lens", "id_lens", "com_lens",
              "qual_lens", "run_lens")


def _scal(r: dict, names: tuple) -> torch.Tensor:
    return torch.stack([r[k].to(torch.int32) for k in names])


def _pack_blocks(rs: list, parity_base: int) -> list:
    """Each block's stream packed at its nibble parity: ``parity_base``
    plus the chars of the blocks before it (one gather of the counts).
    The pack does the reference's roll by one byte on odd parity and its
    ``_fit`` to B'//2+1 bytes, so no per-byte torch op runs between the
    kernels."""
    shifts = parities([r["cnt"] for r in rs], int(parity_base))
    return [pack_4bit(r["sv"], shift=sh, out_len=r["sv"].numel() // 2 + 1)
            for r, sh in zip(rs, shifts)]


def fused_blocks_sharded(xs: list, prevs, siss, parity_base: int, *, seq_type: int) -> tuple:
    """Fused FASTA emit + nibble pack of every block (nucleotide, plain
    format), block k of ``xs`` (u8[B] tensors) on its own device, ``prevs``
    the byte before each block and ``siss`` whether it starts inside a
    record.  ``parity_base`` is the char count before block 0 (0 for a
    whole input, the stream's count so far for a chunk of it).

    Returns per-block lists (packed u8[B'//2+1], scal i32[10], sp_tv
    i32[S], sp_a i32[S]), each tensor on its block's device; scal holds
    ``FASTA_SCALARS``.
    """
    with trace_span("emit", path="fused"):
        rs = [emit_fasta_fused(x, int(p), bool(s), seq_type=seq_type)
              for x, p, s in zip(xs, prevs, siss)]
        return (_pack_blocks(rs, parity_base), [_scal(r, FASTA_SCALARS) for r in rs],
                [r["sp_tv"] for r in rs], [r["sp_a"] for r in rs])


def fused_blocks_fastq_sharded(xs: list, prevs, parity_base: int, *, seq_type: int) -> tuple:
    """Fused FASTQ emit + nibble pack of every block (nucleotide), as
    ``fused_blocks_sharded``.

    Returns per-block lists (packed u8[B'//2+1], qv u8[B'], iv u8[B'], scal
    i32[13], sp_tv, sp_a, sp_b, sp_c i32[S]); scal holds ``FASTQ_SCALARS``.
    """
    with trace_span("emit", path="fused"):
        rs = [emit_fastq_fused(x, int(p), seq_type=seq_type) for x, p in zip(xs, prevs)]
        return (_pack_blocks(rs, parity_base), [r["qv"] for r in rs], [r["iv"] for r in rs],
                [_scal(r, FASTQ_SCALARS) for r in rs],
                *([r[k] for r in rs] for k in ("sp_tv", "sp_a", "sp_b", "sp_c")))


# ---------------------------------------------------------------------------
# the two-pass protocol
# ---------------------------------------------------------------------------

def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


def _fit(arr: torch.Tensor, cap: int) -> torch.Tensor:
    """Pad with zeros or slice a 1-D tensor to exactly ``cap`` elements."""
    n = arr.numel()
    if n >= cap:
        return arr[:cap]
    return torch.cat([arr, arr.new_zeros(cap - n)])


def _record_bounds(rec_start: torch.Tensor, r_cap: int) -> torch.Tensor:
    """i32[r_cap+1] record boundaries [0, marker_1, ..., B, B, ...]: record
    r spans [bnd[r], bnd[r+1]); rows past the record count are empty."""
    B = rec_start.numel()
    starts, n_m = S.compact_best(rec_start, _arange(B, rec_start))
    starts_r = torch.where(_arange(r_cap, rec_start) < n_m, _fit(starts, r_cap), B)
    return torch.cat([starts_r.new_zeros(1), starts_r])


def _segment_sum_bounds(mask: torch.Tensor, bnd: torch.Tensor) -> torch.Tensor:
    """i32[r_cap]: set mask bits per record, one prefix count and two
    record-sized gathers."""
    cum = S.cumsum_best(mask)
    e = torch.cat([cum.new_zeros(1), cum])          # e[i] = count before i
    b = bnd.long()
    return e[b[1:]] - e[b[:-1]]


def _run_stats_uncompacted(keep: torch.Tensor, val: torch.Tensor):
    """(first_lower, n_runs) of the kept stream's case runs without
    compacting it: each kept byte against the case of the kept byte before
    it, found by a max scan of position*2 | lower."""
    B = keep.numel()
    lower = keep & (val >= 96)
    enc = torch.where(keep, _arange(B, keep) * 2 + _i32(lower), S._NEG)
    m = S.maxscan_best(enc)
    m_excl = torch.cat([m.new_full((1,), S._NEG), m[:-1]])
    change = keep & (m_excl >= 0) & (lower != ((m_excl & 1) == 1))
    n_changes = change.sum(dtype=torch.int32)
    cum_keep = S.cumsum_best(keep)
    cnt = cum_keep[-1]
    n_runs = torch.where(cnt > 0, n_changes + 1, 0)
    first_lower = (keep & (cum_keep == 1) & lower).any()
    return first_lower, n_runs


def _run_lengths(lower: torch.Tensor, count: torch.Tensor, m_cap: int) -> torch.Tensor:
    """i32[m_cap] case-run lengths of the compacted stream (its first
    ``count`` bytes)."""
    B = lower.numel()
    idx = _arange(B, lower)
    prev = torch.cat([lower[:1], lower[:-1]])
    change = (idx < count) & (idx > 0) & (lower != prev)
    pos_c, n_changes = S.compact_best(change, idx)
    j = _arange(m_cap, lower)
    # boundaries: [0, change_0, ..., change_{k-1}, count]
    bounds = torch.cat([idx.new_zeros(1), torch.where(j < n_changes, _fit(pos_c, m_cap), 0)])
    bounds = torch.where(_arange(m_cap + 1, lower) == n_changes + 1, count, bounds)
    n_runs = torch.where(count > 0, n_changes + 1, 0)
    return torch.where(j < n_runs, bounds[1:] - bounds[:-1], 0)


def _scan_block(b: torch.Tensor, prev_byte: int, starts_in_seq: bool, *, seq_type: int,
                fastq: bool) -> dict:
    """The masks of a block, from the standalone classify kernels; FASTQ
    adds the quality masks."""
    if fastq:
        return scan_fastq_fused(b, prev_byte, seq_type=seq_type)
    return scan_fasta_fused(b, prev_byte, seq_type=seq_type, starts_in_seq=starts_in_seq)


#: pass 1's counts, in the order of a block's row (then the unexpected
#: bytes of each histogram, ``UNEX_KEYS``)
STATS_KEYS = ("count", "id_bytes", "com_bytes", "qual_bytes", "n_rec", "n_runs", "first_lower",
              "longest")
#: the masks of the id, comment, sequence and quality histograms
UNEX_KEYS = ("id_unex", "com_unex", "seq_unex", "qual_unex")


def _stats_row(block: torch.Tensor, prev_byte: int, starts_in_seq: bool, *, seq_type: int,
               fastq: bool) -> tuple:
    """(i32[12] row on the block's device, masks): ``STATS_KEYS`` and the
    count of each ``UNEX_KEYS`` mask; nothing is fetched."""
    s = _scan_block(block, prev_byte, starts_in_seq, seq_type=seq_type, fastq=fastq)
    first_lower, n_runs = _run_stats_uncompacted(s["stream_keep"], s["stream_val"])
    zero = torch.zeros((), dtype=torch.int32, device=block.device)

    def count(key: str) -> torch.Tensor:
        return s[key].sum(dtype=torch.int32) if key in s else zero

    row = torch.stack([
        count("stream_keep"), count("id_keep"), count("com_keep"), count("qual_keep"),
        count("rec_start"), _i32(n_runs), _i32(first_lower),
        _i32(S.longest_line_block(s["seq_keep"], s["is_eol"])), *map(count, UNEX_KEYS)])
    return row, s


def stats_rows(xs: list, prevs, siss, *, seq_type: int, fastq: bool) -> tuple:
    """Pass 1 of every block, gathered: (rows i64[D, 12], hists u64[4, 257],
    masks).  Every block's pass launches before the one gather of the rows;
    the id, comment, sequence and quality histograms of unexpected bytes
    are counted only on the blocks that have such bytes, and summed over
    them (``psum``, a second fetch then).  ``masks`` is each block's
    classify dict, which ``emit_blocks_sharded`` takes, so a block is
    classified once."""
    launched = [_stats_row(x, int(p), bool(s), seq_type=seq_type, fastq=fastq)
                for x, p, s in zip(xs, prevs, siss)]
    rows = all_gather([r for r, _ in launched]).astype(np.int64)
    masks = [m for _, m in launched]
    k = len(STATS_KEYS)
    dirty = [torch.stack([torch.bincount(x[m[key]].long(), minlength=256) if row[k + j]
                          else torch.zeros(256, dtype=torch.int64, device=x.device)
                          for j, key in enumerate(UNEX_KEYS)])
             for x, m, row in zip(xs, masks, rows) if row[k:].any()]
    hists = np.zeros((4, 257), np.uint64)
    if dirty:
        hists[:, :256] = psum(dirty).astype(np.uint64)
    return rows, hists, masks


def block_stats(rows: np.ndarray, hists: np.ndarray, parity_base: int = 0) -> list:
    """Each block's pass-1 dict from the gathered rows of every block:
    ``STATS_KEYS`` as ints (first_lower a bool), ``odd`` (the parity of
    ``parity_base`` plus the chars of the blocks before it), ``longest``
    as the ``pmax`` over the blocks and ``hists`` the summed histograms,
    each u64[257], the same in every block's dict."""
    counts = rows[:, 0]
    prefix = np.concatenate([[0], np.cumsum(counts)[:-1]])
    longest = pmax(rows[:, STATS_KEYS.index("longest")])
    out = []
    for row, pre in zip(rows, prefix):
        st = {key: int(v) for key, v in zip(STATS_KEYS, row)}
        st.update(first_lower=bool(st["first_lower"]), longest=longest,
                  odd=bool((int(parity_base) + int(pre)) % 2), hists=list(hists))
        out.append(st)
    return out


def stats_columns(stats: list) -> dict:
    """The per-block columns and histograms of a ``BlockRows`` from pass 1's
    dict of every block (``block_stats``)."""
    cols = {col: np.asarray([st[k] for st in stats])
            for col, k in zip(("counts", *STATS_KEYS[1:]), STATS_KEYS)}
    return dict(cols, hists=stats[0]["hists"])


def stats_blocks_sharded(xs: list, prevs, siss, *, seq_type: int, fastq: bool,
                         parity_base: int = 0) -> tuple:
    """Pass 1 over the blocks (``_stats_fn`` with its collectives):
    (per-block stats dicts of ``block_stats``, per-block masks)."""
    with trace_span("emit", path="two-pass"):
        rows, hists, masks = stats_rows(xs, prevs, siss, seq_type=seq_type, fastq=fastq)
    return block_stats(rows, hists, parity_base), masks


def _emit_launch(b: torch.Tensor, s: dict, stats: dict, *, seq_type: int, fastq: bool,
                 pack_nibbles: bool, parity_base: int) -> tuple:
    """Pass 2's device work on one block: (u8 parts, i32 parts), the used
    prefix of each output, on the block's device; nothing is fetched."""
    cnt, n_rec = stats["count"], stats["n_rec"]
    seq_c, cnt_d = S.compact_best(s["stream_keep"], s["stream_val"], dense=True)
    if pack_nibbles:
        packed = pack_4bit(seq_c, shift=int(parity_base) % 2, out_len=(cnt + 1) // 2 + 1)
        first_code = device_tables(seq_type, b.device)["nuc_code"][seq_c[:1].long()]
        m_cap = max(stats["n_runs"], 2)
        lower = (seq_c >= 96) & (_arange(seq_c.numel(), seq_c) < cnt_d)
        run_lens = _run_lengths(lower, cnt_d, m_cap)
    else:
        packed = seq_c[:max(cnt, 1)]
        first_code = seq_c.new_zeros(1)
        run_lens = seq_c.new_zeros(2, dtype=torch.int32)
    id_vals = S.compact_best(s["id_keep"], b)[0][:max(stats["id_bytes"], 1)]
    com_vals = S.compact_best(s["com_keep"], s["com_val"])[0][:max(stats["com_bytes"], 1)]
    bnd = _record_bounds(s["rec_start"], n_rec + 1)
    lens = [_segment_sum_bounds(s[k], bnd) for k in ("seq_keep", "id_keep", "com_keep")]
    if fastq:
        qual_vals = S.compact_best(s["qual_keep"], s["qual_val"], dense=True)[0][
            :max(stats["qual_bytes"], 1)]
        lens.append(_segment_sum_bounds(s["qual_keep"], bnd))
    else:
        qual_vals = b.new_zeros(1)
        lens.append(bnd.new_zeros(n_rec + 1))
    return ([packed, first_code, id_vals, com_vals, qual_vals],
            [cnt_d.reshape(1), *lens, run_lens])


def _emit_fetch(u8: list, i32: list) -> dict:
    """One block's pass-2 parts, fetched as one byte buffer and one i32
    buffer: its first code and its rows, by ``BlockRows`` field.  The i32
    buffer leads with the device's char count, which pass 1 already gave."""
    u8_np = fetch(torch.cat(u8)).numpy()
    i32_np = fetch(torch.cat([_i32(t) for t in i32])).numpy()
    cuts_u8 = np.cumsum([t.numel() for t in u8])[:-1]
    cuts_i32 = np.cumsum([t.numel() for t in i32])[:-1]
    packed, first, id_v, com_v, qual_v = np.split(u8_np, cuts_u8)
    _, seq_l, id_l, com_l, qual_l, run_l = np.split(i32_np, cuts_i32)
    return dict(first_codes=first, packed=packed, id_vals=id_v, com_vals=com_v, qual_vals=qual_v,
                seq_lens=seq_l, id_lens=id_l, com_lens=com_l, qual_lens=qual_l,
                run_lens=run_l.astype(np.int64))


def pad_rows(D: int, rows: list, dtype=np.int32) -> np.ndarray:
    """1-D per-block rows as one [D, w] array, zero-padded to the widest
    (w at least 1)."""
    w = max(max((r.size for r in rows), default=0), 1)
    out = np.zeros((D, w), dtype)
    for k, r in enumerate(rows):
        out[k, :r.size] = r
    return out


def emit_blocks_sharded(xs: list, masks: list, stats: list, *, seq_type: int, fastq: bool,
                        pack_nibbles: bool) -> BlockRows:
    """Pass 2 over the blocks (``_emit_fn``), every block's launches before
    the first fetch.

    ``masks`` and ``stats`` are what ``stats_blocks_sharded`` returned; the
    counts size every output exactly.  Nucleotide streams are packed to
    nibbles (``pack_nibbles``) at each block's ``odd`` parity: on odd
    parity the block's first char pairs with the previous block's last, so
    chars[1:] are packed and ``first_code`` is the code of chars[0].
    Protein and text keep the compacted bytes and store no mask.  Returns
    the blocks' ``BlockRows``, its columns from ``stats``; each block is
    fetched as one byte buffer and one i32 buffer holding the used
    prefixes."""
    with trace_span("emit", path="two-pass"):
        launched = [_emit_launch(x, m, st, seq_type=seq_type, fastq=fastq,
                                 pack_nibbles=pack_nibbles, parity_base=int(st["odd"]))
                    for x, m, st in zip(xs, masks, stats)]
        fetched = [_emit_fetch(*parts) for parts in launched]
    with trace_span("parse"):
        D = len(fetched)
        return BlockRows(**stats_columns(stats),
                         first_codes=np.concatenate([f["first_codes"] for f in fetched]),
                         **{k: pad_rows(D, [f[k] for f in fetched], fetched[0][k].dtype)
                            for k in ROW_FIELDS})


# ---------------------------------------------------------------------------
# host-side block splitting (copy of naf_tpu.parallel.block)
# ---------------------------------------------------------------------------

@dataclass
class Blocks:
    data: np.ndarray          # u8[D, B] '\n'-padded
    prev: np.ndarray          # u8[D] byte before each block
    starts_in_seq: np.ndarray  # bool[D] block cut mid-record (FASTA SP)


def _line_start_from(data: np.ndarray, t: int) -> int:
    """The first line start (a byte after an EOL, below ``data.size``) at or
    after ``t``, or ``data.size``: the EOLs are looked for in windows that
    double from ``t`` on, so a cut costs about one line, not the input."""
    n = data.size
    pos, w = max(t - 1, 0), 1 << 12
    while pos < n - 1:
        hit = np.flatnonzero(C.IS_EOL[:256][data[pos:min(pos + w, n - 1)]])
        if hit.size:
            return pos + int(hit[0]) + 1
        pos, w = pos + w, 2 * w
    return n


def make_blocks(data: np.ndarray, n_blocks: int, *, marker: int = _GT,
                prev0: int | None = None, sis0: bool = False) -> Blocks:
    """Split bytes (already past the first marker) into line-aligned blocks.

    Cut candidates are line starts (byte after any EOL), so headers and
    lines never straddle blocks; a block whose first byte is not a record
    marker starts mid-record (sequence-parallel continuation).

    ``prev0``/``sis0`` carry chunk state for a streaming encoder: the byte
    before this chunk and whether the chunk resumes mid-record.  Default =
    chunk 0 right after the global marker.
    """
    with trace_span("split", bytes=data.size):
        n = data.size
        if n == 0:
            blocks = np.full((n_blocks, 2), _LF, dtype=np.uint8)
            prev = np.full(n_blocks, _LF, dtype=np.uint8)
            prev[0] = marker if prev0 is None else prev0
            sis = np.zeros(n_blocks, bool)
            sis[0] = bool(sis0)
            return Blocks(blocks, prev, sis)

        # each cut is the first line start at or after its target (n when
        # there is none), the reference's search over every line start; a
        # block count of one has no target
        targets = (np.arange(1, n_blocks) * n) // n_blocks
        cuts = [0]
        for t in targets:
            cut = _line_start_from(data, int(t))
            if cut > cuts[-1]:
                cuts.append(cut)
        while len(cuts) < n_blocks + 1:
            cuts.append(n)
        cuts = cuts[: n_blocks + 1]
        cuts[-1] = n

        return _fill_blocks(data, cuts, marker if prev0 is None else prev0, marker=marker,
                            sis0=sis0)


def _fill_blocks(data: np.ndarray, cuts: list, prev0: int, *, marker: int | None = None,
                 sis0: bool = False) -> Blocks:
    """Non-empty ``data`` cut at ``cuts`` (``[0, ..., data.size]``) into
    '\\n'-padded blocks of one even width of at least 2: the byte before
    each block (``prev0`` before the first) and, for FASTA (``marker``
    given), whether each starts inside a record (the first only if
    ``sis0``)."""
    n_blocks = len(cuts) - 1
    B = max(max(e - s for s, e in zip(cuts[:-1], cuts[1:])), 2)
    B += B % 2
    blocks = np.full((n_blocks, B), _LF, dtype=np.uint8)
    prev = np.full(n_blocks, prev0, dtype=np.uint8)
    sis = np.zeros(n_blocks, bool)
    for k, (s, e) in enumerate(zip(cuts[:-1], cuts[1:])):
        blocks[k, : e - s] = data[s:e]
        if k > 0:
            prev[k] = data[s - 1]       # every cut after the first is past 0
        if marker is not None and e > s:
            sis[k] = data[s] != marker and (k > 0 or bool(sis0))
    return Blocks(blocks, prev, sis)


def _fastq_grid_np(data: np.ndarray, n_blocks: int):
    """The grid check and block cuts of ``make_blocks_fastq`` in numpy: the
    ``n_blocks + 1`` cuts and the record count, or None off the grid."""
    n = data.size
    if n == 0 or data[-1] != _LF:
        return None
    if np.any((data == 11) | (data == 12) | (data == 13)):
        return None
    eol = np.flatnonzero(data == _LF)
    n_lines = eol.size
    if n_lines % 4 != 0:
        return None
    line_start = np.concatenate([[0], eol[:-1] + 1])
    if np.any(eol == line_start):           # empty line
        return None
    if not np.all(data[line_start[2::4]] == ord("+")):
        return None
    if n_lines > 4 and not np.all(data[line_start[4::4]] == _AT):
        return None

    rec_starts = line_start[0::4]
    n_rec = rec_starts.size
    targets = (np.arange(1, n_blocks) * n) // n_blocks
    idx = np.searchsorted(rec_starts, targets)
    cuts = [0]
    for i in idx:
        cut = int(rec_starts[i]) if i < rec_starts.size else n
        if cut > cuts[-1]:
            cuts.append(cut)
    while len(cuts) < n_blocks + 1:
        cuts.append(n)
    cuts = cuts[: n_blocks + 1]
    cuts[-1] = n
    return cuts, n_rec


def make_blocks_fastq(data: np.ndarray, n_blocks: int):
    """Record-aligned FASTQ blocks; returns (Blocks, n_records) or None.

    Requires the regular 4-line LF grid (every production FASTQ):
    non-empty lines, '+' third lines, '@' record heads, trailing newline,
    and no CR/VT/FF anywhere; the reference FASTQ parser treats those as
    EOL-class, so e.g. a CRLF grid is an error there.  Returning None
    routes such inputs to the host parser, which raises the reference's
    message.  ``data`` starts right after the leading '@'.

    The check and the cuts are one pass of the host library
    (``native.fastq_grid``), or ``_fastq_grid_np`` without it; the
    ``grid`` span's ``native`` field says which.
    """
    with trace_span("split", bytes=data.size):
        with trace_span("grid", bytes=data.size):
            in_lib = native.available()
            got = native.fastq_grid(data, n_blocks) if in_lib else _fastq_grid_np(data, n_blocks)
            note(records=got[1] if got else 0, native=int(in_lib))
        if got is None:
            return None
        cuts, n_rec = got
        return _fill_blocks(data, cuts, _AT), n_rec


# ---------------------------------------------------------------------------
# host-side stitching (copies of naf_tpu.parallel.block)
# ---------------------------------------------------------------------------

def stitch_packed(packed: np.ndarray, counts: np.ndarray, first_codes: np.ndarray,
                  held: Optional[int] = None) -> np.ndarray:
    """Merge per-block even-aligned payloads into one nibble stream.

    For a block whose prefix parity is odd, its first char's code was left
    out of its packed payload; it belongs in the high nibble of the previous
    byte of the stream.  One OR per block edge.  ``held`` is the low nibble
    of a stream piece before these blocks, left waiting for its high
    nibble: the blocks then start at odd parity and their first char
    completes it.  A trailing half byte ends the stream as its last byte.
    """
    pieces: list[np.ndarray] = []
    odd = held is not None
    pending_low = held
    for d in range(counts.shape[0]):
        cnt = int(counts[d])
        if cnt == 0:
            continue
        if odd:
            assert pending_low is not None
            pieces.append(np.asarray(
                [pending_low | (int(first_codes[d]) << 4)], dtype=np.uint8))
            pending_low = None
            packed_chars = cnt - 1
        else:
            packed_chars = cnt
        nbytes = packed_chars // 2
        body = packed[d, :nbytes]
        pieces.append(np.ascontiguousarray(body))
        if packed_chars % 2:
            pending_low = int(packed[d, nbytes]) & 0x0F
        odd ^= bool(cnt % 2)
    if pending_low is not None:
        pieces.append(np.asarray([pending_low], dtype=np.uint8))
    if not pieces:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(pieces)


def stitch_packed_range(rows: dict, counts: np.ndarray,
                        first_codes: np.ndarray, k0: int, k1: int
                        ) -> np.ndarray:
    """``stitch_packed`` for blocks [k0, k1) only, using global carry state.

    ``rows[d]`` is block d's even-aligned packed payload; ``counts`` and
    ``first_codes`` are the GLOBAL per-block vectors (O(D) scalars every
    process already holds).  Boundary nibble ownership: a byte straddling
    two ranges is emitted by the EARLIER range (completed with the next
    range's first code) and skipped by the later one, so concatenating
    every range's output in block order reproduces ``stitch_packed`` byte
    for byte.  This lets each process of a multi-process encode compress
    its own packed bytes (parallel/multihost.py).
    """
    D = counts.shape[0]
    pieces: list[np.ndarray] = []
    total = int(counts[:k0].sum())
    pending_low: int | None = None
    for d in range(k0, k1):
        cnt = int(counts[d])
        if cnt == 0:
            continue
        odd = (total % 2) == 1
        if odd:
            if pending_low is not None:
                pieces.append(np.asarray(
                    [pending_low | (int(first_codes[d]) << 4)],
                    dtype=np.uint8))
                pending_low = None
            # else: first char of this range completes the previous
            # range's last byte, emitted there, skipped here
            packed_chars = cnt - 1
        else:
            packed_chars = cnt
        nbytes = packed_chars // 2
        pieces.append(np.ascontiguousarray(rows[d][:nbytes]))
        if packed_chars % 2:
            pending_low = int(rows[d][nbytes]) & 0x0F
        total += cnt
    if pending_low is not None:
        nxt = None
        for j in range(k1, D):
            if int(counts[j]) > 0:
                nxt = j
                break
        if nxt is None:
            pieces.append(np.asarray([pending_low], dtype=np.uint8))
        else:
            pieces.append(np.asarray(
                [pending_low | (int(first_codes[nxt]) << 4)],
                dtype=np.uint8))
    if not pieces:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(pieces)


def stitch_lengths(per_block: list[np.ndarray]) -> np.ndarray:
    """Per-block segment counts -> global per-record values.

    Segment 0 of every block after the first continues the previous open
    record (0 when the block starts at a marker); block 0's segment 0 is
    record 0 itself (its marker was stripped by the reader).
    """
    out: list[np.ndarray] = []
    for k, lens in enumerate(per_block):
        lens = np.asarray(lens, dtype=np.int64)
        if k == 0:
            seg = lens
        else:
            if out and lens.size:
                out[-1][-1] += int(lens[0])
            seg = lens[1:]
        if seg.size:
            out.append(seg.copy())
    if not out:
        return np.zeros(0, np.int64)
    return np.concatenate(out)


def stitch_runs(per_block_runs: list[np.ndarray],
                per_block_first: list[bool]) -> tuple[np.ndarray, bool]:
    """Per-block mask runs -> (global run lengths, first char is lower)."""
    runs: list[np.ndarray] = []
    state_first = False
    state_last = None          # case of the last run appended
    for lens, first in zip(per_block_runs, per_block_first):
        lens = np.asarray(lens, dtype=np.int64)
        if lens.size == 0:
            continue
        if state_last is None:
            runs.append(lens.copy())
            state_first = bool(first)
        elif bool(first) == state_last:
            runs[-1][-1] += int(lens[0])
            if lens.size > 1:
                runs.append(lens[1:].copy())
        else:
            runs.append(lens.copy())
        state_last = bool(first) ^ ((lens.size - 1) % 2 == 1)
    if not runs:
        return np.zeros(0, np.int64), False
    return np.concatenate(runs), state_first


def blob_from_lens(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenated per-record values + lens -> '\\0'-terminated blob."""
    n_rec = lens.size
    total = int(vals.size) + n_rec
    out = np.zeros(total, dtype=np.uint8)
    ends = np.cumsum(lens + 1) - 1
    fill = np.ones(total, dtype=bool)
    fill[ends] = False
    out[fill] = vals
    return out.tobytes()


@dataclass
class Stitched:
    """The records of a ``BlockRows`` (``stitch_rows``)."""

    seq_lens: np.ndarray             # i64[records]
    ids_blob: bytes
    comments_blob: bytes
    seq: Optional[np.ndarray]        # the nibble stream (protein, text: the bytes)
    qual: Optional[np.ndarray]       # FASTQ only
    runs: Optional[np.ndarray]       # the mask's case runs
    first_lower: bool                # whether runs[0] is lower case


def stitch_rows(rows: BlockRows, *, fastq: bool, mask: bool, text_like: bool = False,
                payload: bool = True, held: Optional[int] = None) -> Optional[Stitched]:
    """The records of the blocks of ``rows``, carried across their edges
    (O(blocks + records + runs)): record lengths, '\\0'-terminated id and
    comment blobs, the mask runs (under ``mask``), and with ``payload`` the
    nibble stream (``stitch_packed`` from ``held``; protein and text,
    ``text_like``: the bytes) and the FASTQ qualities.  None when a FASTQ
    record's quality length differs from its sequence length, whose
    message only the host parser gives."""
    D = rows.counts.shape[0]

    def lengths(arr2d):
        return stitch_lengths([arr2d[k, : int(rows.n_rec[k]) + 1] for k in range(D)])

    def used(arr2d, sizes):
        return np.concatenate([arr2d[k, : int(sizes[k])] for k in range(D)])

    seq_lens = lengths(rows.seq_lens)
    assert seq_lens.size == int(rows.n_rec.sum()) + 1
    if fastq and not np.array_equal(lengths(rows.qual_lens), seq_lens):
        return None
    seq = qual = runs = None
    first_lower = False
    if payload and text_like:
        seq = (used(rows.packed, rows.counts) if int(rows.counts.sum())
               else np.zeros(0, np.uint8)).astype(np.uint8)
    elif payload:
        seq = stitch_packed(rows.packed, rows.counts, rows.first_codes, held)
    if payload and fastq:
        qual = used(rows.qual_vals, rows.qual_bytes)
    if mask:
        runs, first_lower = stitch_runs([rows.run_lens[k, : int(rows.n_runs[k])]
                                         for k in range(D)],
                                        [bool(f) for f in rows.first_lower])
    return Stitched(seq_lens=seq_lens,
                    ids_blob=blob_from_lens(used(rows.id_vals, rows.id_bytes),
                                            lengths(rows.id_lens)),
                    comments_blob=blob_from_lens(used(rows.com_vals, rows.com_bytes),
                                                 lengths(rows.com_lens)),
                    seq=seq, qual=qual, runs=runs, first_lower=first_lower)
