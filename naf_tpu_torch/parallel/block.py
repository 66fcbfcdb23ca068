"""Block splitting, the one-device fused and two-pass blocks, and the host
stitch helpers.

The numpy helpers are jax-free copies of ``naf_tpu/parallel/block.py``
(``make_blocks``, ``make_blocks_fastq``, ``stitch_packed``,
``stitch_lengths``, ``stitch_runs``, ``blob_from_lens``), whose module
imports jax at load time; the tests hold each copy against its original.
``fused_block`` and ``fused_block_fastq`` are the one-device counterparts of
``fused_blocks_sharded`` and ``fused_blocks_fastq_sharded`` with
``_pack_block``; ``stats_block`` and ``emit_block`` those of the two-pass
protocol's ``_stats_fn`` and ``_emit_fn``, each collective taken over its
one block.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..format import constants as C
from ..ops import scan as S
from ..ops.emit_fused import emit_fasta_fused, emit_fastq_fused
from ..ops.pack import pack_4bit
from ..ops.scan_fused import scan_fasta_fused, scan_fastq_fused
from ..ops.tables import device_tables

_GT = ord(">")
_AT = ord("@")
_LF = ord("\n")


def fused_block(block, prev: int, sis: bool, parity_base: int, *, seq_type: int,
                device) -> tuple:
    """Fused FASTA emit + nibble pack of one block (nucleotide, plain
    format) on ``device``.

    ``block`` is u8[B] (numpy, or a tensor already on the device), ``prev``
    the byte before it and ``sis`` whether it starts inside a record.
    ``parity_base`` is the global char count before this block.  The pack
    does the reference's roll by one byte on odd parity and its ``_fit`` to
    B'//2+1 bytes, so no per-byte torch op runs between the kernels.
    Returns (packed u8[1, B'//2+1], scal i32[1, 10], sp_tv i32[1, S],
    sp_a i32[1, S]); scal holds [cnt, cnt_seq, n_sp, sp_ok, unex_id,
    unex_com, unex_seq, longest, first_lower, first_sval].
    """
    x = torch.as_tensor(block).to(device)
    r = emit_fasta_fused(x, int(prev), bool(sis), seq_type=seq_type)
    sv = r["sv"]
    packed = pack_4bit(sv, shift=int(parity_base) % 2, out_len=sv.numel() // 2 + 1)
    scal = torch.stack([
        r["cnt"], r["cnt_seq"], r["n_sp"], r["sp_ok"].to(torch.int32),
        r["unex_id"], r["unex_com"], r["unex_seq"], r["longest"],
        r["first_lower"], r["first_sval"]]).to(torch.int32)
    return packed[None], scal[None], r["sp_tv"][None], r["sp_a"][None]


def fused_block_fastq(block, prev: int, parity_base: int, *, seq_type: int, device) -> tuple:
    """Fused FASTQ emit + nibble pack of one block (nucleotide) on
    ``device``; ``block``, ``prev`` and ``parity_base`` as in ``fused_block``.

    Returns (packed u8[1, B'//2+1], qv u8[1, B'], iv u8[1, B'],
    scal i32[1, 13], sp_tv, sp_a, sp_b, sp_c i32[1, S]); scal holds [cnt,
    cnt_seq, n_sp, sp_ok, unex_id, unex_com, unex_seq, longest, first_lower,
    first_sval, cnt_qual, cnt_id, unex_qual].
    """
    x = torch.as_tensor(block).to(device)
    r = emit_fastq_fused(x, int(prev), seq_type=seq_type)
    sv = r["sv"]
    packed = pack_4bit(sv, shift=int(parity_base) % 2, out_len=sv.numel() // 2 + 1)
    scal = torch.stack([
        r["cnt"], r["cnt_seq"], r["n_sp"], r["sp_ok"].to(torch.int32),
        r["unex_id"], r["unex_com"], r["unex_seq"], r["longest"],
        r["first_lower"], r["first_sval"], r["cnt_qual"], r["cnt_id"],
        r["unex_qual"]]).to(torch.int32)
    return (packed[None], r["qv"][None], r["iv"][None], scal[None], r["sp_tv"][None],
            r["sp_a"][None], r["sp_b"][None], r["sp_c"][None])


# ---------------------------------------------------------------------------
# the two-pass protocol on one block
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


#: pass 1's counts, in the order ``stats_block`` fetches them
STATS_KEYS = ("count", "id_bytes", "com_bytes", "qual_bytes", "n_rec", "n_runs", "first_lower",
              "longest")


def stats_block(block: torch.Tensor, prev_byte: int, starts_in_seq: bool, *, seq_type: int,
                fastq: bool) -> tuple[dict, dict]:
    """Pass 1 on one block: ``_stats_fn`` for one device.

    Returns (stats, masks).  ``stats`` maps ``STATS_KEYS`` to ints
    (first_lower to a bool) and ``hists`` to the id, comment, sequence and
    quality histograms of unexpected bytes, each u64[257]; one fetch from
    the device.  ``masks`` is the classify's mask dict, which
    ``emit_block`` takes, so the block is classified once.
    """
    s = _scan_block(block, prev_byte, starts_in_seq, seq_type=seq_type, fastq=fastq)
    first_lower, n_runs = _run_stats_uncompacted(s["stream_keep"], s["stream_val"])
    zero = torch.zeros((), dtype=torch.int32, device=block.device)
    row = torch.stack([
        s["stream_keep"].sum(dtype=torch.int32),
        s["id_keep"].sum(dtype=torch.int32), s["com_keep"].sum(dtype=torch.int32),
        s["qual_keep"].sum(dtype=torch.int32) if fastq else zero,
        s["rec_start"].sum(dtype=torch.int32), _i32(n_runs), _i32(first_lower),
        _i32(S.longest_line_block(s["seq_keep"], s["is_eol"]))])
    hist_qual = s["hist_qual"] if fastq else torch.zeros_like(s["hist_seq"])
    h = torch.cat([row, s["hist_id"], s["hist_comment"], s["hist_seq"], hist_qual]).cpu().numpy()
    stats = {k: int(v) for k, v in zip(STATS_KEYS, h)}
    stats["first_lower"] = bool(stats["first_lower"])
    hists = np.zeros((4, 257), np.uint64)
    hists[:, :256] = h[len(STATS_KEYS):].reshape(4, 256)
    stats["hists"] = list(hists)
    return stats, s


def emit_block(block: torch.Tensor, masks: dict, stats: dict, *, seq_type: int, fastq: bool,
               pack_nibbles: bool, parity_base: int = 0) -> list:
    """Pass 2 on one block: ``_emit_fn`` for one device.

    ``masks`` and ``stats`` are what ``stats_block`` returned for this
    block; the counts size every output exactly.  Nucleotide streams are
    packed to nibbles (``pack_nibbles``) at the global nibble parity
    ``parity_base`` (the char count before this block: 0 in memory, the
    stream's count so far for a chunk of a stream): on odd parity the
    block's first char pairs with the previous chunk's last, so chars[1:]
    are packed and ``first_code`` is the code of chars[0].  Protein and
    text keep the compacted bytes and store no mask.  Returns the ``em_np`` list that ``_stitch_and_build``
    takes: [packed, first_code, cnt, id_vals, com_vals, qual_vals, seq_lens,
    id_lens, com_lens, qual_lens, run_lens], host arrays with one row,
    fetched from the device as one byte buffer and one i32 buffer holding
    the used prefixes.
    """
    b, s = block, masks
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
    u8 = [packed, first_code, id_vals, com_vals, qual_vals]
    i32 = [cnt_d.reshape(1), *lens, run_lens]
    u8_np = torch.cat(u8).cpu().numpy()
    i32_np = torch.cat([_i32(t) for t in i32]).cpu().numpy()
    cuts_u8 = np.cumsum([t.numel() for t in u8])[:-1]
    cuts_i32 = np.cumsum([t.numel() for t in i32])[:-1]
    packed_np, first_np, id_np, com_np, qual_np = np.split(u8_np, cuts_u8)
    cnt_np, seq_l, id_l, com_l, qual_l, run_l = np.split(i32_np, cuts_i32)
    return [packed_np[None], first_np, cnt_np.astype(np.int64), id_np[None], com_np[None],
            qual_np[None], seq_l[None], id_l[None], com_l[None], qual_l[None],
            run_l.astype(np.int64)[None]]


# ---------------------------------------------------------------------------
# host-side block splitting (copy of naf_tpu.parallel.block)
# ---------------------------------------------------------------------------

@dataclass
class Blocks:
    data: np.ndarray          # u8[D, B] '\n'-padded
    prev: np.ndarray          # u8[D] byte before each block
    starts_in_seq: np.ndarray  # bool[D] block cut mid-record (FASTA SP)


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
    n = data.size
    if n == 0:
        blocks = np.full((n_blocks, 2), _LF, dtype=np.uint8)
        prev = np.full(n_blocks, _LF, dtype=np.uint8)
        prev[0] = marker if prev0 is None else prev0
        sis = np.zeros(n_blocks, bool)
        sis[0] = bool(sis0)
        return Blocks(blocks, prev, sis)

    if n_blocks == 1:
        # the whole input is the one block: the line-start search below
        # would cost more than the rest of a device encode
        cuts = [0, n]
    else:
        is_eol = C.IS_EOL[:256][data]
        line_starts = np.flatnonzero(is_eol[:-1]) + 1     # n excluded

        targets = (np.arange(1, n_blocks) * n) // n_blocks
        idx = np.searchsorted(line_starts, targets)
        cuts = [0]
        for i in idx:
            cut = int(line_starts[i]) if i < line_starts.size else n
            if cut > cuts[-1]:
                cuts.append(cut)
        while len(cuts) < n_blocks + 1:
            cuts.append(n)
        cuts = cuts[: n_blocks + 1]
        cuts[-1] = n

    B = max(max(e - s for s, e in zip(cuts[:-1], cuts[1:])), 2)
    B += B % 2
    blocks = np.full((n_blocks, B), _LF, dtype=np.uint8)
    prev = np.full(n_blocks, _LF, dtype=np.uint8)
    prev[0] = marker if prev0 is None else prev0
    sis = np.zeros(n_blocks, bool)
    sis[0] = bool(sis0) and data[0] != marker
    for k, (s, e) in enumerate(zip(cuts[:-1], cuts[1:])):
        blocks[k, : e - s] = data[s:e]
        if k > 0:
            if s > 0:
                prev[k] = data[s - 1]
            else:
                prev[k] = prev[0]
            sis[k] = ((e > s) and data[s] != marker
                      and (s > 0 or sis[0]))
    return Blocks(blocks, prev, sis)


def make_blocks_fastq(data: np.ndarray, n_blocks: int):
    """Record-aligned FASTQ blocks; returns (Blocks, n_records) or None.

    Requires the regular 4-line LF grid (every production FASTQ):
    non-empty lines, '+' third lines, '@' record heads, trailing newline,
    and no CR/VT/FF anywhere; the reference FASTQ parser treats those as
    EOL-class, so e.g. a CRLF grid is an error there.  Returning None
    routes such inputs to the host parser, which raises the reference's
    message.  ``data`` starts right after the leading '@'.
    """
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

    B = max(max(e - s for s, e in zip(cuts[:-1], cuts[1:])), 2)
    B += B % 2
    blocks = np.full((n_blocks, B), _LF, dtype=np.uint8)
    prev = np.full(n_blocks, _LF, dtype=np.uint8)
    prev[0] = _AT
    for k, (s, e) in enumerate(zip(cuts[:-1], cuts[1:])):
        blocks[k, : e - s] = data[s:e]
        if k > 0 and s > 0:
            prev[k] = data[s - 1]
    return Blocks(blocks, prev, np.zeros(n_blocks, bool)), n_rec


# ---------------------------------------------------------------------------
# host-side stitching (copies of naf_tpu.parallel.block)
# ---------------------------------------------------------------------------

def stitch_packed(packed: np.ndarray, counts: np.ndarray,
                  first_codes: np.ndarray) -> np.ndarray:
    """Merge per-block even-aligned payloads into one nibble stream.

    For a block whose prefix parity is odd, its first char's code was left
    out of its packed payload; it belongs in the high nibble of the previous
    byte of the stream.  One OR per block edge.
    """
    pieces: list[np.ndarray] = []
    total = 0
    pending_low: int | None = None
    for d in range(counts.shape[0]):
        cnt = int(counts[d])
        if cnt == 0:
            continue
        odd = (total % 2) == 1
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
        total += cnt
    if pending_low is not None:
        pieces.append(np.asarray([pending_low], dtype=np.uint8))
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
