"""Chunked (bounded-memory) device encode: the device encode as a
streaming scan engine.

The port's copy of ``naf_tpu/parallel/stream.py``.  ``DeviceScanEngine.scan``
speaks the carry protocol of ``native.host.scan`` (the feed loop in
``pipeline/stream.py``): the held nibble, the open mask run, the open
record's length, ``F_CONT_SEQ`` and ``F_ALLOW_PARTIAL``.  So
``encode_stream(..., engine=DeviceScanEngine())`` writes the archive of the
host path while each piece's per-byte work (classify, compaction, pack,
mask runs) runs on the card, at O(chunk) host and device memory.

Each piece takes the fused path first (``fused_blocks_sharded`` /
``fused_blocks_fastq_sharded``); where that declines (``sparse_overflow``,
``unexpected_chars``) the same uploaded blocks take the two-pass protocol
(``stats_blocks_sharded`` + ``emit_blocks_sharded``).  Everything is
fetched to host numpy before ``scan`` returns, so no device tensor
outlives its piece.  Pieces
the device path does not take go to the native host scanner, each for a
named reason, as naf_tpu's engine decides: ``host_mode`` (``--strict``,
``--well-formed``, upper-casing, protein or text), ``mid_line`` (a
giant-line piece resuming mid-line), ``open_line`` (a piece ending
mid-line), ``no_full_record`` (a FASTQ piece without a complete record),
``fastq_irregular`` (off the regular 4-line grid) and
``qual_length_mismatch`` (the native scanner raises the reference's text).
Both scanners share the carry algebra, so they interleave within a stream.

Each piece is split over the blocks of the engine's mesh
(``mesh.BlockMesh``; one block on the named device by default), as
naf_tpu's engine splits it over its mesh: the pieces' nibble parity and
open mask run carry across the blocks of a piece and from piece to piece.

Unlike naf_tpu's engine, a fault on the card is never requeued to the
host scanner: an exception of a piece, fused or two-pass, propagates.
The TPU's recompile guards (power-of-two column and capacity buckets, LF
padding) are not copied.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..device import count_route
from ..format import constants as C
from ..native import host as native
from ..ops.mask import runs_to_units
from .block import (STATS_KEYS, blob_from_lens, emit_blocks_sharded, fused_blocks_fastq_sharded,
                    fused_blocks_sharded, make_blocks, make_blocks_fastq, stats_blocks_sharded,
                    stitch_lengths, stitch_runs)
from .mesh import BlockMesh, all_gather, block_mesh
from .pipeline import parse_fused_fasta, parse_fused_fastq

_GT = ord(">")
_LF = ord("\n")


class _Chars:
    """Size-only stand-in for ``NativeScan.seq`` (the device path never
    needs the expanded char stream on the host, only its length)."""

    __slots__ = ("size",)

    def __init__(self, n: int):
        self.size = n


def _stitch_packed_stream(packed_rows: np.ndarray, counts: np.ndarray,
                          first_codes: np.ndarray, pack_carry: Optional[int]) -> np.ndarray:
    """Per-block even-aligned payloads -> chunk nibble stream with carry.

    The boundary algebra of ``block.stitch_packed``, but the stream starts
    at the global parity that ``pack_carry`` implies (a pending low nibble
    means the char count so far is odd), and a trailing half byte is
    emitted as a last byte, which the feed loop strips off by its own
    parity count, as it does for ``native.host.scan``'s packed output.
    """
    pieces: list[np.ndarray] = []
    parity = 1 if pack_carry is not None else 0
    pending = pack_carry
    for d in range(counts.shape[0]):
        cnt = int(counts[d])
        if cnt == 0:
            continue
        if parity % 2 == 1:
            pieces.append(np.asarray([pending | (int(first_codes[d]) << 4)], dtype=np.uint8))
            pending = None
            packed_chars = cnt - 1
        else:
            packed_chars = cnt
        nbytes = packed_chars // 2
        pieces.append(np.ascontiguousarray(packed_rows[d][:nbytes]))
        if packed_chars % 2:
            pending = int(packed_rows[d][nbytes]) & 0x0F
        parity += cnt
    if pending is not None:
        pieces.append(np.asarray([pending], dtype=np.uint8))
    if not pieces:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(pieces)


def _merge_mask(runs: np.ndarray, state_first: bool, mask_on: bool,
                mask_run: int) -> tuple[np.ndarray, bool, int]:
    """Chunk mask runs + carried open run -> (completed units, new tail).

    The native scanner's ``F_NO_MASK_FLUSH`` contract: the carried run
    merges with the chunk's first run when the cases agree, else it
    completes (a 0-length completion at the stream's start gives the
    reference's leading-0 unit, ennaf/src/encoders.c:98-123); the chunk's
    last run stays open.
    """
    if runs.size == 0:
        return np.zeros(0, np.uint8), mask_on, mask_run
    runs = runs.astype(np.int64, copy=True)
    if bool(state_first) == bool(mask_on):
        runs[0] += mask_run
    else:
        runs = np.concatenate([np.asarray([mask_run], np.int64), runs])
    units = runs_to_units(runs[:-1])
    tail_on = bool(mask_on) ^ ((runs.size - 1) % 2 == 1)
    return units, tail_on, int(runs[-1])


class DeviceScanEngine:
    """Scan engine over a block mesh, plug-compatible with
    ``native.host.scan``.

    ``mesh`` gives one block of each piece to each of its devices; without
    it, ``device`` names the one card (the current one by default).  The
    CPU runs the kernels' plain versions and is used only when asked for.
    ``device_chunks`` and ``native_chunks`` count the pieces each scanner
    took; ``device.ROUTES`` names each piece's way.
    """

    #: pipeline/stream.py trims giant-record pieces to line starts for an
    #: engine with this flag, so a block never resumes mid-line
    line_aligned = True

    def __init__(self, device="cuda", mesh: Optional[BlockMesh] = None):
        self.mesh = mesh if mesh is not None else block_mesh(devices=[device])
        self.device = self.mesh.devices[0]
        self.device_chunks = 0
        self.native_chunks = 0

    def scan(self, data, *, fastq: bool, seq_type: int, strict: bool,
             well_formed: bool, do_mask: bool, do_upper: bool,
             marker_pos: int, threads: int = 0, flags: int = 0,
             prev_eol: bool = False, mask_on: bool = False,
             mask_run: int = 0, len_carry: int = 0, line_carry: int = 0,
             pack_carry: Optional[int] = None,
             scratch: Optional[dict] = None) -> "native.NativeScan":
        def delegate(why: str):
            self.native_chunks += 1
            count_route(f"stream_host:{why}")
            return native.scan(
                data, fastq=fastq, seq_type=seq_type, strict=strict,
                well_formed=well_formed, do_mask=do_mask, do_upper=do_upper,
                marker_pos=marker_pos, threads=threads, flags=flags,
                prev_eol=prev_eol, mask_on=mask_on, mask_run=mask_run,
                len_carry=len_carry, line_carry=line_carry,
                pack_carry=pack_carry, scratch=scratch)

        if strict or well_formed or do_upper or seq_type > C.SEQ_TYPE_RNA:
            return delegate("host_mode")
        cont = bool(flags & native.F_CONT_SEQ)
        if cont and (not prev_eol or line_carry):
            return delegate("mid_line")     # a giant single line resumes mid-line

        body = np.frombuffer(data, np.uint8)[marker_pos + 1:]
        carry = dict(seq_type=seq_type, do_mask=do_mask, mask_on=mask_on, mask_run=mask_run,
                     pack_carry=pack_carry)
        if fastq:
            why, out = self._scan_fastq(
                body, allow_partial=bool(flags & native.F_ALLOW_PARTIAL), **carry)
        else:
            why, out = self._scan_fasta(body, cont=cont, len_carry=len_carry, **carry)
        if out is None:
            return delegate(why)
        self.device_chunks += 1
        count_route("stream_device" if why is None else f"stream_device:two_pass:{why}")
        return out

    # -- device passes ----------------------------------------------------

    def _passes(self, blocks, *, fastq: bool, seq_type: int, parity_odd_in: bool):
        """The blocks' fused encode, else their two-pass encode, fetched to
        the host: (None or the two-pass reason, the ``_build`` tuple)."""
        D = self.mesh.size
        xs = self.mesh.upload(blocks.data)
        parity = int(parity_odd_in)
        zero_hists = [np.zeros(257, np.uint64) for _ in range(4)]
        if fastq:
            outs = fused_blocks_fastq_sharded(xs, blocks.prev, parity, seq_type=seq_type)
            scal = all_gather(outs[3])
            parsed = parse_fused_fastq(D, scal, outs)
        else:
            packed, scal_d, tv, a = fused_blocks_sharded(xs, blocks.prev, blocks.starts_in_seq,
                                                         parity, seq_type=seq_type)
            scal = all_gather(scal_d)
            parsed = parse_fused_fasta(D, scal, packed, tv, a)
        if parsed is not None:
            return None, (parsed["counts"], parsed["id_bytes"], parsed["com_bytes"],
                          parsed.get("qual_bytes", np.zeros(D, np.int64)), parsed["n_rec"],
                          parsed["n_runs"], parsed["first_lower"], parsed["longest"],
                          zero_hists, parsed["em_np"])
        why = "sparse_overflow" if not scal[:, 3].all() else "unexpected_chars"
        stats, masks = stats_blocks_sharded(xs, blocks.prev, blocks.starts_in_seq,
                                            seq_type=seq_type, fastq=fastq, parity_base=parity)
        em_np = emit_blocks_sharded(xs, masks, stats, seq_type=seq_type, fastq=fastq,
                                    pack_nibbles=True)
        del masks
        cols = [np.asarray([st[k] for st in stats]) for k in STATS_KEYS]
        return why, (*cols, stats[0]["hists"], em_np)

    # -- stitching into a NativeScan-shaped result ---------------------------

    @staticmethod
    def _build(res, *, fastq: bool, cont: bool, do_mask: bool, len_carry: int,
               mask_on: bool, mask_run: int, pack_carry: Optional[int], consumed: int):
        """The ``NativeScan`` of one piece from its blocks' rows, or None
        when a FASTQ record's quality length differs from its sequence
        length (the native scanner raises the reference's text for it)."""
        (counts, id_bytes, com_bytes, qual_bytes, n_rec, n_runs,
         first_lower, longest, hists, em_np) = res
        (packed, first_codes, _cnt2, id_vals, com_vals, qual_vals,
         seq_lens, id_lens, com_lens, qual_lens, run_lens) = em_np
        D = counts.shape[0]

        def trim(arr2d):
            return [arr2d[k, : int(n_rec[k]) + 1] for k in range(D)]

        def cat(vals, sizes):
            return np.concatenate([vals[k, : int(sizes[k])] for k in range(D)])

        g_seq_lens = stitch_lengths(trim(seq_lens)).astype(np.uint64)
        if cont and g_seq_lens.size:
            g_seq_lens[0] += np.uint64(len_carry)
        g_id_lens = stitch_lengths(trim(id_lens))
        g_com_lens = stitch_lengths(trim(com_lens))
        if fastq:
            g_qual_lens = stitch_lengths(trim(qual_lens)).astype(np.uint64)
            if not np.array_equal(g_qual_lens, g_seq_lens):
                return None
        if cont:
            # segment 0 continues the previous piece's open record: its id
            # and comment (0 bytes) went out with that record's header piece
            g_id_lens = g_id_lens[1:]
            g_com_lens = g_com_lens[1:]

        out = native.NativeScan()
        out.seq = _Chars(int(counts.sum()))
        out.packed = _stitch_packed_stream(packed, counts, first_codes, pack_carry)
        out.ids_blob = blob_from_lens(cat(id_vals, id_bytes), g_id_lens)
        out.comments_blob = blob_from_lens(cat(com_vals, com_bytes), g_com_lens)
        out.lengths = g_seq_lens
        out.n_sequences = int(g_seq_lens.size)
        if fastq:
            out.qual = cat(qual_vals, qual_bytes)
            out.longest_line = int(g_seq_lens.max(initial=0))
        else:
            out.qual = np.zeros(0, np.uint8)
            out.longest_line = int(longest[0])
        if do_mask:
            runs, state_first = stitch_runs([run_lens[k, : int(n_runs[k])] for k in range(D)],
                                            [bool(first_lower[k]) for k in range(D)])
            units, tail_on, tail_run = _merge_mask(runs, state_first, mask_on, mask_run)
        else:
            units, tail_on, tail_run = np.zeros(0, np.uint8), mask_on, mask_run
        out.mask_units = units
        out.mask_tail_on = tail_on
        out.mask_tail_run = tail_run
        (out.unexpected_id, out.unexpected_comment, out.unexpected_seq,
         out.unexpected_qual) = hists
        out.end_state = 2       # line-aligned pieces always end in a sequence
        out.end_line_len = 0
        out.consumed = consumed
        return out

    # -- format-specific front halves ---------------------------------------

    def _scan_fasta(self, body: np.ndarray, *, cont: bool, seq_type: int, do_mask: bool,
                    len_carry: int, mask_on: bool, mask_run: int, pack_carry: Optional[int]):
        if body.size and not C.IS_EOL[body[-1]]:
            # the piece ends mid-line: the open line's length must carry
            # (end_line_len), which only the native scanner reports
            return "open_line", None
        blocks = make_blocks(body, self.mesh.size, prev0=(_LF if cont else _GT), sis0=cont)
        why, res = self._passes(blocks, fastq=False, seq_type=seq_type,
                                parity_odd_in=pack_carry is not None)
        return why, self._build(res, fastq=False, cont=cont, do_mask=do_mask,
                                len_carry=len_carry, mask_on=mask_on, mask_run=mask_run,
                                pack_carry=pack_carry, consumed=int(body.size))

    def _scan_fastq(self, body: np.ndarray, *, allow_partial: bool, seq_type: int,
                    do_mask: bool, mask_on: bool, mask_run: int, pack_carry: Optional[int]):
        if body.size == 0:
            return "no_full_record", None
        if allow_partial:
            eols = np.flatnonzero(body == _LF)
            n_complete = eols.size // 4
            if n_complete == 0:
                return "no_full_record", None    # the native scanner reports consumed
            consumed = int(eols[4 * n_complete - 1]) + 1
            sub = body[:consumed]
        else:
            consumed = int(body.size)
            sub = body
        mb = make_blocks_fastq(sub, self.mesh.size)
        if mb is None:
            return "fastq_irregular", None
        why, res = self._passes(mb[0], fastq=True, seq_type=seq_type,
                                parity_odd_in=pack_carry is not None)
        out = self._build(res, fastq=True, cont=False, do_mask=do_mask, len_carry=0,
                          mask_on=mask_on, mask_run=mask_run, pack_carry=pack_carry,
                          consumed=consumed)
        return ("qual_length_mismatch", None) if out is None else (why, out)
