"""Chunked (bounded-memory) device encode: the device encode as a
streaming scan engine.

The port's copy of ``naf_tpu/parallel/stream.py``.  ``DeviceScanEngine.scan``
speaks the carry protocol of ``native.host.scan`` (the feed loop in
``pipeline/stream.py``): the held nibble, the open mask run, the open
record's length, ``F_CONT_SEQ`` and ``F_ALLOW_PARTIAL``.  So
``encode_stream(..., engine=DeviceScanEngine())`` writes the archive of the
host path while each piece's per-byte work (classify, compaction, pack,
mask runs) runs on the card, at O(chunk) host and device memory.

Each piece's blocks take the passes of ``encode_device``
(``pipeline.device_passes``): the fused path first, and where that
declines (``sparse_overflow``, ``unexpected_chars``) the two-pass protocol
on the same uploaded blocks.  The rows come back to host numpy before
``scan`` returns, so no device tensor outlives its piece, and take
``encode_device``'s stitch (``block.stitch_rows``), the stream's carries
applied on top.  Pieces
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
from .block import make_blocks, make_blocks_fastq, stitch_rows
from .mesh import BlockMesh, block_mesh
from .pipeline import device_passes

_GT = ord(">")
_LF = ord("\n")


class _Chars:
    """Size-only stand-in for ``NativeScan.seq`` (the device path never
    needs the expanded char stream on the host, only its length)."""

    __slots__ = ("size",)

    def __init__(self, n: int):
        self.size = n


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

    # -- device passes, and the piece's NativeScan -------------------------

    def _encode(self, blocks, *, fastq: bool, seq_type: int, cont: bool, do_mask: bool,
                len_carry: int, mask_on: bool, mask_run: int, pack_carry: Optional[int],
                consumed: int):
        """(None or the two-pass reason, the ``NativeScan`` of one piece), or
        (``qual_length_mismatch``, None) when a FASTQ record's quality length
        differs from its sequence length (the native scanner raises the
        reference's text)."""
        xs = self.mesh.upload(blocks.data)
        why, rows = device_passes(xs, blocks, fastq=fastq, seq_type=seq_type,
                                  parity=int(pack_carry is not None))
        del xs          # the blocks' device memory goes back before the host stitch
        st = stitch_rows(rows, fastq=fastq, mask=do_mask, held=pack_carry)
        if st is None:
            return "qual_length_mismatch", None
        lengths = st.seq_lens.astype(np.uint64)
        ids, comments = st.ids_blob, st.comments_blob
        if cont:
            lengths[0] += np.uint64(len_carry)
            # segment 0 continues the previous piece's open record: its id
            # and comment (0 bytes, so the blobs' first terminators) went
            # out with that record's header piece
            assert ids[:1] == comments[:1] == b"\0"
            ids, comments = ids[1:], comments[1:]

        out = native.NativeScan()
        out.seq = _Chars(int(rows.counts.sum()))
        out.packed = st.seq
        out.ids_blob = ids
        out.comments_blob = comments
        out.lengths = lengths
        out.n_sequences = int(lengths.size)
        if fastq:
            out.qual = st.qual
            out.longest_line = int(lengths.max(initial=0))
        else:
            out.qual = np.zeros(0, np.uint8)
            out.longest_line = int(rows.longest[0])
        if do_mask:
            units, tail_on, tail_run = _merge_mask(st.runs, st.first_lower, mask_on, mask_run)
        else:
            units, tail_on, tail_run = np.zeros(0, np.uint8), mask_on, mask_run
        out.mask_units = units
        out.mask_tail_on = tail_on
        out.mask_tail_run = tail_run
        (out.unexpected_id, out.unexpected_comment, out.unexpected_seq,
         out.unexpected_qual) = rows.hists
        out.end_state = 2       # line-aligned pieces always end in a sequence
        out.end_line_len = 0
        out.consumed = consumed
        return why, out

    # -- format-specific front halves ---------------------------------------

    def _scan_fasta(self, body: np.ndarray, *, cont: bool, seq_type: int, do_mask: bool,
                    len_carry: int, mask_on: bool, mask_run: int, pack_carry: Optional[int]):
        if body.size and not C.IS_EOL[body[-1]]:
            # the piece ends mid-line: the open line's length must carry
            # (end_line_len), which only the native scanner reports
            return "open_line", None
        blocks = make_blocks(body, self.mesh.size, prev0=(_LF if cont else _GT), sis0=cont)
        return self._encode(blocks, fastq=False, seq_type=seq_type, cont=cont, do_mask=do_mask,
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
        return self._encode(mb[0], fastq=True, seq_type=seq_type, cont=False, do_mask=do_mask,
                            len_carry=0, mask_on=mask_on, mask_run=mask_run,
                            pack_carry=pack_carry, consumed=consumed)
