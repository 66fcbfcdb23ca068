"""Streaming (bounded-memory) encoder.

The port's copy of ``naf_tpu/pipeline/stream.py``.  The in-memory
pipeline (``encoder.encode``) holds the whole input plus scan outputs;
this module processes the input in chunks with carry state across chunk
boundaries (nibble parity, mask-run state, open-record length, open-line
length):

  * FASTA chunks split at record starts; a record larger than the chunk
    budget continues across chunks via the scanner's CONT_SEQ state;
  * FASTQ chunks stop after the last complete record (the scanner rewinds
    to its per-record snapshot and reports `consumed`);
  * zstd sections are fed incrementally (SectionCompressor streams), and
    with a temp dir spill to it past a threshold
    (SpillingSectionCompressor), so peak memory is O(chunk + compressed
    output).

Produces archives byte-identical to ``encoder.encode`` for the same input
and options.  ``tnaf`` takes this path for pipes and for files of
``NAF_TPU_STREAM_THRESHOLD`` (256 MiB) or more; with ``--device`` the
pieces go through ``parallel.stream.DeviceScanEngine`` (``engine=``).
Under ``NAF_TPU_TRACE`` each piece's scan prints a ``scan`` span.

Reference parity: ennaf/src/process.c 1 MB parse buffers; compressor.c
2 MB section buffers + temp-file spill.
"""

from __future__ import annotations

import os
from typing import BinaryIO, Optional

import numpy as np

from ..codec import SectionCompressor, SpillingSectionCompressor
from ..format import constants as C
from ..format.container import NafArchive, NafHeader, Section, write_naf
from ..native import host as native
from ..utils.trace import trace_span
from . import parser as P
from .encoder import EncodeOptions, EncodeStats, split_lengths

_LF = ord("\n")
_GT = ord(">")
_AT = ord("@")

# Chunk size scales with cores: small chunks keep the scratch footprint
# low on small machines, while many-core hosts get chunks big enough for
# the multithreaded scanner to fan out. Output bytes do not depend on the
# chunk size (SectionCompressor normalizes feed granularity).
DEFAULT_CHUNK = max(4, min(32, 2 * (os.cpu_count() or 2))) << 20


def _last_line_start(buf: np.ndarray) -> int:
    """Index just after the last EOL byte, or 0 (backward windowed search)."""
    n = buf.size
    hi = n
    step = 1 << 16
    while hi > 0:
        lo = max(0, hi - step)
        eols = np.flatnonzero(C.IS_EOL[buf[lo:hi]])
        if eols.size:
            return lo + int(eols[-1]) + 1
        hi = lo
        step = min(step * 4, 8 << 20)
    return 0


def _last_record_start(buf: np.ndarray) -> int:
    """Index of the last '>' preceded by an EOL byte, or -1.

    Searches backwards in growing windows: the hit is normally within the
    last record, so this touches O(tail) bytes instead of scanning the
    whole chunk (a full 32 MB scan costs ~100 ms of allocator+memory
    traffic per chunk).
    """
    n = buf.size
    hi = n
    step = 1 << 16
    while hi > 0:
        lo = max(0, hi - step)
        win = buf[lo:hi]
        gts = np.flatnonzero(win == _GT)
        for g in gts[::-1]:
            gi = lo + int(g)
            if gi > 0 and C.IS_EOL[buf[gi - 1]]:
                return gi
        hi = lo
        step = min(step * 4, 8 << 20)
    return -1


class _SectionSet:
    def __init__(self, opts: EncodeOptions):
        lvl, th = opts.level, opts.threads

        def make(section: str, window_log: int = 0):
            if opts.temp_dir:
                return SpillingSectionCompressor(
                    lvl, window_log=window_log, threads=th, temp_dir=opts.temp_dir,
                    name=opts.temp_name, section=section, keep=opts.keep_temp_files)
            return SectionCompressor(lvl, window_log=window_log, threads=th)

        self.ids = make("ids")
        self.comments = make("comm")
        self.lengths = make("len")
        self.mask = make("mask")
        self.seq = make("seq", opts.long_window_log)
        self.qual = make("qual")


class _WriteBehind:
    """Ordered background zstd feeder: overlaps compression with the next
    chunk's scan (zstandard releases the GIL inside compress)."""

    def __init__(self):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=4)
        self._err: list = []

        def run():
            while True:
                item = self._q.get()
                if item is None:
                    return
                sc, data = item
                if sc is None:      # fence marker: everything before is done
                    data.set()
                    continue
                try:
                    sc.write(data)
                except BaseException as e:   # surfaced on join
                    self._err.append(e)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def write(self, sc: SectionCompressor, data) -> None:
        if self._err:
            raise self._err[0]
        self._q.put((sc, data))

    def fence(self) -> "threading.Event":
        """Event set once all previously queued writes have completed.

        Lets callers hand zero-copy scratch views to the worker: a scratch
        buffer may be reused as soon as its fence is set."""
        import threading

        ev = threading.Event()
        if self._err:       # worker may be dead; don't deadlock waiters
            ev.set()
            raise self._err[0]
        self._q.put((None, ev))
        return ev

    def join(self) -> None:
        if self._t.is_alive():
            self._q.put(None)
            self._t.join()
        if self._err:
            err = self._err[0]
            self._err.clear()
            raise err


def encode_stream(inf: BinaryIO, outf: BinaryIO,
                  opts: Optional[EncodeOptions] = None, *,
                  chunk_size: int = DEFAULT_CHUNK,
                  engine=None) -> EncodeStats:
    """Stream-encode FASTA/FASTQ from `inf` into a NAF archive on `outf`.

    ``engine`` swaps the per-piece scanner: None means the native host
    scanner (``native.host.scan``); an object with a compatible ``.scan``
    (and, if its pieces must start at line starts, ``line_aligned``) runs
    the pieces elsewhere and must give the same archive bytes.
    """
    from ..utils.malloc import tune_for_large_buffers

    tune_for_large_buffers()
    opts = opts or EncodeOptions()
    stats = EncodeStats(
        unexpected_id=np.zeros(257, np.uint64),
        unexpected_comment=np.zeros(257, np.uint64),
        unexpected_seq=np.zeros(257, np.uint64),
        unexpected_qual=np.zeros(257, np.uint64),
    )

    text_like = opts.seq_type >= C.SEQ_TYPE_PROTEIN
    store_mask = not opts.no_mask and not text_like
    nuc = not text_like

    # ---- first chunk: format detection ------------------------------------
    head = inf.read(chunk_size)
    fmt, marker = P.detect_format(head) if head else (C.IN_FORMAT_UNKNOWN, -1)
    while fmt == C.IN_FORMAT_UNKNOWN and head is not None:
        more = inf.read(chunk_size)
        if not more:
            break
        head += more
        fmt, marker = P.detect_format(head)
    if (opts.in_format != C.IN_FORMAT_UNKNOWN and fmt != C.IN_FORMAT_UNKNOWN
            and opts.in_format != fmt):
        raise P.InputError(
            "input format is different from format specified in the command line")
    stats.in_format = fmt
    is_fastq = fmt == C.IN_FORMAT_FASTQ
    store_qual = is_fastq

    secs = _SectionSet(opts)
    wb = _WriteBehind()
    # Two scratch sets alternate between iterations so scan outputs can be
    # handed to the write-behind compressor without copying: scratch k may
    # be reused once its fence (queued after chunk k's writes) is set.
    scratches: tuple[dict, dict] = ({}, {})
    fences: list = [None, None]
    it = 0

    # carry state
    total_chars = 0
    pending_nibble: Optional[int] = None
    mask_on, mask_run = False, 0
    open_len = 0          # chars of the record continuing into the next chunk
    open_line = 0
    cont = False          # FASTA: next piece resumes mid-record
    prev_eol = False
    n_records = 0
    longest = 0
    held_length: Optional[int] = None   # FASTA CONT: open record's length

    def feed_common(s: "native.NativeScan", *, drop_last_length: bool,
                    cont_in: bool) -> None:
        nonlocal total_chars, pending_nibble, mask_on, mask_run
        nonlocal n_records, longest, held_length
        chars = int(s.seq.size)
        # packed stream: hold back the trailing half byte
        if nuc:
            new_total = total_chars + chars
            pk = s.packed
            if pending_nibble is not None and chars == 0:
                pass   # nothing emitted; pending byte unchanged
            elif new_total % 2 == 1:
                if pk.size:
                    wb.write(secs.seq, pk[:-1])
                    pending_nibble = int(pk[-1]) & 0x0F
            else:
                wb.write(secs.seq, pk)
                pending_nibble = None
            total_chars = new_total
        else:
            wb.write(secs.seq,
                     s.seq if not opts.no_mask else C.TOUPPER[s.seq])
            total_chars += chars
        if store_mask:
            wb.write(secs.mask, s.mask_units)
            mask_on, mask_run = s.mask_tail_on, s.mask_tail_run
        wb.write(secs.ids, np.frombuffer(s.ids_blob, np.uint8))
        wb.write(secs.comments, np.frombuffer(s.comments_blob, np.uint8))
        lengths = s.lengths     # with cont_in, lengths[0] includes len_carry
        if drop_last_length and lengths.size:
            held_length = int(lengths[-1])
            lengths = lengths[:-1]
        else:
            held_length = None
        if lengths.size:
            wb.write(secs.lengths, split_lengths(lengths).tobytes())
        n_records += int(s.n_sequences) - (1 if cont_in else 0)
        if s.longest_line > longest:
            longest = int(s.longest_line)
        stats.unexpected_id += s.unexpected_id
        stats.unexpected_comment += s.unexpected_comment
        stats.unexpected_seq += s.unexpected_seq
        stats.unexpected_qual += s.unexpected_qual
        if store_qual:
            wb.write(secs.qual, s.qual)
        # the views queued above alias scratch buffers; fence before reuse
        nonlocal it
        fences[it & 1] = wb.fence()
        it += 1

    base_flags = native.F_NO_MASK_FLUSH if store_mask else 0

    def scan_piece(piece: bytes, *, fastq: bool, extra_flags: int = 0,
                   cont_in: bool = False) -> "native.NativeScan":
        fence = fences[it & 1]
        if fence is not None:
            fence.wait()
        scratch = scratches[it & 1]
        scan_fn = native.scan if engine is None else engine.scan
        try:
            with trace_span("scan", bytes=len(piece)):
                return scan_fn(
                    piece, fastq=fastq, seq_type=opts.seq_type,
                    strict=opts.strict, well_formed=opts.well_formed,
                    do_mask=store_mask, do_upper=False, marker_pos=-1,
                    flags=base_flags | extra_flags
                    | (native.F_CONT_SEQ if cont_in else 0),
                    prev_eol=prev_eol, mask_on=mask_on, mask_run=mask_run,
                    len_carry=open_len if cont_in else 0,
                    line_carry=open_line if cont_in else 0,
                    pack_carry=pending_nibble, scratch=scratch)
        except native.NativeScanError as e:
            e2 = native.NativeScanError(e.code, e.record + n_records,
                                        e.char, e.a, e.b)
            raise P._native_error(e2, opts.seq_type, opts.well_formed) from None

    if fmt != C.IN_FORMAT_UNKNOWN:
      try:
        carry = head[marker + 1:]
        del head
        eof = False
        strip_pending = False   # FASTQ: next record's '@' is still unread
        need = chunk_size   # grow paths raise this to accumulate a record
        while True:
            # top up to the target size before processing (avoids scanning
            # double-size first pieces and bounds per-piece work)
            while not eof and len(carry) < need:
                chunk = inf.read(need - len(carry))
                if not chunk:
                    eof = True
                else:
                    carry = carry + chunk if carry else chunk
            buf = carry
            carry = b""

            if is_fastq:
                if strip_pending and buf:
                    # the previous piece consumed its whole buffer, so the
                    # next record's leading EOLs + '@' arrive in THIS read
                    # and must be stripped here (pieces start after '@')
                    ab = np.frombuffer(buf, np.uint8)
                    nzb = np.flatnonzero(~C.IS_EOL[ab].astype(bool))
                    if nzb.size == 0:
                        if eof:
                            break          # trailing EOLs only
                        carry = buf
                        need = len(buf) + chunk_size
                        continue
                    fb = int(nzb[0])
                    if ab[fb] != _AT:
                        raise P.InputError(
                            "invalid FASTQ input: Can't find '@' after "
                            f"sequence {n_records}")
                    buf = buf[fb + 1:]
                    strip_pending = False
                if not buf and eof:
                    break
                if eof:
                    s = scan_piece(buf, fastq=True)
                    feed_common(s, drop_last_length=False, cont_in=False)
                    break
                s = scan_piece(buf, fastq=True,
                               extra_flags=native.F_ALLOW_PARTIAL)
                if s.consumed == 0:
                    carry = buf   # no full record yet: grow the buffer
                    need = len(buf) + chunk_size
                    continue
                need = chunk_size
                feed_common(s, drop_last_length=False, cont_in=False)
                tail = np.frombuffer(buf, np.uint8)[s.consumed:]
                nz = np.flatnonzero(~C.IS_EOL[tail].astype(bool))
                if nz.size == 0:
                    carry = b""
                    strip_pending = True   # next record's '@' not read yet
                    continue
                first = int(nz[0])
                if tail[first] != _AT:
                    raise P.InputError(
                        "invalid FASTQ input: Can't find '@' after sequence "
                        f"{n_records}")
                carry = tail[first + 1:].tobytes()
                continue

            # ---- FASTA ----------------------------------------------------
            if eof:
                s = scan_piece(buf, fastq=False, cont_in=cont)
                feed_common(s, drop_last_length=False, cont_in=cont)
                break
            arr = np.frombuffer(buf, np.uint8)
            p = _last_record_start(arr)
            if p > 0:
                piece, carry = buf[:p], buf[p + 1:]  # strip the '>' marker
                need = chunk_size
                s = scan_piece(piece, fastq=False, cont_in=cont)
                feed_common(s, drop_last_length=False, cont_in=cont)
                cont = False
                open_len = open_line = 0
                continue
            if len(buf) < 2 * chunk_size:
                carry = buf        # record spans the chunk: accumulate
                need = len(buf) + chunk_size
                continue
            # giant record: process the whole buffer mid-record
            need = chunk_size
            piece = buf
            if engine is not None and getattr(engine, "line_aligned", False):
                # device blocks resume at line starts; carry the partial
                # tail line (a whole buffer with no EOL falls through and
                # the engine delegates that piece to the native scanner)
                q = _last_line_start(arr)
                if q > 0:
                    piece, carry = buf[:q], buf[q:]
            s = scan_piece(piece, fastq=False, cont_in=cont)
            if s.end_state != 2:   # ended inside a header: unsupported
                raise P.InputError(
                    "sequence header too long for streaming mode")
            feed_common(s, drop_last_length=True, cont_in=cont)
            open_len = held_length or 0
            open_line = s.end_line_len
            prev_eol = C.IS_EOL[piece[-1]] if piece else False
            cont = True

      except BaseException:
        wb.join()
        raise

    # ---- finalize ----------------------------------------------------------
    wb.join()
    if nuc and pending_nibble is not None:
        secs.seq.write(np.asarray([pending_nibble], np.uint8))
    if store_mask and mask_run > 0:
        units = []
        run = mask_run
        while run >= 255:
            units.append(255)
            run -= 255
        units.append(run)
        secs.mask.write(np.asarray(units, np.uint8))

    stats.n_sequences = n_records
    stats.longest_line = longest
    stats.seq_size_original = total_chars

    def fin(sc: SectionCompressor, size: Optional[int] = None) -> Section:
        payload = sc.finish()
        return Section(
            uncompressed_size=sc.uncompressed_size if size is None else size,
            payload=payload)

    sections = {
        "ids": fin(secs.ids),
        "comments": fin(secs.comments),
        "lengths": fin(secs.lengths),
        "sequence": fin(secs.seq, size=total_chars),
    }
    if store_mask:
        sections["mask"] = fin(secs.mask)
    if store_qual:
        sections["quality"] = fin(secs.qual)

    header = NafHeader(
        format_version=1 if opts.seq_type == C.SEQ_TYPE_DNA else 2,
        seq_type=opts.seq_type,
        has_title=opts.title is not None,
        has_ids=True, has_comments=True, has_lengths=True,
        has_mask=store_mask, has_sequence=True, has_quality=store_qual,
        line_length=opts.line_length if opts.line_length is not None else longest,
        n_sequences=n_records,
    )
    archive = NafArchive(
        header=header,
        title=opts.title.encode() if opts.title is not None else None,
        sections=sections,
    )
    write_naf(outf, archive)
    return stats
