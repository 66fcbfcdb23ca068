"""Device FASTA and FASTQ encode on one device: bytes -> block -> NAF
archive.

``encode_device`` is the one-device counterpart of
``naf_tpu/parallel/pipeline.py:encode_sharded``.  A nucleotide block first
takes the fused path (``_try_encode_fused``, ``_try_encode_fused_fastq``):
one emit kernel classifies, compacts and packs it.  Where that path cannot
finish (a tile past the sparse cap, or unexpected characters, whose
histograms only the stats pass gives) and for protein and text, the same
uploaded block takes the two-pass protocol: ``stats_block`` counts, then
``emit_block`` compacts every section to the counted sizes.  The host
stitches the sections and writes the container through the shared
``build_archive``, so the archive is byte-identical to host ``encode()``.

Each way is a route counted in ``device.ROUTES``: ``encode_device`` (fused),
``encode_device:two_pass:<why>`` (``text_like``, ``sparse_overflow``,
``unexpected_chars``), and the host routes, which give host ``encode()``
the same bytes: not FASTA or FASTQ, an unsafe ``--well-formed`` input, a
FASTQ off the regular 4-line grid, ``--strict`` with unexpected characters
(the host raises the reference's message), or a FASTQ record whose quality
length differs from its sequence length (likewise).

The host helpers below are jax-free copies of the reference's
(``_wf_device_safe``, ``_pad2d``, ``parse_fused_fasta``,
``parse_fused_fastq``, ``_stitch_and_build``); the tests hold each against
its original.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import count_route, resolve
from ..format import constants as C
from ..ops.mask import runs_to_units
from ..ops.tables_np import NUC_CODE
from ..pipeline import parser as P
from ..pipeline.encoder import EncodeOptions, EncodeStats, build_archive, encode
from .block import (STATS_KEYS, blob_from_lens, emit_block, fused_block, fused_block_fastq,
                    make_blocks, make_blocks_fastq, stats_block, stitch_lengths, stitch_packed,
                    stitch_runs)


def _host(a) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _host_route(reason: str, data: bytes, opts: EncodeOptions):
    count_route(f"encode_host:{reason}")
    return encode(data, opts)


def encode_device(data: bytes, opts: Optional[EncodeOptions] = None, *, device
                  ) -> tuple[bytes, EncodeStats]:
    """FASTA or FASTQ encode with the kernels on ``device`` ('cuda' or,
    asked for explicitly, 'cpu' for the plain versions); archive bytes equal
    host ``encode(data, opts)``."""
    dev = resolve(device)
    opts = opts or EncodeOptions()
    fmt, marker = P.detect_format(data)
    if (opts.in_format != C.IN_FORMAT_UNKNOWN and fmt != C.IN_FORMAT_UNKNOWN
            and opts.in_format != fmt):
        raise P.InputError(
            "input format is different from format specified in the command line")
    fastq = fmt == C.IN_FORMAT_FASTQ
    if not fastq and fmt != C.IN_FORMAT_FASTA:
        return _host_route("not_fasta", data, opts)
    body = np.frombuffer(data, np.uint8)[marker + 1:]
    if opts.well_formed and not _wf_device_safe(body, fastq):
        return _host_route("well_formed_unsafe", data, opts)
    if fastq:
        mb = make_blocks_fastq(body, 1)
        if mb is None:
            return _host_route("fastq_irregular", data, opts)
        blocks = mb[0]
    else:
        blocks = make_blocks(body, 1)
    # one upload, shared by the fused attempt and the two-pass protocol
    x = torch.from_numpy(blocks.data[0]).to(dev)
    prev, sis = int(blocks.prev[0]), bool(blocks.starts_in_seq[0])
    mismatch = []

    def fallback():
        mismatch.append(True)
        return _host_route("qual_length_mismatch", data, opts)

    if opts.seq_type >= C.SEQ_TYPE_PROTEIN:
        why = "text_like"
    else:
        why, out = (_encode_fused_fastq if fastq else _encode_fused)(x, prev, sis, fmt, opts,
                                                                     fallback)
        if why is None:
            if not mismatch:
                count_route("encode_device")
            return out
    out = _encode_two_pass(x, prev, sis, fmt, opts, fallback)
    if out is not None and not mismatch:
        count_route(f"encode_device:two_pass:{why}")
    return out if out is not None else _host_route("strict_unexpected", data, opts)


def _encode_fused(x, prev: int, sis: bool, fmt: int, opts: EncodeOptions, fallback):
    """The fused FASTA path (``_try_encode_fused``): (None, archive), or
    (why, None) when the two-pass protocol must take the block."""
    packed_d, scal_d, tv_d, a_d = fused_block(x, prev, sis, 0, seq_type=opts.seq_type,
                                              device=x.device)
    scal = _host(scal_d)
    if not scal[:, 3].all():
        return "sparse_overflow", None
    if scal[:, 4:7].any():
        return "unexpected_chars", None
    parsed = parse_fused_fasta(1, scal, packed_d, tv_d, a_d)
    zero_hists = [np.zeros(257, np.uint64) for _ in range(4)]
    return None, _stitch_and_build(
        1, fmt, opts, parsed["counts"], parsed["id_bytes"], parsed["com_bytes"],
        np.zeros(1, np.int64), parsed["n_rec"], parsed["n_runs"], parsed["first_lower"],
        parsed["longest"], zero_hists, parsed["em_np"], fallback=fallback)


def _encode_fused_fastq(x, prev: int, sis: bool, fmt: int, opts: EncodeOptions, fallback):
    """The fused FASTQ path (``_try_encode_fused_fastq``), as
    ``_encode_fused``."""
    outs = fused_block_fastq(x, prev, 0, seq_type=opts.seq_type, device=x.device)
    scal = _host(outs[3])
    if not scal[:, 3].all():
        return "sparse_overflow", None
    if scal[:, 4:7].any() or scal[:, 12].any():
        return "unexpected_chars", None
    parsed = parse_fused_fastq(1, scal, outs)
    zero_hists = [np.zeros(257, np.uint64) for _ in range(4)]
    return None, _stitch_and_build(
        1, fmt, opts, parsed["counts"], parsed["id_bytes"], parsed["com_bytes"],
        parsed["qual_bytes"], parsed["n_rec"], parsed["n_runs"], parsed["first_lower"],
        parsed["longest"], zero_hists, parsed["em_np"], fallback=fallback)


def _encode_two_pass(x, prev: int, sis: bool, fmt: int, opts: EncodeOptions, fallback):
    """The two-pass protocol on the uploaded block (``encode_sharded``
    after its fused attempt); None when ``--strict`` meets an unexpected
    character, whose exact message only the host parser gives."""
    fastq = fmt == C.IN_FORMAT_FASTQ
    stats, masks = stats_block(x, prev, sis, seq_type=opts.seq_type, fastq=fastq)
    if opts.strict and any(h.any() for h in stats["hists"]):
        return None
    em_np = emit_block(x, masks, stats, seq_type=opts.seq_type, fastq=fastq,
                       pack_nibbles=opts.seq_type < C.SEQ_TYPE_PROTEIN)
    del masks
    return build_two_pass(fmt, opts, stats, em_np, fallback=fallback)


def build_two_pass(fmt: int, opts: EncodeOptions, stats: dict, em_np: list, fallback):
    """``_stitch_and_build`` of one block's ``stats_block`` and
    ``emit_block`` results."""
    one = [np.asarray([stats[k]]) for k in STATS_KEYS]
    return _stitch_and_build(1, fmt, opts, *one, stats["hists"], em_np, fallback=fallback)


# ---------------------------------------------------------------------------
# host helpers (copies of naf_tpu.parallel.pipeline)
# ---------------------------------------------------------------------------

def _wf_device_safe(body: np.ndarray, fastq: bool) -> bool:
    """True when --well-formed parsing provably equals robust parsing.

    The wf fast path (ennaf/src/process.c:314-355, tables.c:46-69) treats
    only LF and ' ' as whitespace and skips char validation.  Robust
    classification produces identical bytes iff the input contains no
    TAB/VT/FF/CR and no ' ' outside header lines (spaces ON header lines
    behave identically: the first ends the id, the rest are comment bytes
    under both tables).  Char validation differences surface as nonzero
    unexpected-char counts and route the input to the host.
    """
    if body.size == 0:
        return True
    if np.any((body == 9) | (body == 11) | (body == 12) | (body == 13)):
        return False
    sp = np.flatnonzero(body == 32)
    if sp.size == 0:
        return True
    eol = np.flatnonzero(body == 10)
    line_id = np.searchsorted(eol, sp)        # line index of each space
    if fastq:
        return bool(np.all(line_id % 4 == 0))
    starts = np.concatenate([[0], eol + 1])   # start byte of each line
    first = body[np.minimum(starts[line_id], body.size - 1)]
    # line 0 is record 0's header (its '>' was stripped by the caller)
    return bool(np.all((line_id == 0) | (first == ord(">"))))


def _pad2d(D, rows, dtype=np.int32):
    w = max(max((r.size for r in rows), default=0), 1)
    out = np.zeros((D, w), dtype)
    for k, r in enumerate(rows):
        out[k, :r.size] = r
    return out


def parse_fused_fasta(D, scal, packed_d, tv_d, a_d):
    """Host parse of the fused FASTA outputs -> the em_np layout of the
    two-pass protocol.  The device arrays may be tensors on any device or
    numpy arrays; only their used prefixes are fetched.  Returns None when
    a tile overflowed the sparse cap or unexpected characters exist."""
    if not scal[:, 3].all() or scal[:, 4:7].any():
        return None

    counts = scal[:, 0].astype(np.int64)
    cnt_seq = scal[:, 1].astype(np.int64)
    n_sp = scal[:, 2].astype(np.int64)
    longest = np.full(D, int(scal[:, 7].max()))
    first_lower = scal[:, 8] == 2
    first_codes = NUC_CODE[scal[:, 9]]

    # sliced fetches: only used prefixes cross the host<->device link
    p_used = max(int((counts.max(initial=1) + 1) // 2) + 1, 1)
    packed = _host(packed_d[:, :p_used])
    m_sp = max(int(n_sp.max(initial=1)), 1)
    tv = _host(tv_d[:, :m_sp])
    av = _host(a_d[:, :m_sp])

    # host-side sparse parse: O(records + runs + header bytes)
    id_vals_l, com_vals_l = [], []
    seq_lens_l, id_lens_l, com_lens_l, run_lens_l = [], [], [], []
    n_rec = np.zeros(D, np.int64)
    n_runs = np.zeros(D, np.int64)
    for k in range(D):
        t = tv[k, :n_sp[k]] >> 8
        v = (tv[k, :n_sp[k]] & 0xFF).astype(np.uint8)
        a = av[k, :n_sp[k]].astype(np.int64)
        id_vals_l.append(v[t == 0])
        com_vals_l.append(v[t == 1])
        rec = t == 2
        n_rec[k] = int(rec.sum())
        bounds = np.concatenate([[0], a[rec], [cnt_seq[k]]])
        seq_lens_l.append(np.diff(bounds))
        at = np.flatnonzero(rec)
        for tag, sink in ((0, id_lens_l), (1, com_lens_l)):
            c = np.cumsum(t == tag)
            mid = c[at] if at.size else np.zeros(0, np.int64)
            sink.append(np.diff(np.concatenate(
                [[0], mid, [int((t == tag).sum())]])))
        j = a[t == 3]
        run_lens_l.append(np.diff(np.concatenate([[0], j, [counts[k]]]))
                          if counts[k] > 0 else np.zeros(0, np.int64))
        n_runs[k] = (j.size + 1) if counts[k] > 0 else 0

    em_np = [packed, first_codes, counts,
             _pad2d(D, id_vals_l, np.uint8), _pad2d(D, com_vals_l, np.uint8),
             np.zeros((D, 1), np.uint8),
             _pad2d(D, seq_lens_l), _pad2d(D, id_lens_l),
             _pad2d(D, com_lens_l),
             np.zeros((D, int(n_rec.max()) + 1), np.int64),
             _pad2d(D, run_lens_l, np.int64)]
    return dict(
        counts=counts,
        id_bytes=np.array([r.size for r in id_vals_l], np.int64),
        com_bytes=np.array([r.size for r in com_vals_l], np.int64),
        n_rec=n_rec, n_runs=n_runs, first_lower=first_lower,
        longest=longest, em_np=em_np)


def parse_fused_fastq(D, scal, outs):
    """Host parse of the fused FASTQ outputs (tensors on any device or numpy
    arrays; only their used prefixes are fetched); None on sparse-cap
    overflow or unexpected characters."""
    packed_d, qv_d, iv_d, _scal_d, tv_d, a_d, b_d, c_d = outs
    if not scal[:, 3].all() or scal[:, 4:7].any() or scal[:, 12].any():
        return None

    counts = scal[:, 0].astype(np.int64)
    cnt_seq = scal[:, 1].astype(np.int64)
    n_sp = scal[:, 2].astype(np.int64)
    longest = np.full(D, int(scal[:, 7].max()))
    first_lower = scal[:, 8] == 2
    first_codes = NUC_CODE[scal[:, 9]]
    qual_bytes = scal[:, 10].astype(np.int64)
    id_bytes = scal[:, 11].astype(np.int64)

    p_used = max(int((counts.max(initial=1) + 1) // 2) + 1, 1)
    packed = _host(packed_d[:, :p_used])
    qual_vals = _host(qv_d[:, :max(int(qual_bytes.max(initial=1)), 1)])
    id_vals = _host(iv_d[:, :max(int(id_bytes.max(initial=1)), 1)])
    m_sp = max(int(n_sp.max(initial=1)), 1)
    tv = _host(tv_d[:, :m_sp])
    av = _host(a_d[:, :m_sp])
    bv = _host(b_d[:, :m_sp])
    cv = _host(c_d[:, :m_sp])

    com_vals_l = []
    seq_lens_l, qual_lens_l, id_lens_l, com_lens_l, run_lens_l = [], [], [], [], []
    n_rec = np.zeros(D, np.int64)
    n_runs = np.zeros(D, np.int64)
    for k in range(D):
        t = tv[k, :n_sp[k]] >> 8
        v = (tv[k, :n_sp[k]] & 0xFF).astype(np.uint8)
        com_vals_l.append(v[t == 1])
        rec = t == 2
        n_rec[k] = int(rec.sum())
        for arr, total, sink in ((av, cnt_seq[k], seq_lens_l), (bv, qual_bytes[k], qual_lens_l),
                                 (cv, id_bytes[k], id_lens_l)):
            x = arr[k, :n_sp[k]].astype(np.int64)
            sink.append(np.diff(np.concatenate([[0], x[rec], [total]])))
        at = np.flatnonzero(rec)
        ccom = np.cumsum(t == 1)
        mid = ccom[at] if at.size else np.zeros(0, np.int64)
        com_lens_l.append(np.diff(np.concatenate([[0], mid, [int((t == 1).sum())]])))
        j = av[k, :n_sp[k]].astype(np.int64)[t == 3]
        run_lens_l.append(np.diff(np.concatenate([[0], j, [counts[k]]]))
                          if counts[k] > 0 else np.zeros(0, np.int64))
        n_runs[k] = (j.size + 1) if counts[k] > 0 else 0

    em_np = [packed, first_codes, counts,
             id_vals, _pad2d(D, com_vals_l, np.uint8), qual_vals,
             _pad2d(D, seq_lens_l), _pad2d(D, id_lens_l),
             _pad2d(D, com_lens_l), _pad2d(D, qual_lens_l),
             _pad2d(D, run_lens_l, np.int64)]
    return dict(
        counts=counts, id_bytes=id_bytes,
        com_bytes=np.array([r.size for r in com_vals_l], np.int64),
        qual_bytes=qual_bytes, n_rec=n_rec, n_runs=n_runs,
        first_lower=first_lower, longest=longest, em_np=em_np)


def _stitch_and_build(D, fmt, opts, counts, id_bytes, com_bytes, qual_bytes,
                      n_rec, n_runs, first_lower, longest, hists, em_np,
                      fallback):
    """Host carry stitching (O(blocks + records + runs)) + container;
    ``hists`` are the id, comment, sequence and quality histograms of
    unexpected bytes, each u64[257]."""
    fastq = fmt == C.IN_FORMAT_FASTQ
    (packed, first_codes, cnt2, id_vals, com_vals, qual_vals,
     seq_lens, id_lens, com_lens, qual_lens, run_lens) = em_np

    def trim(arr2d):
        return [arr2d[k, : int(n_rec[k]) + 1] for k in range(D)]

    g_seq_lens = stitch_lengths(trim(seq_lens))
    g_id_lens = stitch_lengths(trim(id_lens))
    g_com_lens = stitch_lengths(trim(com_lens))
    n_records = int(n_rec.sum()) + 1
    assert g_seq_lens.size == n_records

    if fastq:
        g_qual_lens = stitch_lengths(trim(qual_lens))
        if not np.array_equal(g_qual_lens, g_seq_lens):
            # exact error text (record index, counts) comes from the host
            # parser, which scans sequentially like the reference
            return fallback()

    res = P.ParseResult()
    res.n_sequences = n_records
    res.ids_blob = blob_from_lens(
        np.concatenate([id_vals[k, : int(id_bytes[k])] for k in range(D)]),
        g_id_lens)
    res.comments_blob = blob_from_lens(
        np.concatenate([com_vals[k, : int(com_bytes[k])] for k in range(D)]),
        g_com_lens)
    res.lengths = g_seq_lens.astype(np.uint64)
    res.longest_line = int(longest[0])

    total_chars = int(counts.sum())
    text_like = opts.seq_type >= C.SEQ_TYPE_PROTEIN
    if text_like:
        # protein/text archives store raw bytes: per-block compacted char
        # streams concatenate directly (no nibble parity); build_archive
        # upper-cases under --no-mask
        res.seq = (np.concatenate(
            [packed[k, : int(counts[k])] for k in range(D)])
            if total_chars else np.zeros(0, np.uint8)).astype(np.uint8)
        res.packed = None
    else:
        res.seq = np.zeros(total_chars, np.uint8)    # only .size is used
        res.packed = stitch_packed(packed, counts, first_codes)

    if not opts.no_mask and not text_like:
        runs, state_first = stitch_runs(
            [run_lens[k, : int(n_runs[k])] for k in range(D)],
            [bool(first_lower[k]) for k in range(D)])
        if state_first and runs.size:
            runs = np.concatenate([[0], runs])   # leading masked run
        res.mask_units = runs_to_units(runs)

    if fastq:
        res.qual = np.concatenate(
            [qual_vals[k, : int(qual_bytes[k])] for k in range(D)])

    (res.unexpected_id, res.unexpected_comment, res.unexpected_seq,
     res.unexpected_qual) = hists

    stats = EncodeStats(
        n_sequences=res.n_sequences, longest_line=res.longest_line,
        seq_size_original=total_chars,
        unexpected_id=res.unexpected_id,
        unexpected_comment=res.unexpected_comment,
        unexpected_seq=res.unexpected_seq,
        unexpected_qual=res.unexpected_qual,
        in_format=fmt,
    )
    return build_archive(res, opts, stats)
