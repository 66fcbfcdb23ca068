"""Device FASTA and FASTQ encode: bytes -> blocks over a mesh -> NAF
archive.

``encode_device`` is the port's ``naf_tpu/parallel/pipeline.py:
encode_sharded``.  It cuts the input into one line-aligned block a mesh
device (``make_blocks``; record-aligned for FASTQ), one block on the named
device when no mesh is given.  Nucleotide blocks first take the fused path
(``_try_encode_fused``, ``_try_encode_fused_fastq``): one emit kernel a
block classifies and compacts it, one gather of the counts sets each
block's nibble parity, and the pack follows.  Where that path cannot
finish in any block (a tile past the sparse cap, or unexpected characters,
whose histograms only the stats pass gives), and for protein and text, the
same uploaded blocks take the two-pass protocol: ``stats_blocks_sharded``
counts, then ``emit_blocks_sharded`` compacts every section to the counted
sizes.  The host stitches the blocks' sections and writes the container
through the shared ``build_archive``, so the archive is byte-identical to
host ``encode()`` whatever the number of blocks.

Each way is a route counted in ``device.ROUTES``: ``encode_device`` (fused),
``encode_device:two_pass:<why>`` (``text_like``, ``sparse_overflow``,
``unexpected_chars``), and the host routes, which give host ``encode()``
the same bytes: not FASTA or FASTQ, an unsafe ``--well-formed`` input, a
FASTQ off the regular 4-line grid, ``--strict`` with unexpected characters
(the host raises the reference's message), or a FASTQ record whose quality
length differs from its sequence length (likewise).  Under ``NAF_TPU_TRACE``
a call is an ``encode`` span, the route its ``route`` field, over the
spans of its stages (``split``, ``upload``, ``emit``, ``fetch``,
``parse`` with the fused parses' host decode of the sparse channel,
``sparse``, inside it, ``carry``, then ``build_archive``'s ``sections``
and ``container``).

The host helpers below are jax-free copies of the reference's
(``_wf_device_safe``, ``_pad2d``, ``parse_fused_fasta``,
``parse_fused_fastq``, ``_stitch_and_build``); the tests hold each against
its original.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..device import count_route
from ..format import constants as C
from ..ops.mask import runs_to_units
from ..ops.tables_np import NUC_CODE
from ..pipeline import parser as P
from ..pipeline.encoder import EncodeOptions, EncodeStats, build_archive, encode
from ..utils.trace import note, trace_span
from .block import (STATS_KEYS, blob_from_lens, emit_blocks_sharded, fused_blocks_fastq_sharded,
                    fused_blocks_sharded, make_blocks, make_blocks_fastq, stats_blocks_sharded,
                    stitch_lengths, stitch_packed, stitch_runs)
from .mesh import BlockMesh, all_gather, block_mesh


def _rows(rows, used: int) -> np.ndarray:
    """The first ``used`` columns of per-block rows as one host array
    [D, used]: from a 2-D array, or a 2-D tensor or a list of per-block
    tensors on their blocks' devices (one gather)."""
    if isinstance(rows, np.ndarray):
        return rows[:, :used]
    return all_gather([r[:used] for r in rows])


def _host_route(reason: str, data: bytes, opts: EncodeOptions, device):
    count_route(f"encode_host:{reason}")
    return encode(data, opts, device=device)


def encode_device(data: bytes, opts: Optional[EncodeOptions] = None, *, device="cuda",
                  mesh: Optional[BlockMesh] = None) -> tuple[bytes, EncodeStats]:
    """FASTA or FASTQ encode with the kernels, one block on each device of
    ``mesh``, or one block on ``device`` (the current card by default;
    'cpu', asked for explicitly, runs the plain versions) when no mesh is
    given; archive bytes equal host ``encode(data, opts)``.  The device
    engine (``opts.engine == "device"``) runs on the mesh's first device."""
    mesh = mesh if mesh is not None else block_mesh(devices=[device])
    with trace_span("encode", bytes=len(data), blocks=mesh.size):
        card = mesh.devices[0]
        opts = opts or EncodeOptions()
        fmt, marker = P.detect_format(data)
        if (opts.in_format != C.IN_FORMAT_UNKNOWN and fmt != C.IN_FORMAT_UNKNOWN
                and opts.in_format != fmt):
            raise P.InputError(
                "input format is different from format specified in the command line")
        fastq = fmt == C.IN_FORMAT_FASTQ
        if not fastq and fmt != C.IN_FORMAT_FASTA:
            return _host_route("not_fasta", data, opts, card)
        body = np.frombuffer(data, np.uint8)[marker + 1:]
        if opts.well_formed and not _wf_device_safe(body, fastq):
            return _host_route("well_formed_unsafe", data, opts, card)
        if fastq:
            mb = make_blocks_fastq(body, mesh.size)
            if mb is None:
                return _host_route("fastq_irregular", data, opts, card)
            blocks = mb[0]
        else:
            blocks = make_blocks(body, mesh.size)
        # one upload, shared by the fused attempt and the two-pass protocol
        xs = mesh.upload(blocks.data)
        mismatch = []

        def fallback():
            mismatch.append(True)
            return _host_route("qual_length_mismatch", data, opts, card)

        if opts.seq_type >= C.SEQ_TYPE_PROTEIN:
            why = "text_like"
        else:
            why, out = (_encode_fused_fastq if fastq else _encode_fused)(xs, blocks, fmt, opts,
                                                                         fallback)
            if why is None:
                if not mismatch:
                    count_route("encode_device")
                return out
        out = _encode_two_pass(xs, blocks, fmt, opts, fallback)
        if out is not None and not mismatch:
            count_route(f"encode_device:two_pass:{why}")
        return out if out is not None else _host_route("strict_unexpected", data, opts, card)


def _encode_fused(xs: list, blocks, fmt: int, opts: EncodeOptions, fallback):
    """The fused FASTA path (``_try_encode_fused``): (None, archive), or
    (why, None) when the two-pass protocol must take the blocks."""
    D = len(xs)
    packed, scal_d, tv, a = fused_blocks_sharded(xs, blocks.prev, blocks.starts_in_seq, 0,
                                                 seq_type=opts.seq_type)
    scal = all_gather(scal_d)
    if not scal[:, 3].all():
        return "sparse_overflow", None
    if scal[:, 4:7].any():
        return "unexpected_chars", None
    parsed = parse_fused_fasta(D, scal, packed, tv, a)
    zero_hists = [np.zeros(257, np.uint64) for _ in range(4)]
    return None, _stitch_and_build(
        D, fmt, opts, parsed["counts"], parsed["id_bytes"], parsed["com_bytes"],
        np.zeros(D, np.int64), parsed["n_rec"], parsed["n_runs"], parsed["first_lower"],
        parsed["longest"], zero_hists, parsed["em_np"], fallback=fallback, device=xs[0].device)


def _encode_fused_fastq(xs: list, blocks, fmt: int, opts: EncodeOptions, fallback):
    """The fused FASTQ path (``_try_encode_fused_fastq``), as
    ``_encode_fused``."""
    D = len(xs)
    outs = fused_blocks_fastq_sharded(xs, blocks.prev, 0, seq_type=opts.seq_type)
    scal = all_gather(outs[3])
    if not scal[:, 3].all():
        return "sparse_overflow", None
    if scal[:, 4:7].any() or scal[:, 12].any():
        return "unexpected_chars", None
    parsed = parse_fused_fastq(D, scal, outs)
    zero_hists = [np.zeros(257, np.uint64) for _ in range(4)]
    return None, _stitch_and_build(
        D, fmt, opts, parsed["counts"], parsed["id_bytes"], parsed["com_bytes"],
        parsed["qual_bytes"], parsed["n_rec"], parsed["n_runs"], parsed["first_lower"],
        parsed["longest"], zero_hists, parsed["em_np"], fallback=fallback, device=xs[0].device)


def _encode_two_pass(xs: list, blocks, fmt: int, opts: EncodeOptions, fallback):
    """The two-pass protocol on the uploaded blocks (``encode_sharded``
    after its fused attempt); None when ``--strict`` meets an unexpected
    character, whose exact message only the host parser gives."""
    fastq = fmt == C.IN_FORMAT_FASTQ
    stats, masks = stats_blocks_sharded(xs, blocks.prev, blocks.starts_in_seq,
                                        seq_type=opts.seq_type, fastq=fastq)
    if opts.strict and any(h.any() for h in stats[0]["hists"]):
        return None
    em_np = emit_blocks_sharded(xs, masks, stats, seq_type=opts.seq_type, fastq=fastq,
                                pack_nibbles=opts.seq_type < C.SEQ_TYPE_PROTEIN)
    del masks
    return build_two_pass(fmt, opts, stats, em_np, fallback=fallback, device=xs[0].device)


def build_two_pass(fmt: int, opts: EncodeOptions, stats: list, em_np: list, fallback,
                   prebuilt: Optional[dict] = None, device="cuda"):
    """``_stitch_and_build`` of the blocks' ``stats_blocks_sharded`` dicts
    and ``emit_blocks_sharded`` rows."""
    cols = [np.asarray([st[k] for st in stats]) for k in STATS_KEYS]
    return _stitch_and_build(len(stats), fmt, opts, *cols, stats[0]["hists"], em_np,
                             fallback=fallback, prebuilt=prebuilt, device=device)


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
    two-pass protocol.  The per-block outputs may be 2-D numpy arrays or
    tensors, or lists of per-block tensors on any devices; only their used
    prefixes are fetched.  Returns None when a tile overflowed the sparse
    cap or unexpected characters exist."""
    with trace_span("parse"):
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
        packed = _rows(packed_d, p_used)
        m_sp = max(int(n_sp.max(initial=1)), 1)
        tv = _rows(tv_d, m_sp)
        av = _rows(a_d, m_sp)

        # host-side sparse parse: O(records + runs + header bytes)
        with trace_span("sparse", entries=int(n_sp.sum())):
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
            note(records=int(n_rec.sum()) + 1)
        return dict(
            counts=counts,
            id_bytes=np.array([r.size for r in id_vals_l], np.int64),
            com_bytes=np.array([r.size for r in com_vals_l], np.int64),
            n_rec=n_rec, n_runs=n_runs, first_lower=first_lower,
            longest=longest, em_np=em_np)


def parse_fused_fastq(D, scal, outs):
    """Host parse of the fused FASTQ outputs (as ``parse_fused_fasta``
    takes them; only their used prefixes are fetched); None on sparse-cap
    overflow or unexpected characters."""
    with trace_span("parse"):
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
        packed = _rows(packed_d, p_used)
        qual_vals = _rows(qv_d, max(int(qual_bytes.max(initial=1)), 1))
        id_vals = _rows(iv_d, max(int(id_bytes.max(initial=1)), 1))
        m_sp = max(int(n_sp.max(initial=1)), 1)
        tv = _rows(tv_d, m_sp)
        av = _rows(a_d, m_sp)
        bv = _rows(b_d, m_sp)
        cv = _rows(c_d, m_sp)

        with trace_span("sparse", entries=int(n_sp.sum())):
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
                for arr, total, sink in ((av, cnt_seq[k], seq_lens_l),
                                         (bv, qual_bytes[k], qual_lens_l),
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
            note(records=int(n_rec.sum()) + 1)
        return dict(
            counts=counts, id_bytes=id_bytes,
            com_bytes=np.array([r.size for r in com_vals_l], np.int64),
            qual_bytes=qual_bytes, n_rec=n_rec, n_runs=n_runs,
            first_lower=first_lower, longest=longest, em_np=em_np)


def _stitch_and_build(D, fmt, opts, counts, id_bytes, com_bytes, qual_bytes,
                      n_rec, n_runs, first_lower, longest, hists, em_np,
                      fallback, prebuilt=None, device="cuda"):
    """Host carry stitching (O(blocks + records + runs)) + container;
    ``hists`` are the id, comment, sequence and quality histograms of
    unexpected bytes, each u64[257]; ``device`` is the device engine's.

    ``prebuilt`` injects ready SEQ/QUAL sections (the multi-process
    compressed-traffic paths: payloads were compressed by the processes
    that own them; em_np then carries zero-width packed/qual arrays).
    """
    with trace_span("carry"):
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
            if prebuilt is None:
                res.packed = stitch_packed(packed, counts, first_codes)
            else:
                res.packed = np.zeros(0, np.uint8)   # payload arrives prebuilt

        if not opts.no_mask and not text_like:
            runs, state_first = stitch_runs(
                [run_lens[k, : int(n_runs[k])] for k in range(D)],
                [bool(first_lower[k]) for k in range(D)])
            if state_first and runs.size:
                runs = np.concatenate([[0], runs])   # leading masked run
            res.mask_units = runs_to_units(runs)

        if fastq and prebuilt is None:
            res.qual = np.concatenate(
                [qual_vals[k, : int(qual_bytes[k])] for k in range(D)])
        elif fastq:
            res.qual = np.zeros(int(counts.sum()), np.uint8)   # size only

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
    return build_archive(res, opts, stats, prebuilt=prebuilt, device=device)
