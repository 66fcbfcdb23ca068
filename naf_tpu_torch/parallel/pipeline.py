"""Device FASTA and FASTQ encode: bytes -> blocks over a mesh -> NAF
archive.

``encode_device`` is the port's ``naf_tpu/parallel/pipeline.py:
encode_sharded``.  It cuts the input into one line-aligned block a mesh
device (``make_blocks``; record-aligned for FASTQ), one block on the named
device when no mesh is given.  ``device_passes`` runs the device work on
the uploaded blocks, for this function and for the stream engine
(``stream.DeviceScanEngine``).  Nucleotide blocks first take the fused
path (naf_tpu's ``_try_encode_fused`` and its FASTQ twin): one emit kernel
a block classifies and compacts it, one gather of the counts sets each
block's nibble parity, the pack follows, and ``parse_fused`` reads the
outputs.  Where that path cannot finish in any block (a tile past the
sparse cap, or unexpected characters, whose histograms only the stats pass
gives), and for protein and text, the same uploaded blocks take the
two-pass protocol: ``stats_blocks_sharded`` counts, then
``emit_blocks_sharded`` compacts every section to the counted sizes.
Either way the blocks come back as one ``block.BlockRows``, which
``_stitch_and_build`` stitches (``block.stitch_rows``) before it writes the
container through the shared ``build_archive``, so the archive is
byte-identical to host ``encode()`` whatever the number of blocks.

Each way is a route counted in ``device.ROUTES``: ``encode_device`` (fused),
``encode_device:two_pass:<why>`` (``text_like``, ``sparse_overflow``,
``unexpected_chars``), and the host routes, which give host ``encode()``
the same bytes: not FASTA or FASTQ, an unsafe ``--well-formed`` input, a
FASTQ off the regular 4-line grid, ``--strict`` with unexpected characters
(the host raises the reference's message), or a FASTQ record whose quality
length differs from its sequence length (likewise).  Under ``NAF_TPU_TRACE``
a call is an ``encode`` span, the route its ``route`` field, over the
spans of its stages (``split``, ``upload``, ``emit``, ``fetch``,
``parse`` with the fused parse's host decode of the sparse channel,
``sparse``, inside it, ``carry``, then ``build_archive``'s ``sections``
and ``container``).

The host helpers below are jax-free versions of the reference's
(``_wf_device_safe``; ``parse_fused``, one parse for naf_tpu's FASTA and
FASTQ parses of the fused outputs; ``_stitch_and_build``); the tests hold
each against its original.
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
from .block import (BlockRows, emit_blocks_sharded, fused_blocks_fastq_sharded,
                    fused_blocks_sharded, make_blocks, make_blocks_fastq, pad_rows,
                    stats_blocks_sharded, stitch_rows)
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
        xs = mesh.upload(blocks.data)
        why, rows = device_passes(xs, blocks, fastq=fastq, seq_type=opts.seq_type,
                                  strict=opts.strict)
        if rows is None:
            return _host_route("strict_unexpected", data, opts, card)
        out = _stitch_and_build(fmt, opts, rows, device=xs[0].device)
        if out is None:
            return _host_route("qual_length_mismatch", data, opts, card)
        count_route("encode_device" if why is None else f"encode_device:two_pass:{why}")
        return out


def device_passes(xs: list, blocks, *, fastq: bool, seq_type: int, strict: bool = False,
                  parity: int = 0) -> tuple:
    """The device passes over uploaded blocks (``xs``, one tensor a block of
    ``blocks``), their char count before them ``parity`` mod 2: (why,
    rows).  The fused emit runs first, but for protein and text
    (``text_like``); where it declines (``sparse_overflow``, or
    ``unexpected_chars``, whose histograms only the stats pass gives) the
    same tensors take the two-pass protocol, and ``why`` names the reason
    (None on the fused path).  ``rows`` is None when ``strict`` meets an
    unexpected byte, whose exact message only the host parser gives."""
    if seq_type >= C.SEQ_TYPE_PROTEIN:
        why = "text_like"
    else:
        outs = (fused_blocks_fastq_sharded(xs, blocks.prev, parity, seq_type=seq_type) if fastq
                else fused_blocks_sharded(xs, blocks.prev, blocks.starts_in_seq, parity,
                                          seq_type=seq_type))
        scal = all_gather(outs[3 if fastq else 1])
        if not scal[:, 3].all():
            why = "sparse_overflow"
        elif scal[:, 4:7].any() or (fastq and scal[:, 12].any()):
            why = "unexpected_chars"
        else:
            return None, parse_fused(scal, outs, fastq=fastq)
        del outs        # the two-pass reuses the fused outputs' device memory
    stats, masks = stats_blocks_sharded(xs, blocks.prev, blocks.starts_in_seq, seq_type=seq_type,
                                        fastq=fastq, parity_base=parity)
    if strict and any(h.any() for h in stats[0]["hists"]):
        return why, None
    return why, emit_blocks_sharded(xs, masks, stats, seq_type=seq_type, fastq=fastq,
                                    pack_nibbles=seq_type < C.SEQ_TYPE_PROTEIN)


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


def _segments(at: np.ndarray, total) -> np.ndarray:
    """Segment lengths between the positions ``at`` in [0, total]."""
    return np.diff(np.concatenate([[0], at, [total]]))


def parse_fused(scal: np.ndarray, outs, *, fastq: bool) -> BlockRows:
    """Host parse of the fused emit's outputs (``fused_blocks_sharded``'s,
    or with ``fastq`` ``fused_blocks_fastq_sharded``'s) whose gathered
    scalars ``scal`` hold no sparse-cap overflow and no unexpected byte.
    The per-block outputs may be 2-D numpy arrays or tensors, or lists of
    per-block tensors on any devices; only their used prefixes are
    fetched.  The sparse channel gives the records, the comments and the
    case runs; FASTA ids come from it too, FASTQ ids and qualities from
    their own rows."""
    with trace_span("parse"):
        D = scal.shape[0]
        counts = scal[:, 0].astype(np.int64)
        cnt_seq = scal[:, 1].astype(np.int64)
        n_sp = scal[:, 2].astype(np.int64)

        # sliced fetches: only used prefixes cross the host<->device link
        packed = _rows(outs[0], max(int((counts.max(initial=1) + 1) // 2) + 1, 1))
        m_sp = max(int(n_sp.max(initial=1)), 1)
        if fastq:
            _, qv_d, iv_d, _, tv_d, a_d, b_d, c_d = outs
            qual_bytes = scal[:, 10].astype(np.int64)
            id_bytes = scal[:, 11].astype(np.int64)
            qual_vals = _rows(qv_d, max(int(qual_bytes.max(initial=1)), 1))
            id_vals = _rows(iv_d, max(int(id_bytes.max(initial=1)), 1))
            tv, av, bv, cv = (_rows(r, m_sp) for r in (tv_d, a_d, b_d, c_d))
        else:
            _, _, tv_d, a_d = outs
            tv, av = _rows(tv_d, m_sp), _rows(a_d, m_sp)

        # host-side sparse parse: O(records + runs + header bytes)
        with trace_span("sparse", entries=int(n_sp.sum())):
            id_vals_l, com_vals_l = [], []
            seq_lens_l, qual_lens_l, id_lens_l, com_lens_l, run_lens_l = [], [], [], [], []
            n_rec = np.zeros(D, np.int64)
            n_runs = np.zeros(D, np.int64)
            for k in range(D):
                t = tv[k, :n_sp[k]] >> 8
                v = (tv[k, :n_sp[k]] & 0xFF).astype(np.uint8)
                a = av[k, :n_sp[k]].astype(np.int64)
                rec = t == 2
                at = np.flatnonzero(rec)
                n_rec[k] = at.size
                seq_lens_l.append(_segments(a[rec], cnt_seq[k]))
                if fastq:
                    qual_lens_l.append(_segments(bv[k, :n_sp[k]].astype(np.int64)[rec],
                                                 qual_bytes[k]))
                    id_lens_l.append(_segments(cv[k, :n_sp[k]].astype(np.int64)[rec],
                                               id_bytes[k]))
                else:
                    id_vals_l.append(v[t == 0])
                    id_lens_l.append(_segments(np.cumsum(t == 0)[at], int((t == 0).sum())))
                com_vals_l.append(v[t == 1])
                com_lens_l.append(_segments(np.cumsum(t == 1)[at], int((t == 1).sum())))
                j = a[t == 3]
                run_lens_l.append(_segments(j, counts[k]) if counts[k] > 0
                                  else np.zeros(0, np.int64))
                n_runs[k] = (j.size + 1) if counts[k] > 0 else 0

            if not fastq:
                id_bytes = np.array([r.size for r in id_vals_l], np.int64)
                id_vals = pad_rows(D, id_vals_l, np.uint8)
                qual_bytes = np.zeros(D, np.int64)
                qual_vals = np.zeros((D, 1), np.uint8)
            rows = BlockRows(
                counts=counts, id_bytes=id_bytes,
                com_bytes=np.array([r.size for r in com_vals_l], np.int64),
                qual_bytes=qual_bytes, n_rec=n_rec, n_runs=n_runs,
                first_lower=scal[:, 8] == 2, longest=np.full(D, int(scal[:, 7].max())),
                first_codes=NUC_CODE[scal[:, 9]], packed=packed, id_vals=id_vals,
                com_vals=pad_rows(D, com_vals_l, np.uint8), qual_vals=qual_vals,
                seq_lens=pad_rows(D, seq_lens_l), id_lens=pad_rows(D, id_lens_l),
                com_lens=pad_rows(D, com_lens_l),
                qual_lens=(pad_rows(D, qual_lens_l) if fastq
                           else np.zeros((D, int(n_rec.max()) + 1), np.int64)),
                run_lens=pad_rows(D, run_lens_l, np.int64))
            note(records=int(n_rec.sum()) + 1)
        return rows


def _stitch_and_build(fmt: int, opts: EncodeOptions, rows: BlockRows, prebuilt=None,
                      device="cuda"):
    """Host carry stitching (``stitch_rows``) + container: the archive, or
    None when a FASTQ record's quality length differs from its sequence
    length (the caller routes the input to the host parser, which gives
    the reference's message); ``device`` is the device engine's.

    ``prebuilt`` injects ready SEQ/QUAL sections (the multi-process
    compressed-traffic paths: payloads were compressed by the processes
    that own them; ``rows`` then carries zero-width packed/qual rows).
    """
    with trace_span("carry"):
        fastq = fmt == C.IN_FORMAT_FASTQ
        text_like = opts.seq_type >= C.SEQ_TYPE_PROTEIN
        st = stitch_rows(rows, fastq=fastq, mask=not opts.no_mask and not text_like,
                         text_like=text_like, payload=prebuilt is None)
        if st is None:
            return None
        res = P.ParseResult()
        res.n_sequences = int(st.seq_lens.size)
        res.ids_blob = st.ids_blob
        res.comments_blob = st.comments_blob
        res.lengths = st.seq_lens.astype(np.uint64)
        res.longest_line = int(rows.longest[0])

        total_chars = int(rows.counts.sum())
        if text_like:
            # protein/text archives store raw bytes: per-block compacted char
            # streams concatenate directly (no nibble parity); build_archive
            # upper-cases under --no-mask
            res.seq = st.seq
            res.packed = None
        else:
            res.seq = np.zeros(total_chars, np.uint8)    # only .size is used
            # without the payload it arrives prebuilt
            res.packed = st.seq if prebuilt is None else np.zeros(0, np.uint8)

        if st.runs is not None:
            runs = st.runs
            if st.first_lower and runs.size:
                runs = np.concatenate([[0], runs])   # leading masked run
            res.mask_units = runs_to_units(runs)

        if fastq:
            res.qual = st.qual if prebuilt is None else np.zeros(total_chars, np.uint8)

        (res.unexpected_id, res.unexpected_comment, res.unexpected_seq,
         res.unexpected_qual) = rows.hists

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
