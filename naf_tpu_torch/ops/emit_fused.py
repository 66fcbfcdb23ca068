"""Fused FASTA and FASTQ emit, and mask-parity apply: the port of
``naf_tpu/ops/emit_fused.py``'s ``emit_fasta_fused``, ``emit_fastq_fused``
and ``apply_mask_parity_pallas``.

``emit_fasta_fused`` classifies a block, left-compacts the kept stream, and
writes the tagged sparse channel of id bytes, comment bytes, record
markers and case changes, with the scalars the host stitch needs.
``emit_fastq_fused`` does the same for a FASTQ block, with three dense
compactions (stream, quality, id) and a sparse channel of comment bytes,
record starts (carrying their sequence, quality and id prefixes) and case
changes.  The FASTA kernel (``csrc/emit_fasta.cu``) runs three passes; the
scans over tile summaries between them are torch ops on [tiles]-sized
tensors.  The FASTQ kernel (``csrc/emit_fastq.cu``) is one pass over the
block that carries across tiles by decoupled look-back, then a launch for
the zero fill and the block scalars.

One difference from the reference, on purpose: a case change at a tile's
first kept byte is found even when that byte is not the tile's first byte.
The TPU kernels miss it there (they read their case carry only at tile
position 0), which loses a mask-run boundary; the port follows the host
encoder, which keeps it.
"""

from __future__ import annotations

import torch

from ..device import LAUNCHES
from ..format import constants as C
from ..native import build
from .common import Q_TILE, TILE, check_1d, n_tiles
from .scan_fused import classify_fastq_masks, classify_masks, entry_states, start_state, tile_maps
from .tables import device_tables

#: sparse entries kept per tile (the TPU kernels' _CS_CAP), for the 64 KiB
#: FASTA tiles and the 32 KiB FASTQ tiles alike
CS_CAP = 2048
TAG_ID, TAG_COM, TAG_REC, TAG_CHG = 0, 1, 2, 3
SUMMARY_COLS = 16          # csrc/emit_fasta.cu pass-B row width


def _plain_cases(stream_keep: torch.Tensor, sval: torch.Tensor):
    """The case-change mask of the kept stream, and the first kept byte's
    (case 0 none / 1 upper / 2 lower, value)."""
    dev = sval.device
    kept = torch.nonzero(stream_keep).flatten()
    lower_k = sval[kept] >= 96
    chg = torch.zeros(sval.numel(), dtype=torch.bool, device=dev)
    chg[kept[1:][lower_k[1:] != lower_k[:-1]]] = True
    if kept.numel():
        first = (1 + lower_k[0].long(), sval[kept[0]])
    else:
        first = (torch.tensor(0, device=dev), torch.tensor(0, device=dev))
    return chg, first


def _plain_compact(keep: torch.Tensor, sval: torch.Tensor, size: int) -> torch.Tensor:
    """u8[size]: the kept values in order, zero after them."""
    out = torch.zeros(size, dtype=torch.uint8, device=sval.device)
    vals = sval[keep]
    out[:vals.numel()] = vals.to(torch.uint8)
    return out


def _plain_sparse(keep_sp: torch.Tensor, cols: list, tile: int, g: int):
    """The capped sparse channel: a tile keeps its first CS_CAP entries.
    Returns (n_sp, sp_ok, [i32[g * CS_CAP] per column])."""
    dev = keep_sp.device
    sp_pos = torch.nonzero(keep_sp).flatten()
    tile_of = sp_pos // tile
    n_t = torch.bincount(tile_of, minlength=g)
    local = torch.arange(sp_pos.numel(), device=dev) - (torch.cumsum(n_t, 0) - n_t)[tile_of]
    sp_pos = sp_pos[local < CS_CAP]
    out = []
    for col in cols:
        a = torch.zeros(g * CS_CAP, dtype=torch.int32, device=dev)
        a[:sp_pos.numel()] = col[sp_pos].int()
        out.append(a)
    return torch.tensor(sp_pos.numel(), device=dev), (n_t <= CS_CAP).all(), out


def _plain_longest(cum_seq: torch.Tensor, is_eol: torch.Tensor) -> torch.Tensor:
    """Longest line: kept seq bytes between EOLs, and the open tail."""
    eol_cum = cum_seq[is_eol]
    lines = torch.diff(eol_cum, prepend=eol_cum.new_zeros(1))
    total_seq = cum_seq[-1] if cum_seq.numel() else torch.tensor(0, device=cum_seq.device)
    open_tail = total_seq - (eol_cum[-1] if eol_cum.numel() else 0)
    return torch.maximum(lines.max() if lines.numel() else open_tail * 0, open_tail)


def _i32(**kw) -> dict:
    """The result dict: counts as i32 scalars, arrays and sp_ok as they are."""
    return {k: v if v.dtype in (torch.uint8, torch.bool) else v.to(torch.int32)
            for k, v in kw.items()}


def emit_fasta_plain(block: torch.Tensor, prev_byte: int, starts_in_seq: bool = False,
                     *, seq_type: int = C.SEQ_TYPE_DNA) -> dict:
    """Plain PyTorch version of the FASTA emit kernel."""
    g = n_tiles(block.numel())
    pe0, st0 = start_state(prev_byte, starts_in_seq)
    m = classify_masks(block, pe0, st0, seq_type)
    sval = m["sval"]
    seq_keep = m["seq_keep"]
    stream_keep = seq_keep | m["id_unex"]
    chg, (first_lower, first_sval) = _plain_cases(stream_keep, sval)

    cum_stream = torch.cumsum(stream_keep.long(), 0)
    cum_seq = torch.cumsum(seq_keep.long(), 0)
    marker, in_com, id_keep = m["marker"], m["in_com"], m["id_keep"]
    tag = torch.where(marker, TAG_REC,
                      torch.where(chg, TAG_CHG, torch.where(in_com, TAG_COM, TAG_ID)))
    spval = torch.where(id_keep | in_com,
                        torch.where(m["com_unex"], C.REPLACEMENT_NAME, sval), 0)
    aval = torch.where(marker, cum_seq, torch.where(chg, cum_stream - 1, 0))
    n_sp, sp_ok, (sp_tv, sp_a) = _plain_sparse(id_keep | in_com | marker | chg,
                                               [spval | (tag << 8), aval], TILE, g)
    return _i32(sv=_plain_compact(stream_keep, sval, g * TILE), cnt=stream_keep.sum(),
                cnt_seq=seq_keep.sum(), n_sp=n_sp, sp_ok=sp_ok, unex_id=m["id_unex"].sum(),
                unex_com=m["com_unex"].sum(), unex_seq=m["seq_unex"].sum(),
                longest=_plain_longest(cum_seq, m["is_eol"]), first_lower=first_lower,
                first_sval=first_sval, sp_tv=sp_tv, sp_a=sp_a)


def _scan_summaries(s: torch.Tensor) -> dict:
    """Scans over the tile summaries that both emit kernels write (pass-B
    columns 0-13: stream, seq and sparse counts, unexpected counts, the
    first and last kept byte's case, the first kept value, the line
    summary): each tile's offsets, and the block's scalars."""
    g = s.shape[0]
    n_stream, n_seq, n_sp_in, has, first, last = (s[:, k] for k in (0, 1, 2, 6, 7, 8))
    stream_off = torch.cumsum(n_stream, 0) - n_stream
    seq_off = torch.cumsum(n_seq, 0) - n_seq
    idx = torch.arange(g, device=s.device)
    last_k = torch.cummax(torch.where(has == 1, idx, -1), 0).values
    prev_k = torch.cat([last_k.new_full((1,), -1), last_k[:-1]])
    prev_lower = torch.where(prev_k >= 0, last[prev_k.clamp(min=0)], -1)
    n_t = n_sp_in + ((has == 1) & (prev_k >= 0) & (first != prev_lower)).long()
    capped = n_t.clamp(max=CS_CAP)
    sp_off = torch.cumsum(capped, 0) - capped
    cnt_seq = n_seq.sum()

    f_tile = torch.argmax(has)
    any_kept = has[f_tile] == 1
    l_has, l_pre, l_post, l_mx = (s[:, k] for k in (10, 11, 12, 13))
    eol_end = torch.where(l_has == 1, seq_off + n_seq - l_post, -1)
    last_e = torch.cummax(eol_end, 0).values
    base = torch.cat([last_e.new_zeros(1), last_e[:-1]]).clamp(min=0)
    first_line = torch.where(l_has == 1, seq_off + l_pre - base, 0)
    return dict(
        stream_off=stream_off, seq_off=seq_off, prev_lower=prev_lower, sp_off=sp_off,
        cnt=n_stream.sum(), cnt_seq=cnt_seq, n_sp=capped.sum(), sp_ok=(n_t <= CS_CAP).all(),
        unex_id=s[:, 3].sum(), unex_com=s[:, 4].sum(), unex_seq=s[:, 5].sum(),
        longest=torch.maximum(torch.maximum(l_mx.max(), first_line.max()),
                              cnt_seq - last_e[-1].clamp(min=0)),
        first_lower=torch.where(any_kept, 1 + first[f_tile], 0),
        first_sval=torch.where(any_kept, s[f_tile, 9], 0))


def _check_block(block: torch.Tensor) -> int:
    check_1d(block, torch.uint8, "block")
    n = block.numel()
    if n >= 1 << 31:
        raise ValueError(f"the emit kernels keep int32 offsets: a block of {n} bytes is "
                         "too long")
    return n


def emit_fasta_kernel(block: torch.Tensor, prev_byte: int, starts_in_seq: bool = False,
                      *, seq_type: int = C.SEQ_TYPE_DNA, lib=None) -> dict:
    """Launch the FASTA emit kernel on ``block``'s device (``lib`` as in
    ``scan_fused.classify_fasta_kernel``)."""
    n = _check_block(block)
    lib = build.kernel_lib(block, lib)
    dev = block.device
    tabs = device_tables(seq_type, dev)
    pe0, st0 = start_state(prev_byte, starts_in_seq)
    g = n_tiles(n)
    stream = build.stream_of(block)
    args = (tabs["cls"].data_ptr(), tabs["repl_seq"], tabs["repl_name"])

    st_in = entry_states(tile_maps(block, pe0, tabs["cls"], lib), st0)
    summ = torch.empty((g, SUMMARY_COLS), dtype=torch.int32, device=dev)
    build.call(lib, "naf_emit_fasta_summary", block.data_ptr(), n, pe0, st_in.data_ptr(),
               *args, summ.data_ptr(), g, stream)
    r = _scan_summaries(summ.long())
    tile_in = torch.stack([st_in.long(), r.pop("stream_off"), r.pop("seq_off"),
                           r.pop("prev_lower"), r.pop("sp_off")], 1).int()
    totals = torch.stack([r["cnt"], r["n_sp"]]).int()
    sv = torch.empty(g * TILE, dtype=torch.uint8, device=dev)
    sp_tv = torch.empty(g * CS_CAP, dtype=torch.int32, device=dev)
    sp_a = torch.empty(g * CS_CAP, dtype=torch.int32, device=dev)
    build.call(lib, "naf_emit_fasta_write", block.data_ptr(), n, pe0, tile_in.data_ptr(),
               totals.data_ptr(), *args, CS_CAP, sv.data_ptr(), sp_tv.data_ptr(),
               sp_a.data_ptr(), g, stream)
    LAUNCHES["emit_fasta"] += 1
    return _i32(sv=sv, **r, sp_tv=sp_tv, sp_a=sp_a)


def emit_fasta_fused(block: torch.Tensor, prev_byte: int, starts_in_seq: bool = False,
                     *, seq_type: int = C.SEQ_TYPE_DNA) -> dict:
    """Fused single-pass FASTA emit of one block.

    Returns a dict of tensors on the block's device, as the reference:
      sv u8[B']   compacted stream values (B' = B rounded up to 64 KiB tiles;
                  zero past cnt)
      cnt, cnt_seq, n_sp, unex_id/com/seq, longest, first_lower (0 none /
                  1 upper / 2 lower), first_sval  i32 scalars
      sp_tv, sp_a i32[tiles * CS_CAP] tagged sparse channel (zero past n_sp)
      sp_ok       bool: no tile had more than CS_CAP sparse entries
    A CUDA tensor runs the kernel; a CPU tensor the plain version.
    """
    check_1d(block, torch.uint8, "block")
    if block.is_cuda:
        return emit_fasta_kernel(block, prev_byte, starts_in_seq, seq_type=seq_type)
    return emit_fasta_plain(block, prev_byte, starts_in_seq, seq_type=seq_type)


# ---------------------------------------------------------------------------
# FASTQ
# ---------------------------------------------------------------------------

def emit_fastq_plain(block: torch.Tensor, prev_byte: int, *,
                     seq_type: int = C.SEQ_TYPE_DNA) -> dict:
    """Plain PyTorch version of the FASTQ emit kernel."""
    g = n_tiles(block.numel(), Q_TILE)
    m = classify_fastq_masks(block, start_state(prev_byte, False)[0], seq_type)
    sval = m["sval"]
    seq_keep, qual_keep, id_keep = m["seq_keep"], m["qual_keep"], m["id_keep"]
    stream_keep = seq_keep | m["id_unex"]
    chg, (first_lower, first_sval) = _plain_cases(stream_keep, sval)

    cum_stream = torch.cumsum(stream_keep.long(), 0)
    cum_seq = torch.cumsum(seq_keep.long(), 0)
    rec, in_com = m["rec_start"], m["in_com"]
    # rec_start is the '@' byte, which no stream keeps: the inclusive
    # prefixes at it are the record's start coordinates
    tag = torch.where(rec, TAG_REC, torch.where(chg, TAG_CHG, TAG_COM))
    spval = torch.where(in_com, torch.where(m["com_unex"], C.REPLACEMENT_NAME, sval), 0)
    zero = torch.zeros_like(cum_seq)
    cols = [spval | (tag << 8), torch.where(rec, cum_seq, torch.where(chg, cum_stream - 1, 0)),
            torch.where(rec, torch.cumsum(qual_keep.long(), 0), zero),
            torch.where(rec, torch.cumsum(id_keep.long(), 0), zero)]
    n_sp, sp_ok, (sp_tv, sp_a, sp_b, sp_c) = _plain_sparse(in_com | rec | chg, cols, Q_TILE, g)
    size = g * Q_TILE
    return _i32(sv=_plain_compact(stream_keep, sval, size),
                qv=_plain_compact(qual_keep, sval, size), iv=_plain_compact(id_keep, sval, size),
                cnt=stream_keep.sum(), cnt_seq=seq_keep.sum(), cnt_qual=qual_keep.sum(),
                cnt_id=id_keep.sum(), n_sp=n_sp, sp_ok=sp_ok, unex_id=m["id_unex"].sum(),
                unex_com=m["com_unex"].sum(), unex_seq=m["seq_unex"].sum(),
                unex_qual=m["qual_unex"].sum(), longest=_plain_longest(cum_seq, m["is_lf"]),
                first_lower=first_lower, first_sval=first_sval,
                sp_tv=sp_tv, sp_a=sp_a, sp_b=sp_b, sp_c=sp_c)


#: the order of the scalars ``naf_emit_fastq`` writes (csrc/emit_fastq.cu)
_Q_SCALARS = ("cnt", "cnt_seq", "cnt_qual", "cnt_id", "n_sp", "sp_ok", "unex_id", "unex_com",
              "unex_seq", "unex_qual", "longest", "first_lower", "first_sval")


def emit_fastq_kernel(block: torch.Tensor, prev_byte: int, *, seq_type: int = C.SEQ_TYPE_DNA,
                      lib=None) -> dict:
    """Launch the FASTQ emit kernel on ``block``'s device (``lib`` as in
    ``scan_fused.classify_fasta_kernel``): one pass over the block, then
    the zero fill and the scalars, with no host sync between."""
    n = _check_block(block)
    lib = build.kernel_lib(block, lib)
    dev = block.device
    tabs = device_tables(seq_type, dev)
    g = n_tiles(n, Q_TILE)
    scratch = torch.zeros(lib.naf_emit_fastq_scratch(g), dtype=torch.int32, device=dev)
    scal = torch.empty(len(_Q_SCALARS), dtype=torch.int32, device=dev)
    sv, qv, iv = (torch.empty(g * Q_TILE, dtype=torch.uint8, device=dev) for _ in range(3))
    sp = [torch.empty(g * CS_CAP, dtype=torch.int32, device=dev) for _ in range(4)]
    build.call(lib, "naf_emit_fastq", block.data_ptr(), n, start_state(prev_byte, False)[0],
               tabs["cls"].data_ptr(), tabs["repl_seq"], tabs["repl_name"], tabs["repl_qual"],
               CS_CAP, scratch.data_ptr(), scal.data_ptr(), sv.data_ptr(), qv.data_ptr(),
               iv.data_ptr(), *(a.data_ptr() for a in sp), g, build.stream_of(block))
    LAUNCHES["emit_fastq"] += 1
    r = dict(zip(_Q_SCALARS, scal.unbind()))
    r["sp_ok"] = r["sp_ok"] != 0
    return dict(sv=sv, qv=qv, iv=iv, **r, sp_tv=sp[0], sp_a=sp[1], sp_b=sp[2], sp_c=sp[3])


def emit_fastq_fused(block: torch.Tensor, prev_byte: int, *,
                     seq_type: int = C.SEQ_TYPE_DNA) -> dict:
    """Fused single-pass FASTQ emit of one block (whole records on the
    regular 4-line grid, as ``parallel.block.make_blocks_fastq`` cuts them).

    Returns a dict of tensors on the block's device, as the reference:
      sv, qv, iv  u8[B'] compacted stream, quality and id values (B' = B
                  rounded up to 32 KiB tiles; zero past their counts)
      cnt, cnt_seq, cnt_qual, cnt_id, n_sp, unex_id/com/seq/qual, longest,
                  first_lower (0 none / 1 upper / 2 lower), first_sval
                  i32 scalars
      sp_tv, sp_a, sp_b, sp_c  i32[tiles * CS_CAP] tagged sparse channel
                  (comment bytes, record starts with their sequence,
                  quality and id prefixes, case changes; zero past n_sp)
      sp_ok       bool: no tile had more than CS_CAP sparse entries
    A CUDA tensor runs the kernel; a CPU tensor the plain version.
    """
    check_1d(block, torch.uint8, "block")
    if block.is_cuda:
        return emit_fastq_kernel(block, prev_byte, seq_type=seq_type)
    return emit_fastq_plain(block, prev_byte, seq_type=seq_type)


# ---------------------------------------------------------------------------
# mask parity (decode render prep)
# ---------------------------------------------------------------------------

def apply_mask_parity_plain(chars: torch.Tensor, tog: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the mask-parity kernel."""
    parity = torch.cumsum((tog & 1).long(), 0) & 1
    return (chars.long() + 32 * parity).to(torch.uint8)


def apply_mask_parity_kernel(chars: torch.Tensor, tog: torch.Tensor, *, lib=None
                             ) -> torch.Tensor:
    """Launch the mask-parity kernel (``lib`` as in the classify kernel)."""
    check_1d(chars, torch.uint8, "chars")
    check_1d(tog, torch.uint8, "tog")
    if tog.numel() != chars.numel() or tog.device != chars.device:
        raise ValueError("chars and tog must match in length and device")
    lib = build.kernel_lib(chars, lib)
    n = chars.numel()
    g = n_tiles(n)
    stream = build.stream_of(chars)
    tile_par = torch.empty(g, dtype=torch.int32, device=chars.device)
    build.call(lib, "naf_mask_parity_tiles", tog.data_ptr(), n, tile_par.data_ptr(), g,
               stream)
    tile_in = ((torch.cumsum(tile_par, 0) - tile_par) & 1).int()
    out = torch.empty_like(chars)
    build.call(lib, "naf_mask_parity_apply", chars.data_ptr(), tog.data_ptr(), n,
               tile_in.data_ptr(), out.data_ptr(), g, stream)
    LAUNCHES["apply_mask_parity"] += 1
    return out


def apply_mask_parity(chars: torch.Tensor, tog: torch.Tensor) -> torch.Tensor:
    """u8 chars + u8 span toggles -> chars + 32 inside masked spans (the
    parity of the toggles up to and including each position)."""
    check_1d(chars, torch.uint8, "chars")
    check_1d(tog, torch.uint8, "tog")
    if chars.is_cuda:
        return apply_mask_parity_kernel(chars, tog)
    return apply_mask_parity_plain(chars, tog)
