"""Fused FASTA and FASTQ emit, and mask-parity apply: the port of
``naf_tpu/ops/emit_fused.py``'s ``emit_fasta_fused``, ``emit_fastq_fused``
and ``apply_mask_parity_pallas``.

``emit_fasta_fused`` classifies a block, left-compacts the kept stream, and
writes the tagged sparse channel of id bytes, comment bytes, record
markers and case changes, with the scalars the host stitch needs.
``emit_fastq_fused`` does the same for a FASTQ block, with three dense
compactions (stream, quality, id) and a sparse channel of comment bytes,
record starts (carrying their sequence, quality and id prefixes) and case
changes.  Each kernel (``csrc/emit_fasta.cu``, ``csrc/emit_fastq.cu``) is
one pass over the block that carries across tiles by decoupled look-back,
then a launch for the zero fill and the block scalars; the wrapper runs no
torch op between them but the zeroing of the scratch.

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
from .common import CLASSIFY_TILE, Q_TILE, TILE, check_1d, n_tiles
from .scan_fused import classify_fastq_masks, classify_masks, start_state
from .tables import device_tables

#: sparse entries kept per tile (the TPU kernels' _CS_CAP), for the 64 KiB
#: FASTA tiles and the 32 KiB FASTQ tiles alike
CS_CAP = 2048
TAG_ID, TAG_COM, TAG_REC, TAG_CHG = 0, 1, 2, 3


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


def _check_block(block: torch.Tensor) -> int:
    check_1d(block, torch.uint8, "block")
    n = block.numel()
    if n >= 1 << 31:
        raise ValueError(f"the emit kernels keep int32 offsets: a block of {n} bytes is "
                         "too long")
    return n


#: the order of the scalars ``naf_emit_fasta`` writes (csrc/emit_fasta.cu)
_F_SCALARS = ("cnt", "cnt_seq", "n_sp", "sp_ok", "unex_id", "unex_com", "unex_seq", "longest",
              "first_lower", "first_sval")


def _scalars(scal: torch.Tensor, names: tuple) -> dict:
    """The i32 scalars a kernel wrote, as 0-dim views of ``scal``; sp_ok (0
    or 1) as a bool view of its lowest byte (little-endian), so that no
    launch follows the kernel's."""
    r = dict(zip(names, scal.unbind()))
    r["sp_ok"] = scal.view(torch.uint8)[4 * names.index("sp_ok")].view(torch.bool)
    return r


def emit_fasta_kernel(block: torch.Tensor, prev_byte: int, starts_in_seq: bool = False,
                      *, seq_type: int = C.SEQ_TYPE_DNA, lib=None) -> dict:
    """Launch the FASTA emit kernel on ``block``'s device (``lib`` as in
    ``scan_fused.classify_fasta_kernel``): one pass over the block, then
    the zero fill and the scalars, with no host sync between."""
    n = _check_block(block)
    lib = build.kernel_lib(block, lib)
    dev = block.device
    tabs = device_tables(seq_type, dev)
    pe0, st0 = start_state(prev_byte, starts_in_seq)
    g = n_tiles(n)
    scratch = torch.zeros(lib.naf_emit_fasta_scratch(g), dtype=torch.int32, device=dev)
    scal = torch.empty(len(_F_SCALARS), dtype=torch.int32, device=dev)
    sv = torch.empty(g * TILE, dtype=torch.uint8, device=dev)
    sp_tv, sp_a = (torch.empty(g * CS_CAP, dtype=torch.int32, device=dev) for _ in range(2))
    build.call(lib, "naf_emit_fasta", block, block.data_ptr(), n, pe0, st0,
               tabs["cls"].data_ptr(), tabs["repl_seq"], tabs["repl_name"], CS_CAP,
               scratch.data_ptr(), scal.data_ptr(), sv.data_ptr(), sp_tv.data_ptr(),
               sp_a.data_ptr(), g, build.stream_of(block))
    LAUNCHES["emit_fasta"] += 1
    return dict(sv=sv, **_scalars(scal, _F_SCALARS), sp_tv=sp_tv, sp_a=sp_a)


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
    build.call(lib, "naf_emit_fastq", block, block.data_ptr(), n,
               start_state(prev_byte, False)[0], tabs["cls"].data_ptr(), tabs["repl_seq"],
               tabs["repl_name"], tabs["repl_qual"], CS_CAP, scratch.data_ptr(),
               scal.data_ptr(), sv.data_ptr(), qv.data_ptr(), iv.data_ptr(),
               *(a.data_ptr() for a in sp), g, build.stream_of(block))
    LAUNCHES["emit_fastq"] += 1
    return dict(sv=sv, qv=qv, iv=iv, **_scalars(scal, _Q_SCALARS), sp_tv=sp[0], sp_a=sp[1],
                sp_b=sp[2], sp_c=sp[3])


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
    """Launch the mask-parity kernel (``lib`` as in the classify kernel):
    one pass over the chars and the toggles."""
    check_1d(chars, torch.uint8, "chars")
    check_1d(tog, torch.uint8, "tog")
    if tog.numel() != chars.numel() or tog.device != chars.device:
        raise ValueError("chars and tog must match in length and device")
    lib = build.kernel_lib(chars, lib)
    n = chars.numel()
    g = n_tiles(n, CLASSIFY_TILE)
    # a ticket and a look-back status word per tile, zero on entry
    scratch = torch.zeros(1 + g, dtype=torch.int32, device=chars.device)
    out = torch.empty_like(chars)
    build.call(lib, "naf_mask_parity", chars, chars.data_ptr(), tog.data_ptr(), n,
               scratch.data_ptr(), out.data_ptr(), g, build.stream_of(chars))
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
