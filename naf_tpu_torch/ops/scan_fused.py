"""FASTA and FASTQ byte classify and the i32 prefix scans: the port of
``naf_tpu/ops/scan_fused.py``'s ``classify_fasta_fused``,
``classify_fastq_fused``, ``cumsum_i32_pallas``, ``maxscan_i32_pallas``,
``scan_fasta_fused`` and ``scan_fastq_fused``.

On the fused encode each classify runs inside its emit kernel
(``csrc/classify.cuh``, ``csrc/classify_fastq.cuh``); ``classify_fasta`` and
``classify_fastq`` are the standalone launches of the two-pass encode,
which ``scan_fasta_fused`` and ``scan_fastq_fused`` turn into its masks.
``cumsum_i32`` and ``maxscan_i32`` run ``csrc/scan.cu``.

FASTA flag bits as the TPU kernel: bit0 marker, bit1 seq_unex, bit2 seq_keep,
bit3 is_eol, bit4 id_keep, bit5 id_unex, bit6 in_com, bit7 com_unex.
FASTQ flag bits as the TPU kernel: bit0 rec_start, bit1 seq_unex,
bit2 seq_keep, bit3 is_lf, bit4 id_keep|qual_keep, bit5
id_unex|qual_unex|com_unex, bit6 in_com, bit7 quality-line byte.
"""

from __future__ import annotations

import torch

from ..device import LAUNCHES
from ..format import constants as C
from ..native import build
from .common import CLASSIFY_TILE, Q_TILE, SCAN_TILE, check_1d, n_tiles
from .tables import device_tables
from .tables_np import (CLS_EOL, CLS_UNEX_COM, CLS_UNEX_QUAL, CLS_UNEX_SEQ, CLS_UNEX_TEXT,
                        IS_EOL)

ST_ID, ST_COM, ST_SEQ = 0, 1, 2
M_IDENT, M_SPACE, M_CID, M_CCOM, M_CSEQ = range(5)


def start_state(prev_byte: int, starts_in_seq: bool) -> tuple[int, int]:
    """(prev-is-EOL, parser state) before a block's first byte."""
    return int(bool(IS_EOL[int(prev_byte)])), ST_SEQ if starts_in_seq else ST_ID


def entry_states(maps: torch.Tensor, st0: int) -> torch.Tensor:
    """i32[g]: parser state entering each tile, from the tiles' composed
    maps (the FASTQ classify's scan between its kernel passes; O(tiles)
    torch ops).

    A constant map (marker, EOL) resets the state; after it, or from st0 if
    none came, any space map turns ID into COMMENT.
    """
    m = maps.long()
    g = m.numel()
    idx = torch.arange(g, device=m.device)
    last_c = torch.cummax(torch.where(m >= M_CID, idx, -1), 0).values
    prev_c = torch.cat([last_c.new_full((1,), -1), last_c[:-1]])
    base = torch.where(prev_c >= 0, m[prev_c.clamp(min=0)] - 2, st0)
    sp = (m == M_SPACE).long()
    csp = torch.cumsum(sp, 0)
    spaces = (csp - sp) - torch.where(prev_c >= 0, csp[prev_c.clamp(min=0)], 0)
    return torch.where((base == ST_ID) & (spaces > 0), ST_COM, base).int()


def classify_masks(x: torch.Tensor, pe0: int, st0: int, seq_type: int) -> dict:
    """Plain per-byte classify of u8[B]: every mask the flags encode, plus
    the stream value (unexpected id/seq bytes replaced)."""
    tabs = device_tables(seq_type, x.device)
    b = x.long()
    cls = tabs["cls"][b].long()
    is_eol = (cls & CLS_EOL) != 0
    is_sp = is_eol | (b == 0x09) | (b == 0x20)
    n = b.numel()
    pe = torch.cat([torch.tensor([bool(pe0)], device=x.device), is_eol[:-1]])[:n]
    marker = (b == ord(">")) & pe
    space_nc = is_sp & ~is_eol
    # parser state AFTER each byte: the last reset (marker -> ID, EOL -> SEQ)
    # or st0, then ID -> COMMENT once a space follows it
    idx = torch.arange(n, device=x.device)
    last_r = torch.cummax(torch.where(marker | is_eol, idx, -1), 0).values
    base = torch.where(last_r >= 0,
                       torch.where(marker[last_r.clamp(min=0)], ST_ID, ST_SEQ), st0)
    csp = torch.cumsum(space_nc.long(), 0)
    spaces = csp - torch.where(last_r >= 0, csp[last_r.clamp(min=0)], 0)
    after = torch.where((base == ST_ID) & (spaces > 0), ST_COM, base)
    sb = torch.cat([after.new_full((1,), st0), after[:-1]])[:n]

    in_id = ~marker & (sb == ST_ID) & ~is_sp
    in_com = ~marker & (sb == ST_COM) & ~is_eol
    in_seq = ~marker & (sb == ST_SEQ)
    unex_text = (cls & CLS_UNEX_TEXT) != 0
    id_unex = in_id & unex_text
    id_keep = in_id & ~unex_text
    com_unex = in_com & ((cls & CLS_UNEX_COM) != 0)
    seq_keep = in_seq & ~is_sp
    seq_unex = seq_keep & ((cls & CLS_UNEX_SEQ) != 0)
    sval = torch.where(id_unex, tabs["repl_name"],
                       torch.where(seq_unex, tabs["repl_seq"], b))
    return dict(marker=marker, seq_unex=seq_unex, seq_keep=seq_keep,
                is_eol=is_eol, id_keep=id_keep, id_unex=id_unex, in_com=in_com,
                com_unex=com_unex, sval=sval)


_FLAG_BITS = ("marker", "seq_unex", "seq_keep", "is_eol", "id_keep", "id_unex",
              "in_com", "com_unex")


def classify_fasta_plain(block: torch.Tensor, prev_byte: int, starts_in_seq: bool = False,
                         *, seq_type: int = C.SEQ_TYPE_DNA):
    """Plain PyTorch version of the classify kernel."""
    pe0, st0 = start_state(prev_byte, starts_in_seq)
    m = classify_masks(block, pe0, st0, seq_type)
    flags = torch.zeros_like(block, dtype=torch.long)
    for bit, key in enumerate(_FLAG_BITS):
        flags |= m[key].long() << bit
    return flags.to(torch.uint8), m["sval"].to(torch.uint8)


def classify_fasta_kernel(block: torch.Tensor, prev_byte: int, starts_in_seq: bool = False,
                          *, seq_type: int = C.SEQ_TYPE_DNA, lib=None):
    """Launch the classify kernel on ``block``'s device (``lib``: the kernel
    library; the CUDA build unless a test passes the host-emulation one):
    one pass over the block."""
    check_1d(block, torch.uint8, "block")
    lib = build.kernel_lib(block, lib)
    tabs = device_tables(seq_type, block.device)
    pe0, st0 = start_state(prev_byte, starts_in_seq)
    n = block.numel()
    g = n_tiles(n, CLASSIFY_TILE)
    # a ticket and a look-back status word per tile, zero on entry
    scratch = torch.zeros(1 + g, dtype=torch.int32, device=block.device)
    flags = torch.empty_like(block)
    sval = torch.empty_like(block)
    build.call(lib, "naf_classify_fasta", block.data_ptr(), n, pe0, st0,
               tabs["cls"].data_ptr(), tabs["repl_seq"], tabs["repl_name"], scratch.data_ptr(),
               flags.data_ptr(), sval.data_ptr(), g, build.stream_of(block))
    LAUNCHES["classify_fasta"] += 1
    return flags, sval


def classify_fasta(block: torch.Tensor, prev_byte: int, starts_in_seq: bool = False,
                   *, seq_type: int = C.SEQ_TYPE_DNA):
    """u8[B] -> (flags u8[B], stream value u8[B]).

    ``prev_byte`` is the byte before the block ('>' for a whole input past
    its first marker); ``starts_in_seq`` whether the block was cut inside a
    record.  A CUDA tensor runs the kernel; a CPU tensor the plain version.
    """
    check_1d(block, torch.uint8, "block")
    if block.is_cuda:
        return classify_fasta_kernel(block, prev_byte, starts_in_seq, seq_type=seq_type)
    return classify_fasta_plain(block, prev_byte, starts_in_seq, seq_type=seq_type)


# ---------------------------------------------------------------------------
# FASTQ
# ---------------------------------------------------------------------------

def classify_fastq_masks(x: torch.Tensor, pe0: int, seq_type: int) -> dict:
    """Plain per-byte FASTQ classify of u8[B] (the regular 4-line grid of a
    block cut at a record start): every mask the flags encode, plus the
    stream/quality value (unexpected id/seq/quality bytes replaced)."""
    tabs = device_tables(seq_type, x.device)
    b = x.long()
    cls = tabs["cls"][b].long()
    n = b.numel()
    is_lf = b == 0x0A
    is_eolc = (cls & CLS_EOL) != 0
    is_sp = is_eolc | (b == 0x09) | (b == 0x20)
    pe = torch.cat([torch.tensor([bool(pe0)], device=x.device), is_lf[:-1]])[:n]
    lane = (torch.cumsum(is_lf.long(), 0) - is_lf.long()) & 3
    rec_start = (b == ord("@")) & pe & (lane == 0)
    # header sub-state BEFORE each byte: COMMENT once a non-EOL space has
    # come since the last EOL (an EOL starts the next header at ID)
    idx = torch.arange(n, device=x.device)
    last_r = torch.cummax(torch.where(is_eolc, idx, -1), 0).values
    csp = torch.cumsum((is_sp & ~is_eolc).long(), 0)
    com_after = (csp - torch.where(last_r >= 0, csp[last_r.clamp(min=0)], 0)) > 0
    com = torch.cat([com_after.new_zeros(1), com_after[:-1]])[:n]

    in_hdr = (lane == 0) & ~rec_start & ~is_eolc
    in_id = in_hdr & ~com & ~is_sp
    in_com = in_hdr & com
    unex_text = (cls & CLS_UNEX_TEXT) != 0
    id_unex = in_id & unex_text
    seq_keep = (lane == 1) & ~is_sp
    seq_unex = seq_keep & ((cls & CLS_UNEX_SEQ) != 0)
    qual_line = (lane == 3) & ~is_lf
    qual_rest = qual_line & ~pe & ~is_sp
    qual_unex = qual_rest & ((cls & CLS_UNEX_QUAL) != 0)
    sval = torch.where(id_unex, tabs["repl_name"],
                       torch.where(seq_unex, tabs["repl_seq"],
                                   torch.where(qual_unex, tabs["repl_qual"], b)))
    return dict(rec_start=rec_start, seq_unex=seq_unex, seq_keep=seq_keep, is_lf=is_lf,
                id_keep=in_id & ~unex_text, qual_keep=qual_rest | (qual_line & pe),
                id_unex=id_unex, qual_unex=qual_unex,
                com_unex=in_com & ((cls & CLS_UNEX_COM) != 0), in_com=in_com,
                qual_line=qual_line, sval=sval)


def _fastq_flags(m: dict) -> torch.Tensor:
    bits = (m["rec_start"], m["seq_unex"], m["seq_keep"], m["is_lf"],
            m["id_keep"] | m["qual_keep"], m["id_unex"] | m["qual_unex"] | m["com_unex"],
            m["in_com"], m["qual_line"])
    flags = torch.zeros_like(m["sval"])
    for bit, mask in enumerate(bits):
        flags |= mask.long() << bit
    return flags.to(torch.uint8)


def classify_fastq_plain(block: torch.Tensor, prev_byte: int, *,
                         seq_type: int = C.SEQ_TYPE_DNA):
    """Plain PyTorch version of the FASTQ classify kernel."""
    m = classify_fastq_masks(block, start_state(prev_byte, False)[0], seq_type)
    return _fastq_flags(m), m["sval"].to(torch.uint8)


def fastq_tile_entry(block: torch.Tensor, cls: torch.Tensor, lib) -> torch.Tensor:
    """Kernel pass A and the scan after it: i32[tiles, 2], the line index
    mod 4 and the header sub-state entering each 32 KiB tile (the
    standalone classify's first pass, and the emit's)."""
    n = block.numel()
    g = n_tiles(n, Q_TILE)
    maps = torch.empty(g, dtype=torch.int32, device=block.device)
    lfs = torch.empty(g, dtype=torch.int32, device=block.device)
    build.call(lib, "naf_fastq_tile_maps", block.data_ptr(), n, cls.data_ptr(),
               maps.data_ptr(), lfs.data_ptr(), g, build.stream_of(block))
    lane = (torch.cumsum(lfs.long(), 0) - lfs.long()) & 3
    return torch.stack([lane.int(), entry_states(maps, ST_ID)], 1).contiguous()


def classify_fastq_kernel(block: torch.Tensor, prev_byte: int, *,
                          seq_type: int = C.SEQ_TYPE_DNA, lib=None):
    """Launch the FASTQ classify kernel on ``block``'s device (``lib`` as in
    ``classify_fasta_kernel``)."""
    check_1d(block, torch.uint8, "block")
    lib = build.kernel_lib(block, lib)
    tabs = device_tables(seq_type, block.device)
    n = block.numel()
    tile_in = fastq_tile_entry(block, tabs["cls"], lib)
    flags = torch.empty_like(block)
    sval = torch.empty_like(block)
    build.call(lib, "naf_classify_fastq", block.data_ptr(), n,
               start_state(prev_byte, False)[0], tile_in.data_ptr(), tabs["cls"].data_ptr(),
               tabs["repl_seq"], tabs["repl_name"], tabs["repl_qual"], flags.data_ptr(),
               sval.data_ptr(), tile_in.shape[0], build.stream_of(block))
    LAUNCHES["classify_fastq"] += 1
    return flags, sval


def classify_fastq(block: torch.Tensor, prev_byte: int, *, seq_type: int = C.SEQ_TYPE_DNA):
    """u8[B] -> (flags u8[B], stream/quality value u8[B]).

    ``block`` holds whole FASTQ records on the regular 4-line grid, cut
    right after a record's leading '@' or at a record start; ``prev_byte``
    is the byte before it.  A CUDA tensor runs the kernel; a CPU tensor the
    plain version.
    """
    check_1d(block, torch.uint8, "block")
    if block.is_cuda:
        return classify_fastq_kernel(block, prev_byte, seq_type=seq_type)
    return classify_fastq_plain(block, prev_byte, seq_type=seq_type)


# ---------------------------------------------------------------------------
# i32 prefix scans
# ---------------------------------------------------------------------------

#: the max scan's carry start (the TPU kernel's _NEGBIG): no output is below it
NEG_BIG = -(1 << 30)
_SCAN_OPS = {"add": (0, "cumsum_i32"), "max": (1, "maxscan_i32")}
_SCAN_DTYPES = (torch.bool, torch.uint8, torch.int32)


def cumsum_i32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the add scan."""
    check_1d(x, _SCAN_DTYPES, "x")
    return torch.cumsum(x, 0, dtype=torch.int32)


def maxscan_i32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the max scan (floored at -2^30)."""
    check_1d(x, _SCAN_DTYPES, "x")
    if x.numel() == 0:
        return torch.zeros(0, dtype=torch.int32, device=x.device)
    return torch.cummax(x.to(torch.int32), 0).values.clamp(min=NEG_BIG)


def scan_i32_kernel(x: torch.Tensor, op: str, *, lib=None) -> torch.Tensor:
    """Launch the scan kernel, ``op`` 'add' or 'max' (``lib`` as in
    ``classify_fasta_kernel``)."""
    check_1d(x, _SCAN_DTYPES, "x")
    lib = build.kernel_lib(x, lib)
    code, counter = _SCAN_OPS[op]
    n = x.numel()
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    if n:
        g = n_tiles(n, SCAN_TILE)
        # a ticket, a pad word and a u64 status word per tile, zero on entry
        scratch = torch.zeros(2 + 2 * g, dtype=torch.int32, device=x.device)
        build.call(lib, "naf_scan_i32", x.data_ptr(), x.element_size(), n, code,
                   scratch.data_ptr(), out.data_ptr(), g, build.stream_of(x))
        LAUNCHES[counter] += 1
    return out


def cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive i32 prefix sum of a bool, u8 or i32 stream (wrapping as
    i32).  A CUDA tensor runs the kernel; a CPU tensor the plain version."""
    if x.is_cuda:
        return scan_i32_kernel(x, "add")
    return cumsum_i32_plain(x)


def maxscan_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive i32 prefix max, floored at -2^30 as the TPU kernel's carry
    start floors it.  A CUDA tensor runs the kernel; a CPU tensor the plain
    version."""
    if x.is_cuda:
        return scan_i32_kernel(x, "max")
    return maxscan_i32_plain(x)


# ---------------------------------------------------------------------------
# the two-pass encode's masks from the standalone classifies
# ---------------------------------------------------------------------------

def _bit(flags: torch.Tensor, bit: int) -> torch.Tensor:
    return (flags & (1 << bit)) != 0


def _hist_cond(mask: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """i32[256] histogram of the bytes ``b`` where ``mask``; the count runs
    only when some byte is set (the clean case skips it, as the TPU
    package's ``lax.cond`` does)."""
    if not bool(mask.any()):
        return torch.zeros(256, dtype=torch.int32, device=b.device)
    return torch.bincount(b[mask].long(), minlength=256).to(torch.int32)


def scan_fasta_fused(block: torch.Tensor, prev_byte: int, seq_type: int = C.SEQ_TYPE_DNA,
                     starts_in_seq: bool = False) -> dict:
    """The masks of a FASTA block (``naf_tpu/ops/scan_fused.py``'s dict of
    the same name): rec_start, stream_keep/val, seq_keep, is_eol, id_keep,
    id_unex, com_keep, com_unex, com_val, and the unexpected-byte
    histograms hist_id, hist_comment, hist_seq (i32[256])."""
    flags, sval = classify_fasta(block, prev_byte, starts_in_seq, seq_type=seq_type)
    seq_unex, seq_keep, id_unex = _bit(flags, 1), _bit(flags, 2), _bit(flags, 5)
    com_unex = _bit(flags, 7)
    return dict(
        rec_start=_bit(flags, 0),
        stream_keep=seq_keep | seq_unex | id_unex,
        stream_val=sval,
        seq_keep=seq_keep | seq_unex,
        is_eol=_bit(flags, 3),
        id_keep=_bit(flags, 4),
        id_unex=id_unex,
        com_keep=_bit(flags, 6),
        com_unex=com_unex,
        com_val=torch.where(com_unex, C.REPLACEMENT_NAME, block),
        hist_id=_hist_cond(id_unex, block),
        hist_comment=_hist_cond(com_unex, block),
        hist_seq=_hist_cond(seq_unex, block),
    )


def scan_fastq_fused(block: torch.Tensor, prev_byte: int,
                     seq_type: int = C.SEQ_TYPE_DNA) -> dict:
    """The masks of a FASTQ block: those of ``scan_fasta_fused`` plus
    qual_keep, qual_unex, qual_val and hist_qual."""
    flags, sval = classify_fastq(block, prev_byte, seq_type=seq_type)
    b45, b5, com_keep, is_qual = _bit(flags, 4), _bit(flags, 5), _bit(flags, 6), _bit(flags, 7)
    seq_unex, seq_keep = _bit(flags, 1), _bit(flags, 2)
    id_unex = b5 & ~com_keep & ~is_qual
    com_unex = b5 & com_keep
    qual_unex = b5 & is_qual
    return dict(
        rec_start=_bit(flags, 0),
        stream_keep=seq_keep | id_unex,
        stream_val=torch.where(qual_unex, block, sval),
        seq_keep=seq_keep,
        is_eol=_bit(flags, 3),
        id_keep=b45 & ~is_qual,
        id_unex=id_unex,
        com_keep=com_keep,
        com_unex=com_unex,
        com_val=torch.where(com_unex, C.REPLACEMENT_NAME, block),
        qual_keep=b45 & is_qual,
        qual_unex=qual_unex,
        qual_val=torch.where(qual_unex, C.REPLACEMENT_QUAL, block),
        hist_id=_hist_cond(id_unex, block),
        hist_comment=_hist_cond(com_unex, block),
        hist_seq=_hist_cond(seq_unex, block),
        hist_qual=_hist_cond(qual_unex, block),
    )
