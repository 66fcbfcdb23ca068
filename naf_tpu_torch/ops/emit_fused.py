"""Fused FASTA emit and mask-parity apply: the port of
``naf_tpu/ops/emit_fused.py``'s ``emit_fasta_fused`` and
``apply_mask_parity_pallas``.

``emit_fasta_fused`` classifies a block, left-compacts the kept stream, and
writes the tagged sparse channel of id bytes, comment bytes, record
markers and case changes, with the scalars the host stitch needs.  Its
kernel (``csrc/emit_fasta.cu``) runs three passes; the scans over tile
summaries between them are torch ops on [tiles]-sized tensors.

One difference from the reference, on purpose: a case change at a tile's
first kept byte is found even when that byte is not the tile's first byte.
The TPU kernel misses it there (it reads its case carry only at tile
position 0), which loses a mask-run boundary; the port follows the host
encoder, which keeps it.
"""

from __future__ import annotations

import torch

from naf_tpu.format import constants as C

from ..device import LAUNCHES
from ..native import build
from .common import TILE, check_1d, n_tiles
from .scan_fused import classify_masks, entry_states, start_state, tile_maps
from .tables import device_tables

#: sparse entries kept per tile (the TPU kernel's _CS_CAP)
CS_CAP = 2048
TAG_ID, TAG_COM, TAG_REC, TAG_CHG = 0, 1, 2, 3
SUMMARY_COLS = 16          # csrc/emit_fasta.cu pass-B row width


def _result(sv, sp_tv, sp_a, cnt, cnt_seq, n_sp, sp_ok, unex_id, unex_com, unex_seq,
            longest, first_lower, first_sval) -> dict:
    i32 = torch.int32
    return dict(sv=sv, cnt=cnt.to(i32), cnt_seq=cnt_seq.to(i32), n_sp=n_sp.to(i32),
                sp_ok=sp_ok, unex_id=unex_id.to(i32), unex_com=unex_com.to(i32),
                unex_seq=unex_seq.to(i32), longest=longest.to(i32),
                first_lower=first_lower.to(i32), first_sval=first_sval.to(i32),
                sp_tv=sp_tv, sp_a=sp_a)


def emit_fasta_plain(block: torch.Tensor, prev_byte: int, starts_in_seq: bool = False,
                     *, seq_type: int = C.SEQ_TYPE_DNA) -> dict:
    """Plain PyTorch version of the emit kernel."""
    dev = block.device
    B = block.numel()
    g = n_tiles(B)
    pe0, st0 = start_state(prev_byte, starts_in_seq)
    m = classify_masks(block, pe0, st0, seq_type)
    sval = m["sval"]
    seq_keep = m["seq_keep"]
    stream_keep = seq_keep | m["id_unex"]

    kept = torch.nonzero(stream_keep).flatten()
    cnt = torch.tensor(kept.numel(), device=dev)
    sv = torch.zeros(g * TILE, dtype=torch.uint8, device=dev)
    sv[:kept.numel()] = sval[kept].to(torch.uint8)
    lower_k = sval[kept] >= 96
    chg = torch.zeros(B, dtype=torch.bool, device=dev)
    chg[kept[1:][lower_k[1:] != lower_k[:-1]]] = True

    cum_stream = torch.cumsum(stream_keep.long(), 0)
    cum_seq = torch.cumsum(seq_keep.long(), 0)
    marker, in_com, id_keep = m["marker"], m["in_com"], m["id_keep"]
    keep_sp = id_keep | in_com | marker | chg
    tag = torch.where(marker, TAG_REC,
                      torch.where(chg, TAG_CHG, torch.where(in_com, TAG_COM, TAG_ID)))
    spval = torch.where(id_keep | in_com,
                        torch.where(m["com_unex"], C.REPLACEMENT_NAME, sval), 0)
    tv = spval | (tag << 8)
    aval = torch.where(marker, cum_seq, torch.where(chg, cum_stream - 1, 0))

    # the per-tile cap: a tile keeps its first CS_CAP entries
    sp_pos = torch.nonzero(keep_sp).flatten()
    tile_of = sp_pos // TILE
    n_t = torch.bincount(tile_of, minlength=g)
    local = torch.arange(sp_pos.numel(), device=dev) - (torch.cumsum(n_t, 0) - n_t)[tile_of]
    sp_pos = sp_pos[local < CS_CAP]
    n_sp = torch.tensor(sp_pos.numel(), device=dev)
    sp_tv = torch.zeros(g * CS_CAP, dtype=torch.int32, device=dev)
    sp_a = torch.zeros(g * CS_CAP, dtype=torch.int32, device=dev)
    sp_tv[:sp_pos.numel()] = tv[sp_pos].int()
    sp_a[:sp_pos.numel()] = aval[sp_pos].int()

    # longest line: kept seq bytes between EOLs, and the open tail
    eol_cum = cum_seq[m["is_eol"]]
    lines = torch.diff(eol_cum, prepend=eol_cum.new_zeros(1))
    total_seq = cum_seq[-1] if B else torch.tensor(0, device=dev)
    open_tail = total_seq - (eol_cum[-1] if eol_cum.numel() else 0)
    longest = torch.maximum(lines.max() if lines.numel() else open_tail * 0, open_tail)

    if kept.numel():
        first_lower, first_sval = 1 + lower_k[0].long(), sval[kept[0]]
    else:
        first_lower = first_sval = torch.tensor(0, device=dev)
    return _result(sv, sp_tv, sp_a, cnt, total_seq, n_sp, (n_t <= CS_CAP).all(),
                   m["id_unex"].sum(), m["com_unex"].sum(), m["seq_unex"].sum(),
                   longest, first_lower, first_sval)


def emit_fasta_kernel(block: torch.Tensor, prev_byte: int, starts_in_seq: bool = False,
                      *, seq_type: int = C.SEQ_TYPE_DNA, lib=None) -> dict:
    """Launch the emit kernel on ``block``'s device (``lib`` as in
    ``scan_fused.classify_fasta_kernel``)."""
    check_1d(block, torch.uint8, "block")
    lib = build.kernel_lib(block, lib)
    dev = block.device
    tabs = device_tables(seq_type, dev)
    pe0, st0 = start_state(prev_byte, starts_in_seq)
    n = block.numel()
    if n >= 1 << 31:
        raise ValueError(f"the emit kernel keeps int32 offsets: a block of {n} bytes is "
                         "too long")
    g = n_tiles(n)
    stream = build.stream_of(block)
    args = (tabs["cls"].data_ptr(), tabs["repl_seq"], tabs["repl_name"])

    st_in = entry_states(tile_maps(block, pe0, tabs["cls"], lib), st0)
    summ = torch.empty((g, SUMMARY_COLS), dtype=torch.int32, device=dev)
    build.call(lib, "naf_emit_fasta_summary", block.data_ptr(), n, pe0, st_in.data_ptr(),
               *args, summ.data_ptr(), g, stream)

    # scans over the tile summaries (csrc/emit_fasta.cu pass-B columns)
    s = summ.long()
    n_stream, n_seq, n_sp_in, has, first, last = (s[:, k] for k in (0, 1, 2, 6, 7, 8))
    stream_off = torch.cumsum(n_stream, 0) - n_stream
    seq_off = torch.cumsum(n_seq, 0) - n_seq
    idx = torch.arange(g, device=dev)
    last_k = torch.cummax(torch.where(has == 1, idx, -1), 0).values
    prev_k = torch.cat([last_k.new_full((1,), -1), last_k[:-1]])
    prev_lower = torch.where(prev_k >= 0, last[prev_k.clamp(min=0)], -1)
    n_t = n_sp_in + ((has == 1) & (prev_k >= 0) & (first != prev_lower)).long()
    capped = n_t.clamp(max=CS_CAP)
    sp_off = torch.cumsum(capped, 0) - capped
    cnt, cnt_seq, n_sp = n_stream.sum(), n_seq.sum(), capped.sum()

    f_tile = torch.argmax(has)
    any_kept = has[f_tile] == 1
    first_lower = torch.where(any_kept, 1 + first[f_tile], 0)
    first_sval = torch.where(any_kept, s[f_tile, 9], 0)

    l_has, l_pre, l_post, l_mx = (s[:, k] for k in (10, 11, 12, 13))
    eol_end = torch.where(l_has == 1, seq_off + n_seq - l_post, -1)
    last_e = torch.cummax(eol_end, 0).values
    base = torch.cat([last_e.new_zeros(1), last_e[:-1]]).clamp(min=0)
    first_line = torch.where(l_has == 1, seq_off + l_pre - base, 0)
    longest = torch.maximum(torch.maximum(l_mx.max(), first_line.max()),
                            cnt_seq - last_e[-1].clamp(min=0))

    tile_in = torch.stack([st_in.long(), stream_off, seq_off, prev_lower, sp_off], 1).int()
    totals = torch.stack([cnt, n_sp]).int()
    sv = torch.empty(g * TILE, dtype=torch.uint8, device=dev)
    sp_tv = torch.empty(g * CS_CAP, dtype=torch.int32, device=dev)
    sp_a = torch.empty(g * CS_CAP, dtype=torch.int32, device=dev)
    build.call(lib, "naf_emit_fasta_write", block.data_ptr(), n, pe0, tile_in.data_ptr(),
               totals.data_ptr(), *args, CS_CAP, sv.data_ptr(), sp_tv.data_ptr(),
               sp_a.data_ptr(), g, stream)
    LAUNCHES["emit_fasta"] += 1
    return _result(sv, sp_tv, sp_a, cnt, cnt_seq, n_sp, (n_t <= CS_CAP).all(),
                   s[:, 3].sum(), s[:, 4].sum(), s[:, 5].sum(), longest, first_lower,
                   first_sval)


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
