"""Device FASTA and FASTQ render: the uniform-group path and the ragged
path of ``naf_tpu/parallel/decode.py``, the latter also over a mesh.

Uniform path (``regular_session``, ``render_regular``): the section bytes
become chars on the device (``ops.unpack`` kernel, or the upper-case fold
of a text archive; then, for masked FASTA, the ``ops.emit_fused``
mask-parity kernel over a toggle scatter at the masked-span bounds), and
records whose (header length, sequence length) repeat are laid out as
strided copies into one output tensor.  A FASTA record is its header, its
full lines plus a newline column, and its tail line; a FASTQ record is
``[header, sequence, "\\n+\\n", quality, "\\n"]``.

Ragged path (``render_batched``, ``render_sharded``): every output
position is a function of the record it falls in, rendered in batches of
at most ``OUT_BATCH`` bytes with i32 indices rebased per batch
(``_render_step``, the gather-minimal ``_make_kernel``).  Its per-position
record lookups are segment broadcasts by the max-scan kernel, and its mask
parity a prefix sum by the add-scan kernel (``ops.scan``).  Over a mesh of
D devices each batch is cut into D output chunks, each rendered on its own
device, and the chunks are joined in order; one device renders the whole
batch.  The uniform path is for one device only, as in the reference.

``RenderPlan``, ``build_plan``, ``_next_seq_char`` and ``_next_qual_char``
are the port's copies of the reference's render metadata (the tests hold
them against the originals).  ``decline_reason`` says which archives the
uniform path leaves to the ragged one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..format import constants as C
from ..native import host as native
from ..ops import scan as S
from ..ops.assemble import const_column, ragged_concat, split_blob
from ..ops.emit_fused import apply_mask_parity
from ..ops.render import body_length
from ..ops.tables import device_tables
from ..ops.unpack import unpack_4bit
from ..utils.trace import note, trace_span
from .mesh import fetch

MODE_FASTA = 0
MODE_FASTQ = 1

#: output bytes of one ragged render batch; the uniform path takes outputs
#: below two of them (the reference's limit)
OUT_BATCH = 256 << 20


class RenderOverflow(Exception):
    """A single record's output/char/header span exceeds the i32-rebased
    batch window; the caller renders on the host instead."""


#: the most record shapes the uniform path lays out one by one
_REG_MAX_GROUPS = 24


@dataclass
class RenderPlan:
    """Per-archive render metadata (host numpy, O(n_records))."""

    mode: int
    line_len: int
    rna: bool
    packed: bool            # nucleotide 4-bit stream (else raw text bytes)
    upper: bool             # uppercase raw text (mask ignored)
    slens: np.ndarray       # i64[N] sequence length per record
    E: np.ndarray           # i64[N] cumsum char ends
    O: np.ndarray           # i64[N] cumsum output ends (header+body)
    H: np.ndarray           # i64[N] cumsum header-blob ends
    hdr: np.ndarray         # u8[sum hdr lens] concatenated header lines
    bounds: np.ndarray      # i64[2M] flattened masked-span bounds (sorted)
    total_out: int


def _header_lines_np(lead: bytes, ids_blob: Optional[bytes],
                     comments_blob: Optional[bytes], name_sep: bytes, n: int):
    """(u8 header lines, i64 line lengths): ``lead``, the id, ``name_sep``
    and the comment where the comment is non-empty, ``\\n``, a record."""
    cols = [const_column(lead, n)]
    if ids_blob is not None and comments_blob is not None:
        idc = split_blob(ids_blob, n)
        com = split_blob(comments_blob, n, "names")
        cols += [idc, const_column(name_sep, n, present=com.length > 0), com]
    elif ids_blob is not None:
        cols.append(split_blob(ids_blob, n))
    elif comments_blob is not None:
        cols.append(split_blob(comments_blob, n, "names"))
    cols.append(const_column(b"\n", n))
    hlens = np.zeros(n, np.int64)
    for c in cols:
        hlens += np.broadcast_to(np.asarray(c.length, np.int64), (n,))
    return ragged_concat(cols, n), hlens


def build_plan(*, mode: int, line_len: int, rna: bool, packed: bool,
               upper: bool, slens: np.ndarray,
               ids_blob: Optional[bytes], comments_blob: Optional[bytes],
               name_sep: bytes, mask_spans=None) -> RenderPlan:
    """Precompute the prefix sums and the header blob of a render.  The
    header lines come from one pass of the host library
    (``native.header_lines``), or from the numpy columns without it; the
    ``build-plan`` span's ``headers`` field says which."""
    with trace_span("build-plan", records=np.size(slens)):
        slens = np.asarray(slens, dtype=np.int64)
        n = slens.size
        E = np.cumsum(slens)

        lead = b"@" if mode == MODE_FASTQ else b">"
        got = (native.header_lines(ids_blob, comments_blob, n, lead, name_sep)
               if native.available() else None)
        if got is not None:
            (hdr, hlens), headers = got, "native"
        else:       # no library, or a corrupt blob, which split_blob names
            hdr, hlens = _header_lines_np(lead, ids_blob, comments_blob, name_sep, n)
            headers = "numpy"
        note(headers=headers, bytes=hdr.size)
        H = np.cumsum(hlens)

        if mode == MODE_FASTQ:
            blens = 2 * slens + 4
        else:
            blens = body_length(slens, line_len).astype(np.int64)
        O = np.cumsum(hlens + blens)

        if mask_spans is not None and mask_spans[0].size:
            starts, ends = mask_spans
            bounds = np.empty(2 * starts.size, np.int64)
            bounds[0::2] = starts
            bounds[1::2] = ends
        else:
            bounds = np.zeros(0, np.int64)

        return RenderPlan(mode=mode, line_len=line_len, rna=rna, packed=packed,
                          upper=upper, slens=slens, E=E, O=O, H=H, hdr=hdr,
                          bounds=bounds, total_out=int(O[-1]) if n else 0)


def _groups(plan: RenderPlan):
    """(hlens, slens, group starts, group ends) of runs of equal shape."""
    n = plan.slens.size
    hlens = np.diff(plan.H, prepend=np.int64(0))
    slens = plan.slens.astype(np.int64)
    if n > 1:
        change = np.flatnonzero((hlens[1:] != hlens[:-1])
                                | (slens[1:] != slens[:-1])) + 1
    else:
        change = np.zeros(0, np.int64)
    starts = np.concatenate([[0], change]).astype(np.int64)
    ends = np.append(starts[1:], n)
    return hlens, slens, starts, ends


def _body_lengths(plan: RenderPlan, slens: np.ndarray) -> np.ndarray:
    if plan.mode == MODE_FASTQ:
        return 2 * slens + 4
    return body_length(slens, plan.line_len)


def decline_reason(plan: RenderPlan) -> Optional[str]:
    """Why the uniform-group render does not take this archive, or None."""
    if plan.slens.size == 0 or plan.total_out == 0:
        return "empty"
    if plan.total_out >= min(1 << 31, 2 * OUT_BATCH):
        return "too_large"
    hlens, slens, starts, _ = _groups(plan)
    if starts.size > _REG_MAX_GROUPS:
        return "too_many_groups"
    if int((hlens + _body_lengths(plan, slens)).sum()) != plan.total_out:
        return "spill"
    return None


def _upper(ch: torch.Tensor) -> torch.Tensor:
    """a-z folded to A-Z (any integer dtype)."""
    return torch.where((ch >= ord("a")) & (ch <= ord("z")), ch - 32, ch)


def _prep_chars_step(seq_d: torch.Tensor, bounds_d: Optional[torch.Tensor], *, packed: bool,
                     upper: bool, rna: bool) -> torch.Tensor:
    """Section bytes -> rendered chars: unpack (nucleotide) or the raw
    bytes, folded to upper case where ``upper`` (text); then +32 inside the
    masked spans whose bounds (char indices) ``bounds_d`` holds."""
    if packed:
        chars = unpack_4bit(seq_d, rna)
    else:
        chars = _upper(seq_d) if upper else seq_d
    if bounds_d is None:
        return chars
    tog = torch.zeros_like(chars)
    tog.index_add_(0, bounds_d, torch.ones_like(bounds_d, dtype=torch.uint8))
    return apply_mask_parity(chars, tog)


def regular_session(plan: RenderPlan, seq_bytes: np.ndarray,
                    qual: Optional[np.ndarray] = None, *, device
                    ) -> Optional[Callable[[], torch.Tensor]]:
    """Uniform-group render session, or None when ``decline_reason`` says so.

    Uploads the section bytes, the quality bytes (FASTQ), the headers and
    the mask bounds once and returns a zero-argument callable that renders
    the whole output as one u8 tensor on ``device`` (repeated calls time
    the device-resident render).
    """
    if decline_reason(plan) is not None:
        return None
    fastq = plan.mode == MODE_FASTQ
    hlens, slens, starts, ends = _groups(plan)
    L = plan.line_len
    blens = _body_lengths(plan, slens)
    sb = np.asarray(seq_bytes, np.uint8)
    seq_d = _up(sb, device)
    n_chars = 2 * sb.size if plan.packed else sb.size
    bounds = plan.bounds[plan.bounds < n_chars]
    bounds_d = _up(bounds.astype(np.int64, copy=False), device) if bounds.size else None
    hdr_d = _up(np.asarray(plan.hdr, np.uint8), device)
    qual_d = _up(np.asarray(qual, np.uint8), device) if fastq else None
    total = plan.total_out

    layout = []
    o = 0
    for r0, r1 in zip(starts, ends):
        nrec, hl, sl = int(r1 - r0), int(hlens[r0]), int(slens[r0])
        c0 = int(plan.E[r0 - 1]) if r0 > 0 else 0
        h0 = int(plan.H[r0 - 1]) if r0 > 0 else 0
        w = hl + int(blens[r0])
        layout.append((o, nrec, hl, sl, w, c0, h0))
        o += nrec * w

    def run() -> torch.Tensor:
        chars = _prep_chars_step(seq_d, bounds_d, packed=plan.packed, upper=plan.upper,
                                 rna=plan.rna)
        out = torch.empty(total, dtype=torch.uint8, device=seq_d.device)
        for o, nrec, hl, sl, w, c0, h0 in layout:
            view = out[o:o + nrec * w].view(nrec, w)
            if hl:
                view[:, :hl] = hdr_d[h0:h0 + nrec * hl].view(nrec, hl)
            if fastq:
                _fastq_group_step(view, chars, qual_d, nrec, hl, sl, c0)
            else:
                _fasta_group_step(view, chars, nrec, hl, sl, L, c0)
        return out

    return run


def _fasta_group_step(view: torch.Tensor, chars: torch.Tensor, nrec: int, hl: int, sl: int,
                      L: int, c0: int) -> None:
    """Lay out the bodies of ``nrec`` FASTA records of one shape into view."""
    if sl == 0:
        return
    ch = chars[c0:c0 + nrec * sl].view(nrec, sl)
    if L <= 0:
        view[:, hl:hl + sl] = ch
        view[:, hl + sl] = 0x0A
        return
    kf, tail = divmod(sl, L)
    if kf:
        lines = view[:, hl:hl + kf * (L + 1)].view(nrec, kf, L + 1)
        lines[:, :, :L] = ch[:, :kf * L].view(nrec, kf, L)
        lines[:, :, L] = 0x0A
    if tail:
        t0 = hl + kf * (L + 1)
        view[:, t0:t0 + tail] = ch[:, kf * L:]
        view[:, t0 + tail] = 0x0A


_SEP = b"\n+\n"


def _fastq_group_step(view: torch.Tensor, chars: torch.Tensor, qual: torch.Tensor, nrec: int,
                      hl: int, sl: int, c0: int) -> None:
    """Lay out ``[sequence, "\\n+\\n", quality, "\\n"]`` of ``nrec`` FASTQ
    records of one shape into view (the reference's group layout)."""
    if sl:
        view[:, hl:hl + sl] = chars[c0:c0 + nrec * sl].view(nrec, sl)
        view[:, hl + sl + 3:hl + 2 * sl + 3] = qual[c0:c0 + nrec * sl].view(nrec, sl)
    for k, b in enumerate(_SEP):
        view[:, hl + sl + k] = b
    view[:, hl + 2 * sl + 3] = 0x0A


def render_regular(plan: RenderPlan, seq_bytes: np.ndarray, qual: Optional[np.ndarray] = None,
                   *, device) -> Optional[bytes]:
    """Uniform-group render to bytes (see regular_session), or None."""
    if plan.total_out == 0:
        return b""
    run = regular_session(plan, seq_bytes, qual, device=device)
    if run is None:
        return None
    return fetch(run()).numpy().tobytes()


# ---------------------------------------------------------------------------
# ragged render
# ---------------------------------------------------------------------------

def _next_seq_char(plan: RenderPlan, p: int) -> int:
    """Char index of the first sequence-char gather at out position >= p."""
    if p >= plan.total_out:
        return int(plan.E[-1]) if plan.E.size else 0
    r = int(np.searchsorted(plan.O, p, side="right"))
    rec_out = int(plan.O[r - 1]) if r > 0 else 0
    e_prev = int(plan.E[r - 1]) if r > 0 else 0
    sl = int(plan.slens[r])
    q = p - rec_out
    hl = int(plan.H[r] - (plan.H[r - 1] if r > 0 else 0))
    if q <= hl:
        return e_prev
    u = q - hl
    if plan.mode == MODE_FASTQ:
        return e_prev + min(u, sl) if u <= sl else int(plan.E[r])
    L = plan.line_len
    src = u - u // (L + 1) if L > 0 else u
    return e_prev + min(src, sl)


def _next_qual_char(plan: RenderPlan, p: int) -> int:
    """Char index of the first quality gather at out position >= p (FASTQ)."""
    if p >= plan.total_out:
        return int(plan.E[-1]) if plan.E.size else 0
    r = int(np.searchsorted(plan.O, p, side="right"))
    rec_out = int(plan.O[r - 1]) if r > 0 else 0
    e_prev = int(plan.E[r - 1]) if r > 0 else 0
    sl = int(plan.slens[r])
    q = p - rec_out
    hl = int(plan.H[r] - (plan.H[r - 1] if r > 0 else 0))
    u = q - hl
    if u <= sl + 3:
        return e_prev
    return e_prev + min(u - sl - 3, sl)


#: every rebased index of a batch stays below this (the reference's pad
#: sentinel, which its kernels must never meet)
_PAD = 1 << 30


def _at(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[idx] for an i32 index tensor of any shape."""
    return t[idx.long()]


def _render_step(seq: torch.Tensor, qual: torch.Tensor, o0: int, c0: int, q0: int,
                 E: torch.Tensor, O: torch.Tensor, H: torch.Tensor, hdr: torch.Tensor,
                 bounds: torch.Tensor, *, osz: int, mode: int, line_len: int, rna: bool,
                 packed: bool, upper: bool, masking: bool) -> torch.Tensor:
    """u8[osz]: output positions [o0, o0+osz) of a batch, on the tensors'
    device (the gather-minimal ``_make_kernel`` of the reference).

    ``seq`` holds the batch's packed nibbles (or raw text bytes) from char
    ``c0`` on, ``qual`` its quality bytes from char ``q0`` on; E, O, H are
    the batch's i32 char, output and header prefix sums, ``hdr`` its header
    bytes and ``bounds`` its masked-span bounds, all rebased to the batch
    and unpadded (the reference pads them to shape buckets with 2^30
    sentinels, which the port has no need of).
    Each position finds its record by segment broadcasts: the record's
    prefix values scattered to its start, spread by the max-scan kernel
    (the prefix sums do not decrease).  Header bytes scatter from the blob
    side; the mask parity is the add-scan kernel over toggles scattered to
    the bounds' output positions.  Only the sequence and quality bytes are
    gathered per position.
    """
    L = line_len
    i32 = torch.int32
    dev = E.device
    R = E.numel()
    zero1 = torch.zeros(1, dtype=i32, device=dev)
    starts = torch.cat([zero1, O[:-1]])
    e_before = torch.cat([zero1, E[:-1]])
    h_before = torch.cat([zero1, H[:-1]])
    # the record covering o0, and where each record starting in range starts
    r0 = ((starts <= o0).sum(dtype=i32) - 1).clamp(0, R - 1).reshape(1)
    sidx = starts - o0
    valid = (sidx >= 0) & (sidx < osz)
    slot = torch.where(valid, sidx, 0).long()

    def bcast(vals: torch.Tensor) -> torch.Tensor:
        arr = torch.full((osz,), S._NEG, dtype=i32, device=dev)
        arr[:1] = _at(vals, r0)
        arr.scatter_reduce_(0, slot, torch.where(valid, vals, S._NEG), reduce="amax")
        return S.maxscan_best(arr)

    q = torch.arange(osz, dtype=i32, device=dev) - (bcast(starts) - o0)
    e_prev = bcast(e_before)
    sl = bcast(E) - e_prev
    hl = bcast(H) - bcast(h_before)
    in_hdr = q < hl
    u = q - hl
    del q

    # header bytes scatter from the blob side: byte k lands at its record's
    # output start plus its offset in the record's header
    k = torch.arange(hdr.numel(), dtype=i32, device=dev)
    rk = torch.searchsorted(H, k, right=True, out_int32=True).clamp(max=R - 1)
    hk_prev = torch.where(rk > 0, _at(H, (rk - 1).clamp(min=0)), 0)
    out_pos = _at(starts, rk) + (k - hk_prev) - o0
    out_pos = torch.where((out_pos >= 0) & (out_pos < osz), out_pos, osz)
    hdr_at = torch.zeros(osz + 1, dtype=torch.uint8, device=dev)
    hdr_at[out_pos.long()] = hdr
    code_to_nuc = device_tables(C.SEQ_TYPE_RNA if rna else C.SEQ_TYPE_DNA, dev)["code_to_nuc"]

    def char_at(idx: torch.Tensor) -> torch.Tensor:
        kk = idx - c0
        if packed:
            byte = _at(seq, (kk >> 1).clamp(0, seq.numel() - 1)).to(i32)
            ch = _at(code_to_nuc, torch.where((kk & 1) == 1, byte >> 4, byte & 15)).to(i32)
        else:
            ch = _at(seq, kk.clamp(0, seq.numel() - 1)).to(i32)
            if upper:
                ch = _upper(ch)
        if masking:
            # toggles at the bounds' output positions; chars after one flip
            rb = torch.searchsorted(E, bounds, right=True, out_int32=True).clamp(max=R - 1)
            eb = torch.where(rb > 0, _at(E, (rb - 1).clamp(min=0)), 0)
            hb = _at(H, rb) - torch.where(rb > 0, _at(H, (rb - 1).clamp(min=0)), 0)
            c_in = bounds - eb
            body_off = c_in if mode == MODE_FASTQ or L <= 0 else c_in + c_in // L
            tpos = _at(starts, rb) + hb + body_off - o0
            base_par = (tpos < 0).sum(dtype=i32)
            tpos = torch.where((tpos >= 0) & (tpos < osz), tpos, osz)
            tog = torch.zeros(osz + 1, dtype=i32, device=dev)
            tog.index_add_(0, tpos.long(), torch.ones_like(tpos))
            ch = ch + 32 * ((S.cumsum_best(tog[:osz]) + base_par) & 1)
        return ch

    if mode == MODE_FASTQ:
        in_seq = u < sl
        in_qual = (u >= sl + 3) & (u < 2 * sl + 3)
        seq_ch = char_at(e_prev + torch.minimum(u.clamp(min=0), sl))
        qk = e_prev + torch.minimum((u - sl - 3).clamp(min=0), sl) - q0
        qual_ch = _at(qual, qk.clamp(0, qual.numel() - 1)).to(i32)
        sep_ch = (u == sl + 1).to(i32) * (ord("+") - ord("\n")) + ord("\n")   # "\n+\n"
        body = torch.where(in_seq, seq_ch, torch.where(in_qual, qual_ch, sep_ch))
    else:
        if L > 0:
            blen = torch.where(sl > 0, sl + (sl + L - 1) // L, 0)
            is_nl = (((u + 1) % (L + 1)) == 0) | (u == blen - 1)
            src = u - u // (L + 1)
        else:
            is_nl = u == sl
            src = u
        ch = char_at(e_prev + torch.minimum(src.clamp(min=0), sl))
        body = torch.where(is_nl, ord("\n"), ch)
    return torch.where(in_hdr, hdr_at[:osz].to(i32), body).to(torch.uint8)


@dataclass
class RenderBatch:
    """One batch (or one chunk of a batch) of a ragged render: host
    metadata, rebased to the batch."""

    p0: int                 # output positions [p0, p1)
    p1: int
    o0: int                 # p0, c0, q0 rebased
    c0: int
    q0: int
    b_lo: int               # section bytes [b_lo, b_hi) and quality [q_lo, q_hi)
    b_hi: int
    q_lo: int
    q_hi: int
    E: np.ndarray           # i32 rebased prefix sums of the batch's records
    O: np.ndarray
    H: np.ndarray
    hdr: np.ndarray         # u8 header bytes of the batch's records
    bounds: np.ndarray      # i32 rebased masked-span bounds
    out_base: int           # the batch's first record's output and char start
    char_base: int


def _span(plan: RenderPlan, p0: int, p1: int, out_base: int, char_base: int) -> dict:
    """Where the output positions [p0, p1) read the section and quality
    bytes, rebased to a batch that starts at ``out_base`` / ``char_base``."""
    seq_lo, seq_hi = _next_seq_char(plan, p0), _next_seq_char(plan, p1)
    if plan.mode == MODE_FASTQ:
        q_lo, q_hi = _next_qual_char(plan, p0), _next_qual_char(plan, p1)
    else:
        q_lo = q_hi = 0
    if plan.packed:
        b_lo, b_hi, c0 = seq_lo // 2, (seq_hi + 1) // 2, (seq_lo // 2) * 2
    else:
        b_lo, b_hi, c0 = seq_lo, seq_hi, seq_lo
    return dict(p0=p0, p1=p1, o0=p0 - out_base, c0=c0 - char_base, q0=q_lo - char_base,
                b_lo=b_lo, b_hi=b_hi, q_lo=q_lo, q_hi=q_hi)


def plan_batches(plan: RenderPlan, out_batch: int = 0) -> list[RenderBatch]:
    """The batches of ``render_batched``, or RenderOverflow when one
    record's span does not fit the i32 window of a batch."""
    out_batch = min(out_batch or OUT_BATCH, 1 << 28)
    # every rebased index of a batch must stay below the 1 << 30 sentinel:
    # the largest is below out_batch plus the spans of the two records
    # straddling the batch's edges
    max_span = 0
    for arr in (plan.O, plan.E, plan.H):
        if arr.size:
            max_span = max(max_span, int(np.diff(arr, prepend=np.int64(0)).max(initial=0)))
    if out_batch + 2 * max_span >= _PAD:
        raise RenderOverflow(f"record span {max_span} too large for device render batches")
    batches = []
    p0 = 0
    while p0 < plan.total_out:
        p1 = min(p0 + out_batch, plan.total_out)
        r0 = int(np.searchsorted(plan.O, p0, side="right"))
        r1 = min(int(np.searchsorted(plan.O, p1 - 1, side="right")) + 1, plan.O.size)
        out_base = int(plan.O[r0 - 1]) if r0 > 0 else 0
        char_base = int(plan.E[r0 - 1]) if r0 > 0 else 0
        hdr_base = int(plan.H[r0 - 1]) if r0 > 0 else 0
        # mask bounds clipped and rebased; whole pairs, so parity holds
        char_hi = int(plan.E[r1 - 1])
        lo = int(np.searchsorted(plan.bounds[1::2], char_base, side="right"))
        hi = int(np.searchsorted(plan.bounds[0::2], char_hi, side="left"))
        bounds = np.clip(plan.bounds[2 * lo:2 * hi] - char_base, 0, char_hi - char_base)
        batches.append(RenderBatch(
            **_span(plan, p0, p1, out_base, char_base),
            E=(plan.E[r0:r1] - char_base).astype(np.int32),
            O=(plan.O[r0:r1] - out_base).astype(np.int32),
            H=(plan.H[r0:r1] - hdr_base).astype(np.int32),
            hdr=plan.hdr[hdr_base:int(plan.H[r1 - 1])],
            bounds=bounds.astype(np.int32), out_base=out_base, char_base=char_base))
        p0 = p1
    return batches


def split_batch(plan: RenderPlan, bt: RenderBatch, parts: int) -> list[RenderBatch]:
    """A batch cut into ``parts`` output chunks of even length (the last
    ones may be empty), each with the byte ranges its positions read; they
    share the batch's records, headers and mask bounds
    (``render_sharded``'s device chunks)."""
    chunk = -(-(bt.p1 - bt.p0) // parts)
    chunk += chunk % 2
    out = []
    for d in range(parts):
        a = min(bt.p0 + d * chunk, bt.p1)
        b = min(a + chunk, bt.p1)
        out.append(RenderBatch(**_span(plan, a, b, bt.out_base, bt.char_base), E=bt.E, O=bt.O,
                               H=bt.H, hdr=bt.hdr, bounds=bt.bounds, out_base=bt.out_base,
                               char_base=bt.char_base))
    return out


def _up(a: np.ndarray, device) -> torch.Tensor:
    """A copy of ``a`` on ``device``: an ``upload`` span."""
    with trace_span("upload", bytes=a.nbytes):
        return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def ragged_session(plan: RenderPlan, seq_bytes: np.ndarray, qual: Optional[np.ndarray] = None,
                   *, mesh, out_batch: int = 0):
    """(batches, render): the batches of a ragged render over the devices
    of ``mesh``, and a function that renders one of them as its u8 chunks
    in output order, one a device (``split_batch``; one device renders the
    whole batch).  The section and quality bytes each chunk reads are
    uploaded here, once, to its device, so each device holds only its
    chunks' bytes; each device uploads a batch's record-sized metadata
    once.  Every chunk of a batch launches before any is fetched, so the
    devices overlap."""
    batches = plan_batches(plan, out_batch)
    fastq = plan.mode == MODE_FASTQ and qual is not None
    seq_bytes = np.asarray(seq_bytes, np.uint8)
    qual = np.asarray(qual, np.uint8) if fastq else None
    none = np.zeros(1, np.uint8)
    chunks = {bt.p0: [(dev, ch, _up(seq_bytes[ch.b_lo:ch.b_hi] if ch.b_hi > ch.b_lo else none, dev),
                       _up(qual[ch.q_lo:ch.q_hi] if fastq and ch.q_hi > ch.q_lo else none, dev))
                      for dev, ch in zip(mesh.devices, split_batch(plan, bt, mesh.size))
                      if ch.p1 > ch.p0]
              for bt in batches}

    def render(bt: RenderBatch) -> list[torch.Tensor]:
        meta, outs = {}, []
        for dev, ch, seq, qsl in chunks[bt.p0]:
            if dev not in meta:
                meta[dev] = [_up(a, dev) for a in (bt.E, bt.O, bt.H, bt.hdr, bt.bounds)]
            outs.append(_render_step(seq, qsl, ch.o0, ch.c0, ch.q0, *meta[dev], osz=ch.p1 - ch.p0,
                                     mode=plan.mode, line_len=plan.line_len, rna=plan.rna,
                                     packed=plan.packed, upper=plan.upper,
                                     masking=plan.bounds.size > 0))
        return outs

    return batches, render


def render_batched(plan: RenderPlan, seq_bytes: np.ndarray, qual: Optional[np.ndarray] = None,
                   *, mesh, out_batch: int = 0) -> bytes:
    """The whole output of a ragged render over the devices of ``mesh``
    (``render_sharded``), batch by batch, each batch in one chunk a device
    joined in order; raises RenderOverflow where the reference does."""
    if plan.total_out == 0:
        return b""
    batches, render = ragged_session(plan, seq_bytes, qual, mesh=mesh, out_batch=out_batch)
    return b"".join(fetch(o).numpy().tobytes() for bt in batches for o in render(bt))
