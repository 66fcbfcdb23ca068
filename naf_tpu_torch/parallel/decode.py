"""Device FASTA and FASTQ render on one device: the uniform-group path of
``naf_tpu/parallel/decode.py`` (``regular_session``, ``render_regular``).

The section bytes become chars on the device (``ops.unpack`` kernel, then,
for masked FASTA, the ``ops.emit_fused`` mask-parity kernel over a toggle
scatter at the masked-span bounds), and records whose (header length,
sequence length) repeat are laid out as strided copies into one output
tensor.  A FASTA record is its header, its full lines plus a newline
column, and its tail line; a FASTQ record is ``[header, sequence, "\\n+\\n",
quality, "\\n"]``, with the quality bytes uploaded once per session.

``RenderPlan`` and ``build_plan`` are the port's copies of the reference's
render metadata (the tests hold them against the originals).  Archives the
uniform path declines (too many distinct record shapes, an output of
512 MiB or more, text) are left to the caller, which renders them on the
host; ragged device render is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.assemble import const_column, ragged_concat, split_blob
from ..ops.emit_fused import apply_mask_parity
from ..ops.render import body_length
from ..ops.unpack import unpack_4bit

MODE_FASTA = 0
MODE_FASTQ = 1

#: output bytes of one reference render batch; the uniform path takes
#: outputs below two of them (the reference's limit)
OUT_BATCH = 256 << 20
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


def build_plan(*, mode: int, line_len: int, rna: bool, packed: bool,
               upper: bool, slens: np.ndarray,
               ids_blob: Optional[bytes], comments_blob: Optional[bytes],
               name_sep: bytes, mask_spans=None) -> RenderPlan:
    """Precompute the prefix sums and the header blob of a render."""
    slens = np.asarray(slens, dtype=np.int64)
    n = slens.size
    E = np.cumsum(slens)

    lead = b"@" if mode == MODE_FASTQ else b">"
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
    hdr = ragged_concat(cols, n)
    hlens = np.zeros(n, np.int64)
    for c in cols:
        hlens += np.broadcast_to(np.asarray(c.length, np.int64), (n,))
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
    if not plan.packed:
        return "text"
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


def _prep_chars_step(seq_d: torch.Tensor, bounds_d: Optional[torch.Tensor], *, rna: bool
                     ) -> torch.Tensor:
    """Packed section bytes -> rendered chars: unpack, then +32 inside the
    masked spans whose bounds (char indices) ``bounds_d`` holds."""
    chars = unpack_4bit(seq_d, rna)
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
    sb = np.ascontiguousarray(seq_bytes, np.uint8)
    seq_d = torch.from_numpy(sb.copy()).to(device)
    n_chars = 2 * sb.size
    bounds = plan.bounds[plan.bounds < n_chars]
    bounds_d = torch.from_numpy(bounds.astype(np.int64)).to(device) if bounds.size else None
    hdr_d = torch.from_numpy(np.ascontiguousarray(plan.hdr, np.uint8).copy()).to(device)
    qual_d = (torch.from_numpy(np.ascontiguousarray(qual, np.uint8).copy()).to(device)
              if fastq else None)
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
        chars = _prep_chars_step(seq_d, bounds_d, rna=plan.rna)
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
    return run().cpu().numpy().tobytes()
