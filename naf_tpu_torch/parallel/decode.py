"""Device FASTA render on one device: the uniform-group path of
``naf_tpu/parallel/decode.py`` (``regular_session``, ``render_regular``).

The section bytes become chars on the device (``ops.unpack`` kernel, then
the ``ops.emit_fused`` mask-parity kernel over a toggle scatter at the
masked-span bounds), and records whose (header length, sequence length)
repeat are laid out as strided copies into one output tensor: headers,
full lines plus a newline column, the tail line.  The render metadata is
``naf_tpu.parallel.decode.build_plan``'s ``RenderPlan``, used as it is.

Archives the uniform path declines (too many distinct record shapes, an
output of 512 MiB or more, FASTQ or text) are left to the caller, which
renders them on the host; ragged device render is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from naf_tpu.ops.render import body_length
from naf_tpu.parallel import decode as DV

from ..ops.emit_fused import apply_mask_parity
from ..ops.unpack import unpack_4bit


def _groups(plan: DV.RenderPlan):
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


def decline_reason(plan: DV.RenderPlan) -> Optional[str]:
    """Why the uniform-group render does not take this archive, or None."""
    if plan.mode != DV.MODE_FASTA:
        return "fastq"
    if not plan.packed:
        return "text"
    if plan.slens.size == 0 or plan.total_out == 0:
        return "empty"
    if plan.total_out >= min(1 << 31, 2 * DV.OUT_BATCH):
        return "too_large"
    hlens, slens, starts, _ = _groups(plan)
    if starts.size > DV._REG_MAX_GROUPS:
        return "too_many_groups"
    if int((hlens + body_length(slens, plan.line_len)).sum()) != plan.total_out:
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


def regular_session(plan: DV.RenderPlan, seq_bytes: np.ndarray, *, device
                    ) -> Optional[Callable[[], torch.Tensor]]:
    """Uniform-group render session, or None when ``decline_reason`` says so.

    Uploads the section bytes, headers and mask bounds once and returns a
    zero-argument callable that renders the whole output as one u8 tensor
    on ``device`` (repeated calls time the device-resident render).
    """
    if decline_reason(plan) is not None:
        return None
    hlens, slens, starts, ends = _groups(plan)
    L = plan.line_len
    blens = body_length(slens, L)
    sb = np.ascontiguousarray(seq_bytes, np.uint8)
    seq_d = torch.from_numpy(sb.copy()).to(device)
    n_chars = 2 * sb.size
    bounds = plan.bounds[plan.bounds < n_chars]
    bounds_d = torch.from_numpy(bounds.astype(np.int64)).to(device) if bounds.size else None
    hdr_d = torch.from_numpy(np.ascontiguousarray(plan.hdr, np.uint8).copy()).to(device)
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
            _regular_group_step(out[o:o + nrec * w].view(nrec, w), chars, hdr_d,
                                nrec, hl, sl, L, c0, h0)
        return out

    return run


def _regular_group_step(view: torch.Tensor, chars: torch.Tensor, hdr: torch.Tensor,
                        nrec: int, hl: int, sl: int, L: int, c0: int, h0: int) -> None:
    """Lay out ``nrec`` records of one shape into view (nrec, hl + body)."""
    if hl:
        view[:, :hl] = hdr[h0:h0 + nrec * hl].view(nrec, hl)
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


def render_regular(plan: DV.RenderPlan, seq_bytes: np.ndarray, *, device
                   ) -> Optional[bytes]:
    """Uniform-group render to bytes (see regular_session), or None."""
    if plan.total_out == 0:
        return b""
    run = regular_session(plan, seq_bytes, device=device)
    if run is None:
        return None
    return run().cpu().numpy().tobytes()
