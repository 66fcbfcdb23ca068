"""The scan and compaction entry points of the two-pass encode and the
ragged render: the port of the dispatch in ``naf_tpu/ops/scan.py``
(``cumsum_best``, ``maxscan_best``, ``compact_best``), with
``longest_line_block``.

The TPU package chose between its Pallas kernels and XLA formulations by
the mesh's platform; here the tensor's device decides, as everywhere in the
port: a CUDA tensor launches the kernel (``csrc/scan.cu``,
``csrc/compact.cu``), a CPU tensor runs the plain version.
"""

from __future__ import annotations

import torch

from .compact import compact_u8, compact_u8_dense
from .scan_fused import cumsum_i32, maxscan_i32

#: the masked-scan sentinel below every position or count (naf_tpu's _NEG)
_NEG = -(1 << 30)


#: inclusive i32 prefix sum and prefix max (kernel 8), under the
#: reference's names
cumsum_best = cumsum_i32
maxscan_best = maxscan_i32


def compact_best(mask: torch.Tensor, values: torch.Tensor, dense: bool = False):
    """(out, count) of the kept values: ``compact_u8_dense`` for the
    mostly-keep sequence and quality streams, ``compact_u8`` otherwise."""
    return (compact_u8_dense if dense else compact_u8)(values, mask)


def longest_line_block(seq_keep: torch.Tensor, is_eol: torch.Tensor) -> torch.Tensor:
    """i32 scalar: the most kept characters between two EOLs of the block
    (the kept count at each EOL less the count at the EOL before it, and
    the open line at the end)."""
    if seq_keep.numel() == 0:
        return torch.zeros((), dtype=torch.int32, device=seq_keep.device)
    cum = cumsum_best(seq_keep)
    a = maxscan_best(torch.where(is_eol, cum, _NEG))
    a_prev = torch.cat([a.new_full((1,), _NEG), a[:-1]])
    base = torch.where(a_prev == _NEG, 0, a_prev)
    line_at_eol = torch.where(is_eol, cum - base, 0)
    tail = cum[-1] - torch.where(a[-1] == _NEG, 0, a[-1])
    return torch.maximum(line_at_eol.max(), tail)
