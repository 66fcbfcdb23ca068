"""Stable stream compaction: the port of ``naf_tpu/ops/compact.py``'s
``compact_u8_pallas`` and ``compact_u8_dense``.

Both keep the contract of the TPU wrappers: ``(values, keep) -> (out,
count)``, with out of values' dtype (u8 or i32) and length, the kept
values at the front in order, zero at and past ``count`` (an i32 scalar
tensor).  The TPU needed two kernels, a general one and one for
mostly-keep masks that falls back to the general one; here one CUDA kernel
(``csrc/compact.cu``) serves both wrappers, which count their launches
apart: ``compact`` for the sparse streams (ids, comments, record and run
positions) and ``compact_dense`` for the sequence and quality streams.
"""

from __future__ import annotations

import torch

from ..device import LAUNCHES
from ..native import build
from .common import COMPACT_TILE, check_1d, n_tiles


def _check(values: torch.Tensor, keep: torch.Tensor) -> None:
    check_1d(values, (torch.uint8, torch.int32), "values")
    check_1d(keep, (torch.bool, torch.uint8), "keep")
    if keep.numel() != values.numel() or keep.device != values.device:
        raise ValueError("values and keep must match in length and device")


def compact_plain(values: torch.Tensor, keep: torch.Tensor):
    """Plain PyTorch version of the compaction kernel."""
    _check(values, keep)
    kept = values[keep.bool()]
    out = torch.zeros_like(values)
    out[:kept.numel()] = kept
    return out, torch.tensor(kept.numel(), dtype=torch.int32, device=values.device)


def compact_kernel(values: torch.Tensor, keep: torch.Tensor, *, dense: bool = False, lib=None):
    """Launch the compaction kernel, counted as ``compact_dense`` or
    ``compact`` (``lib`` as in ``scan_fused.classify_fasta_kernel``)."""
    _check(values, keep)
    lib = build.kernel_lib(values, lib)
    n = values.numel()
    out = torch.empty_like(values)
    if n == 0:
        return out, torch.zeros((), dtype=torch.int32, device=values.device)
    g = n_tiles(n, COMPACT_TILE)
    # a ticket, the count, and one u64 look-back status word per tile, all 0
    scratch = torch.zeros(2 + 2 * g, dtype=torch.int32, device=values.device)
    build.call(lib, "naf_compact", values.data_ptr(), values.element_size(), keep.data_ptr(), n,
               scratch.data_ptr(), out.data_ptr(), g, build.stream_of(values))
    LAUNCHES["compact_dense" if dense else "compact"] += 1
    return out, scratch[1]


def compact_u8(values: torch.Tensor, keep: torch.Tensor):
    """(out, count) of the kept values (``compact_u8_pallas``'s contract).
    A CUDA tensor runs the kernel; a CPU tensor the plain version."""
    if values.is_cuda:
        return compact_kernel(values, keep)
    return compact_plain(values, keep)


def compact_u8_dense(values: torch.Tensor, keep: torch.Tensor):
    """``compact_u8`` for mostly-keep masks (``compact_u8_dense``'s place
    in the two-pass encode: the sequence and quality streams)."""
    if values.is_cuda:
        return compact_kernel(values, keep, dense=True)
    return compact_plain(values, keep)
