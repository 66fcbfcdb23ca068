"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

#: bytes per tile of the FASTA emit (csrc/common.cuh TILE; the TPU
#: kernels' _TILE, so per-tile caps mean the same on both)
TILE = 1 << 16
#: bytes per tile of the FASTQ kernels (csrc/classify_fastq.cuh Q_TILE; the
#: TPU FASTQ emit's _TILE_Q, so its per-tile sparse cap means the same)
Q_TILE = 1 << 15
#: elements per tile of the one-pass scan kernel (csrc/scan.cuh SCAN_TILE):
#: the wrapper sizes its look-back status words by it; nothing else outside
#: the kernels depends on it
SCAN_TILE = 6 << 12
#: bytes per tile of the standalone FASTA and FASTQ classifies and of the
#: mask parity (csrc/classify_stage.cuh CL_TILE): the wrappers size their
#: look-back status words by it
CLASSIFY_TILE = 1 << 15
#: elements per tile of the compaction kernel (csrc/compact.cu CT_TILE)
COMPACT_TILE = 1 << 15


def check_1d(t: torch.Tensor, dtype, name: str) -> None:
    """Raise unless t is a contiguous 1-D tensor of ``dtype`` (or of one of
    a tuple of dtypes) on the CPU or a CUDA device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D {' or '.join(map(str, dtypes))} "
                         f"tensor, got {t.dtype} of shape {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} lies on unsupported device {t.device}")


def n_tiles(n: int, tile: int = TILE) -> int:
    return max(1, -(-n // tile))
