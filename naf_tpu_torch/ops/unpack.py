"""4-bit nucleotide unpack: the port of ``naf_tpu/ops/unpack.py``'s
``unpack_4bit_pallas``; its host numpy ``unpack_4bit`` (``unpack_4bit_np``)
lives in the torch-free ``nibble_np`` and is re-exported here.  The kernel
writes the interleaved u8 chars directly; the TPU kernel's u16 output only
dodged a TPU relayout.
"""

from __future__ import annotations

import torch

from ..device import LAUNCHES
from ..format import constants as C
from ..native import build
from .common import check_1d
from .nibble_np import unpack_4bit_np  # noqa: F401  (the host half, re-exported)
from .tables import device_tables


def _table(packed: torch.Tensor, rna: bool) -> torch.Tensor:
    return device_tables(C.SEQ_TYPE_RNA if rna else C.SEQ_TYPE_DNA,
                         packed.device)["code_to_nuc"]


def unpack_4bit_plain(packed: torch.Tensor, rna: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the unpack kernel."""
    check_1d(packed, torch.uint8, "packed")
    tab = _table(packed, rna)
    p = packed.long()
    return torch.stack([tab[p & 15], tab[p >> 4]], 1).reshape(-1)


def unpack_4bit_kernel(packed: torch.Tensor, rna: bool = False, *, lib=None) -> torch.Tensor:
    """Launch the unpack kernel (``lib`` as in ``scan_fused.classify_fasta_kernel``)."""
    check_1d(packed, torch.uint8, "packed")
    lib = build.kernel_lib(packed, lib)
    m = packed.numel()
    out = torch.empty(2 * m, dtype=torch.uint8, device=packed.device)
    if m:
        build.call(lib, "naf_unpack_4bit", packed, packed.data_ptr(), m,
                   _table(packed, rna).data_ptr(), out.data_ptr(), build.stream_of(packed))
        LAUNCHES["unpack_4bit"] += 1
    return out


def unpack_4bit(packed: torch.Tensor, rna: bool = False) -> torch.Tensor:
    """u8[M] packed codes -> u8[2M] ASCII, low nibble first.  A CUDA tensor
    runs the kernel; a CPU tensor the plain version."""
    if packed.is_cuda:
        return unpack_4bit_kernel(packed, rna)
    return unpack_4bit_plain(packed, rna)
