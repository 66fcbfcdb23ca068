"""4-bit nucleotide pack: the port of ``naf_tpu/ops/pack.py``'s
``pack_4bit_pallas``; its host numpy ``pack_4bit`` (``pack_4bit_np``) lives
in the torch-free ``nibble_np`` and is re-exported here.

``pack_4bit`` also takes the parallel encoder's two steps around the TPU
kernel: the one-byte roll on odd nibble parity (``shift``) and the zero
padding to a fixed output length (``out_len``), so no per-byte torch op
runs between the emit and the pack.
"""

from __future__ import annotations

import torch

from ..device import LAUNCHES
from ..native import build
from .common import check_1d
from .nibble_np import pack_4bit_np  # noqa: F401  (the host half, re-exported)
from .tables import device_tables


def _check(seq: torch.Tensor, shift: int, out_len: int | None) -> int:
    check_1d(seq, torch.uint8, "seq")
    n = seq.numel()
    if n % 2:
        raise ValueError(f"pack_4bit needs an even length, got {n}")
    if shift < 0 or out_len is not None and out_len < 0:
        raise ValueError("shift and out_len must not be negative")
    return n // 2 if out_len is None else out_len


def pack_4bit_plain(seq: torch.Tensor, *, shift: int = 0, out_len: int | None = None
                    ) -> torch.Tensor:
    """Plain PyTorch version of the pack kernel."""
    out_len = _check(seq, shift, out_len)
    n = seq.numel()
    s = torch.roll(seq, -shift) if shift and n else seq
    codes = device_tables(0, seq.device)["nuc_code"][s.long()]
    packed = codes[0::2] | (codes[1::2] << 4)
    out = torch.zeros(out_len, dtype=torch.uint8, device=seq.device)
    m = min(out_len, n // 2)
    out[:m] = packed[:m]
    return out


def pack_4bit_kernel(seq: torch.Tensor, *, shift: int = 0, out_len: int | None = None,
                     lib=None) -> torch.Tensor:
    """Launch the pack kernel (``lib`` as in ``scan_fused.classify_fasta_kernel``)."""
    out_len = _check(seq, shift, out_len)
    lib = build.kernel_lib(seq, lib)
    n = seq.numel()
    out = torch.empty(out_len, dtype=torch.uint8, device=seq.device)
    if out_len:
        build.call(lib, "naf_pack_4bit", seq, seq.data_ptr(), n, shift % n if n else 0,
                   device_tables(0, seq.device)["nuc_code"].data_ptr(), out.data_ptr(),
                   out_len, build.stream_of(seq))
        LAUNCHES["pack_4bit"] += 1
    return out


def pack_4bit(seq: torch.Tensor, *, shift: int = 0, out_len: int | None = None
              ) -> torch.Tensor:
    """u8[N] ASCII (N even) -> u8[out_len] packed codes.

    out[j] = NUC_CODE[s[2j]] | NUC_CODE[s[2j+1]] << 4 for j < N/2 and 0
    after, where s is seq rolled left by ``shift``; ``out_len`` defaults to
    N/2.  A CUDA tensor runs the kernel; a CPU tensor the plain version.
    """
    if seq.is_cuda:
        return pack_4bit_kernel(seq, shift=shift, out_len=out_len)
    return pack_4bit_plain(seq, shift=shift, out_len=out_len)
