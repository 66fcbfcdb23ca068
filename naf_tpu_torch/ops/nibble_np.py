"""Host numpy 4-bit nucleotide pack and unpack, without torch: the port's
copies of ``naf_tpu/ops/pack.py:pack_4bit`` (``pack_4bit_np``) and
``naf_tpu/ops/unpack.py:unpack_4bit`` (``unpack_4bit_np``).  The host
encoder and decoder call these; ``ops/pack.py`` and ``ops/unpack.py``
re-export them beside their kernels.
"""

from __future__ import annotations

import numpy as np

from ..format import constants as C
from .tables_np import NUC_CODE


def pack_4bit_np(seq_np: np.ndarray, parity_nibble: int | None = None
                 ) -> tuple[np.ndarray, int | None]:
    """Host numpy pack of ASCII bytes into 4-bit codes, low nibble first.

    ``parity_nibble`` is the pending low nibble carried from the previous
    piece, or None; returns (packed bytes, new carry nibble or None), as
    ennaf/src/encoders.c:40-68.
    """
    seq_np = np.ascontiguousarray(seq_np, dtype=np.uint8)
    prefix = np.zeros(0, np.uint8)
    if parity_nibble is not None:
        if seq_np.size == 0:
            return prefix, parity_nibble
        prefix = np.asarray([parity_nibble | (int(NUC_CODE[seq_np[0]]) << 4)], np.uint8)
        seq_np = seq_np[1:]
    carry = None
    if seq_np.size % 2:
        carry = int(NUC_CODE[seq_np[-1]])
        seq_np = seq_np[:-1]
    codes = NUC_CODE[seq_np]
    return np.concatenate([prefix, codes[0::2] | (codes[1::2] << 4)]), carry


def unpack_4bit_np(packed_np: np.ndarray, total_chars: int, rna: bool = False) -> np.ndarray:
    """Host numpy unpack of 4-bit codes to ``total_chars`` ASCII bytes."""
    packed_np = np.ascontiguousarray(packed_np, dtype=np.uint8)
    lut = C.CODES_TO_NUCS_RNA if rna else C.CODES_TO_NUCS_DNA
    return lut[packed_np].reshape(-1)[:total_chars]
