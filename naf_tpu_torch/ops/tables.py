"""The byte tables as the tensors the kernels take.

This system has no weights; its state is its byte tables.  The numpy
constants live in the torch-free ``tables_np``; ``device_tables`` puts
them on a device, and the kernels get them as arguments (a block copies
each into shared memory).
"""

from __future__ import annotations

import functools

import torch

from ..format import constants as C
from .tables_np import CODE_TO_NUC_DNA, CODE_TO_NUC_RNA, NUC_CODE, class_table


@functools.lru_cache(maxsize=None)
def device_tables(seq_type: int, device: torch.device) -> dict:
    """The tables for ``seq_type`` as tensors on ``device``.

    cls u8[256] (class bits), nuc_code u8[256] (ASCII -> 4-bit code),
    code_to_nuc u8[16] (code -> ASCII, T or U by seq_type), and the ints
    repl_seq, repl_name and repl_qual (replacements of unexpected bytes).
    """
    code_to_nuc = CODE_TO_NUC_RNA if seq_type == C.SEQ_TYPE_RNA else CODE_TO_NUC_DNA
    return dict(
        cls=torch.from_numpy(class_table(seq_type)).to(device),
        nuc_code=torch.from_numpy(NUC_CODE.copy()).to(device),
        code_to_nuc=torch.from_numpy(code_to_nuc.copy()).to(device),
        repl_seq=int(C.REPLACEMENT_SEQ[seq_type]),
        repl_name=int(C.REPLACEMENT_NAME),
        repl_qual=int(C.REPLACEMENT_QUAL),
    )
