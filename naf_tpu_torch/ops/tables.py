"""The byte tables: host numpy constants and the tensors the kernels take.

This system has no weights; its state is its byte tables.  The numpy
constants are those of ``naf_tpu/ops/tables.py``, made from the port's copy
of the format constants; the kernels get them as arguments (a block copies
each into shared memory).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..format import constants as C

NUC_CODE = np.asarray(C.NUC_CODE[:256], dtype=np.uint8)
CODE_TO_NUC_DNA = np.asarray(C.CODE_TO_NUC_DNA, dtype=np.uint8)
CODE_TO_NUC_RNA = np.asarray(C.CODE_TO_NUC_RNA, dtype=np.uint8)
IS_EOL = np.asarray(C.IS_EOL[:256])
UNEXPECTED_BY_TYPE = {t: np.asarray(tab[:256]) for t, tab in C.UNEXPECTED_BY_TYPE.items()}
IS_UNEXPECTED_COMMENT = np.asarray(C.IS_UNEXPECTED_COMMENT[:256])
IS_UNEXPECTED_TEXT = np.asarray(C.IS_UNEXPECTED_TEXT[:256])
IS_UNEXPECTED_QUAL = np.asarray(C.IS_UNEXPECTED_QUAL[:256])

# bits of the class table (csrc/common.cuh CLS_*)
CLS_UNEX_SEQ, CLS_UNEX_TEXT, CLS_UNEX_COM, CLS_EOL, CLS_UNEX_QUAL = 1, 2, 4, 8, 16


def class_table(seq_type: int) -> np.ndarray:
    """u8[256]: the classify kernels' byte classes as bits."""
    return (UNEXPECTED_BY_TYPE[seq_type].astype(np.uint8) * CLS_UNEX_SEQ
            | IS_UNEXPECTED_TEXT.astype(np.uint8) * CLS_UNEX_TEXT
            | IS_UNEXPECTED_COMMENT.astype(np.uint8) * CLS_UNEX_COM
            | IS_EOL.astype(np.uint8) * CLS_EOL
            | IS_UNEXPECTED_QUAL.astype(np.uint8) * CLS_UNEX_QUAL)


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
