"""The lookup tables the kernels take, made from naf_tpu's numpy tables.

This system has no weights; its state is its byte tables.  The kernels get
them as arguments (a block copies each into shared memory), so the JAX
package and the port read one source of truth: ``naf_tpu/ops/tables.py`` and
``naf_tpu/format/constants.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from naf_tpu.format import constants as C
from naf_tpu.ops import tables as T

# bits of the class table (csrc/common.cuh CLS_*)
CLS_UNEX_SEQ, CLS_UNEX_TEXT, CLS_UNEX_COM, CLS_EOL = 1, 2, 4, 8


def class_table(seq_type: int) -> np.ndarray:
    """u8[256]: the FASTA classify's byte classes as bits."""
    return (T.UNEXPECTED_BY_TYPE[seq_type][:256].astype(np.uint8) * CLS_UNEX_SEQ
            | T.IS_UNEXPECTED_TEXT[:256].astype(np.uint8) * CLS_UNEX_TEXT
            | T.IS_UNEXPECTED_COMMENT[:256].astype(np.uint8) * CLS_UNEX_COM
            | T.IS_EOL[:256].astype(np.uint8) * CLS_EOL)


@functools.lru_cache(maxsize=None)
def device_tables(seq_type: int, device: torch.device) -> dict:
    """The tables for ``seq_type`` as tensors on ``device``.

    cls u8[256] (class bits), nuc_code u8[256] (ASCII -> 4-bit code),
    code_to_nuc u8[16] (code -> ASCII, T or U by seq_type), and the ints
    repl_seq and repl_name (replacements of unexpected bytes).
    """
    code_to_nuc = T.CODE_TO_NUC_RNA if seq_type == C.SEQ_TYPE_RNA else T.CODE_TO_NUC_DNA
    return dict(
        cls=torch.from_numpy(class_table(seq_type)).to(device),
        nuc_code=torch.from_numpy(T.NUC_CODE.copy()).to(device),
        code_to_nuc=torch.from_numpy(code_to_nuc.copy()).to(device),
        repl_seq=int(C.REPLACEMENT_SEQ[seq_type]),
        repl_name=int(C.REPLACEMENT_NAME),
    )
