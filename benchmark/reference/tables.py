"""The byte tables as host numpy constants: a frozen copy of
``naf_tpu_torch/ops/tables_np.py``, for the benchmark's reference.
"""

from __future__ import annotations

import numpy as np

from . import constants as C

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
