"""NAF format constants and lookup tables.

All tables are *generated* from the format rules (NAF spec / reference
behavior at ennaf/src/tables.c, unnaf/src/unnaf.c:13) rather than copied,
and are exposed as numpy arrays so device code can lift them to jnp
constants.

Byte-class semantics (reference parity, ennaf/src/tables.c:28-145):
  * EOL chars:    LF VT FF CR                  (0x0A-0x0D)
  * space chars:  TAB LF VT FF CR SPACE
  * "well formed" spaces: LF and SPACE only

A frozen copy of ``naf_tpu_torch/format/constants.py``, for the benchmark's reference.
"""

from __future__ import annotations

import numpy as np

# --- container magic -------------------------------------------------------

NAF_MAGIC = bytes((0x01, 0xF9, 0xEC))          # ennaf/src/ennaf.c:18
ZSTD_FRAME_MAGIC = bytes((0x28, 0xB5, 0x2F, 0xFD))  # stripped per section

# --- sequence types --------------------------------------------------------

SEQ_TYPE_DNA = 0
SEQ_TYPE_RNA = 1
SEQ_TYPE_PROTEIN = 2
SEQ_TYPE_TEXT = 3

SEQ_TYPE_NAMES = {
    SEQ_TYPE_DNA: "DNA",
    SEQ_TYPE_RNA: "RNA",
    SEQ_TYPE_PROTEIN: "protein",
    SEQ_TYPE_TEXT: "text",
}

# --- input formats ---------------------------------------------------------

IN_FORMAT_UNKNOWN = 0
IN_FORMAT_FASTA = 1
IN_FORMAT_FASTQ = 2

# --- replacement characters (ennaf/src/tables.c:11-13) ---------------------

REPLACEMENT_SEQ = {
    SEQ_TYPE_DNA: ord("N"),
    SEQ_TYPE_RNA: ord("N"),
    SEQ_TYPE_PROTEIN: ord("X"),
    SEQ_TYPE_TEXT: ord("?"),
}
REPLACEMENT_NAME = ord("?")
REPLACEMENT_QUAL = ord("!")

# --- length / mask unit semantics -----------------------------------------

LENGTH_UNIT_MAX = 0xFFFFFFFF    # u32 continuation sentinel (encoders.c:78)
MASK_UNIT_MAX = 0xFF            # u8 continuation sentinel (encoders.c:107)

# --- byte class tables (257 entries: 256 bytes + EOF) ----------------------

_EOL = (0x0A, 0x0B, 0x0C, 0x0D)
_SPACE = (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20)
_WF_SPACE = (0x0A, 0x20)


def _table(allowed_true: set[int], *, size: int = 257) -> np.ndarray:
    t = np.zeros(size, dtype=np.bool_)
    for i in allowed_true:
        t[i] = True
    return t


IS_EOL = _table(set(_EOL))
IS_SPACE = _table(set(_SPACE))
IS_WELL_FORMED_SPACE = _table(set(_WF_SPACE))


def _unexpected_from_allowed(allowed: set[int]) -> np.ndarray:
    """257-entry bool table: True for bytes NOT in `allowed` (EOF always True)."""
    t = np.ones(257, dtype=np.bool_)
    for c in allowed:
        t[c] = False
    return t


def _both_cases(letters: str) -> set[int]:
    out = set()
    for ch in letters:
        out.add(ord(ch.upper()))
        out.add(ord(ch.lower()))
    return out


# IUPAC nucleotide codes; DNA uses T, RNA uses U (ennaf/src/tables.c:72-90).
_DNA_LETTERS = "ABCDGHKMNRSTVWY"
_RNA_LETTERS = "ABCDGHKMNRSUVWY"

IS_UNEXPECTED_DNA = _unexpected_from_allowed(_both_cases(_DNA_LETTERS) | {ord("-")})
IS_UNEXPECTED_RNA = _unexpected_from_allowed(_both_cases(_RNA_LETTERS) | {ord("-")})
# Protein: all letters (incl. ambiguity codes), stop '*', gap '-'.
IS_UNEXPECTED_PROTEIN = _unexpected_from_allowed(
    _both_cases("ABCDEFGHIJKLMNOPQRSTUVWXYZ") | {ord("*"), ord("-")}
)
# Text sequence: printable non-space, 8-bit chars allowed except DEL and 0xFF.
IS_UNEXPECTED_TEXT = _unexpected_from_allowed(
    (set(range(33, 127)) | set(range(128, 255)))
)
# Comment: like text but space (0x20) also allowed.
IS_UNEXPECTED_COMMENT = _unexpected_from_allowed(
    (set(range(32, 127)) | set(range(128, 255)))
)
# Quality: printable ASCII 33..126 only.
IS_UNEXPECTED_QUAL = _unexpected_from_allowed(set(range(33, 127)))

UNEXPECTED_BY_TYPE = {
    SEQ_TYPE_DNA: IS_UNEXPECTED_DNA,
    SEQ_TYPE_RNA: IS_UNEXPECTED_RNA,
    SEQ_TYPE_PROTEIN: IS_UNEXPECTED_PROTEIN,
    SEQ_TYPE_TEXT: IS_UNEXPECTED_TEXT,
}

# --- 4-bit nucleotide coding -----------------------------------------------

# Decode table: 4-bit code -> ASCII nucleotide (unnaf/src/unnaf.c:13).
# Bit layout of the code: bit0=T(U), bit1=G, bit2=C, bit3=A; 0 is gap '-'.
CODE_TO_NUC_DNA = np.frombuffer(b"-TGKCYSBAWRDMHVN", dtype=np.uint8).copy()
CODE_TO_NUC_RNA = CODE_TO_NUC_DNA.copy()
CODE_TO_NUC_RNA[1] = ord("U")   # slot 1 renders as U for RNA (unnaf.c:369)


def _make_nuc_code() -> np.ndarray:
    """ASCII (+EOF) -> 4-bit code; unknowns map to 15 ('N')."""
    t = np.full(257, 15, dtype=np.uint8)
    for code, ch in enumerate(CODE_TO_NUC_DNA.tobytes().decode("ascii")):
        t[ord(ch.upper())] = code
        t[ord(ch.lower())] = code
    t[ord("U")] = t[ord("T")]
    t[ord("u")] = t[ord("t")]
    t[ord("-")] = 0
    return t


NUC_CODE = _make_nuc_code()


def make_codes_to_nucs(code_to_nuc: np.ndarray) -> np.ndarray:
    """256 -> (lo_char, hi_char) uint8 pairs for byte-at-once 4-bit decode."""
    lo = code_to_nuc[np.arange(256) & 15]
    hi = code_to_nuc[np.arange(256) >> 4]
    return np.stack([lo, hi], axis=1)


CODES_TO_NUCS_DNA = make_codes_to_nucs(CODE_TO_NUC_DNA)
CODES_TO_NUCS_RNA = make_codes_to_nucs(CODE_TO_NUC_RNA)

# ASCII toupper for the C locale, as a 256-entry table (for text/protein paths).
TOUPPER = np.arange(256, dtype=np.uint8)
TOUPPER[ord("a"):ord("z") + 1] -= 32

# Section order in the container (NAF spec §2).
SECTION_ORDER = ("title", "ids", "comments", "lengths", "mask", "sequence", "quality")
