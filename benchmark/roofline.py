"""The peak table and the bytes a call's work needs, for the kernels'
roofline share.

The least time a card could take for a call is the bytes its work must
move over the card's memory bandwidth.  The bytes are counted from what the
call turns into what, never from which kernels run, so a fused kernel that
replaces two reads the same work: the text once (the input of a compress,
the output of a decompress) and each uncompressed section of the archive
once (a nucleotide sequence as its packed nibbles, ⌈bases/2⌉).  The
section sizes come from the reference's reading of the archive.
"""

from __future__ import annotations

import io

from .reference import constants as C
from .reference.container import NafReader

#: memory bandwidth by card (``torch.cuda.get_device_name()``): the H100
#: SXM5 80GB HBM3 of NVIDIA's data sheet, at its 700 W power limit
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}}


def section_bytes(archive: bytes) -> dict:
    """Each stored section's uncompressed bytes (the sequence of a
    nucleotide archive as its packed nibbles)."""
    r = NafReader(io.BytesIO(archive))
    r.read_counters()
    out = {}
    for key in C.SECTION_ORDER[1:]:
        if not getattr(r.header, r._FLAG_ATTR[key]):
            continue
        u, c = r.section_sizes(key)
        r._skip_ahead(c)
        nucleotide = r.header.seq_type <= C.SEQ_TYPE_RNA
        out[key] = (u + 1) // 2 if key == "sequence" and nucleotide else u
    return out


def work_bytes(text_bytes: int, archive: bytes) -> int:
    """The bytes one call must read and write: the text and the sections."""
    return text_bytes + sum(section_bytes(archive).values())


def bound_s(nbytes: int, kind: str):
    """The least seconds a card of ``kind`` needs to move ``nbytes``, or
    None for a kind the table lacks."""
    peak = PEAKS.get(kind)
    return None if peak is None else nbytes / peak["hbm_bytes_per_s"]
