"""NAF container reading/writing (host side).

Archive layout (NAF spec §2; writer parity: ennaf/src/ennaf.c:538-589,
reader parity: unnaf/src/input.c:31-77):

    magic 01 F9 EC
    version byte: 1 (DNA) or 2 followed by a sequence-type byte (1=RNA,
                  2=protein, 3=text)
    flags byte:   bit7 extended-format, bit6 title, bit5 ids, bit4 comments
                  ("names" in unnaf), bit3 lengths, bit2 mask, bit1 sequence,
                  bit0 quality
    name-separator byte (' ')
    VLE line-length, VLE number-of-sequences
    [title: VLE size + bytes]
    sections in fixed order (ids, comments, lengths, mask, sequence, quality),
    each present iff its flag is set, encoded as:
        VLE uncompressed-size, VLE compressed-size, compressed bytes
    where the compressed bytes are a zstd frame with its 4-byte magic removed.

Streaming reads support stdin pipes: skipping a section reads-and-discards
rather than seeking (unnaf/src/input.c:11-28).

The port's copy of ``naf_tpu/format/container.py``; the tests hold the two against each other.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List, Optional, Tuple

from .constants import (
    NAF_MAGIC,
    SEQ_TYPE_DNA,
    SEQ_TYPE_NAMES,
    SEQ_TYPE_PROTEIN,
    SEQ_TYPE_RNA,
    SEQ_TYPE_TEXT,
)
from .vle import encode_vle, read_vle


class NafFormatError(ValueError):
    pass


@dataclass
class NafHeader:
    format_version: int = 1
    seq_type: int = SEQ_TYPE_DNA
    extended: bool = False        # bit 7: tnaf extended format (blocked SEQ)
    has_title: bool = False
    has_ids: bool = True
    has_comments: bool = True     # "names" in unnaf terminology
    has_lengths: bool = True
    has_mask: bool = True
    has_sequence: bool = True
    has_quality: bool = False
    name_separator: str = " "
    line_length: int = 0
    n_sequences: int = 0

    @property
    def seq_type_name(self) -> str:
        return SEQ_TYPE_NAMES[self.seq_type]

    def flags_byte(self) -> int:
        return (
            (int(self.extended) << 7)
            | (int(self.has_title) << 6)
            | (int(self.has_ids) << 5)
            | (int(self.has_comments) << 4)
            | (int(self.has_lengths) << 3)
            | (int(self.has_mask) << 2)
            | (int(self.has_sequence) << 1)
            | int(self.has_quality)
        )


@dataclass
class Section:
    """One compressed section: zstd frame bytes *minus* the 4-byte magic.

    `payload` is bytes or a byte buffer (a memoryview of a section
    compressor's frame), or a spill handle exposing `__len__` and
    `copy_into(out)` (codec.SpilledPayload) for a section written to a temp
    file (ennaf/src/compressor.c:51-61, 150-173).
    """
    uncompressed_size: int
    payload: object  # bytes | memoryview | SpilledPayload

    @property
    def compressed_size(self) -> int:
        return len(self.payload)


@dataclass
class NafArchive:
    header: NafHeader
    title: Optional[bytes] = None
    sections: Dict[str, Section] = field(default_factory=dict)

    # section keys, in container order
    ORDER = ("ids", "comments", "lengths", "mask", "sequence", "quality")


def write_naf(out: BinaryIO, archive: NafArchive) -> None:
    h = archive.header
    out.write(NAF_MAGIC)
    if h.seq_type == SEQ_TYPE_DNA:
        out.write(bytes((1,)))
    else:
        out.write(bytes((2, h.seq_type)))
    out.write(bytes((h.flags_byte(),)))
    out.write(h.name_separator.encode("ascii"))
    out.write(encode_vle(h.line_length))
    out.write(encode_vle(h.n_sequences))

    if h.has_title:
        title = archive.title or b""
        out.write(encode_vle(len(title)))
        out.write(title)

    flag_by_key = {
        "ids": h.has_ids,
        "comments": h.has_comments,
        "lengths": h.has_lengths,
        "mask": h.has_mask,
        "sequence": h.has_sequence,
        "quality": h.has_quality,
    }
    for key in NafArchive.ORDER:
        if not flag_by_key[key]:
            continue
        sec = archive.sections.get(key)
        if sec is None:
            raise NafFormatError(f"flag set for section {key!r} but no payload given")
        out.write(encode_vle(sec.uncompressed_size))
        out.write(encode_vle(sec.compressed_size))
        if isinstance(sec.payload, (bytes, bytearray, memoryview)):
            out.write(sec.payload)
        else:
            sec.payload.copy_into(out)   # spilled payload streams from disk


class _PartsWriter:
    """Write-API shim that collects parts for a single-copy b"".join.

    BytesIO grows by realloc-and-copy, which on multi-MB archives moves each
    byte several times; joining once moves it exactly once.  Parts are kept
    as given, buffers included (a section compressor's frame view).
    """

    __slots__ = ("parts",)

    def __init__(self):
        self.parts: list = []

    def write(self, b) -> int:
        self.parts.append(b)
        return len(b)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


def naf_bytes(archive: NafArchive) -> bytes:
    buf = _PartsWriter()
    write_naf(buf, archive)
    return buf.getvalue()


class NafReader:
    """Streaming NAF reader with skip/load per section (pipe friendly).

    Sections must be consumed in container order; `skip_through(key)` skips
    everything up to (not including) section `key`.
    """

    def __init__(self, f: BinaryIO):
        self.f = f
        self.header = self._read_header()
        self._line_length: Optional[int] = None
        self._n_sequences: Optional[int] = None
        self._cursor = 0  # index into order: 0=title, then sections

    # -- header -------------------------------------------------------------

    def _read_header(self) -> NafHeader:
        magic = self.f.read(3)
        if len(magic) == 0:
            raise NafFormatError("empty input")
        if len(magic) != 3:
            raise NafFormatError("incomplete or truncated input")
        if magic != NAF_MAGIC:
            raise NafFormatError("not a NAF format")

        version = self._u8()
        if version < 1 or version > 2:
            raise NafFormatError(f"unknown version ({version}) of NAF format")
        seq_type = SEQ_TYPE_DNA
        if version > 1:
            t = self._u8()
            if t == 1:
                seq_type = SEQ_TYPE_RNA
            elif t == 2:
                seq_type = SEQ_TYPE_PROTEIN
            elif t == 3:
                seq_type = SEQ_TYPE_TEXT
            else:
                raise NafFormatError(f"unknown sequence type ({t}) found in NAF file")

        flags = self._u8()
        sep = self._u8()
        if sep < 0x20 or sep > 0x7E:
            raise NafFormatError("unsupported name separator character")

        return NafHeader(
            format_version=version,
            seq_type=seq_type,
            extended=bool((flags >> 7) & 1),
            has_title=bool((flags >> 6) & 1),
            has_ids=bool((flags >> 5) & 1),
            has_comments=bool((flags >> 4) & 1),
            has_lengths=bool((flags >> 3) & 1),
            has_mask=bool((flags >> 2) & 1),
            has_sequence=bool((flags >> 1) & 1),
            has_quality=bool(flags & 1),
            name_separator=chr(sep),
        )

    def _u8(self) -> int:
        b = self.f.read(1)
        if not b:
            raise NafFormatError("incomplete or truncated input")
        return b[0]

    def read_counters(self) -> Tuple[int, int]:
        """Read (line_length, n_sequences); must be called before sections."""
        if self._line_length is None:
            self._line_length = read_vle(self.f)
            self._n_sequences = read_vle(self.f)
        return self._line_length, self._n_sequences

    @property
    def n_sequences(self) -> int:
        self.read_counters()
        return self._n_sequences  # type: ignore[return-value]

    @property
    def line_length(self) -> int:
        self.read_counters()
        return self._line_length  # type: ignore[return-value]

    # -- section access -------------------------------------------------------

    _FLAG_ATTR = {
        "title": "has_title",
        "ids": "has_ids",
        "comments": "has_comments",
        "lengths": "has_lengths",
        "mask": "has_mask",
        "sequence": "has_sequence",
        "quality": "has_quality",
    }
    _ORDER: List[str] = ["title", "ids", "comments", "lengths", "mask", "sequence", "quality"]

    def _present(self, key: str) -> bool:
        return getattr(self.header, self._FLAG_ATTR[key])

    def _skip_ahead(self, nbytes: int) -> None:
        # Pipes can't seek; read-and-discard in chunks (unnaf/src/input.c:11).
        remaining = nbytes
        if self.f.seekable():
            self.f.seek(nbytes, io.SEEK_CUR)
            return
        while remaining > 0:
            chunk = self.f.read(min(remaining, 1 << 20))
            if not chunk:
                raise NafFormatError("incomplete or truncated input")
            remaining -= len(chunk)

    def skip_section(self, key: str) -> None:
        self.read_counters()
        idx = self._ORDER.index(key)
        if idx < self._cursor:
            raise NafFormatError(f"section {key!r} already passed")
        self._cursor = idx + 1
        if not self._present(key):
            return
        if key == "title":
            self._skip_ahead(read_vle(self.f))
        else:
            read_vle(self.f)  # uncompressed size
            self._skip_ahead(read_vle(self.f))

    def skip_through(self, key: str) -> None:
        idx = self._ORDER.index(key)
        while self._cursor < idx:
            self.skip_section(self._ORDER[self._cursor])

    def section_sizes(self, key: str) -> Tuple[int, int]:
        """Read (uncompressed, compressed) sizes, positioning at payload."""
        self.skip_through(key)
        if not self._present(key):
            raise NafFormatError(f"section {key!r} not present")
        self._cursor = self._ORDER.index(key) + 1
        u = read_vle(self.f)
        c = read_vle(self.f)
        return u, c

    def load_title(self) -> bytes:
        self.skip_through("title")
        self._cursor = 1
        if not self._present("title"):
            return b""
        size = read_vle(self.f)
        data = self.f.read(size)
        if len(data) != size:
            raise NafFormatError("incomplete or truncated input")
        return data

    def load_section(self, key: str) -> Tuple[int, bytes]:
        """Returns (uncompressed_size, magic-stripped compressed payload)."""
        u, c = self.section_sizes(key)
        payload = self.f.read(c)
        if len(payload) != c:
            raise NafFormatError("incomplete or truncated input")
        return u, payload
