"""Variable-length-encoded numbers (NAF spec §10).

Unsigned integers in base-128, most-significant limb first, high bit set on
every limb except the last.  Parity targets: writer ennaf/src/encoders.c:175,
reader unnaf/src/utils.c:117 (including its overflow and leading-0x80 checks).

A frozen copy of ``naf_tpu_torch/format/vle.py``, for the benchmark's reference.
"""

from __future__ import annotations

from typing import BinaryIO, Tuple


class VleError(ValueError):
    pass


def encode_vle(value: int) -> bytes:
    if value < 0:
        raise VleError("VLE numbers are unsigned")
    out = bytearray()
    out.append(value & 0x7F)
    value >>= 7
    while value > 0:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    out.reverse()
    return bytes(out)


def decode_vle(buf: bytes, pos: int = 0) -> Tuple[int, int]:
    """Decode one VLE number from `buf` at `pos`; returns (value, new_pos)."""
    n = len(buf)
    if pos >= n:
        raise VleError("incomplete or truncated input")
    c = buf[pos]
    pos += 1
    if c == 0x80:
        raise VleError("invalid input: error parsing variable length encoded number")
    value = 0
    while c & 0x80:
        if value & (0x7F << 57):
            raise VleError("invalid input: overflow reading a variable length encoded number")
        value = (value << 7) | (c & 0x7F)
        if pos >= n:
            raise VleError("incomplete or truncated input")
        c = buf[pos]
        pos += 1
    if value & (0x7F << 57):
        raise VleError("invalid input: overflow reading a variable length encoded number")
    value = (value << 7) | c
    return value, pos


def read_vle(f: BinaryIO) -> int:
    """Streaming variant of decode_vle over a file object."""
    b = f.read(1)
    if not b:
        raise VleError("incomplete or truncated input")
    c = b[0]
    if c == 0x80:
        raise VleError("invalid input: error parsing variable length encoded number")
    value = 0
    while c & 0x80:
        if value & (0x7F << 57):
            raise VleError("invalid input: overflow reading a variable length encoded number")
        value = (value << 7) | (c & 0x7F)
        b = f.read(1)
        if not b:
            raise VleError("incomplete or truncated input")
        c = b[0]
    if value & (0x7F << 57):
        raise VleError("invalid input: overflow reading a variable length encoded number")
    return (value << 7) | c
